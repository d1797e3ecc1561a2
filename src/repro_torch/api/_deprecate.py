"""Warn-once machinery for the legacy entry points the facade supersedes
(port of ``repro.api._deprecate``).

Package-level access to a legacy entry point routes through a PEP 562
module ``__getattr__`` that calls :func:`warn_once` before handing back
the real object.  Direct sub-module imports (``from
repro_torch.serve.pod_scheduler import serve_online``) stay silent — that
is what the port's own modules use.  In the port only
``repro_torch.serve.serve_online`` goes through it: ``pm_schedule``,
``make_plan``, ``execute_plan`` and ``OnlineScheduler`` are exported
directly by their packages, as they were before this module was ported.
"""
from __future__ import annotations

import importlib
import warnings
from typing import Dict, Set, Tuple

_warned: Set[str] = set()


def warn_once(key: str, replacement: str) -> None:
    """Emit one DeprecationWarning per ``key`` per process."""
    if key in _warned:
        return
    _warned.add(key)
    # stacklevel walks warn_once -> closure __getattr__ -> the package
    # __getattr__ -> the user's attribute access
    warnings.warn(
        f"{key} is deprecated as a public entry point; use {replacement}",
        DeprecationWarning,
        stacklevel=4,
    )


def reset_warnings() -> None:
    """Forget which keys already warned (tests only)."""
    _warned.clear()


def deprecated_getattr(
    package: str, table: Dict[str, Tuple[str, str]]
):
    """Build a module ``__getattr__`` for ``package``.

    ``table`` maps the public name to ``(implementation module, suggested
    replacement)``; the attribute of the same name is fetched from the
    implementation module after the (once-only) warning.
    """

    def __getattr__(name: str):
        if name in table:
            mod, replacement = table[name]
            warn_once(f"{package}.{name}", replacement)
            return getattr(importlib.import_module(mod), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    return __getattr__


__all__ = ["deprecated_getattr", "reset_warnings", "warn_once"]
