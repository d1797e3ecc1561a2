"""Named regions for the cost counter (``repro_torch.launch.hlocost``).

Model code names a region with :func:`cost_scope` (``models.attention``
opens ``"attention"``); host bookkeeping that is not the program's runs
under :func:`uncounted`.  Both only record state here, so the model layer
can open a scope without importing the launch layer; nothing is counted
unless a counter is running.
"""
from __future__ import annotations

import contextlib
from typing import Iterator, List


class _Scopes:
    """Open scopes and the uncounted depth.  Process-wide, not per thread:
    autograd runs a CUDA backward on its own device thread."""

    stack: List[str] = []
    uncounted = 0


SCOPES = _Scopes()


@contextlib.contextmanager
def cost_scope(name: str) -> Iterator[None]:
    """Name a region for the counter (no effect when nothing counts)."""
    stack = SCOPES.stack
    SCOPES.stack = stack + [name]
    try:
        yield
    finally:
        SCOPES.stack = stack


@contextlib.contextmanager
def uncounted() -> Iterator[None]:
    """Ops run inside are not the program's (host bookkeeping): the
    counter neither counts nor tracks them."""
    SCOPES.uncounted += 1
    try:
        yield
    finally:
        SCOPES.uncounted -= 1
