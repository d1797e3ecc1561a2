"""Pod-level request scheduling (port of ``repro.serve``): batch placement
on two pods and, through a deprecation shim, online serving of a request
stream (``serve_online``; the facade's ``Session.serve(stream)``)."""
from .pod_scheduler import (
    Request,
    place_two_pods,
    place_two_pods_equal,
)

__all__ = [k for k in dir() if not k.startswith("_")]

# ----------------------------------------------------------------------
# Deprecated entry point(s): kept working through a PEP 562 shim that
# warns once and defers to the implementation module.  New code goes
# through repro_torch.api (Session / Platform / Policy).
_DEPRECATED = {
    "serve_online": (
        "repro_torch.serve.pod_scheduler",
        "repro_torch.api.Session.serve(stream)",
    ),
}
__all__ += list(_DEPRECATED)


def __getattr__(name):
    if name in _DEPRECATED:  # lazy: keep repro_torch.api out of base imports
        from repro_torch.api._deprecate import deprecated_getattr

        return deprecated_getattr(__name__, _DEPRECATED)(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_DEPRECATED))
