"""``repro_torch.obs`` — the telemetry layer the executor publishes to.

* :mod:`~repro_torch.obs.events` — the process-local span/event bus with
  wall + virtual dual clocks (``BUS``, ``enable``/``disable``).
* :mod:`~repro_torch.obs.metrics` — counters / gauges / histograms with
  Prometheus-text and JSON exporters (``REGISTRY``).
* :mod:`~repro_torch.obs.trace` — the chrome-trace / perfetto exporter.

Metric names are those of ``repro.obs``.  ``obs.disable()`` turns every
publish site into an immediate return.
"""
from .events import (
    BUS,
    CLOCKS,
    VIRTUAL,
    WALL,
    Event,
    EventBus,
    Span,
    disable,
    enable,
    enabled,
    get_bus,
)
from .metrics import (
    DEFAULT_BUCKETS,
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    get_registry,
)
from .trace import (
    SLICE_KEYS,
    counter_event,
    from_bus,
    from_execution_report,
    from_schedule,
    metadata_event,
    save_trace,
    slice_event,
)


def reset() -> None:
    """Clear the bus and the registry (the start-of-run hook)."""
    BUS.clear()
    REGISTRY.reset()


__all__ = [k for k in dir() if not k.startswith("_")]
