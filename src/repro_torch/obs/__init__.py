"""``repro_torch.obs`` — the telemetry layer.

* :mod:`~repro_torch.obs.events` — the process-local span/event bus with
  wall + virtual dual clocks (``BUS``, ``enable``/``disable``).
* :mod:`~repro_torch.obs.metrics` — counters / gauges / histograms with
  Prometheus-text and JSON exporters (``REGISTRY``).
* :mod:`~repro_torch.obs.efficiency` — paper-grounded derived metrics: the
  measured share timeline p̂(t), Theorem-6 fluid ratio, L2 deviation
  from the fluid PM optimum, per-shape-bucket α residuals, device
  utilization.
* :mod:`~repro_torch.obs.trace` — the chrome-trace / perfetto exporter.
* :mod:`~repro_torch.obs.dashboard` — live stdlib-http dashboard
  (localhost) and static HTML report.

Metric names and exports are those of ``repro.obs``.  ``obs.disable()``
turns every publish site into an immediate return.
"""
from .dashboard import Dashboard, render_html, save_html_report
from .efficiency import (
    alpha_residuals,
    device_utilization,
    efficiency_summary,
    execution_alpha_residuals,
    fluid_ratio,
    fold_share_timeline,
    l2_share_deviation,
    measured_share_timeline,
    pm_reference_timeline,
    schedule_l2_deviation,
    schedule_share_timeline,
)
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


__all__ = [
    "BUS",
    "CLOCKS",
    "Counter",
    "DEFAULT_BUCKETS",
    "Dashboard",
    "Event",
    "EventBus",
    "Gauge",
    "Histogram",
    "REGISTRY",
    "Registry",
    "SLICE_KEYS",
    "Span",
    "VIRTUAL",
    "WALL",
    "alpha_residuals",
    "counter_event",
    "device_utilization",
    "disable",
    "efficiency_summary",
    "enable",
    "enabled",
    "execution_alpha_residuals",
    "fluid_ratio",
    "fold_share_timeline",
    "from_bus",
    "from_execution_report",
    "from_schedule",
    "get_bus",
    "get_registry",
    "l2_share_deviation",
    "measured_share_timeline",
    "metadata_event",
    "pm_reference_timeline",
    "render_html",
    "reset",
    "save_html_report",
    "save_trace",
    "schedule_l2_deviation",
    "schedule_share_timeline",
    "slice_event",
]
