"""Live dashboard and static HTML report — stdlib http only.

``Dashboard`` serves an auto-refreshing status page over
``http.server.ThreadingHTTPServer`` on a daemon thread (the shape of
dask distributed's ``bokeh/status_monitor.py``, without the bokeh):

* ``/`` — the HTML page: stat tiles (makespan, fluid ratio, dispatches,
  resident bytes), per-device utilization bars, a queue-depth
  sparkline, the Gantt tail of recent ``run`` spans, and a metrics
  table.  ``<meta http-equiv="refresh">`` keeps it live with zero JS
  dependencies.
* ``/metrics`` — Prometheus text exposition from the registry.
* ``/metrics.json`` — the registry's JSON snapshot.
* ``/trace.json`` — the current bus rendered by
  :func:`repro_torch.obs.trace.from_bus` (perfetto-loadable).

:func:`render_html` is a pure function of (bus, registry, context), so
the same page the server renders is dumped as a static artifact by
:func:`save_html_report` — that is what ``RunReport.save_html`` calls
and what the bench-gate uploads.

Colors follow the repo-wide chart palette: CSS custom properties with a
``prefers-color-scheme: dark`` block, series color reserved for data
marks, text in ink tokens.
"""
from __future__ import annotations

import html
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Sequence, Tuple

from . import trace as trace_mod
from .efficiency import device_utilization, fluid_ratio
from .events import BUS, EventBus
from .metrics import REGISTRY, Registry

_CSS = """
:root {
  color-scheme: light;
  --surface-1: #fcfcfb; --page: #f9f9f7;
  --text-primary: #0b0b0b; --text-secondary: #52514e; --muted: #898781;
  --grid: #e1e0d9; --baseline: #c3c2b7;
  --series-1: #2a78d6; --good: #0ca30c; --critical: #d03b3b;
  --ring: rgba(11,11,11,0.10);
}
@media (prefers-color-scheme: dark) {
  :root {
    color-scheme: dark;
    --surface-1: #1a1a19; --page: #0d0d0d;
    --text-primary: #ffffff; --text-secondary: #c3c2b7; --muted: #898781;
    --grid: #2c2c2a; --baseline: #383835;
    --series-1: #3987e5; --good: #0ca30c; --critical: #d03b3b;
    --ring: rgba(255,255,255,0.10);
  }
}
* { box-sizing: border-box; }
body {
  margin: 0; padding: 24px; background: var(--page);
  color: var(--text-primary);
  font: 14px/1.45 system-ui, -apple-system, "Segoe UI", sans-serif;
}
h1 { font-size: 18px; margin: 0 0 4px; }
.sub { color: var(--text-secondary); margin: 0 0 20px; }
.cards { display: flex; flex-wrap: wrap; gap: 12px; margin-bottom: 20px; }
.card {
  background: var(--surface-1); border: 1px solid var(--ring);
  border-radius: 8px; padding: 12px 16px; min-width: 148px;
}
.card .v { font-size: 26px; font-weight: 600; }
.card .k { color: var(--text-secondary); font-size: 12px; }
.panel {
  background: var(--surface-1); border: 1px solid var(--ring);
  border-radius: 8px; padding: 16px; margin-bottom: 16px;
}
.panel h2 { font-size: 13px; margin: 0 0 10px; color: var(--text-secondary);
  font-weight: 600; }
.utilrow { display: flex; align-items: center; gap: 8px; margin: 4px 0; }
.utilrow .lbl { width: 72px; color: var(--muted); font-size: 12px;
  font-variant-numeric: tabular-nums; }
.utilrow .bar { flex: 1; height: 10px; background: var(--grid);
  border-radius: 4px; overflow: hidden; }
.utilrow .fill { height: 100%; background: var(--series-1);
  border-radius: 4px; }
.utilrow .pct { width: 52px; text-align: right; font-size: 12px;
  font-variant-numeric: tabular-nums; }
.gantt { position: relative; height: var(--gh); background: var(--surface-1); }
.gantt .slice {
  position: absolute; height: 10px; background: var(--series-1);
  border-radius: 4px; border: 2px solid var(--surface-1);
}
.gantt .axis { position: absolute; left: 0; right: 0; bottom: 0;
  border-top: 1px solid var(--baseline); }
table { border-collapse: collapse; width: 100%; }
td, th { padding: 4px 10px 4px 0; text-align: left; font-size: 13px;
  border-bottom: 1px solid var(--grid); }
th { color: var(--text-secondary); font-weight: 600; }
td.num { font-variant-numeric: tabular-nums; }
svg .line { fill: none; stroke: var(--series-1); stroke-width: 2; }
svg .area { fill: var(--series-1); opacity: 0.12; }
svg .gridline { stroke: var(--grid); stroke-width: 1; }
.empty { color: var(--muted); font-size: 13px; }
"""


def _fmt(v: float) -> str:
    if v != v:  # NaN
        return "–"
    a = abs(v)
    if a >= 1e9 or (a > 0 and a < 1e-3):
        return f"{v:.3g}"
    if a >= 100:
        return f"{v:,.0f}"
    return f"{v:.3g}"


def _tile(label: str, value: str, hint: str = "") -> str:
    t = f' title="{html.escape(hint)}"' if hint else ""
    return (
        f'<div class="card"{t}><div class="v">{html.escape(value)}</div>'
        f'<div class="k">{html.escape(label)}</div></div>'
    )


def _sparkline(
    pts: Sequence[Tuple[float, float]], width: int = 560, height: int = 60
) -> str:
    """Single-series SVG sparkline with baseline grid (no legend: the
    panel title names the one series)."""
    if len(pts) < 2:
        return '<div class="empty">no samples yet</div>'
    t0, t1 = pts[0][0], pts[-1][0]
    vmax = max(v for _, v in pts) or 1.0
    dt = (t1 - t0) or 1.0
    xy = [
        (2 + (t - t0) / dt * (width - 4), height - 4 - v / vmax * (height - 10))
        for t, v in pts
    ]
    line = " ".join(f"{x:.1f},{y:.1f}" for x, y in xy)
    area = f"2,{height-4} {line} {width-2},{height-4}"
    return (
        f'<svg viewBox="0 0 {width} {height}" width="100%" height="{height}"'
        f' role="img" aria-label="queue depth over time">'
        f'<line class="gridline" x1="0" y1="{height-4}" x2="{width}"'
        f' y2="{height-4}"/>'
        f'<polygon class="area" points="{area}"/>'
        f'<polyline class="line" points="{line}"/>'
        f'<title>peak {vmax:g}</title></svg>'
    )


def _gantt_tail(spans, horizon: float, n_rows: int = 16) -> str:
    """The last ``n_rows`` run spans as a miniature Gantt (2px surface
    gap between slices via the border spacer)."""
    runs = sorted(
        (s for s in spans if s.name == "run" and s.t1 > s.t0),
        key=lambda s: s.t1,
    )[-n_rows:]
    if not runs:
        return '<div class="empty">no completed work yet</div>'
    t0 = min(s.t0 for s in runs)
    t1 = max(s.t1 for s in runs)
    dt = (t1 - t0) or 1.0
    rows = []
    for i, s in enumerate(runs):
        left = (s.t0 - t0) / dt * 100
        w = max(s.duration / dt * 100, 0.5)
        tip = (
            f"{s.cat} {s.key}: {s.duration*1e3:.2f} ms on device "
            f"{s.device} ×{s.attrs.get('devices_used', 1)}"
        )
        rows.append(
            f'<div class="slice" title="{html.escape(tip)}" '
            f'style="top:{i*14}px;left:{left:.2f}%;width:{w:.2f}%"></div>'
        )
    h = len(runs) * 14 + 6
    return (
        f'<div class="gantt" style="--gh:{h}px;height:{h}px">'
        + "".join(rows)
        + '<div class="axis"></div></div>'
    )


def render_html(
    bus: Optional[EventBus] = None,
    registry: Optional[Registry] = None,
    *,
    title: str = "repro observatory",
    context: Optional[Dict] = None,
    refresh: Optional[float] = None,
) -> str:
    """The dashboard page as a self-contained HTML string.

    ``context`` carries run-level numbers the bus doesn't know
    (makespan, fluid_makespan, n_devices...); ``refresh`` adds the
    auto-reload meta tag (live mode only — static reports omit it).
    """
    bus = bus if bus is not None else BUS
    registry = registry if registry is not None else REGISTRY
    ctx = dict(context or {})
    spans = bus.spans()
    tracks = bus.counter_tracks()

    tiles: List[str] = []
    makespan = ctx.get("makespan")
    fluid = ctx.get("fluid_makespan")
    if makespan is not None:
        tiles.append(_tile("makespan (s)", _fmt(makespan)))
    if makespan is not None and fluid:
        tiles.append(
            _tile(
                "fluid ratio",
                _fmt(fluid_ratio(makespan, fluid)),
                "makespan / Theorem-6 fluid PM lower bound (1.0 = optimal)",
            )
        )
    disp = registry.get("repro_dispatches_total")
    if disp is not None:
        tiles.append(_tile("dispatches", _fmt(disp.value)))
    fronts = registry.get("repro_fronts_completed_total")
    if fronts is not None:
        tiles.append(_tile("fronts done", _fmt(fronts.value)))
    res = registry.get("repro_resident_bytes")
    if res is not None and res.value:
        tiles.append(_tile("resident (MiB)", _fmt(res.value / 2**20)))
    lat = registry.get("repro_ready_latency_seconds")
    if lat is not None and getattr(lat, "count", 0):
        tiles.append(_tile("ready lat p50 (s)", _fmt(lat.quantile(0.5))))
    wait_h = registry.get("repro_serve_wait_seconds")
    if wait_h is not None and getattr(wait_h, "count", 0):
        tiles.append(
            _tile(
                "serve wait p50 (s)",
                _fmt(wait_h.quantile(0.5)),
                "admission wait: request submit -> admit",
            )
        )
    exec_h = registry.get("repro_serve_exec_seconds")
    if exec_h is not None and getattr(exec_h, "count", 0):
        tiles.append(
            _tile(
                "serve exec p50 (s)",
                _fmt(exec_h.quantile(0.5)),
                "execution time: request admit -> done",
            )
        )
    slots = registry.get("repro_cluster_slots")
    if slots is not None and slots.value:
        tiles.append(_tile("cluster slots", _fmt(slots.value)))

    n_devices = int(ctx.get("n_devices", 0))
    if not n_devices:
        n_devices = max(
            (s.device + int(s.attrs.get("devices_used", 1)) for s in spans),
            default=0,
        )
    util_html = '<div class="empty">no device activity yet</div>'
    if n_devices > 0 and spans:
        util = device_utilization(spans, n_devices, ctx.get("makespan"))
        rows = []
        for d, frac in enumerate(util["per_device"]):
            pct = min(max(frac, 0.0), 1.0) * 100
            rows.append(
                f'<div class="utilrow"><span class="lbl">device {d}</span>'
                f'<span class="bar" title="device {d}: {pct:.1f}% busy">'
                f'<span class="fill" style="width:{pct:.1f}%"></span></span>'
                f'<span class="pct">{pct:.1f}%</span></div>'
            )
        rows.append(
            f'<div class="utilrow"><span class="lbl">occupancy</span>'
            f'<span class="pct">{util["occupancy"]*100:.1f}%</span></div>'
        )
        util_html = "".join(rows)

    qd = tracks.get("queue_depth", [])
    if not qd:
        g = registry.get("repro_queue_depth")
        qd = g.track() if g is not None and hasattr(g, "track") else []

    mrows = []
    for name, d in sorted(registry.snapshot().items()):
        if d["kind"] == "histogram":
            val = f"n={d['count']} mean={_fmt(d['mean'])} p99={_fmt(d['p99'])}"
        else:
            vals = d["values"]
            val = ", ".join(f"{k}={_fmt(v)}" for k, v in sorted(vals.items()))
        unit = d.get("unit", "")
        mrows.append(
            f"<tr><td>{html.escape(name)}</td><td>{html.escape(d['kind'])}"
            f"</td><td class='num'>{html.escape(val)}</td>"
            f"<td>{html.escape(unit)}</td></tr>"
        )
    metrics_html = (
        "<table><tr><th>metric</th><th>kind</th><th>value</th><th>unit</th>"
        "</tr>" + "".join(mrows) + "</table>"
        if mrows
        else '<div class="empty">no metrics registered</div>'
    )

    tenants_html = ""
    if wait_h is not None and getattr(wait_h, "count", 0):
        rows = []
        waits = wait_h.children()
        execs = exec_h.children() if exec_h is not None else {}
        for label in sorted(waits):
            wh, eh = waits[label], execs.get(label)
            rows.append(
                f"<tr><td>{html.escape(label.strip('{}'))}</td>"
                f"<td class='num'>{wh.count}</td>"
                f"<td class='num'>{_fmt(wh.quantile(0.5))}</td>"
                f"<td class='num'>"
                f"{_fmt(eh.quantile(0.5)) if eh else '–'}</td>"
                f"<td class='num'>"
                f"{_fmt(eh.quantile(0.99)) if eh else '–'}</td></tr>"
            )
        if rows:
            tenants_html = (
                '<div class="panel"><h2>Serving by tenant '
                "(wait = queued, exec = running)</h2>"
                "<table><tr><th>tenant</th><th>served</th>"
                "<th>wait p50 (s)</th><th>exec p50 (s)</th>"
                "<th>exec p99 (s)</th></tr>"
                + "".join(rows)
                + "</table></div>"
            )

    refresh_tag = (
        f'<meta http-equiv="refresh" content="{refresh:g}">' if refresh else ""
    )
    sub = ctx.get("subtitle", f"{len(spans)} spans · {len(bus.events())} events")
    return f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">{refresh_tag}
<title>{html.escape(title)}</title><style>{_CSS}</style></head>
<body>
<h1>{html.escape(title)}</h1>
<p class="sub">{html.escape(str(sub))}</p>
<div class="cards">{''.join(tiles)}</div>
<div class="panel"><h2>Device utilization</h2>{util_html}</div>
<div class="panel"><h2>Queue depth</h2>{_sparkline(qd)}</div>
{tenants_html}<div class="panel"><h2>Recent work (Gantt tail)</h2>
{_gantt_tail(spans, ctx.get("makespan") or 0.0)}</div>
<div class="panel"><h2>Metrics</h2>{metrics_html}</div>
</body></html>"""


def save_html_report(
    path,
    *,
    bus: Optional[EventBus] = None,
    registry: Optional[Registry] = None,
    title: str = "repro run report",
    context: Optional[Dict] = None,
) -> str:
    """Write the dashboard page as a static artifact; returns the path."""
    doc = render_html(bus, registry, title=title, context=context)
    with open(path, "w") as fh:
        fh.write(doc)
    return str(path)


class Dashboard:
    """Threaded live-dashboard server over the process bus + registry.

    ``port=0`` picks a free port (read it back from ``.port``).  The
    server thread is a daemon, so it never blocks interpreter exit;
    call :meth:`stop` for a clean shutdown.
    """

    def __init__(
        self,
        port: int = 0,
        *,
        host: str = "127.0.0.1",
        bus: Optional[EventBus] = None,
        registry: Optional[Registry] = None,
        context: Optional[Dict] = None,
        refresh: float = 2.0,
        title: str = "repro observatory",
    ) -> None:
        self.bus = bus if bus is not None else BUS
        self.registry = registry if registry is not None else REGISTRY
        self.context = dict(context or {})
        dash = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, ctype: str) -> None:
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self) -> None:
                route = self.path.split("?")[0]
                try:
                    if route in ("/", "/index.html"):
                        page = render_html(
                            dash.bus,
                            dash.registry,
                            title=title,
                            context=dash.context,
                            refresh=refresh,
                        )
                        self._send(page.encode(), "text/html; charset=utf-8")
                    elif route == "/metrics":
                        self._send(
                            dash.registry.prometheus().encode(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif route == "/metrics.json":
                        self._send(
                            json.dumps(dash.registry.snapshot()).encode(),
                            "application/json",
                        )
                    elif route == "/trace.json":
                        evts = trace_mod.from_bus(dash.bus)
                        self._send(
                            json.dumps(
                                {"traceEvents": evts, "displayTimeUnit": "ms"}
                            ).encode(),
                            "application/json",
                        )
                    else:
                        self.send_error(404)
                except BrokenPipeError:  # client went away mid-write
                    pass

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="repro_torch-obs-dashboard",
            daemon=True,
        )
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def update_context(self, **kv) -> None:
        """Merge run-level numbers into the page context."""
        self.context.update(kv)

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


__all__ = ["Dashboard", "render_html", "save_html_report"]
