"""Pod-level request scheduling — §6 and the online subsystem, serving.

Requests (prefill jobs, or whole factorization trees) are malleable tasks
that must not span pods (constraint 𝓡 at the pods' interconnect boundary).  Two
modes:

* **batch placement** — a fixed request set split across two pods: for
  equal pods Algorithm 11 (trees) / the Lemma-10 greedy (independent
  requests); for unequal pods (a degraded pod after failures, or mixed
  generations) the Algorithm-12 FPTAS.
* **online serving** (:func:`serve_online`) — a *stream* of requests with
  arrival times, served by the event-driven online scheduler through a
  multi-tenant admission queue (FIFO / SJF / fair-share): each admitted
  request is a malleable task sharing the pod by Lemma-4 ratios, and the
  report carries per-request latency plus pod utilization.

Request cost model: prefill flops ≈ 2·N_active·prompt_tokens.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hetero import hetero_fptas, partition_makespan
from repro_torch.core.trees import star_tree
from repro_torch.core.two_node import homogeneous_two_node
from repro_torch.models.config import ModelConfig
from repro_torch.online.queue import TreeRequest, serve_trees  # noqa: F401 (re-export)


@dataclass
class Request:
    rid: int
    prompt_tokens: int


def request_lengths(cfg: ModelConfig, requests: Sequence[Request]) -> np.ndarray:
    return np.array(
        [2.0 * cfg.n_active_params * r.prompt_tokens for r in requests],
        dtype=np.float64,
    )


def place_two_pods_equal(
    cfg: ModelConfig, requests: Sequence[Request], pod_devices: int, alpha: float
) -> Tuple[float, List[int]]:
    """Equal pods: Algorithm 11 on the star tree of requests.

    Returns (makespan_estimate, pod id per request).
    """
    lengths = request_lengths(cfg, requests)
    tree = star_tree(lengths)
    res = homogeneous_two_node(tree, alpha, float(pod_devices))
    # star_tree: label i+1 == request i... labels are identity over tree
    # nodes; node 0 is the virtual root.
    placement = [res.placement[i + 1] for i in range(len(requests))]
    return res.makespan, placement


def serve_online(
    cfg: ModelConfig,
    requests: Sequence[Request],
    arrivals: Sequence[float],
    pod_devices: int,
    alpha: float,
    *,
    tenants: Optional[Sequence[int]] = None,
    policy: str = "pm",
    admission: str = "sjf",
    max_concurrent: Optional[int] = 4,
    flop_rate: float = 1e12,
    noise=None,
):
    """Online mode: serve a request stream on one pod via the event core.

    Each request is a single malleable task (length = prefill flops /
    ``flop_rate``, so times are seconds at a ``flop_rate``-flops/s
    device).  Admitted requests share the pod by PM ratios; the admission
    queue (``fifo`` / ``sjf`` / ``fair``) orders the backlog.  Returns
    the :class:`~repro_torch.online.scheduler.OnlineReport`; per-request
    latency is ``report.futures[i].latency`` keyed by submission order
    (``rid`` carries the request id).

    Each request becomes one shared :class:`repro_torch.api.problem.Problem`
    with the pod's α, so the 𝓛 that SJF admission sorts by and the
    length the event loop pays down come from the same object.

    This is the inproc backend of the cluster engine API
    (:class:`repro_torch.cluster.engine.SimEngine`): the same
    submit/run/stats verbs the distributed
    :class:`~repro_torch.cluster.engine.ClusterEngine` speaks, in virtual
    time.  Per-request results carry the **latency split** — admission
    wait (submit → admit) vs execution time (admit → done), see
    ``report.request_results()`` — published as separate
    ``repro_serve_wait_seconds`` / ``repro_serve_exec_seconds``
    histograms so a saturated queue and slow execution are
    distinguishable on the dashboard.
    """
    from repro_torch.api.problem import Problem
    from repro_torch.cluster.engine import SimEngine

    engine = SimEngine(
        pod_devices,
        alpha,
        policy=policy,
        admission=admission,
        max_concurrent=max_concurrent,
        noise=noise,
    )
    lengths = request_lengths(cfg, requests) / float(flop_rate)
    for i, (r, L, a) in enumerate(zip(requests, lengths, arrivals)):
        engine.submit(
            Problem.from_lengths([L], alpha, name=f"request-{r.rid}"),
            arrival=float(a),
            tenant=int(tenants[i]) if tenants is not None else 0,
            rid=r.rid,
        )
    report = engine.run()
    from repro_torch.obs import events as obs_events
    from repro_torch.obs import metrics as obs_metrics

    if obs_events.enabled():
        req_counter = obs_metrics.REGISTRY.counter(
            "repro_serve_requests_total", "pod requests served, by tenant"
        )
        wait_h = obs_metrics.REGISTRY.histogram(
            "repro_serve_wait_seconds",
            "admission wait (submit -> admit), virtual s",
            unit="s",
        )
        exec_h = obs_metrics.REGISTRY.histogram(
            "repro_serve_exec_seconds",
            "execution time (admit -> done), virtual s",
            unit="s",
        )
        for rec in report.request_results():
            req_counter.inc(tenant=rec.tenant)
            wait_h.observe(rec.wait, tenant=rec.tenant)
            exec_h.observe(rec.exec_time, tenant=rec.tenant)
        obs_metrics.REGISTRY.gauge(
            "repro_serve_mean_latency",
            "mean request latency of the last serve batch (virtual s)",
            unit="s",
        ).set(report.mean_latency())
        obs_metrics.REGISTRY.gauge(
            "repro_serve_mean_wait",
            "mean admission wait of the last serve batch (virtual s)",
            unit="s",
        ).set(report.mean_wait())
    return report


def place_two_pods(
    cfg: ModelConfig,
    requests: Sequence[Request],
    pod_p: int,
    pod_q: int,
    alpha: float,
    lam: float = 1.05,
) -> Tuple[float, List[int]]:
    """Unequal pods: the Algorithm-12 FPTAS (λ-approximation)."""
    lengths = request_lengths(cfg, requests)
    res = hetero_fptas(lengths, float(pod_p), float(pod_q), alpha, lam)
    placement = [0 if i in set(res.on_p) else 1 for i in range(len(requests))]
    mk = partition_makespan(lengths, res.on_p, float(pod_p), float(pod_q), alpha)
    return mk, placement
