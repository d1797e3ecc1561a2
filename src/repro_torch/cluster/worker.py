"""Cluster worker: registers capacity, heartbeats, executes front groups.

A worker is one long-lived process-local peer of the scheduler.  On
start it connects over :mod:`repro_torch.cluster.comm` (inproc or TCP — same
protocol), registers its slot capacity, and then serves two loops:

* a daemon *heartbeat* thread that sends ``{"op": "heartbeat"}`` every
  ``heartbeat_interval`` seconds — the scheduler's failure detector
  (:class:`repro_torch.runtime.elastic.HeartbeatMonitor` semantics) treats a
  silence longer than its timeout as a Theorem-6 capacity-down event;
* a *dispatch* loop that receives front-group messages and executes
  them on a slot-sized thread pool, streaming one ``front-done``
  (Schur-complement-ready) notification back per group.

Three dispatch kinds mirror the async executor's numeric path:

``batched``
    B unpadded fronts of one (mp, nbp) shape class — each padded here
    (``pad_front_np``, the executor's host padding) into a (B, mp, mp)
    stack, copied to the worker's device, one ``batched_front_factor``
    launch (one thread-block cluster per front on the card), one copy
    back, then per-lane ``extract_panel_schur`` host-side; lanes are
    independent, so batch composition (including *cross-tenant*
    composition) cannot change bits.
``large``
    one front with mp > VMEM_FRONT_MAX — the per-front
    ``partial_cholesky`` pipeline (``panel_factor`` + ``syrk_downdate``).
``sim``
    no numerics: sleep for the scheduler-computed p^α duration (used by
    deterministic tests and the serving benchmark, where the cost model
    *is* the workload).

Each worker owns one torch ``device``: a CUDA device launches the port's
hand-written kernels (each pool thread works under
``torch.cuda.device(device)``, so its launches go to that thread's
current stream on it), a CPU device runs their plain versions.  Several
workers may share one card.  ``device=None`` means the first CUDA
device, and a numeric dispatch then raises where there is none; ``sim``
dispatches never touch torch.

``kill()`` simulates a crash for fault-tolerance tests: heartbeats stop
and in-flight results are dropped on the floor, which is exactly what
the scheduler's requeue + elastic re-share path must absorb.
"""
from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from repro_torch.cluster.comm import (
    Comm,
    CommClosedError,
    RetryPolicy,
    connect,
)
from repro_torch.kernels.ops import (
    batched_front_factor,
    extract_panel_schur,
    pad_front_np,
    partial_cholesky,
)
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.sparse.multifrontal import default_device

_WORKER_SEQ = [0]
_SEQ_LOCK = threading.Lock()


def _next_name() -> str:
    with _SEQ_LOCK:
        _WORKER_SEQ[0] += 1
        return f"worker-{_WORKER_SEQ[0]}"


class Worker:
    """One cluster worker bound to a scheduler address."""

    def __init__(
        self,
        address: str,
        *,
        slots: int = 2,
        name: Optional[str] = None,
        heartbeat_interval: float = 0.05,
        dispatch_overhead_s: float = 0.0,
        device: Optional[torch.device] = None,
        retry: Optional[RetryPolicy] = None,
    ) -> None:
        if slots < 1:
            raise ValueError("slots must be >= 1")
        self.name = name or _next_name()
        self.slots = int(slots)
        self.heartbeat_interval = float(heartbeat_interval)
        self.dispatch_overhead_s = float(dispatch_overhead_s)
        self.device = torch.device(device) if device is not None else None
        self._killed = threading.Event()
        self._stopped = threading.Event()
        self.n_dispatches = 0
        self.batch_sizes: list = []  # per-dispatch item counts (tests)

        self.comm: Comm = connect(address, label=self.name, retry=retry)
        self.comm.send(
            {"op": "register", "worker": self.name, "slots": self.slots}
        )
        self._pool = ThreadPoolExecutor(
            max_workers=self.slots,
            thread_name_prefix=f"repro_torch-{self.name}",
        )
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop,
            name=f"repro_torch-{self.name}-hb",
            daemon=True,
        )
        self._rx_thread = threading.Thread(
            target=self._dispatch_loop,
            name=f"repro_torch-{self.name}-rx",
            daemon=True,
        )
        self._hb_thread.start()
        self._rx_thread.start()

    # ------------------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stopped.wait(self.heartbeat_interval):
            if self._killed.is_set():
                continue  # crashed workers fall silent, they don't exit
            try:
                self.comm.send({"op": "heartbeat", "worker": self.name})
            except CommClosedError:
                return
            if obs_events.enabled():
                obs_metrics.REGISTRY.counter(
                    "repro_cluster_heartbeats_total", "worker heartbeats sent"
                ).inc(worker=self.name)

    def _dispatch_loop(self) -> None:
        while not self._stopped.is_set():
            try:
                msg = self.comm.recv(timeout=0.2)
            except CommClosedError:
                return
            if msg is None:
                continue
            op = msg.get("op")
            if op == "dispatch":
                self.n_dispatches += 1
                self.batch_sizes.append(len(msg.get("items", ())))
                self._pool.submit(self._execute, msg)
            elif op == "stop":
                self._stopped.set()
                return

    # ------------------------------------------------------------------
    def _execute(self, msg: dict) -> None:
        t0 = time.perf_counter()
        kind = msg["kind"]
        items = msg["items"]
        try:
            if kind == "sim":
                # the p^α cost model is the workload; lanes are parallel,
                # so one group costs its slowest member plus the fixed
                # per-dispatch overhead that batching amortizes.
                dur = max((it["duration"] for it in items), default=0.0)
                time.sleep(dur + self.dispatch_overhead_s)
                results = [
                    {"tree": it["tree"], "task": it["task"]} for it in items
                ]
            elif kind == "batched":
                results = self._run_batched(msg)
            elif kind == "large":
                results = self._run_large(msg)
            else:  # pragma: no cover - protocol error
                raise ValueError(f"unknown dispatch kind {kind!r}")
        except Exception as e:  # surface as a failed batch, don't die
            self._reply(
                {
                    "op": "front-failed",
                    "worker": self.name,
                    "batch": msg["batch"],
                    "error": f"{type(e).__name__}: {e}",
                }
            )
            return
        elapsed = time.perf_counter() - t0
        if obs_events.enabled():
            obs_metrics.REGISTRY.histogram(
                "repro_cluster_dispatch_seconds",
                "wall time of one worker dispatch",
                unit="s",
            ).observe(elapsed, worker=self.name, kind=kind)
        self._reply(
            {
                "op": "front-done",
                "worker": self.name,
                "batch": msg["batch"],
                "elapsed": elapsed,
                "results": results,
            }
        )

    def _on_device(self):
        """The worker's device, and the context its launches run under."""
        if self.device is None:
            self.device = default_device()
        if self.device.type == "cuda":
            return self.device, torch.cuda.device(self.device)
        return self.device, contextlib.nullcontext()

    def _run_batched(self, msg: dict) -> list:
        """One kernel launch over the padded stack, per-lane extraction."""
        device, ctx = self._on_device()
        fronts = np.stack([
            pad_front_np(np.asarray(f), int(it["nb"]))
            for f, it in zip(msg["fronts"], msg["items"])
        ])
        with ctx:
            x = torch.from_numpy(fronts).to(device)
            # .cpu() waits for the launch on this thread's current stream
            out = batched_front_factor(x, int(msg["nbp"])).cpu().numpy()
        if self.dispatch_overhead_s:
            time.sleep(self.dispatch_overhead_s)
        results = []
        for lane, it in enumerate(msg["items"]):
            panel, schur = extract_panel_schur(
                out[lane], int(it["m"]), int(it["nb"])
            )
            results.append(
                {
                    "tree": it["tree"],
                    "task": it["task"],
                    "panel": panel,
                    "schur": schur,
                }
            )
        return results

    def _run_large(self, msg: dict) -> list:
        """mp > VMEM_FRONT_MAX: the per-front panel pipeline."""
        device, ctx = self._on_device()
        (it,) = msg["items"]
        front = np.asarray(msg["front"])
        with ctx:
            panel, schur = partial_cholesky(
                torch.from_numpy(front).to(device), int(it["nb"])
            )
            panel, schur = panel.cpu().numpy(), schur.cpu().numpy()
        if self.dispatch_overhead_s:
            time.sleep(self.dispatch_overhead_s)
        return [
            {
                "tree": it["tree"],
                "task": it["task"],
                "panel": panel,
                "schur": schur,
            }
        ]

    def _reply(self, msg: dict) -> None:
        if self._killed.is_set():
            return  # crashed: results are lost, scheduler must requeue
        try:
            self.comm.send(msg)
        except CommClosedError:
            pass

    # ------------------------------------------------------------------
    def kill(self) -> None:
        """Simulate a crash: go silent (no heartbeats, no results)."""
        self._killed.set()

    def revive(self) -> None:
        """Undo :meth:`kill` — the next heartbeat re-registers capacity."""
        self._killed.clear()

    def stop(self, timeout: float = 5.0) -> None:
        """Graceful shutdown: deregister, drain the pool, close the comm."""
        if self._stopped.is_set():
            return
        self._stopped.set()
        if not self._killed.is_set():
            try:
                self.comm.send({"op": "bye", "worker": self.name})
            except CommClosedError:
                pass
        self._pool.shutdown(wait=True)
        self.comm.close()
        self._hb_thread.join(timeout=timeout)
        self._rx_thread.join(timeout=timeout)

    def __repr__(self) -> str:
        state = (
            "killed"
            if self._killed.is_set()
            else ("stopped" if self._stopped.is_set() else "running")
        )
        return (
            f"<Worker {self.name} slots={self.slots} device={self.device} "
            f"[{state}]>"
        )


__all__ = ["Worker"]
