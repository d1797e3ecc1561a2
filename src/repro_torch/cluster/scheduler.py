"""Long-lived cluster scheduler: admission, Lemma-4 re-share, dispatch.

One scheduler process owns the serving state that
:class:`~repro_torch.online.scheduler.OnlineScheduler` holds in virtual time,
transplanted to the wall clock of a real cluster:

* tenants submit :class:`~repro_torch.api.problem.Problem` trees over
  :mod:`repro_torch.cluster.comm` (inproc or TCP — same protocol);
* a :class:`~repro_torch.online.queue.AdmissionQueue` (fifo/sjf/fair,
  memory-aware) decides *when* a tree joins the admitted forest;
* on **every cluster event** — submit, admission, front completion,
  worker register/loss/rejoin — the scheduler recomputes the Lemma-4
  PM split over the residual forest: per-tree weights
  ``𝓛(residual)^(1/α)`` (the parallel composition at the virtual root)
  and per-task ratios from :func:`repro_torch.core.pm.tree_pm_ratios`.  The
  resulting fractions order dispatch and size slot grants;
* ready fronts are grouped by padded shape class **across tenants**
  (continuous batching) and dispatched to workers as single vmapped
  front groups;
* a lost heartbeat is a Theorem-6 capacity event: the dead worker's
  in-flight batches are tombstoned and requeued, the survivors'
  capacity is recorded in an
  :class:`~repro_torch.runtime.elastic.ElasticController`, and the next
  re-share rescales shares while task *ratios* stay put (Lemma 4's
  invariance under p(t) — the paper's fault-tolerance story).

Numeric trees (problems that carry a matrix + symbolic factorization)
are executed with the exact kernel path of the plan executor
(:mod:`repro_torch.runtime.executor`): ``assemble_front_np`` folds
children **in tree order** regardless of completion order, in the
scheduler's ``dtype`` (``torch.float32`` or ``torch.float64``, given
explicitly); ``pad_front_np`` + ``batched_front_factor`` for fronts of
padded order ≤ ``VMEM_FRONT_MAX``, ``partial_cholesky`` for larger ones —
which is why cluster factors are bit-identical to single-process
execution no matter how batches are composed or which worker dies
mid-run (a front's bits depend on its assembly, not on its batch).  Only
numpy arrays go on the wire, and fronts go unpadded: the worker pads them
to their shape class (the executor's host padding) and moves them to and
from its device, so the wire encoding carries no padding (most fronts of
a 2-D grid are a small fraction of their 128-aligned class).

Threading model (dask-scheduler-like): one reader thread per
connection feeds a central inbox; one scheduler loop thread drains the
inbox, runs the failure detector, admits, re-shares, dispatches.  All
mutable state is touched only by the loop thread.  :meth:`ClusterScheduler.stop`
hangs up every connection the listener accepted, so a client whose
``hello`` was still unread when the scheduler died sees its stream close
(its futures resolve ``ok=False``) instead of waiting forever.
"""
from __future__ import annotations

import itertools
import math
import queue as _queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.api.problem import Problem
from repro_torch.cluster.comm import (
    Comm,
    CommClosedError,
    Listener,
    RetryPolicy,
    connect,
    listen,
)
from repro_torch.core.graph import TaskTree
from repro_torch.core.pm import tree_equivalent_lengths, tree_pm_ratios
from repro_torch.kernels.frontal_cholesky import VMEM_FRONT_MAX
from repro_torch.kernels.ops import padded_shape
from repro_torch.obs import events as obs_events
from repro_torch.obs import metrics as obs_metrics
from repro_torch.online.events import NoNoise
from repro_torch.online.queue import AdmissionQueue
from repro_torch.online.state import READY, RUNNING, RequestRecord, TreeRun
from repro_torch.runtime.elastic import ElasticController
from repro_torch.sparse.multifrontal import (
    Factorization,
    assemble_front_np,
    lower_csc,
)

_SCHED_SEQ = itertools.count(1)
# the fronts' host type for each dtype the kernels take
NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


# ----------------------------------------------------------------------
@dataclass
class _WorkerState:
    name: str
    comm: Comm
    slots: int
    last_seen: float
    alive: bool = True
    inflight: Dict[int, "_Batch"] = field(default_factory=dict)

    def free_slots(self) -> int:
        return self.slots - sum(b.slots for b in self.inflight.values())


@dataclass
class _Batch:
    batch_id: int
    worker: str
    items: List[Tuple[int, int]]  # (tree_id, task)
    slots: int
    t0: float
    tenants: List[int]


class _TreeEntry:
    """Scheduler-side state of one submitted tree."""

    def __init__(
        self,
        tree_id: int,
        problem: Problem,
        run: TreeRun,
        *,
        client: Optional[Comm],
        ckey: Optional[int],
        mem: float,
        dtype: np.dtype,
    ) -> None:
        self.tree_id = tree_id
        self.problem = problem
        self.run = run
        self.client = client
        self.ckey = ckey
        self.mem = mem
        self.dispatched: set = set()
        self.spans: Dict[int, Tuple[float, float, int]] = {}
        # numeric state (None for sim trees)
        self.numeric = (
            problem.symb is not None
            and problem.matrix is not None
            and len(problem.symb.supernodes) == problem.tree.n
        )
        self.acsc = None
        self.panels: Dict[int, np.ndarray] = {}
        self.updates: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self.dtype = dtype
        if self.numeric:
            self.acsc = lower_csc(problem.matrix)

    def shape_key(self, i: int) -> tuple:
        """The continuous-batching class of task ``i``: padded shape for
        fronts, a pow-2 duration bucket for simulated work."""
        if self.numeric:
            sn = self.problem.symb.supernodes[i]
            mp, nbp = padded_shape(sn.m, sn.nb)
            if mp > VMEM_FRONT_MAX:
                return ("large", self.tree_id, i)  # never shared
            return ("front", mp, nbp)
        length = max(float(self.problem.tree.lengths[i]), 1e-12)
        return ("sim", int(round(math.log2(length))))

    def assemble_raw(self, i: int) -> np.ndarray:
        """Assemble front ``i`` (children folded in tree order — the
        bit-identity invariant), unpadded, in the scheduler's dtype."""
        sn = self.problem.symb.supernodes[i]
        kid_updates = [self.updates[c] for c in self.run.children[i]]
        f = assemble_front_np(self.acsc, sn, kid_updates)
        return f.astype(self.dtype, copy=False)

    def store(self, i: int, panel: np.ndarray, schur: np.ndarray) -> None:
        sn = self.problem.symb.supernodes[i]
        self.panels[i] = np.asarray(panel)
        self.updates[i] = (sn.rows[sn.nb :], np.asarray(schur))

    def factorization(self) -> Factorization:
        return Factorization(
            symb=self.problem.symb,
            panels=[self.panels[i] for i in range(self.problem.tree.n)],
        )


# ----------------------------------------------------------------------
class ClusterScheduler:
    """The long-lived scheduler process (one per cluster).

    Parameters mirror :class:`~repro_torch.online.scheduler.OnlineScheduler`
    where they overlap; the extras are the cluster knobs:

    ``heartbeat_timeout``
        silence after which a worker is declared dead (Theorem-6
        capacity-down event).
    ``batching`` / ``max_batch``
        cross-tenant continuous batching of same-shape ready fronts
        into one vmapped dispatch (``False`` → one front per dispatch).
    ``work_rate``
        simulated work units per second at share 1 — only simulated
        (matrix-free) trees consume it.
    ``tick``
        scheduler loop granularity in seconds.
    ``dtype``
        the type numeric fronts are assembled and factored in
        (``torch.float32``, the executor's default, or ``torch.float64``).
        The workers' devices are theirs (:class:`~repro_torch.cluster.worker.Worker`).
    """

    def __init__(
        self,
        address: Optional[str] = None,
        *,
        alpha: Optional[float] = None,
        policy: str = "pm",
        admission: str = "fifo",
        max_concurrent: Optional[int] = None,
        qos_weights: Optional[Dict[int, float]] = None,
        memory_capacity: Optional[float] = None,
        heartbeat_timeout: float = 0.25,
        batching: bool = True,
        max_batch: int = 32,
        work_rate: float = 100.0,
        tick: float = 0.005,
        dtype: torch.dtype = torch.float32,
        name: Optional[str] = None,
    ) -> None:
        if policy not in ("pm", "proportional"):
            raise ValueError(f"unknown share policy {policy!r}")
        if dtype not in NP_DTYPE:
            raise TypeError(
                f"dtype must be torch.float32 or torch.float64, got {dtype}"
            )
        self.name = name or f"scheduler-{next(_SCHED_SEQ)}"
        self.alpha = alpha
        self.policy = policy
        self.queue = AdmissionQueue(admission, max_concurrent, qos_weights)
        self.memory_capacity = (
            float(memory_capacity) if memory_capacity else math.inf
        )
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.batching = bool(batching)
        self.max_batch = int(max_batch)
        self.work_rate = float(work_rate)
        self.tick = float(tick)
        self.dtype = dtype

        self._t0 = time.perf_counter()
        self.workers: Dict[str, _WorkerState] = {}
        self.trees: Dict[int, _TreeEntry] = {}
        self.admitted: set = set()
        self.records: List[RequestRecord] = []
        self.artifacts: Dict[int, object] = {}  # tree_id -> Factorization
        self.elastic = ElasticController(initial_devices=0)
        self.capacity_steps: List[Tuple[float, int]] = [(0.0, 0)]
        self.n_reshares = 0
        self.n_dispatches = 0
        self.n_requeued = 0
        self.n_worker_losses = 0
        self.batch_tenant_mix: List[int] = []  # distinct tenants per batch
        self._service_by_tenant: Dict[int, float] = {}
        self._prios: Dict[Tuple[int, int], Tuple[float, int]] = {}
        self._tree_seq = itertools.count(0)
        self._batch_seq = itertools.count(0)
        self.inflight: Dict[int, _Batch] = {}
        self._inbox: "_queue.Queue" = _queue.Queue()
        self._dirty = True
        self._stop = threading.Event()
        self._readers: List[threading.Thread] = []
        self._comms: List[Comm] = []  # every accepted connection
        self._client_comms: List[Comm] = []

        self.listener: Listener = listen(
            address or f"inproc://{self.name}", self._on_connect
        )
        self.address = self.listener.address
        self._thread = threading.Thread(
            target=self._loop, name=f"repro_torch-{self.name}", daemon=True
        )
        self._thread.start()

    # -- connection plumbing -------------------------------------------
    def _on_connect(self, comm: Comm) -> None:
        self._comms.append(comm)
        t = threading.Thread(
            target=self._reader,
            args=(comm,),
            name=f"repro_torch-{self.name}-reader",
            daemon=True,
        )
        self._readers.append(t)
        t.start()

    def _reader(self, comm: Comm) -> None:
        while not self._stop.is_set():
            try:
                msg = comm.recv(timeout=0.2)
            except CommClosedError:
                self._inbox.put((comm, None))
                return
            if msg is not None:
                self._inbox.put((comm, msg))

    def _now(self) -> float:
        return time.perf_counter() - self._t0

    # -- the scheduler loop --------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                comm, msg = self._inbox.get(timeout=self.tick)
                self._handle(comm, msg)
            except _queue.Empty:
                pass
            while True:  # drain without sleeping between messages
                try:
                    comm, msg = self._inbox.get_nowait()
                    self._handle(comm, msg)
                except _queue.Empty:
                    break
            self._check_heartbeats()
            progressed = self._autocomplete()
            self._admit()
            # the ready set and the free slots change only on an event
            # (each sets _dirty) or an autocompletion; a dispatch runs
            # until one of them is exhausted, so a pass without a change
            # would dispatch nothing and only rescan every admitted tree
            changed = self._dirty or progressed
            if self._dirty:
                self._reshare()
                self._dirty = False
            if changed:
                self._dispatch()

    # -- message handling ----------------------------------------------
    def _handle(self, comm: Comm, msg: Optional[dict]) -> None:
        if msg is None:  # connection closed
            for w in self.workers.values():
                if w.comm is comm and w.alive:
                    self._worker_lost(w, self._now(), reason="disconnect")
            for e in self.trees.values():
                if e.client is comm:
                    e.client = None
            return
        op = msg.get("op")
        if op == "register":
            self._on_register(comm, msg)
        elif op == "heartbeat":
            self._on_heartbeat(msg)
        elif op == "front-done":
            self._on_front_done(msg)
        elif op == "front-failed":
            self._on_front_failed(msg)
        elif op == "bye":
            self._on_bye(msg)
        elif op == "submit":
            self._on_submit(comm, msg)
        elif op == "stats":
            self._reply(comm, {"op": "stats-reply", "ckey": msg.get("ckey"),
                               "stats": self.stats()})
        elif op == "hello":
            # Client handshake: remember the comm so stop() can hang up
            # even if every submit is still sitting in the inbox.
            if comm is not None and comm not in self._client_comms:
                self._client_comms.append(comm)
        elif op == "stop":
            self._stop.set()

    @staticmethod
    def _reply(comm: Optional[Comm], msg: dict) -> None:
        if comm is None:
            return
        try:
            comm.send(msg)
        except CommClosedError:
            pass

    # -- workers --------------------------------------------------------
    def _on_register(self, comm: Comm, msg: dict) -> None:
        now = self._now()
        w = _WorkerState(
            name=msg["worker"], comm=comm, slots=int(msg["slots"]),
            last_seen=now,
        )
        self.workers[w.name] = w
        self._capacity_event(now)

    def _on_heartbeat(self, msg: dict) -> None:
        w = self.workers.get(msg["worker"])
        if w is None:
            return
        now = self._now()
        w.last_seen = now
        if not w.alive:  # late heartbeat: the node rejoined (p(t) steps up)
            w.alive = True
            self._capacity_event(now)

    def _on_bye(self, msg: dict) -> None:
        w = self.workers.pop(msg["worker"], None)
        if w is None:
            return
        now = self._now()
        for b in list(w.inflight.values()):
            self._requeue(b)
        if w.alive:
            self._capacity_event(now)

    def _check_heartbeats(self) -> None:
        now = self._now()
        for w in self.workers.values():
            if w.alive and now - w.last_seen > self.heartbeat_timeout:
                self._worker_lost(w, now, reason="heartbeat timeout")

    def _worker_lost(self, w: _WorkerState, now: float, *, reason: str) -> None:
        """Theorem-6 capacity-down event: tombstone + requeue + re-share."""
        w.alive = False
        self.n_worker_losses += 1
        for b in list(w.inflight.values()):
            self._requeue(b)
        self._capacity_event(now)
        if obs_events.enabled():
            obs_metrics.REGISTRY.counter(
                "repro_cluster_worker_loss_total",
                "workers declared dead by the heartbeat detector",
            ).inc(worker=w.name, reason=reason.replace(" ", "_"))

    def _requeue(self, b: _Batch) -> None:
        """running → ready for a tombstoned batch; late results for its
        batch id are ignored (it leaves ``inflight``)."""
        self.inflight.pop(b.batch_id, None)
        w = self.workers.get(b.worker)
        if w is not None:
            w.inflight.pop(b.batch_id, None)
        for tree_id, i in b.items:
            e = self.trees.get(tree_id)
            if e is None:
                continue
            ts = e.run.tasks[i]
            if ts.state == RUNNING:
                ts.state = READY
                ts.t_start = math.nan
            e.dispatched.discard(i)
            self.n_requeued += 1
        self._dirty = True

    def total_slots(self) -> int:
        return sum(w.slots for w in self.workers.values() if w.alive)

    def _capacity_event(self, now: float) -> None:
        slots = self.total_slots()
        self.elastic.capacity_change(now, slots)
        self.capacity_steps.append((now, slots))
        self._dirty = True
        if obs_events.enabled():
            obs_metrics.REGISTRY.gauge(
                "repro_cluster_slots", "live worker slots"
            ).set(slots)
            obs_events.BUS.point("cluster_capacity", slots, t=now)

    # -- submission & admission ----------------------------------------
    def _on_submit(self, comm: Optional[Comm], msg: dict) -> None:
        problem = msg["problem"]
        ckey = msg.get("ckey")
        rid = msg.get("rid")
        tenant = int(msg.get("tenant", 0))
        if not isinstance(problem, Problem):
            self._reply(comm, {"op": "refused", "ckey": ckey, "rid": rid,
                               "reason": "submit payload is not a Problem"})
            return
        if self.alpha is None:
            self.alpha = float(problem.alpha)  # late-bound from first tree
        if abs(problem.alpha - self.alpha) > 1e-12:
            self._reply(comm, {
                "op": "refused", "ckey": ckey, "rid": rid,
                "reason": f"alpha mismatch: cluster runs {self.alpha}, "
                          f"tree has {problem.alpha}",
            })
            return
        mem = problem.min_peak_memory()
        if mem > self.memory_capacity:
            self._reply(comm, {
                "op": "refused", "ckey": ckey, "rid": rid,
                "reason": f"minimal peak {mem:.3g} B exceeds cluster "
                          f"memory {self.memory_capacity:.3g} B",
            })
            return
        now = self._now()
        tree_id = next(self._tree_seq)
        run = TreeRun(
            tree_id, problem.tree, NoNoise(), now, rid=rid, tenant=tenant
        )
        self.trees[tree_id] = _TreeEntry(
            tree_id, problem, run, client=comm, ckey=ckey, mem=mem,
            dtype=np.dtype(NP_DTYPE[self.dtype]),
        )
        self.queue.push(tree_id, tenant, problem.eq_root, mem)
        self._reply(comm, {"op": "submitted", "ckey": ckey, "rid": rid,
                           "tree_id": tree_id})
        if obs_events.enabled():
            obs_metrics.REGISTRY.counter(
                "repro_cluster_requests_total",
                "trees submitted to the cluster, by tenant",
            ).inc(tenant=tenant)
        self._dirty = True

    def submit_local(
        self,
        problem: Problem,
        *,
        tenant: int = 0,
        rid: Optional[int] = None,
    ) -> None:
        """In-process submission (scheduler restart/restore path) — the
        result lands in :attr:`records`/:attr:`artifacts` only."""
        self._inbox.put(
            (None, {"op": "submit", "problem": problem, "tenant": tenant,
                    "rid": rid})
        )

    def _mem_free(self) -> float:
        used = sum(self.trees[t].mem for t in self.admitted)
        return self.memory_capacity - used

    def _admit(self) -> None:
        while self.queue.can_admit(len(self.admitted), self._mem_free()):
            try:
                p = self.queue.pop_next(
                    self._service_by_tenant, self._mem_free()
                )
            except IndexError:
                break
            now = self._now()
            self.admitted.add(p.tree_id)
            self.trees[p.tree_id].run.admit(now)
            self._dirty = True

    def _autocomplete(self) -> bool:
        """Zero-length / virtual tasks of simulated trees finish without a
        dispatch (numeric supernodes always run a kernel).  Returns whether
        any did."""
        progressed, any_done = True, False
        while progressed:
            progressed = False
            for tree_id in list(self.admitted):
                e = self.trees[tree_id]
                if e.numeric:
                    continue
                for i in list(e.run.active_tasks()):
                    if float(e.problem.tree.lengths[i]) <= 0.0:
                        now = self._now()
                        e.spans[i] = (now, now, 0)
                        e.run.mark_done(i, now)
                        progressed = True
                if e.run.complete():
                    self._finish_tree(e)
                    progressed = True
            any_done = any_done or progressed
        return any_done

    # -- the Lemma-4 re-share ------------------------------------------
    def _reshare(self) -> None:
        """PM split over the admitted residual forest (wall-clock Lemma 4):
        weights 𝓛^(1/α) at the virtual root, per-task ratios inside each
        tree.  Ratios are invariant under capacity changes (Lemma 4 /
        Theorem 6); only the slot grants rescale."""
        self._prios.clear()
        runs = [
            self.trees[t] for t in self.admitted
            if not self.trees[t].run.complete()
        ]
        if not runs or self.alpha is None:
            return
        self.n_reshares += 1
        inv = 1.0 / self.alpha
        weights, ratios_by = [], {}
        for e in runs:
            res = TaskTree(e.run.tree.parent, e.run.estimated_residual())
            if self.policy == "pm":
                eq = tree_equivalent_lengths(res, self.alpha)
                ratios_by[e.tree_id] = tree_pm_ratios(res, self.alpha)
                weights.append(float(eq[res.root]) ** inv)
            else:  # proportional: α-unaware subtree-weight split
                total = float(res.lengths.sum())
                r = res.lengths / total if total > 0 else res.lengths
                ratios_by[e.tree_id] = r
                weights.append(total)
        denom = sum(weights) or 1.0
        slots = max(self.total_slots(), 1)
        for e, w in zip(runs, weights):
            frac = w / denom
            ratios = ratios_by[e.tree_id]
            for i in e.run.active_tasks():
                pr = frac * float(ratios[i])
                want = max(1, int(round(pr * slots)))
                self._prios[(e.tree_id, i)] = (pr, want)
        if obs_events.enabled():
            obs_metrics.REGISTRY.counter(
                "repro_cluster_reshares_total", "Lemma-4 re-shares"
            ).inc()

    # -- dispatch (cross-tenant continuous batching) -------------------
    def _dispatch(self) -> None:
        ready = self._ready_pool()
        if not ready:
            return
        for w in self.workers.values():
            if not w.alive:
                continue
            while w.free_slots() > 0 and ready:
                key, group = self._take_group(ready, w.free_slots())
                if group is None:
                    break
                self._send_group(w, key, group)

    def _ready_pool(self) -> Dict[tuple, List[Tuple[float, int, int, int]]]:
        """shape key → [(priority, want, tree_id, task)] sorted desc."""
        pool: Dict[tuple, List[Tuple[float, int, int, int]]] = {}
        for tree_id in self.admitted:
            e = self.trees[tree_id]
            for i in e.run.active_tasks():
                ts = e.run.tasks[i]
                if ts.state != READY or i in e.dispatched:
                    continue
                pr, want = self._prios.get((tree_id, i), (0.0, 1))
                pool.setdefault(e.shape_key(i), []).append(
                    (pr, want, tree_id, i)
                )
        for group in pool.values():
            group.sort(key=lambda x: -x[0])
        return pool

    def _take_group(self, pool, free_slots):
        """Pop the highest-priority head and everything batchable with it."""
        best_key, best = None, None
        for key, group in pool.items():
            if group and (best is None or group[0][0] > best[0][0]):
                best_key, best = key, group
        if best is None:
            return None, None
        cap = self.max_batch if self.batching else 1
        taken = best[:cap]
        del best[:cap]
        if not best:
            del pool[best_key]
        head_want = taken[0][1]
        slots = max(1, min(head_want, free_slots))
        return best_key, (taken, slots)

    def _send_group(self, w: _WorkerState, key: tuple, group) -> None:
        taken, slots = group
        now = self._now()
        batch_id = next(self._batch_seq)
        items, msg_extra = [], {}
        kind = "sim"
        tenants = []
        for _, _, tree_id, i in taken:
            e = self.trees[tree_id]
            tenants.append(e.run.future.tenant)
            e.dispatched.add(i)
            e.run.start(i, now)
            if key[0] == "sim":
                dur = (
                    float(e.problem.tree.lengths[i])
                    / (slots ** self.alpha)
                    / self.work_rate
                )
                items.append({"tree": tree_id, "task": i, "duration": dur})
            else:
                sn = e.problem.symb.supernodes[i]
                items.append(
                    {"tree": tree_id, "task": i, "m": sn.m, "nb": sn.nb}
                )
        if key[0] == "front":
            kind = "batched"
            fronts = [self.trees[t].assemble_raw(i) for _, _, t, i in taken]
            msg_extra = {"fronts": fronts, "nbp": int(key[2])}
        elif key[0] == "large":
            kind = "large"
            (_, _, t, i) = taken[0]
            e = self.trees[t]
            msg_extra = {"front": e.assemble_raw(i)}
        batch = _Batch(batch_id, w.name, [(t, i) for _, _, t, i in taken],
                       slots, now, tenants)
        self.inflight[batch_id] = batch
        w.inflight[batch_id] = batch
        self.n_dispatches += 1
        self.batch_tenant_mix.append(len(set(tenants)))
        try:
            w.comm.send({"op": "dispatch", "batch": batch_id, "kind": kind,
                         "items": items, **msg_extra})
        except CommClosedError:
            self._worker_lost(w, now, reason="send failed")
            return
        if obs_events.enabled():
            obs_metrics.REGISTRY.counter(
                "repro_cluster_dispatches_total", "front groups dispatched"
            ).inc(kind=kind)
            obs_metrics.REGISTRY.histogram(
                "repro_cluster_batch_size", "fronts per dispatch"
            ).observe(len(items))

    # -- completion -----------------------------------------------------
    def _on_front_done(self, msg: dict) -> None:
        batch = self.inflight.pop(msg["batch"], None)
        if batch is None:
            return  # tombstoned: late result of a dead worker's batch
        w = self.workers.get(batch.worker)
        if w is not None:
            w.inflight.pop(batch.batch_id, None)
            w.last_seen = self._now()
        now = self._now()
        for res in msg["results"]:
            tree_id, i = int(res["tree"]), int(res["task"])
            e = self.trees.get(tree_id)
            if e is None or tree_id not in self.admitted:
                continue
            if e.numeric:
                e.store(i, res["panel"], res["schur"])
            e.spans[i] = (batch.t0, now, batch.slots)
            e.run.mark_done(i, now)
            if e.run.complete():
                self._finish_tree(e)
        self._dirty = True

    def _on_front_failed(self, msg: dict) -> None:
        batch = self.inflight.get(msg["batch"])
        if batch is None:
            return
        self._requeue(batch)

    def _finish_tree(self, e: _TreeEntry) -> None:
        now = self._now()
        e.run.finish(now)
        self.admitted.discard(e.tree_id)
        fut = e.run.future
        rec = RequestRecord(
            rid=fut.rid, tenant=fut.tenant, tree_id=e.tree_id,
            t_submit=fut.t_submit, t_admit=fut.t_admit, t_done=now,
        )
        self.records.append(rec)
        self._service_by_tenant[fut.tenant] = (
            self._service_by_tenant.get(fut.tenant, 0.0) + rec.exec_time
        )
        panels = None
        if e.numeric:
            fact = e.factorization()
            self.artifacts[e.tree_id] = fact
            panels = fact.panels
            e.updates.clear()
        self._reply(e.client, {
            "op": "tree-done", "ckey": e.ckey, "rid": fut.rid,
            "tree_id": e.tree_id, "tenant": fut.tenant, "ok": True,
            "t_submit": fut.t_submit, "t_admit": fut.t_admit, "t_done": now,
            "tasks": [
                {"task": i, "start": s, "end": t, "slots": k}
                for i, (s, t, k) in sorted(e.spans.items())
            ],
            "panels": panels,
        })
        if obs_events.enabled():
            obs_metrics.REGISTRY.histogram(
                "repro_serve_wait_seconds",
                "admission wait (submit → admit)", unit="s",
            ).observe(rec.wait, tenant=fut.tenant)
            obs_metrics.REGISTRY.histogram(
                "repro_serve_exec_seconds",
                "execution time (admit → done)", unit="s",
            ).observe(rec.exec_time, tenant=fut.tenant)
        self._dirty = True

    # -- lifecycle ------------------------------------------------------
    def stats(self) -> dict:
        lat = [r.latency for r in self.records]
        return {
            "name": self.name,
            "address": self.address,
            "alpha": self.alpha,
            "workers": {
                w.name: {"slots": w.slots, "alive": w.alive}
                for w in self.workers.values()
            },
            "total_slots": self.total_slots(),
            "n_pending": len(self.queue),
            "n_admitted": len(self.admitted),
            "n_done": len(self.records),
            "n_dispatches": self.n_dispatches,
            "n_reshares": self.n_reshares,
            "n_requeued": self.n_requeued,
            "n_worker_losses": self.n_worker_losses,
            "n_capacity_events": len(self.capacity_steps) - 1,
            "mean_latency": float(np.mean(lat)) if lat else 0.0,
        }

    def checkpoint(self) -> List[dict]:
        """Unfinished submissions, for restart/restore (satellite: a
        scheduler restart must not lose queued tenants)."""
        out = []
        for e in self.trees.values():
            if not e.run.future.done():
                out.append({
                    "problem": e.problem,
                    "tenant": e.run.future.tenant,
                    "rid": e.run.future.rid,
                })
        return out

    def restore(self, state: List[dict]) -> None:
        for s in state:
            self.submit_local(
                s["problem"], tenant=s["tenant"], rid=s.get("rid")
            )

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until no pending/admitted trees remain (True) or the
        timeout expires (False)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if not self.queue and not self.admitted and self._inbox.empty():
                return True
            time.sleep(self.tick)
        return False

    def stop(self, timeout: float = 5.0) -> None:
        """Deterministic shutdown: stop the loop, close every connection
        and the listener, join all threads."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._thread.join(timeout=timeout)
        for w in self.workers.values():
            try:
                w.comm.send({"op": "stop"})
            except CommClosedError:
                pass
            w.comm.close()
        for e in self.trees.values():
            if e.client is not None:
                e.client.close()
        for c in self._client_comms:
            c.close()
        # connections whose first message the loop never read (a client's
        # hello still in a reader or the inbox) are hung up too
        for c in self._comms:
            c.close()
        self.listener.close()
        for t in self._readers:
            t.join(timeout=timeout)

    def __repr__(self) -> str:
        return (
            f"<ClusterScheduler {self.name} @ {self.address} "
            f"workers={len(self.workers)} admitted={len(self.admitted)}>"
        )


# ----------------------------------------------------------------------
# Client side
# ----------------------------------------------------------------------
@dataclass
class TreeResult:
    """What a tenant gets back for one served tree."""

    rid: Optional[int]
    tenant: int
    tree_id: int
    ok: bool
    t_submit: float = math.nan
    t_admit: float = math.nan
    t_done: float = math.nan
    spans: List[dict] = field(default_factory=list)
    factor: Optional[object] = None  # Factorization for numeric trees
    error: Optional[str] = None

    @property
    def wait(self) -> float:
        return self.t_admit - self.t_submit

    @property
    def exec_time(self) -> float:
        return self.t_done - self.t_admit

    @property
    def latency(self) -> float:
        return self.t_done - self.t_submit


class ClusterFuture:
    def __init__(self, ckey: int, problem: Problem, tenant: int,
                 rid: Optional[int]) -> None:
        self.ckey = ckey
        self.problem = problem
        self.tenant = tenant
        self.rid = rid
        self._event = threading.Event()
        self._result: Optional[TreeResult] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> TreeResult:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"tree (rid={self.rid}, tenant={self.tenant}) not done "
                f"within {timeout}s"
            )
        return self._result

    def _resolve(self, result: TreeResult) -> None:
        self._result = result
        self._event.set()


class ClusterClient:
    """A tenant's connection to the scheduler."""

    def __init__(
        self,
        address: str,
        *,
        label: str = "client",
        retry: Optional[RetryPolicy] = None,
    ) -> None:
        self.comm = connect(address, label=label, retry=retry)
        self.comm.send({"op": "hello", "role": "client", "name": label})
        self._ckey = itertools.count(0)
        self._futures: Dict[int, ClusterFuture] = {}
        self._stats: "_queue.Queue" = _queue.Queue()
        self._closed = threading.Event()
        self._thread = threading.Thread(
            target=self._recv_loop,
            name=f"repro_torch-{label}-rx",
            daemon=True,
        )
        self._thread.start()

    def _recv_loop(self) -> None:
        while not self._closed.is_set():
            try:
                msg = self.comm.recv(timeout=0.2)
            except CommClosedError:
                for f in self._futures.values():
                    if not f.done():
                        f._resolve(TreeResult(
                            rid=f.rid, tenant=f.tenant, tree_id=-1,
                            ok=False, error="connection to scheduler lost",
                        ))
                return
            if msg is None:
                continue
            op = msg.get("op")
            if op in ("tree-done", "refused"):
                f = self._futures.get(msg.get("ckey"))
                if f is None:
                    continue
                if op == "refused":
                    f._resolve(TreeResult(
                        rid=f.rid, tenant=f.tenant, tree_id=-1, ok=False,
                        error=msg.get("reason", "refused"),
                    ))
                    continue
                factor = None
                if msg.get("panels") is not None:
                    factor = Factorization(
                        symb=f.problem.symb, panels=list(msg["panels"])
                    )
                f._resolve(TreeResult(
                    rid=f.rid, tenant=f.tenant, tree_id=int(msg["tree_id"]),
                    ok=True, t_submit=msg["t_submit"],
                    t_admit=msg["t_admit"], t_done=msg["t_done"],
                    spans=msg.get("tasks", []), factor=factor,
                ))
            elif op == "stats-reply":
                self._stats.put(msg["stats"])

    def submit(
        self,
        problem: Problem,
        *,
        tenant: int = 0,
        rid: Optional[int] = None,
    ) -> ClusterFuture:
        ckey = next(self._ckey)
        fut = ClusterFuture(ckey, problem, tenant, rid)
        self._futures[ckey] = fut
        self.comm.send({"op": "submit", "ckey": ckey, "rid": rid,
                        "tenant": tenant, "problem": problem})
        return fut

    def gather(
        self, futures: List[ClusterFuture], timeout: float = 60.0
    ) -> List[TreeResult]:
        deadline = time.monotonic() + timeout
        return [
            f.result(timeout=max(0.0, deadline - time.monotonic()))
            for f in futures
        ]

    def stats(self, timeout: float = 5.0) -> dict:
        self.comm.send({"op": "stats"})
        return self._stats.get(timeout=timeout)

    def close(self) -> None:
        if self._closed.is_set():
            return
        self._closed.set()
        self.comm.close()
        self._thread.join(timeout=5.0)


__all__ = [
    "ClusterClient",
    "ClusterFuture",
    "ClusterScheduler",
    "TreeResult",
]
