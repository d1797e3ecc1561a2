"""Malleable-DAG IR and tree-ification for model workloads.

The paper schedules *in-trees* of malleable tasks (children complete
before the parent; Figure 7 views the tree as a series-parallel graph).
Real model computation graphs are DAGs of ops.  This module is the
bridge: a tiny op-level IR (:class:`Op` / :class:`OpGraph`) plus
:func:`treeify`, which compiles the DAG into a
:class:`~repro_torch.core.graph.TaskTree` the whole existing stack (policies,
online scheduler, executor, cluster) schedules unchanged.

Tree-ification applies two work-conserving rewrites:

* **series contraction** — a dataflow edge ``u → v`` where ``v`` is
  ``u``'s only consumer and ``u`` is ``v``'s only producer fuses into
  one task (costs sum).  Ops carry an optional ``group`` tag (pipeline
  stage id): ops in *different* groups never fuse, so a pipeline chain
  contracts to exactly its stages instead of one monolithic task.
* **fan-out relaxation** — a producer with several consumers cannot be
  expressed in an in-tree (it would need several parents).  The first
  consumer (in deterministic topo order) becomes the tree parent and
  the remaining precedence edges are *dropped and recorded* in
  ``relaxed_edges``.  Work is conserved exactly; only the dropped
  orderings are a relaxation of true dataflow, and the zoo builders
  keep fan-out sources cheap (routers, broadcasts) so the relaxation is
  immaterial.

Several sinks (a serving pod's independent models) are joined under a
zero-cost virtual root — the forest-of-sibling-subtrees shape the MoE
dispatch and multi-model pods map to naturally.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import TaskTree


@dataclass(frozen=True)
class Op:
    """One model operation (or fused region) of the workload DAG.

    Costs are platform-independent: ``flops`` (useful floating-point
    work), ``bytes`` (HBM traffic), ``param_bytes`` (persistent weights
    the op reads), ``out_bytes`` (activation handed to consumers).  A
    :class:`~repro_torch.workloads.costs.Calibration` turns them into task
    lengths (seconds) and memory footprints.
    """

    name: str
    flops: float = 0.0
    bytes: float = 0.0
    param_bytes: float = 0.0
    out_bytes: float = 0.0
    deps: Tuple[str, ...] = ()
    group: Optional[str] = None  # contraction group (e.g. pipeline stage)

    def __post_init__(self) -> None:
        for f in ("flops", "bytes", "param_bytes", "out_bytes"):
            if getattr(self, f) < 0:
                raise ValueError(f"{self.name}: {f} must be non-negative")
        object.__setattr__(self, "deps", tuple(self.deps))


class OpGraph:
    """A validated DAG of :class:`Op`\\ s (dataflow edges dep → op)."""

    def __init__(self, ops: Sequence[Op]) -> None:
        self.ops: List[Op] = list(ops)
        if not self.ops:
            raise ValueError("an OpGraph needs at least one op")
        self.by_name: Dict[str, Op] = {}
        for op in self.ops:
            if op.name in self.by_name:
                raise ValueError(f"duplicate op name {op.name!r}")
            self.by_name[op.name] = op
        for op in self.ops:
            for d in op.deps:
                if d not in self.by_name:
                    raise ValueError(
                        f"op {op.name!r} depends on unknown op {d!r}"
                    )
        self._topo = self._toposort()

    def _toposort(self) -> List[str]:
        """Kahn's algorithm in insertion order; raises on cycles."""
        indeg = {op.name: len(set(op.deps)) for op in self.ops}
        consumers = self.consumers()
        ready = [op.name for op in self.ops if indeg[op.name] == 0]
        order: List[str] = []
        while ready:
            u = ready.pop(0)
            order.append(u)
            for v in consumers[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        if len(order) != len(self.ops):
            raise ValueError("op graph has a cycle")
        return order

    def topo_order(self) -> List[str]:
        return list(self._topo)

    def consumers(self) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {op.name: [] for op in self.ops}
        for op in self.ops:
            for d in set(op.deps):
                out[d].append(op.name)
        return out

    @property
    def n_ops(self) -> int:
        return len(self.ops)

    def total_flops(self) -> float:
        return float(sum(op.flops for op in self.ops))

    def __repr__(self) -> str:
        return f"OpGraph(n_ops={self.n_ops}, flops={self.total_flops():.3g})"


@dataclass
class Treeified:
    """The task-level view :func:`treeify` produces.

    ``tree`` holds *flops* as lengths (work units); the cost model
    rescales them into seconds per platform (``with_lengths``).
    ``op_map[i]`` lists the op names fused into task ``i`` (empty for
    the virtual root), ``relaxed_edges`` the dropped fan-out
    precedences as ``(producer_op, consumer_op)`` pairs.
    """

    tree: TaskTree
    op_map: List[List[str]]
    relaxed_edges: List[Tuple[str, str]]
    flops: np.ndarray
    bytes: np.ndarray
    param_bytes: np.ndarray
    out_bytes: np.ndarray

    @property
    def n_tasks(self) -> int:
        return self.tree.n

    def with_lengths(self, lengths: np.ndarray) -> TaskTree:
        """Same structure, per-task lengths in the caller's units."""
        lengths = np.asarray(lengths, dtype=np.float64)
        if lengths.shape != (self.tree.n,):
            raise ValueError(
                f"expected {self.tree.n} lengths, got {lengths.shape}"
            )
        return TaskTree(
            parent=self.tree.parent.copy(),
            lengths=lengths,
            labels=self.tree.labels.copy(),
        )

    def meta(self) -> Dict:
        """JSON-serializable op-provenance block (rides Problem → Schedule)."""
        return {
            "op_map": {str(i): ops for i, ops in enumerate(self.op_map)},
            "relaxed_edges": [list(e) for e in self.relaxed_edges],
            "n_ops": int(sum(len(ops) for ops in self.op_map)),
        }


def _contract(graph: OpGraph) -> Tuple[List[List[str]], Dict[str, int]]:
    """Series contraction: maximal single-in/single-out chains within a
    compatible group fuse into one task.  Returns the op partition (in
    topo order of their first op) and the op → task index map."""
    consumers = graph.consumers()
    producers: Dict[str, List[str]] = {op.name: [] for op in graph.ops}
    for op in graph.ops:
        for d in set(op.deps):
            producers[op.name].append(d)

    task_of: Dict[str, int] = {}
    members: List[List[str]] = []
    task_group: List[Optional[str]] = []
    for name in graph.topo_order():
        op = graph.by_name[name]
        prods = producers[name]
        if len(prods) == 1 and len(consumers[prods[0]]) == 1:
            t = task_of[prods[0]]
            g = task_group[t]
            if g is None or op.group is None or g == op.group:
                task_of[name] = t
                members[t].append(name)
                if g is None:
                    task_group[t] = op.group
                continue
        task_of[name] = len(members)
        members.append([name])
        task_group.append(op.group)
    return members, task_of


def treeify(graph: OpGraph) -> Treeified:
    """Compile the op DAG into an in-tree of malleable tasks."""
    members, task_of = _contract(graph)
    n = len(members)
    consumers = graph.consumers()

    # task-level consumer edges (dedup'd, excluding intra-task edges)
    task_consumers: List[List[int]] = [[] for _ in range(n)]
    edge_ops: Dict[Tuple[int, int], Tuple[str, str]] = {}
    for op in graph.ops:
        for d in set(op.deps):
            tu, tv = task_of[d], task_of[op.name]
            if tu == tv:
                continue
            if tv not in task_consumers[tu]:
                task_consumers[tu].append(tv)
                edge_ops[(tu, tv)] = (d, op.name)

    # in-tree: parent = first consumer task; extra consumer edges relax
    parent = np.full(n, -1, dtype=np.int64)
    relaxed: List[Tuple[str, str]] = []
    sinks: List[int] = []
    for t in range(n):
        cons = sorted(task_consumers[t])
        if not cons:
            sinks.append(t)
            continue
        parent[t] = cons[0]
        for extra in cons[1:]:
            relaxed.append(edge_ops[(t, extra)])

    op_map = [list(m) for m in members]
    if len(sinks) > 1:  # forest → virtual root (a serving pod's join)
        parent = np.concatenate([parent, [-1]])
        for s in sinks:
            parent[s] = n
        op_map.append([])
        n += 1

    def fold(attr: str) -> np.ndarray:
        out = np.zeros(n)
        for i, ops in enumerate(op_map):
            out[i] = sum(getattr(graph.by_name[o], attr) for o in ops)
        return out

    # a task's handoff is its *sink* ops' output (ops whose consumers
    # all lie outside the task) — intra-chain activations are transient,
    # not part of the contribution block
    out_bytes = np.zeros(n)
    for i, ops in enumerate(op_map):
        mine = set(ops)
        out_bytes[i] = sum(
            graph.by_name[o].out_bytes
            for o in ops
            if not any(c in mine for c in consumers[o])
        )

    flops = fold("flops")
    tree = TaskTree(parent=parent, lengths=flops)
    return Treeified(
        tree=tree,
        op_map=op_map,
        relaxed_edges=relaxed,
        flops=flops,
        bytes=fold("bytes"),
        param_bytes=fold("param_bytes"),
        out_bytes=out_bytes,
    )


__all__ = ["Op", "OpGraph", "Treeified", "treeify"]
