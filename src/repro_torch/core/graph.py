"""Series-parallel graph IR for malleable-task scheduling.

The paper (RR-8616) schedules in-trees of malleable tasks by viewing them as
series-parallel (SP) graphs: a tree node ``T`` with children subtrees
``C_1..C_k`` is the series composition ``(C_1 || ... || C_k) ; T`` (Figure 7,
"pseudo-tree").  The §7 aggregation transform produces graphs that are no
longer trees, so the IR is a general SP graph with n-ary compositions.

All traversals are iterative (explicit stacks): the paper's simulation data
set has trees with up to 1e6 nodes and depth 75k, far past Python's recursion
limit.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Union

import numpy as np

TASK = "task"
SERIES = "series"
PARALLEL = "parallel"

_fresh_id = itertools.count()


@dataclass
class SPNode:
    """One node of an SP graph.

    ``kind`` is one of TASK/SERIES/PARALLEL.  TASK nodes carry ``length``
    (sequential processing time ``L_i``) and an optional user ``label``
    (e.g. the original tree-node id).  SERIES children are ordered
    first-executed-first.
    """

    kind: str
    length: float = 0.0
    children: List["SPNode"] = field(default_factory=list)
    label: Optional[int] = None
    uid: int = field(default_factory=lambda: next(_fresh_id))

    # ------------------------------------------------------------------
    def __repr__(self) -> str:  # compact, non-recursive
        if self.kind == TASK:
            return f"Task(L={self.length:g}, label={self.label})"
        return f"{self.kind.capitalize()}(n={len(self.children)})"

    def iter_postorder(self) -> Iterator["SPNode"]:
        """Iterative post-order traversal."""
        stack: List[tuple] = [(self, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded or node.kind == TASK:
                yield node
            else:
                stack.append((node, True))
                for c in reversed(node.children):
                    stack.append((c, False))

    def iter_tasks(self) -> Iterator["SPNode"]:
        for n in self.iter_postorder():
            if n.kind == TASK:
                yield n

    def n_tasks(self) -> int:
        return sum(1 for _ in self.iter_tasks())

    def total_length(self) -> float:
        """Sum of task lengths (the paper's Σ L_i, DIVISIBLE's work)."""
        return float(sum(t.length for t in self.iter_tasks()))


def task(length: float, label: Optional[int] = None) -> SPNode:
    return SPNode(TASK, length=float(length), label=label)


def series(*children: Union[SPNode, Sequence[SPNode]]) -> SPNode:
    flat = _flatten(children)
    if len(flat) == 1:
        return flat[0]
    return SPNode(SERIES, children=flat)


def parallel(*children: Union[SPNode, Sequence[SPNode]]) -> SPNode:
    flat = _flatten(children)
    if len(flat) == 1:
        return flat[0]
    return SPNode(PARALLEL, children=flat)


def _flatten(children) -> List[SPNode]:
    out: List[SPNode] = []
    for c in children:
        if isinstance(c, SPNode):
            out.append(c)
        else:
            out.extend(c)
    if not out:
        raise ValueError("composition needs at least one child")
    return out


# ----------------------------------------------------------------------
# In-tree representation (flat arrays) and conversion to SP graphs.
# ----------------------------------------------------------------------
@dataclass
class TaskTree:
    """In-tree of tasks in flat-array form.

    ``parent[i]`` is the parent index of task ``i`` (-1 for the root);
    ``lengths[i]`` is ``L_i``.  This is the natural output of symbolic
    multifrontal analysis (one task per front) and the input of the §7
    simulations.

    ``labels[i]`` maps local indices to stable user-facing task ids; virtual
    nodes (zero-length roots introduced by forest wrappers or the two-node
    recursion) carry label -1.  Defaults to identity.
    """

    parent: np.ndarray  # int array, parent[root] == -1
    lengths: np.ndarray  # float array
    labels: Optional[np.ndarray] = None

    def __post_init__(self):
        self.parent = np.asarray(self.parent, dtype=np.int64)
        self.lengths = np.asarray(self.lengths, dtype=np.float64)
        if self.parent.shape != self.lengths.shape:
            raise ValueError("parent/lengths shape mismatch")
        if self.labels is None:
            self.labels = np.arange(self.parent.shape[0], dtype=np.int64)
        else:
            self.labels = np.asarray(self.labels, dtype=np.int64)
        roots = np.flatnonzero(self.parent < 0)
        if len(roots) != 1:
            raise ValueError(f"expected exactly one root, got {len(roots)}")
        self.root = int(roots[0])

    @property
    def n(self) -> int:
        return int(self.parent.shape[0])

    def children_lists(self) -> List[List[int]]:
        ch: List[List[int]] = [[] for _ in range(self.n)]
        for i, p in enumerate(self.parent):
            if p >= 0:
                ch[int(p)].append(i)
        return ch

    def topo_order(self) -> np.ndarray:
        """Indices ordered so children precede parents (post-order)."""
        ch = self.children_lists()
        order = np.empty(self.n, dtype=np.int64)
        k = 0
        stack: List[tuple] = [(self.root, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                order[k] = node
                k += 1
            else:
                stack.append((node, True))
                for c in reversed(ch[node]):
                    stack.append((c, False))
        assert k == self.n
        return order

    def depth(self) -> int:
        ch = self.children_lists()
        best = 0
        stack = [(self.root, 1)]
        while stack:
            node, d = stack.pop()
            best = max(best, d)
            for c in ch[node]:
                stack.append((c, d + 1))
        return best

    def to_sp(self) -> SPNode:
        """Tree → pseudo-tree SP graph (paper Figure 7).

        node i with children c1..ck  ==>  series(parallel(sp(c1)..sp(ck)), T_i)
        """
        ch = self.children_lists()
        built: List[Optional[SPNode]] = [None] * self.n
        for i in self.topo_order():
            t = task(self.lengths[i], label=int(self.labels[i]))
            if ch[i]:
                kids = [built[c] for c in ch[i]]
                par = kids[0] if len(kids) == 1 else SPNode(PARALLEL, children=kids)  # type: ignore[arg-type]
                built[i] = SPNode(SERIES, children=[par, t])
            else:
                built[i] = t
        root = built[self.root]
        assert root is not None
        return root


def forest_to_sp(trees: Sequence[SPNode]) -> SPNode:
    """Parallel composition of independent subgraphs (a forest)."""
    return parallel(list(trees))


def independent_tasks(lengths: Sequence[float]) -> SPNode:
    """n independent tasks == depth-1 parallel composition (§6 instances)."""
    return parallel([task(L, label=i) for i, L in enumerate(lengths)])
