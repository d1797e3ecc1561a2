"""§7 aggregation: eliminate sub-unit processor allocations.

The p^α law is superlinear for p < 1, so the paper modifies each tree until
the PM schedule allocates ≥ 1 processor to every task: whenever the subtree
of a node u would receive less than one processor, that subtree is removed
from the parallel composition and executed *serially, right before u, on u's
whole share* (Figure 15).  The result is an SP graph (no longer a tree).

This transform is also the bridge to TPU meshes: replace the threshold 1 by
``min_share`` = one chip (or one 2×2 sub-mesh, …) to guarantee that every
task's share discretizes to at least one whole device group.
"""
from __future__ import annotations

from typing import Dict, List

from .graph import PARALLEL, SERIES, TASK, SPNode
from .pm import equivalent_lengths


def aggregate(g: SPNode, alpha: float, p: float, min_share: float = 1.0) -> SPNode:
    """Iterate the §7 transform until every task gets ≥ min_share processors
    under the PM schedule on a constant profile p.

    One pass: top-down share propagation (root share = p).  At a parallel
    composition with share s, children get s·π_i.  Any child whose share
    drops below ``min_share`` while the *parent composition's* share is at
    least min_share is pulled out of the composition and appended serially
    (executed on the full share s just before whatever follows).  If the
    composition's own share is already < min_share, the ancestors' pass will
    have handled it (whole-subtree aggregation happens at the highest
    offending level, as in the paper's iterative description).
    """
    guard = 0
    while True:
        guard += 1
        if guard > 10_000:
            raise RuntimeError("aggregation did not converge")
        g, changed = _one_pass(g, alpha, p, min_share)
        if not changed:
            return g


def _one_pass(g: SPNode, alpha: float, p: float, min_share: float):
    eq = equivalent_lengths(g, alpha)
    inv = 1.0 / alpha
    changed = False

    # Rebuild bottom-up with knowledge of the share each node receives.
    # Shares depend on structure above, so compute them first (top-down),
    # then rebuild (bottom-up).
    share: Dict[int, float] = {g.uid: p}
    stack: List[SPNode] = [g]
    while stack:
        node = stack.pop()
        s = share[node.uid]
        if node.kind == SERIES:
            for c in node.children:
                share[c.uid] = s
                stack.append(c)
        elif node.kind == PARALLEL:
            denom = sum(eq[c.uid] ** inv for c in node.children)
            for c in node.children:
                share[c.uid] = s * (eq[c.uid] ** inv) / denom if denom > 0 else 0.0
                stack.append(c)

    rebuilt: Dict[int, SPNode] = {}
    for node in g.iter_postorder():
        if node.kind == TASK:
            rebuilt[node.uid] = node
        elif node.kind == SERIES:
            rebuilt[node.uid] = SPNode(
                SERIES, children=[rebuilt[c.uid] for c in node.children]
            )
        else:  # PARALLEL
            s = share[node.uid]
            keep: List[SPNode] = []
            pulled: List[SPNode] = []
            for c in node.children:
                if share[c.uid] < min_share - 1e-12 and s >= min_share - 1e-12:
                    pulled.append(rebuilt[c.uid])
                else:
                    keep.append(rebuilt[c.uid])
            if pulled and keep:
                changed = True
                par = keep[0] if len(keep) == 1 else SPNode(PARALLEL, children=keep)
                # pulled subtrees run serially on the full share s, right
                # before what follows the composition (Figure 15).
                rebuilt[node.uid] = SPNode(SERIES, children=[par] + pulled)
            elif pulled and not keep:
                # every child under-allocated: serialize them all
                changed = True
                rebuilt[node.uid] = (
                    pulled[0] if len(pulled) == 1 else SPNode(SERIES, children=pulled)
                )
            else:
                rebuilt[node.uid] = SPNode(PARALLEL, children=keep)
    return rebuilt[g.uid], changed


def min_task_share(g: SPNode, alpha: float, p: float) -> float:
    """Smallest share any positive-length task receives under PM on p."""
    from .pm import pm_schedule

    sched = pm_schedule(g, alpha)
    shares = [
        iv.ratio * p for iv in sched.intervals if iv.length > 0
    ]
    return min(shares) if shares else p
