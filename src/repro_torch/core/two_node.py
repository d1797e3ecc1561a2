"""Two homogeneous multicore nodes (§6.1).

Constraint 𝓡: a task may use processors of only one node.  The decision
problem is weakly NP-complete (Theorem 7, reduction from PARTITION with
``L_i = a_i^α``); Algorithm 11 (HomogeneousApp) is a polynomial
(4/3)^α-approximation for trees, implemented here on the flat
:class:`TaskTree` form (pseudo-trees are closed under every operation the
algorithm performs, so trees with fractional task lengths and virtual
zero-length roots suffice — no general SP machinery needed).

Fluid vs strict: the paper's schedule S_u lets the part ``B_u`` of B executed
beside c₁ "contain fractions of tasks"; a straddling task would then run on
one node in the recursive phase and another in the last phase, which violates
𝓡 for that physical task.  ``snap=True`` (default) rounds the B̄/B split to
task boundaries (straddlers go wholly to the *late* phase on the same node),
keeping 𝓡 strict at the cost of a possibly slightly longer last phase;
``snap=False`` reproduces the paper's fluid analysis exactly (used by the
tests to check the proof's invariants, e.g. M ≤ (4/3)^α · M_p).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .graph import TaskTree
from .pm import tree_equivalent_lengths


# ----------------------------------------------------------------------
# Small tree helpers (forest wrapping, sub-forest extraction, splitting)
# ----------------------------------------------------------------------
def forest_tree(
    roots_parents: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]]
) -> TaskTree:
    """Join sub-trees under a fresh zero-length virtual root (label -1).

    Each element is (parent, lengths, labels) of one sub-tree.
    """
    parents = [np.array([-1])]
    lengths = [np.array([0.0])]
    labels = [np.array([-1])]
    offset = 1
    for par, lng, lab in roots_parents:
        par = par.copy()
        par[par < 0] = -offset  # temporary marker for "attach to virtual root"
        par = np.where(par == -offset, 0, par + offset)
        parents.append(par)
        lengths.append(lng)
        labels.append(lab)
        offset += len(par)
    return TaskTree(
        parent=np.concatenate(parents),
        lengths=np.concatenate(lengths),
        labels=np.concatenate(labels),
    )


def extract_subtree(tree: TaskTree, root: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(parent, lengths, labels) of the subtree rooted at ``root``."""
    ch = tree.children_lists()
    nodes: List[int] = []
    stack = [root]
    while stack:
        i = stack.pop()
        nodes.append(i)
        stack.extend(ch[i])
    index = {old: new for new, old in enumerate(nodes)}
    par = np.array(
        [index[int(tree.parent[i])] if i != root else -1 for i in nodes],
        dtype=np.int64,
    )
    return par, tree.lengths[np.array(nodes)], tree.labels[np.array(nodes)]


def subtree_of(tree: TaskTree, root: int) -> TaskTree:
    par, lng, lab = extract_subtree(tree, root)
    return TaskTree(parent=par, lengths=lng, labels=lab)


def split_tree(
    tree: TaskTree, suffix_eq: float, alpha: float, snap: bool = True
) -> Tuple[Optional[TaskTree], Optional[TaskTree]]:
    """Split a (pseudo-)tree into (prefix, suffix) at equivalent-length
    ``suffix_eq`` from the end, following the PM execution order (cf.
    pm.cut_suffix): a parallel composition splits proportionally
    (identical work fractions, Lemma 5); the root task is consumed last.

    With ``snap`` a task cut mid-way goes wholly to the *suffix*.
    Returns TaskTree or None for empty sides.
    """
    eq = tree_equivalent_lengths(tree, alpha)
    if suffix_eq <= 1e-15:
        return tree, None
    if suffix_eq >= eq[tree.root] - 1e-12:
        return None, tree

    ch = tree.children_lists()
    # out arrays built incrementally
    pre_parent: List[int] = []
    pre_len: List[float] = []
    pre_lab: List[int] = []
    suf_parent: List[int] = []
    suf_len: List[float] = []
    suf_lab: List[int] = []

    def new_node(side_parent, side_len, side_lab, parent, length, label) -> int:
        side_parent.append(parent)
        side_len.append(length)
        side_lab.append(label)
        return len(side_parent) - 1

    # Work-list: (node, remaining_suffix_eq, suf_parent_idx).  A node whose
    # subtree is wholly in the suffix is copied there; wholly in prefix:
    # copied to prefix under pre_parent_idx.
    def copy_whole(i: int, side: str, parent_idx: int) -> None:
        stack = [(i, parent_idx)]
        tgt = (pre_parent, pre_len, pre_lab) if side == "pre" else (
            suf_parent,
            suf_len,
            suf_lab,
        )
        while stack:
            j, pidx = stack.pop()
            nid = new_node(*tgt, pidx, float(tree.lengths[j]), int(tree.labels[j]))
            for c in ch[j]:
                stack.append((c, nid))

    # virtual roots for both sides
    pre_root = new_node(pre_parent, pre_len, pre_lab, -1, 0.0, -1)
    suf_root = new_node(suf_parent, suf_len, suf_lab, -1, 0.0, -1)

    stack: List[Tuple[int, float, int, int]] = [
        (tree.root, suffix_eq, suf_root, pre_root)
    ]
    while stack:
        i, rem, suf_pidx, pre_pidx = stack.pop()
        L = float(tree.lengths[i])
        if rem >= eq[i] - 1e-12:
            copy_whole(i, "suf", suf_pidx)
            continue
        if rem <= 1e-15:
            copy_whole(i, "pre", pre_pidx)
            continue
        if rem < L - 1e-15:
            # cut inside the root task of this subtree
            if snap:
                # whole task to the suffix; children to prefix
                new_node(suf_parent, suf_len, suf_lab, suf_pidx, L, int(tree.labels[i]))
                for c in ch[i]:
                    copy_whole(c, "pre", pre_pidx)
            else:
                new_node(
                    suf_parent, suf_len, suf_lab, suf_pidx, rem, int(tree.labels[i])
                )
                pid = new_node(
                    pre_parent, pre_len, pre_lab, pre_pidx, L - rem, int(tree.labels[i])
                )
                for c in ch[i]:
                    copy_whole(c, "pre", pid)
            continue
        # task i fully in suffix; split children composition
        sid = new_node(suf_parent, suf_len, suf_lab, suf_pidx, L, int(tree.labels[i]))
        rem_children = rem - L
        kids = ch[i]
        eq_par = sum(eq[c] ** (1.0 / alpha) for c in kids) ** alpha
        if eq_par <= 0:
            continue
        frac = rem_children / eq_par
        for c in kids:
            stack.append((c, eq[c] * frac, sid, pre_pidx))

    def finalize(par, lng, lab) -> Optional[TaskTree]:
        if len(par) <= 1:  # only virtual root
            return None
        t = TaskTree(
            parent=np.array(par, dtype=np.int64),
            lengths=np.array(lng, dtype=np.float64),
            labels=np.array(lab, dtype=np.int64),
        )
        if t.lengths.sum() <= 1e-15:
            return None
        return t

    return finalize(pre_parent, pre_len, pre_lab), finalize(
        suf_parent, suf_len, suf_lab
    )


# ----------------------------------------------------------------------
# Algorithm 11
# ----------------------------------------------------------------------
@dataclass
class TwoNodeResult:
    makespan: float
    placement: Dict[int, int] = field(default_factory=dict)  # label -> node id
    # diagnostics
    m_pm_2p: float = 0.0  # PM lower bound 𝓛_G/(2p)^α
    m_p_lb: float = 0.0  # Lemma 15 lower bound where computed (else m_pm_2p)
    case_trace: List[str] = field(default_factory=list)


def homogeneous_two_node(
    tree: TaskTree, alpha: float, p: float, snap: bool = True
) -> TwoNodeResult:
    """HomogeneousApp (Algorithm 11): (4/3)^α-approximation on two nodes of p
    processors each."""
    eq_all = tree_equivalent_lengths(tree, alpha)
    res = _homogeneous_rec(tree, alpha, p, snap, depth=0)
    res.m_pm_2p = eq_all[tree.root] / (2 * p) ** alpha
    return res


def _place_all(tree: TaskTree, node: int, placement: Dict[int, int]) -> None:
    for lbl in tree.labels:
        if lbl >= 0:
            placement[int(lbl)] = node


def _homogeneous_rec(
    tree: TaskTree, alpha: float, p: float, snap: bool, depth: int
) -> TwoNodeResult:
    if depth > 10_000:
        raise RuntimeError("two-node recursion too deep")
    eq = tree_equivalent_lengths(tree, alpha)
    ch = tree.children_lists()
    inv = 1.0 / alpha

    # ---- Lemma 9 normalization: strip the root chain -------------------
    chain: List[int] = []
    r = tree.root
    while len(ch[r]) == 1:
        chain.append(r)
        r = ch[r][0]
    if len(ch[r]) == 0:
        # the whole tree is a chain: everything sequential on one node
        res = TwoNodeResult(makespan=float(tree.lengths.sum()) / p**alpha)
        _place_all(tree, 0, res.placement)
        res.case_trace.append("chain")
        return res
    chain_len = float(sum(tree.lengths[c] for c in chain))
    if tree.lengths[r] > 0:
        chain.append(r)
        chain_len += float(tree.lengths[r])
    chain_time = chain_len / p**alpha
    # equivalent length of the normalized graph G̃ (root chain stripped)
    eq_stripped = eq[r] - float(tree.lengths[r])

    # children subtrees of the (virtual) root, largest equivalent length first
    kids = sorted(ch[r], key=lambda c: -eq[c])
    sigma = sum(eq[c] ** inv for c in kids)
    x = 2.0 * eq[kids[0]] ** inv / sigma

    res = TwoNodeResult(makespan=0.0)
    for c in chain:
        if tree.labels[c] >= 0:
            res.placement[int(tree.labels[c])] = 0

    c1 = kids[0]
    c1_children = ch[c1]

    if x >= 1.0 and len(c1_children) == 0:
        # c₁ is a leaf: shrink its share to p — optimal (proof of Thm 8)
        m_c1 = float(tree.lengths[c1]) / p**alpha
        rest = [eq[c] ** inv for c in kids[1:]]
        share_rest = (2.0 - x) * p
        m_rest = (
            (sum(rest) ** alpha) / share_rest**alpha
            if sum(rest) > 0 and share_rest > 0
            else 0.0
        )
        res.makespan = max(m_c1, m_rest) + chain_time
        res.m_p_lb = max(m_c1, eq_stripped / (2 * p) ** alpha) + chain_time
        res.placement[int(tree.labels[c1])] = 0
        for c in kids[1:]:
            _place_all(subtree_of(tree, c), 1, res.placement)
        res.case_trace.append("x>=1,leaf")
        return res

    if x <= 1.0:
        # Lemma 10: 3-bin greedy partition of PM shares, largest bin alone
        shares = [2.0 * p * eq[c] ** inv / sigma for c in kids]
        bins: List[List[int]] = [[], [], []]
        bin_load = [0.0, 0.0, 0.0]
        for idx, c in enumerate(kids):  # kids already sorted desc
            b = int(np.argmin(bin_load))
            bins[b].append(c)
            bin_load[b] += shares[idx]
        big = int(np.argmax(bin_load))
        set_a = bins[big]
        set_b = [c for b in range(3) if b != big for c in bins[b]]
        la = sum(eq[c] ** inv for c in set_a) ** alpha if set_a else 0.0
        lb = sum(eq[c] ** inv for c in set_b) ** alpha if set_b else 0.0
        res.makespan = max(la, lb) / p**alpha + chain_time
        res.m_p_lb = eq_stripped / (2 * p) ** alpha + chain_time
        for c in set_a:
            _place_all(subtree_of(tree, c), 0, res.placement)
        for c in set_b:
            _place_all(subtree_of(tree, c), 1, res.placement)
        res.case_trace.append("x<=1")
        return res

    # ---- x > 1 and c₁ internal: S_p decomposition + recursion ----------
    L_c1 = float(tree.lengths[c1])
    delta1 = L_c1 / p**alpha
    b_trees = [extract_subtree(tree, c) for c in kids[1:]]
    eq_b = sum(eq[c] ** inv for c in kids[1:]) ** alpha
    b_forest = forest_tree(b_trees)

    if eq_b <= L_c1 + 1e-12:
        # B fits entirely beside c₁: no recursion on B needed
        b_bar, b_suf = None, b_forest
    else:
        b_bar, b_suf = split_tree(b_forest, L_c1, alpha, snap=snap)

    # G_{p,2} = (C1 \ c1) || B̄_p
    g2_parts = [extract_subtree(tree, c) for c in c1_children]
    if b_bar is not None:
        g2_parts.append((b_bar.parent, b_bar.lengths, b_bar.labels))
    g2 = forest_tree(g2_parts)
    sub = _homogeneous_rec(g2, alpha, p, snap, depth + 1)

    # last phase: c₁ on node 0 (p procs), B_p on node 1 (p procs, PM)
    eq_bp = (
        tree_equivalent_lengths(b_suf, alpha)[b_suf.root] if b_suf is not None else 0.0
    )
    last_phase = max(delta1, eq_bp / p**alpha)

    res.makespan = sub.makespan + last_phase + chain_time
    res.placement.update(sub.placement)
    res.placement[int(tree.labels[c1])] = 0
    if b_suf is not None:
        for lbl in b_suf.labels:
            if lbl >= 0:
                res.placement[int(lbl)] = 1
    # Lemma 15 lower bound: M_p = Δ1 + Δ2 with the *fluid* split
    if eq_b <= L_c1 + 1e-12:
        eq_bbar_fluid = 0.0
    else:
        eq_bbar_fluid = eq_b - L_c1
    eq_g2_fluid = (
        sum(eq[c] ** inv for c in c1_children) + eq_bbar_fluid**inv
        if eq_bbar_fluid > 0
        else sum(eq[c] ** inv for c in c1_children)
    ) ** alpha
    delta2 = eq_g2_fluid / (2 * p) ** alpha
    res.m_p_lb = delta1 + delta2 + chain_time
    res.case_trace.append(f"x>1,rec[{';'.join(sub.case_trace)}]")
    return res


# ----------------------------------------------------------------------
def two_node_lower_bound(tree: TaskTree, alpha: float, p: float) -> float:
    """max(PM-on-2p, longest-single-task-on-p) — always ≤ OPT under 𝓡."""
    eq = tree_equivalent_lengths(tree, alpha)
    lb_pm = eq[tree.root] / (2 * p) ** alpha
    lb_task = float(tree.lengths.max()) / p**alpha
    # chain of tasks along any root-to-leaf path cannot overlap itself
    return max(lb_pm, lb_task)
