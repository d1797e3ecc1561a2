"""Two heterogeneous nodes: the (p,q)-SCHEDULING FPTAS (§6.2, Algorithm 12).

n independent malleable tasks, nodes of p and q processors, same α.  With
``x_i = L_i^{1/α}`` the makespan of a partition (A on the p-part) is
``max((Σ_A x_i / p)^α, (Σ_Ā x_i / q)^α)``, so the problem reduces to
subset-sum around the ideal split ``p·S/(p+q)``.  Algorithm 12 runs a
subset-sum AS twice (targets pS/(p+q) and qS/(p+q)) with accuracy
``ε_κ = (λ^{1/α} − 1)/r``, r = max(p/q, q/p), and returns the better of the
two induced schedules; Theorem 18 proves the result is a λ-approximation.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from .subset_sum import subset_sum_exact, subset_sum_fptas


@dataclass
class HeteroResult:
    makespan: float
    on_p: List[int]  # indices of tasks on the p-part
    on_q: List[int]
    lam: float  # requested approximation ratio
    lower_bound: float  # M_ideal = (S/(p+q))^α


def partition_makespan(
    lengths: Sequence[float], on_p: Sequence[int], p: float, q: float, alpha: float
) -> float:
    xs = np.asarray(lengths, dtype=np.float64) ** (1.0 / alpha)
    sel = np.zeros(len(xs), dtype=bool)
    sel[list(on_p)] = True
    sp = max(float(xs[sel].sum()), 0.0)
    sq = max(float(xs[~sel].sum()), 0.0)
    return max((sp / p) ** alpha, (sq / q) ** alpha)


def hetero_fptas(
    lengths: Sequence[float], p: float, q: float, alpha: float, lam: float
) -> HeteroResult:
    """Algorithm 12 (HeterogeneousApp)."""
    if lam <= 1:
        raise ValueError("lambda must exceed 1")
    n = len(lengths)
    xs = [float(L) ** (1.0 / alpha) for L in lengths]
    S = sum(xs)
    r = max(p / q, q / p)
    m_ideal = (S / (p + q)) ** alpha

    if lam >= (1.0 + r) ** alpha:
        # PM on the largest part alone is already a λ-approximation
        big_is_p = p >= q
        on_p = list(range(n)) if big_is_p else []
        on_q = [] if big_is_p else list(range(n))
        mk = (S / max(p, q)) ** alpha
        return HeteroResult(mk, on_p, on_q, lam, m_ideal)

    eps_k = (lam ** (1.0 / alpha) - 1.0) / r
    # run the AS on both targets (both branches of inequality (1))
    _, a_idx = subset_sum_fptas(xs, p * S / (p + q), eps_k)
    _, b_idx = subset_sum_fptas(xs, q * S / (p + q), eps_k)

    cand_a = a_idx  # A on p-part
    cand_b = [i for i in range(n) if i not in set(b_idx)]  # B on q-part ⇒ B̄ on p-part
    mk_a = partition_makespan(lengths, cand_a, p, q, alpha)
    mk_b = partition_makespan(lengths, cand_b, p, q, alpha)
    if mk_a <= mk_b:
        chosen = cand_a
        mk = mk_a
    else:
        chosen = cand_b
        mk = mk_b
    on_q = [i for i in range(n) if i not in set(chosen)]
    return HeteroResult(mk, sorted(chosen), on_q, lam, m_ideal)


# ----------------------------------------------------------------------
# Beyond-paper generalization: genuinely mixed nodes.  §6.2 assumes both
# nodes share the speedup exponent α and a unit work rate; a CPU node
# next to an accelerator node has neither.  NodeSpec carries (p, α,
# speed); a set A on node j finishes at ((Σ_A (w_i/s_j)^{1/α_j})/p_j)^{α_j}
# (constant shares are optimal per task by power-mean concavity).  The
# FPTAS machinery still applies per node — subset-sum runs in each
# node's mass space and every candidate partition is evaluated EXACTLY,
# so the returned makespan is achievable; when the exponents and speeds
# agree the candidates include Algorithm 12's and the result matches
# hetero_fptas.  No approximation theorem is claimed for α_p ≠ α_q — the
# reported lower_bound (single-task and fluid min-share relaxations) is
# what certifies a run.


@dataclass(frozen=True)
class NodeSpec:
    """One node of a mixed platform: processors, exponent, work rate."""

    p: float
    alpha: float
    speed: float = 1.0

    def __post_init__(self) -> None:
        if self.p <= 0 or self.speed <= 0:
            raise ValueError("node processors and speed must be positive")
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")

    def mass(self, works: np.ndarray) -> np.ndarray:
        """Per-task subset-sum mass in this node's space: (w/s)^{1/α}."""
        return (np.asarray(works, dtype=np.float64) / self.speed) ** (
            1.0 / self.alpha
        )

    def time(self, total_mass: float) -> float:
        """Completion time of a set with the given summed mass."""
        return (max(total_mass, 0.0) / self.p) ** self.alpha


@dataclass
class MixedHeteroResult:
    makespan: float  # exact makespan of the returned partition
    on_p: List[int]
    on_q: List[int]
    lam: float
    lower_bound: float


def mixed_partition_makespan(
    works: Sequence[float],
    on_p: Sequence[int],
    node_p: NodeSpec,
    node_q: NodeSpec,
) -> float:
    """Exact makespan of a partition on two mixed nodes."""
    w = np.asarray(works, dtype=np.float64)
    sel = np.zeros(len(w), dtype=bool)
    sel[list(on_p)] = True
    tp = node_p.time(float(node_p.mass(w[sel]).sum())) if sel.any() else 0.0
    tq = node_q.time(float(node_q.mass(w[~sel]).sum())) if (~sel).any() else 0.0
    return max(tp, tq)


def mixed_lower_bound(
    works: Sequence[float], node_p: NodeSpec, node_q: NodeSpec
) -> float:
    """A valid makespan lower bound for mixed nodes.

    (a) every task runs somewhere: max_i min_j (time of i alone on the
    full node j); (b) fluid min-share relaxation: at horizon T task i
    needs constant share ρ_ij = ((w_i/s_j)/T)^{1/α_j} on its node, and
    any feasible schedule has Σ_i ρ_ij(i)/p_j(i) ≤ 2 — binary-search the
    smallest T where even the per-task *cheapest* node keeps the sum ≤ 2.
    """
    w = np.asarray(works, dtype=np.float64)
    w = w[w > 0]
    if w.size == 0:
        return 0.0
    nodes = (node_p, node_q)
    lb_single = float(
        max(
            min(nd.time(float(nd.mass(wi).sum())) for nd in nodes)
            for wi in w
        )
    )

    def load(T: float) -> float:
        tot = 0.0
        for wi in w:
            tot += min(
                ((wi / nd.speed) / T) ** (1.0 / nd.alpha) / nd.p
                for nd in nodes
            )
        return tot

    lo, hi = lb_single, lb_single
    while load(hi) > 2.0:
        hi *= 2.0
    if hi > lo:
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if load(mid) > 2.0:
                lo = mid
            else:
                hi = mid
    return max(lb_single, lo)


def mixed_hetero_fptas(
    works: Sequence[float],
    node_p: NodeSpec,
    node_q: NodeSpec,
    lam: float = 1.05,
) -> MixedHeteroResult:
    """Partition independent tasks across two genuinely mixed nodes.

    Runs the subset-sum AS in *each* node's mass space — in p-space the
    other node acts as ``q' = q·(s_q/s_p)^{1/α_p}`` effective processors,
    which is exactly Algorithm 12's target when the exponents agree —
    then bisects the p-side mass target against the exact mixed
    makespan (the two sides' times are monotone in the split, so the
    best balance point brackets).  All candidates (both mass spaces,
    every bisection probe, all-on-p, all-on-q) are scored with
    :func:`mixed_partition_makespan`; the best exact one wins.
    """
    if lam <= 1:
        raise ValueError("lambda must exceed 1")
    w = np.asarray(works, dtype=np.float64)
    if w.ndim != 1 or w.size == 0:
        raise ValueError("works must be a non-empty 1-D sequence")
    if (w < 0).any():
        raise ValueError("works must be non-negative")
    n = w.size
    nodes = (node_p, node_q)
    a_min = min(nd.alpha for nd in nodes)
    eff = [
        nodes[1 - j].p
        * (nodes[1 - j].speed / nodes[j].speed) ** (1.0 / nodes[j].alpha)
        for j in range(2)
    ]
    r = max(
        (node_p.p / eff[1]) if eff[1] > 0 else 1.0,
        (eff[0] / node_p.p) if node_p.p > 0 else 1.0,
        1.0,
    )
    eps_k = max((lam ** (1.0 / a_min) - 1.0) / r, 1e-9)

    def score(on_p_idx: Sequence[int]) -> Tuple[float, List[int]]:
        idx = sorted(set(int(i) for i in on_p_idx))
        return mixed_partition_makespan(w, idx, node_p, node_q), idx

    candidates: List[Tuple[float, List[int]]] = [
        score(range(n)),
        score([]),
    ]

    # Algorithm-12-style targets in each node's own mass space
    for j, nd in enumerate(nodes):
        xs = [float(x) for x in nd.mass(w)]
        S = sum(xs)
        if S <= 0:
            continue
        frac = nd.p / (nd.p + eff[j]) if nd.p + eff[j] > 0 else 0.5
        _, sel = subset_sum_fptas(xs, frac * S, eps_k)
        on_p_idx = sel if j == 0 else [i for i in range(n) if i not in set(sel)]
        candidates.append(score(on_p_idx))

        # bisect the mass target against the exact mixed makespan: the
        # p-side time grows and the q-side time shrinks in the target,
        # so probing the balance point closes the gap unequal α leaves
        if j == 0:
            lo_t, hi_t = 0.0, S
            for _ in range(16):
                mid = 0.5 * (lo_t + hi_t)
                _, sel = subset_sum_fptas(xs, mid, eps_k)
                mk, idx = score(sel)
                candidates.append((mk, idx))
                w_sel = np.zeros(n, dtype=bool)
                w_sel[idx] = True
                tp = node_p.time(float(node_p.mass(w[w_sel]).sum()))
                tq = node_q.time(float(node_q.mass(w[~w_sel]).sum()))
                if tp >= tq:
                    hi_t = mid
                else:
                    lo_t = mid

    mk, chosen = min(candidates, key=lambda c: c[0])
    on_q = [i for i in range(n) if i not in set(chosen)]
    return MixedHeteroResult(
        makespan=float(mk),
        on_p=chosen,
        on_q=on_q,
        lam=float(lam),
        lower_bound=mixed_lower_bound(w, node_p, node_q),
    )


def hetero_exact(
    lengths: Sequence[float], p: float, q: float, alpha: float
) -> Tuple[float, List[int]]:
    """Brute-force optimum over the 2^n partitions (test oracle, n ≤ 22)."""
    n = len(lengths)
    if n > 22:
        raise ValueError("exact limited to n <= 22")
    xs = np.asarray(lengths, dtype=np.float64) ** (1.0 / alpha)
    S = float(xs.sum())
    best, best_mask = np.inf, 0
    for mask in range(1 << n):
        sp = 0.0
        m, i = mask, 0
        while m:
            if m & 1:
                sp += xs[i]
            m >>= 1
            i += 1
        sq = max(S - sp, 0.0)  # guard float-accumulation underflow
        mk = max((sp / p) ** alpha, (sq / q) ** alpha)
        if mk < best:
            best, best_mask = mk, mask
    return float(best), [i for i in range(n) if best_mask >> i & 1]
