"""Subset-sum approximation scheme used by Algorithm 12 (§6.2).

The paper plugs in the Kellerer et al. FPTAS [22]; any AS with guarantee
``κ·OPT ≤ Σ_A ≤ OPT`` (OPT = largest achievable sum ≤ target) works
(Theorem 18 is parametric in the AS).  We implement the classical
trim-based FPTAS (Ibarra–Kim style): O(n²/ε) time, simple and exact enough
for the scheduling use; an exact DP/exhaustive variant is provided for tests
and small instances.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple


def subset_sum_fptas(
    xs: Sequence[float], target: float, eps: float,
    max_entries: int = 20_000,
) -> Tuple[float, List[int]]:
    """Return (best_sum, indices) with best_sum ≤ target and
    best_sum ≥ (1 − eps)·OPT.

    Vectorized list-and-trim: achievable sums live in a sorted numpy array;
    trimming keeps the smallest representative per (1 + eps/2n)-factor
    bucket (log-bucket via np.unique — one vector op per item instead of a
    Python merge, which is what keeps n ≈ 10³ instances interactive).
    Chains of chosen indices are linked tuples aligned with the array.
    The kept representative under-estimates its bucket by ≤ (1+eps/2n), so
    after n items best_sum ≥ OPT/(1+eps/2n)^n ≥ (1−eps)·OPT.
    """
    import numpy as np

    if eps <= 0:
        raise ValueError("eps must be > 0")
    n = len(xs)
    if n == 0 or target <= 0:
        return 0.0, []
    delta = eps / (2.0 * n)
    floor = min(x for x in xs if x > 0) if any(x > 0 for x in xs) else 1.0
    floor = min(floor, target) / 2.0
    # adaptive coarsening: if the trimmed list would exceed ``max_entries``
    # (large n, tiny eps), widen the buckets.  The guarantee degrades to
    # (1 − eps_eff) with eps_eff = 2n·delta_eff — the practical
    # quality/time knob for the scheduling use; the strict FPTAS regime is
    # preserved whenever the cap does not bind (all tests).
    import math
    log_range = math.log(max(target / floor, 2.0))
    if log_range / math.log1p(delta) > max_entries:
        delta = math.expm1(log_range / max_entries)
    log1d = np.log1p(delta)

    sums = np.array([0.0])
    chains: List[tuple] = [()]
    for i, x in enumerate(xs):
        if x <= 0 or x > target:
            continue
        added = sums + x
        keep = added <= target
        if not keep.any():
            continue
        new_sums = np.concatenate([sums, added[keep]])
        new_chains = chains + [(i, chains[j]) for j in np.flatnonzero(keep)]
        order = np.argsort(new_sums, kind="stable")
        new_sums = new_sums[order]
        # log-bucket trim: first (smallest) entry per bucket + always the max
        buckets = np.floor(
            np.log(np.maximum(new_sums, floor) / floor) / log1d
        ).astype(np.int64)
        _, first = np.unique(buckets, return_index=True)
        if first[-1] != len(new_sums) - 1:
            first = np.append(first, len(new_sums) - 1)
        sums = new_sums[first]
        sel = order[first]
        chains = [new_chains[j] for j in sel]
    best_sum = float(sums[-1])
    idx: List[int] = []
    node = chains[-1]
    while node:
        i, node = node  # type: ignore[misc]
        idx.append(i)
    return best_sum, sorted(idx)


def subset_sum_exact(xs: Sequence[float], target: float) -> Tuple[float, List[int]]:
    """Exhaustive optimum (n ≤ ~22) — test oracle."""
    n = len(xs)
    if n > 22:
        raise ValueError("exact subset-sum limited to n <= 22")
    best, best_mask = 0.0, 0
    for mask in range(1 << n):
        s = 0.0
        m = mask
        i = 0
        while m:
            if m & 1:
                s += xs[i]
            m >>= 1
            i += 1
        if s <= target and s > best:
            best, best_mask = s, mask
    return best, [i for i in range(n) if best_mask >> i & 1]
