"""Step-function processor profiles p(t) (paper §4).

The number of available processors may vary with time; the paper restricts
p(t) to step functions.  The key quantity everywhere is *work-time*
``W(t) = ∫_0^t p(u)^α du``: under the PM schedule every task holds a constant
*ratio* r_i of p(t), so it accrues work at rate ``r_i^α · p(t)^α`` and all
scheduling can be done in work-time coordinates, then mapped back through the
inverse of W.  This is also how elastic capacity changes (node loss / grow)
enter the framework: they only edit p(t).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Profile:
    """Piecewise-constant p(t).

    ``steps`` is a sequence of (duration, processors); the final step is
    implicitly extended to infinity (its duration is ignored for inversion
    past the end).  All processors counts may be fractional.
    """

    steps: Tuple[Tuple[float, float], ...]

    @staticmethod
    def constant(p: float) -> "Profile":
        return Profile(((np.inf, float(p)),))

    @staticmethod
    def of(steps: Sequence[Tuple[float, float]]) -> "Profile":
        if not steps:
            raise ValueError("empty profile")
        if any(p <= 0 for _, p in steps):
            raise ValueError("profile must be positive")
        s = [(float(d), float(p)) for d, p in steps]
        s[-1] = (np.inf, s[-1][1])  # extend last step
        return Profile(tuple(s))

    # ------------------------------------------------------------------
    def p_at(self, t: float) -> float:
        acc = 0.0
        for d, p in self.steps:
            acc += d
            if t < acc:
                return p
        return self.steps[-1][1]

    def work_until(self, t: float, alpha: float) -> float:
        """W(t) = ∫_0^t p(u)^α du."""
        acc_t, acc_w = 0.0, 0.0
        for d, p in self.steps:
            rate = p**alpha
            if t <= acc_t + d:
                return acc_w + (t - acc_t) * rate
            acc_t += d
            acc_w += d * rate
        return acc_w  # unreachable (last step infinite)

    def time_for_work(self, w: float, alpha: float) -> float:
        """Inverse of work_until: smallest t with W(t) >= w."""
        acc_t, acc_w = 0.0, 0.0
        for d, p in self.steps:
            rate = p**alpha
            if w <= acc_w + d * rate or d == np.inf:
                return acc_t + (w - acc_w) / rate
            acc_t += d
            acc_w += d * rate
        raise AssertionError("unreachable: last step is infinite")

    def restricted_after(self, t0: float) -> "Profile":
        """The profile seen from time t0 onwards (for re-planning/elastic)."""
        out: List[Tuple[float, float]] = []
        acc = 0.0
        for d, p in self.steps:
            lo, hi = acc, acc + d
            acc = hi
            if hi <= t0:
                continue
            out.append((hi - max(lo, t0), p))
        return Profile.of(out)

    def scaled(self, factor: float) -> "Profile":
        return Profile(tuple((d, p * factor) for d, p in self.steps))
