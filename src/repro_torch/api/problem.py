"""The canonical scheduling problem: one tree, one α, one set of lengths.

Every subsystem used to re-derive the quantities it needed — the serve
path recomputed request lengths, the replay bridge rebuilt the task tree
from the symbolic analysis, the online scheduler recomputed equivalent
lengths at admission.  :class:`Problem` is the single object they all
consume now, so α and the lengths cannot drift between admission,
planning and execution: equivalent lengths are computed once (cached)
and a scheduler configured with a different α refuses the problem.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.core.graph import TaskTree
from repro_torch.core.pm import tree_equivalent_lengths
from repro_torch.core.profiles import Profile


@dataclass
class Problem:
    """A tree of `p^α` malleable tasks with the exponent fixed.

    ``tree`` holds the task lengths (for multifrontal problems: frontal
    flops / ``flop_rate``); ``symb``/``matrix`` carry the sparse
    application context when the problem came from a matrix, which is
    what lets :meth:`repro_torch.api.session.Session.execute` actually
    factorize.  Equivalent lengths (Definition 1) are cached — compute
    once, reuse everywhere.
    """

    tree: TaskTree
    alpha: float
    name: str = "problem"
    symb: Optional[object] = None  # SymbolicFactorization
    matrix: Optional[object] = None  # the (permuted) sparse matrix symb describes
    footprints: Optional[object] = None  # memory.Footprints override (generic trees)
    provenance: Optional[object] = None  # optimize.Provenance (amalgamated trees)
    # JSON-serializable provenance of non-sparse problems (the workload
    # frontend's op map); Session.plan copies it into Schedule.meta
    meta: Optional[dict] = None
    _eq: Optional[np.ndarray] = field(
        default=None, repr=False, compare=False
    )
    _fp: Optional[object] = field(default=None, repr=False, compare=False)
    _seq_peak: Optional[float] = field(default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        self.alpha = float(self.alpha)
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")

    # -- derived quantities (single source of truth) --------------------
    @property
    def n(self) -> int:
        return self.tree.n

    def equivalent_lengths(self) -> np.ndarray:
        """Per-subtree 𝓛 (Definition 1), computed once."""
        if self._eq is None:
            self._eq = tree_equivalent_lengths(self.tree, self.alpha)
        return self._eq

    @property
    def eq_root(self) -> float:
        """𝓛 of the whole tree — the quantity Theorem 6 inverts."""
        return float(self.equivalent_lengths()[self.tree.root])

    def total_work(self) -> float:
        return float(self.tree.lengths.sum())

    # -- memory model ---------------------------------------------------
    def memory_footprints(self):
        """Per-task :class:`~repro_torch.core.memory.Footprints` in bytes.

        An explicit override (``footprints=`` — the generic non-sparse
        hook) wins; otherwise the footprints are derived once from the
        symbolic factorization (front order → front / factor /
        contribution-block bytes, zero-padded over a virtual root).
        ``None`` when the problem carries no memory model — every memory
        feature then degrades to "unconstrained".
        """
        if self.footprints is not None:
            if self.footprints.n != self.n:
                raise ValueError(
                    f"footprints cover {self.footprints.n} tasks, "
                    f"tree has {self.n}"
                )
            return self.footprints
        if self.symb is None:
            return None
        if self._fp is None:
            self._fp = self.symb.footprints().padded(self.n)
        return self._fp

    def min_peak_memory(self) -> float:
        """Least bytes any schedule of this problem needs (Liu's
        sequential bound) — the admission-control number.  0.0 when the
        problem has no memory model."""
        if self._seq_peak is None:
            fp = self.memory_footprints()
            if fp is None:
                self._seq_peak = 0.0
            else:
                from repro_torch.core.memory import sequential_peak

                self._seq_peak = sequential_peak(self.tree, fp)
        return self._seq_peak

    def pm_peak_memory(self) -> float:
        """Peak bytes of the fluid PM schedule (0.0 without a model)."""
        fp = self.memory_footprints()
        if fp is None:
            return 0.0
        from repro_torch.core.memory import pm_peak

        return pm_peak(self.tree, self.alpha, fp)

    def fluid_makespan(self, profile: Union[Profile, float]) -> float:
        """Theorem-6 lower bound under a profile (or constant capacity)."""
        if not isinstance(profile, Profile):
            profile = Profile.constant(float(profile))
        return profile.time_for_work(self.eq_root, self.alpha)

    def to_sp(self):
        """The pseudo-tree SP graph (paper Figure 7)."""
        return self.tree.to_sp()

    def residual(self, lengths: np.ndarray) -> "Problem":
        """Same structure, new lengths (elastic replans, online residuals)."""
        return Problem(
            tree=TaskTree(
                parent=self.tree.parent.copy(),
                lengths=np.asarray(lengths, dtype=np.float64),
                labels=self.tree.labels.copy(),
            ),
            alpha=self.alpha,
            name=self.name,
            symb=self.symb,
            matrix=self.matrix,
            footprints=self.footprints,
            provenance=self.provenance,
            meta=self.meta,
        )

    # -- constructors ---------------------------------------------------
    @classmethod
    def from_tree(
        cls,
        tree: TaskTree,
        alpha: float,
        name: str = "tree",
        *,
        footprints=None,
    ) -> "Problem":
        """From a bare tree; ``footprints`` is the generic memory-model
        override for trees that are not factorizations."""
        return cls(tree=tree, alpha=alpha, name=name, footprints=footprints)

    @classmethod
    def from_symbolic(
        cls,
        symb,
        alpha: float,
        *,
        matrix=None,
        flop_rate: float = 1.0,
        name: str = "multifrontal",
    ) -> "Problem":
        """From a symbolic factorization (lengths = frontal flops/rate)."""
        return cls(
            tree=symb.task_tree(flop_rate=flop_rate),
            alpha=alpha,
            name=name,
            symb=symb,
            matrix=matrix,
        )

    @classmethod
    def from_matrix(
        cls,
        a,
        alpha: float,
        *,
        ordering: Optional[Union[np.ndarray, Callable]] = None,
        relax: int = 2,
        flop_rate: float = 1.0,
        name: str = "matrix",
    ) -> "Problem":
        """Analyze a sparse SPD matrix: ordering → symbolic → task tree.

        ``ordering`` is a permutation array, or a callable ``a -> perm``
        (e.g. ``repro_torch.sparse.min_degree``), or None to keep ``a`` as-is.
        """
        from repro_torch.sparse.matrix import permute_symmetric
        from repro_torch.sparse.symbolic import analyze

        if callable(ordering):
            ordering = ordering(a)
        ap = permute_symmetric(a, ordering) if ordering is not None else a
        symb = analyze(ap, relax=relax)
        return cls.from_symbolic(
            symb, alpha, matrix=ap, flop_rate=flop_rate, name=name
        )

    @classmethod
    def from_lengths(
        cls, lengths: Sequence[float], alpha: float, name: str = "tasks"
    ) -> "Problem":
        """Independent tasks (one request, or a §6-style star instance)."""
        lengths = np.asarray(lengths, dtype=np.float64)
        if lengths.ndim != 1 or lengths.size == 0:
            raise ValueError("lengths must be a non-empty 1-D sequence")
        if lengths.size == 1:
            tree = TaskTree(
                parent=np.array([-1]), lengths=lengths.astype(np.float64)
            )
        else:
            from repro_torch.core.trees import star_tree

            tree = star_tree(lengths)
        return cls(tree=tree, alpha=alpha, name=name)


def as_problem(obj, alpha: Optional[float] = None) -> Problem:
    """Coerce ``obj`` into a :class:`Problem`.

    Accepts a Problem (α must agree if given), a TaskTree (+α), or a
    1-D length sequence (+α).
    """
    if isinstance(obj, Problem):
        if alpha is not None and abs(obj.alpha - float(alpha)) > 1e-12:
            raise ValueError(
                f"problem has alpha={obj.alpha}, context expects {alpha}"
            )
        return obj
    if alpha is None:
        raise ValueError("alpha is required to build a Problem")
    if isinstance(obj, TaskTree):
        return Problem.from_tree(obj, alpha)
    return Problem.from_lengths(np.asarray(obj, dtype=np.float64), alpha)


__all__ = ["Problem", "as_problem"]
