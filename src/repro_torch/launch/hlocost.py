"""Loop-aware cost counter (port of ``repro.launch.hlocost``) in PyTorch's
terms.

The reference walks the optimized HLO text of the per-chip SPMD program,
because XLA's ``cost_analysis()`` counts each ``while`` body once.  The
port has no HLO: it counts the ATen ops a rank runs, as they are
dispatched (:func:`count_costs`, a ``TorchDispatchMode``), with the
reference's rules:

* flops        — matmuls and convolutions: 2 · |result| · contracted size
                 (``torch.utils.flop_counter``'s formulas for ``mm``,
                 ``bmm``, ``addmm``, ``baddbmm``, ``convolution`` ...);
* bytes        — Σ over materialising ops of (result + unique operand)
                 bytes.  Views are free, as the reference treats parameter,
                 get-tuple-element, tuple and bitcast; so are ``empty`` and
                 ``arange`` (its iota).  Index-driven ops touch only the
                 slice: a gather (``index``, ``index_select``, ``gather``,
                 ``embedding``) counts 2 × its result, a scatter
                 (``index_put_``, ``index_copy_``, ``index_add_``,
                 ``scatter``) 2 × its update, the reference's dynamic-slice
                 and dynamic-update-slice rules;
* collectives  — per kind, ring-model per-rank bytes of the c10d functional
                 collectives, the group size read from the group:
                 all-reduce 2s(n−1)/n, all-gather and all-to-all s(n−1)/n,
                 reduce-scatter s(n−1), permute s (s the result's bytes).

**Per rank.** Under a mesh every op is a DTensor op on global shapes; the
counter lets DTensor run it (it returns ``NotImplemented`` for DTensor
arguments) and counts the local ops and the collectives DTensor issues,
which is the rank's own program, as the reference's SPMD module is the
chip's.  Ops on meta tensors do no work and are not counted.  Count a
DTensor program on a warm run (see :class:`CostCounter`).  ``torch.utils.flop_counter.FlopCounterMode`` does not do this: it
counts the global op as well.

**Loops.** The reference multiplies through known trip counts.  The port's
layers are Python loops and run unrolled; the microbatch loop is the one
loop the dry run does not unroll: it runs one microbatch under
:meth:`CostCounter.loop` (``M``) and every count inside is multiplied by M.

**Scopes.** :func:`cost_scope` (``repro_torch.obs.scopes``) names a region (``models.attention.attend``
opens ``"attention"``); the bytes counted inside it are also added to
``CostSummary.scope_bytes[name]``.  :func:`attention_scan_bytes` reads the
attention scope, the reference's bytes of the blocked-attention kv scans.

No TPU correction is made: the reference's ``bf16_legalization_bytes`` and
``convert_bytes`` undo what XLA:CPU's dot legalisation adds for a TPU's
MXU, and the port has no such ops to undo.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.obs.scopes import SCOPES, cost_scope, uncounted  # noqa: F401 (re-exported)

COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclass
class CostSummary:
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVES})
    scope_bytes: Dict[str, float] = field(default_factory=dict)

    @property
    def collective_total(self) -> float:
        return sum(self.collective_bytes.values())


def attention_scan_bytes(summary: CostSummary) -> float:
    """Bytes counted inside ``models.attention.attend``: the traffic a
    fused attention kernel removes (logits and probabilities stay on chip)."""
    return summary.scope_bytes.get("attention", 0.0)


# ----------------------------------------------------------------------
def _nbytes(t) -> float:
    return float(t.numel() * t.element_size()) if isinstance(t, torch.Tensor) else 0.0


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _on_meta(args, out) -> bool:
    """Whether an op ran on meta tensors: shapes only, no work."""
    return any(t.device.type == "meta" for t in _tensors((args, out)))


def _unique(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    seen, out = set(), []
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


_aten = torch.ops.aten
_FREE = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.arange,
    _aten.lift_fresh, _aten.lift_fresh_copy, _aten._local_scalar_dense,
    _aten.detach, _aten.alias,
}
_GATHERS = {_aten.index, _aten.index_select, _aten.gather, _aten.embedding}
# scatter op → position of the update among its arguments
_SCATTERS = {
    _aten.index_put: 2, _aten.index_put_: 2, _aten._index_put_impl_: 2,
    _aten.index_copy: 3, _aten.index_copy_: 3, _aten.index_add: 3, _aten.index_add_: 3,
    _aten.scatter: 3, _aten.scatter_: 3, _aten.scatter_add: 3, _aten.scatter_add_: 3,
}


def _collective(func) -> str:
    """The reference's collective kind of a c10d functional op, or ''."""
    name = func._overloadpacket.__name__
    if func.namespace not in ("_c10d_functional", "_c10d_functional_autograd", "c10d_functional"):
        return ""
    if name.startswith("all_reduce"):
        return "all-reduce"
    if name.startswith("all_gather"):
        return "all-gather"
    if name.startswith("reduce_scatter"):
        return "reduce-scatter"
    if name.startswith("all_to_all"):
        return "all-to-all"
    if name.startswith("broadcast") or name.startswith("permute"):
        return "collective-permute"
    return ""


def _group_size(args) -> int:
    """The size of the group a functional collective names (its last str
    argument)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


def _ring_bytes(kind: str, size: float, n: int) -> float:
    if n <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * size * (n - 1) / n
    if kind in ("all-gather", "all-to-all"):
        return size * (n - 1) / n
    if kind == "reduce-scatter":
        return size * (n - 1)
    return size  # collective-permute


class CostCounter(TorchDispatchMode):
    """Counts the ops dispatched while it is active into :attr:`summary`,
    and tracks the bytes of the storages they make (:attr:`peak_bytes`:
    the most live at once, with those passed to :meth:`track`).

    Count a DTensor program on a warm run: the first time DTensor meets an
    op on given placements it runs the op once on global-shaped fake
    stand-ins to learn the output's shape, which the counter cannot tell
    from the rank's own ops, and caches the answer."""

    def __init__(self) -> None:
        super().__init__()
        self.summary = CostSummary()
        self._mult = 1.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = WeakIdKeyDictionary()

    def track(self, *tensors: torch.Tensor) -> None:
        """Count ``tensors``' storages as live (the step's arguments)."""
        for t in tensors:
            st = t.untyped_storage()
            if st in self._live:
                continue
            n = st.nbytes()
            self._live[st] = n
            weakref.finalize(st, self._free, n)
            self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    @contextlib.contextmanager
    def loop(self, trips: int) -> Iterator[None]:
        """Count what runs inside as run ``trips`` times (a loop of known
        trip count, run once)."""
        prev = self._mult
        self._mult = prev * trips
        try:
            yield
        finally:
            self._mult = prev

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs it; its local ops come back here
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if (isinstance(func, torch._ops.OpOverload) and not _on_meta(args, out)
                and not SCOPES.uncounted):
            self._count(func, args, kwargs, out)
            self.track(*_tensors(out))
        return out

    def _add_bytes(self, b: float) -> None:
        b *= self._mult
        self.summary.bytes += b
        for name in set(SCOPES.stack):
            self.summary.scope_bytes[name] = self.summary.scope_bytes.get(name, 0.0) + b

    def _count(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        s = self.summary
        kind = _collective(func)
        if kind:
            size = sum(_nbytes(t) for t in _tensors(out))
            s.collective_bytes[kind] += self._mult * _ring_bytes(kind, size, _group_size(args))
            self._add_bytes(size)
            return
        if func.namespace != "aten" or func.is_view or packet in _FREE:
            return
        if packet in flop_registry:
            s.flops += self._mult * flop_registry[packet](*args, **kwargs, out_val=out)
        result = sum(_nbytes(t) for t in _tensors(out))
        if packet in _GATHERS:
            self._add_bytes(2.0 * result)
        elif packet in _SCATTERS:
            i = _SCATTERS[packet]
            upd = args[i] if i < len(args) else kwargs.get("values", kwargs.get("source"))
            self._add_bytes(2.0 * sum(_nbytes(t) for t in _tensors(upd)))
        else:
            self._add_bytes(result + sum(_nbytes(t) for t in _unique(_tensors((args, kwargs)))))


@contextlib.contextmanager
def count_costs() -> Iterator[CostCounter]:
    """``with count_costs() as c: ...`` then ``c.summary`` (a
    :class:`CostSummary`) holds what the block's ops cost on this rank."""
    counter = CostCounter()
    with counter:
        yield counter
