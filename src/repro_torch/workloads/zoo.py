"""Workload builders: the model zoo as trees of malleable tasks.

Each builder turns a :class:`~repro_torch.models.config.ModelConfig` (or a
set of them) into an :class:`~repro_torch.workloads.graph.OpGraph` and
tree-ifies it; the resulting :class:`Workload` produces standard
:class:`~repro_torch.api.problem.Problem`\\ s that the whole stack — policies,
online scheduler, executor, cluster — schedules unchanged.

Three shapes (the §6 workload families):

* :func:`moe_dispatch` — one routed-experts layer stack as a *star*:
  every expert is a leaf sibling whose length is its expected routed
  token load (optionally Zipf-skewed), joined at a router/combine root
  that also carries the attention backbone.  The natural malleable
  forest — exactly the shape §6's two-node FPTAS partitions.
* :func:`pipeline` — the layer stack cut into ``stages`` pipeline
  stages.  Ops carry per-stage contraction groups, so tree-ification
  collapses each stage's chain into one task and the tree is the stage
  path.
* :func:`serving_pod` — several models behind one endpoint: each
  model's graph is namespaced and their roots join under a zero-cost
  pod root (a forest of sibling subtrees).

:func:`sparse_solver` covers ``configs/multifrontal.py`` — the paper's
own workload, built through ``Problem.from_matrix`` on a grid
Laplacian so *every* file in ``configs/`` maps to a schedulable
problem.  :func:`analyze` is the dispatch front door the
``Session.analyze_workload`` facade calls.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.models.config import ModelConfig, ShapeCell, shape_by_name

from .costs import (
    Calibration,
    calibration_for,
    effective_alpha,
    hlo_flop_scale,
    task_footprints,
    task_lengths,
)
from .graph import Op, OpGraph, Treeified, treeify

BF16 = 2  # bytes per element, the serving dtype


def _tokens(shape: ShapeCell) -> float:
    """Tokens processed by one step of the cell (decode: one per seq)."""
    if shape.kind == "decode":
        return float(shape.global_batch)
    return float(shape.global_batch) * float(shape.seq_len)


def _as_shape(shape: Union[str, ShapeCell, None], default: str) -> ShapeCell:
    if shape is None:
        return shape_by_name(default)
    if isinstance(shape, str):
        return shape_by_name(shape)
    return shape


def _attn_param_bytes(cfg: ModelConfig) -> float:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    per_layer = d * hd * cfg.n_heads + 2 * d * hd * cfg.n_kv_heads + hd * cfg.n_heads * d
    return float(cfg.n_layers * per_layer * BF16)


# ----------------------------------------------------------------------
@dataclass
class Workload:
    """A built workload: op DAG, its tree-ification, and provenance.

    :meth:`problem` is the handoff to the scheduling stack — per-platform
    calibrated lengths (seconds), per-task activation footprints, and
    the op-provenance meta that rides ``Problem → Schedule → JSON v2``.
    """

    name: str
    kind: str  # moe | pipeline | pod | sparse
    graph: OpGraph
    treeified: Treeified
    meta: Dict = field(default_factory=dict)
    configs: Tuple[ModelConfig, ...] = ()
    # pod member → op-name prefix, for per-model HLO scaling
    prefixes: Tuple[str, ...] = ()

    @property
    def n_tasks(self) -> int:
        return self.treeified.n_tasks

    def _hlo_scales(self, shape: Optional[str]) -> np.ndarray:
        """Per-task measured HLO/analytic corrective (pods scale each
        member by its own model's ratio)."""
        tf = self.treeified
        scales = np.ones(tf.n_tasks)
        if not self.configs:
            return scales
        if len(self.configs) == 1:
            return scales * hlo_flop_scale(self.configs[0], shape)
        ratio = {
            pfx: hlo_flop_scale(cfg, shape)
            for pfx, cfg in zip(self.prefixes, self.configs)
        }
        for i, ops in enumerate(tf.op_map):
            if not ops:
                continue  # virtual root
            for pfx, r in ratio.items():
                if ops[0].startswith(pfx):
                    scales[i] = r
                    break
        return scales

    def problem(
        self,
        platform=None,
        *,
        alpha: Optional[float] = None,
        calibration: Optional[Calibration] = None,
        estimator: str = "analytic",
    ):
        """Build the standard scheduling :class:`~repro_torch.api.problem.Problem`.

        ``estimator="analytic"`` uses the roofline counts as-is;
        ``"hlo"`` rescales them by the measured
        :func:`~repro_torch.workloads.costs.hlo_flop_scale` ratio.
        """
        from repro_torch.api.problem import Problem

        if estimator not in ("analytic", "hlo"):
            raise ValueError(f"unknown estimator {estimator!r}")
        cal = calibration or calibration_for(platform)
        tf = self.treeified
        lengths = task_lengths(tf, cal)
        if estimator == "hlo" and self.kind != "sparse":
            lengths = lengths * self._hlo_scales(self.meta.get("shape"))
        fp = task_footprints(tf)
        meta = {
            "workload": {
                **self.meta,
                **tf.meta(),
                "kind": self.kind,
                "calibration": cal.name,
                "estimator": estimator,
            }
        }
        return Problem(
            tree=tf.with_lengths(lengths),
            alpha=effective_alpha(platform, alpha),
            name=self.name,
            footprints=fp,
            meta=meta,
        )

    def __repr__(self) -> str:
        return (
            f"Workload({self.name!r}, kind={self.kind!r}, "
            f"n_tasks={self.n_tasks}, n_ops={self.graph.n_ops})"
        )


# ----------------------------------------------------------------------
def moe_dispatch(
    cfg: ModelConfig,
    shape: Union[str, ShapeCell, None] = None,
    *,
    skew: float = 1.0,
) -> Workload:
    """Routed-expert dispatch as a star of malleable tasks.

    Expert *e*'s expected token load follows a Zipf(``skew``) law over
    the routed slots (``tokens × top_k``); ``skew=0`` is the uniform
    router.  Router + shared experts + combine + the attention backbone
    fold into the root op, which depends on every expert — the exact
    "forest of sibling subtrees joined at a router root".
    """
    if cfg.moe is None:
        raise ValueError(f"{cfg.name} has no MoE block; use pipeline()")
    cell = _as_shape(shape, "decode_32k")
    m = cfg.moe
    tok = _tokens(cell)
    d = cfg.d_model

    ranks = np.arange(1, m.n_experts + 1, dtype=np.float64)
    w = ranks ** (-float(skew))
    w /= w.sum()
    loads = tok * m.top_k * w  # expected token-slots per expert

    flops_per_slot = 6.0 * d * m.d_expert  # 3 swiglu matmuls × 2
    expert_w_bytes = 3.0 * d * m.d_expert * BF16
    ops: List[Op] = []
    for e, load in enumerate(loads):
        act = load * d * BF16
        ops.append(
            Op(
                name=f"expert{e:03d}",
                flops=cfg.n_layers * load * flops_per_slot,
                bytes=cfg.n_layers * (expert_w_bytes + 2 * act),
                param_bytes=cfg.n_layers * expert_w_bytes,
                out_bytes=act,
            )
        )

    router = cfg.n_layers * tok * d * m.n_experts * 2.0
    shared = cfg.n_layers * tok * m.n_shared * flops_per_slot
    combine = cfg.n_layers * tok * d * m.top_k * 2.0
    backbone = 2.0 * tok * _attn_param_bytes(cfg) / BF16
    root_params = _attn_param_bytes(cfg) + cfg.n_layers * (
        d * m.n_experts * BF16 + m.n_shared * expert_w_bytes
    )
    ops.append(
        Op(
            name="router",
            flops=router + shared + combine + backbone,
            bytes=root_params + 4 * tok * d * BF16,
            param_bytes=root_params,
            out_bytes=tok * d * BF16,
            deps=tuple(op.name for op in ops),
        )
    )
    graph = OpGraph(ops)
    meta = {
        "model": cfg.name,
        "shape": cell.name,
        "skew": float(skew),
        "n_experts": m.n_experts,
        "top_k": m.top_k,
        "param_bytes": float(cfg.n_params * BF16),
    }
    return Workload(
        name=f"moe:{cfg.name}:{cell.name}",
        kind="moe",
        graph=graph,
        treeified=treeify(graph),
        meta=meta,
        configs=(cfg,),
        prefixes=("",),
    )


def pipeline(
    cfg: ModelConfig,
    stages: int = 4,
    shape: Union[str, ShapeCell, None] = None,
) -> Workload:
    """The layer stack cut into ``stages`` pipeline-stage tasks.

    Per-layer ops form a dataflow chain with per-stage contraction
    groups, so :func:`~repro_torch.workloads.graph.treeify` fuses each
    stage's layers into one task and the tree is the stage path —
    series-parallel contraction of the pipeline chain.
    """
    cell = _as_shape(shape, "prefill_32k")
    from repro_torch.launch.roofline import model_flops

    stages = int(stages)
    if not 1 <= stages <= cfg.n_layers:
        raise ValueError(
            f"stages must be in [1, {cfg.n_layers}] for {cfg.name}, got {stages}"
        )
    tok = _tokens(cell)
    d, v = cfg.d_model, cfg.padded_vocab()
    total = model_flops(cfg, cell)
    head = 2.0 * tok * d * v * (3.0 if cell.kind == "train" else 1.0)
    per_layer = max(total - head, 0.0) / cfg.n_layers
    emb_params = v * d * BF16 * (1 if cfg.tie_embeddings else 2)
    layer_params = max(cfg.n_params * BF16 - emb_params, 0.0) / cfg.n_layers
    act = tok * d * BF16

    def stage_of(layer: int) -> str:
        return f"stage{layer * stages // cfg.n_layers}"

    ops: List[Op] = [
        Op(
            name="embed",
            flops=0.0,
            bytes=emb_params / 2 + act,
            param_bytes=emb_params / 2,
            out_bytes=act,
            group="stage0",
        )
    ]
    prev = "embed"
    for i in range(cfg.n_layers):
        name = f"layer{i:03d}"
        ops.append(
            Op(
                name=name,
                flops=per_layer,
                bytes=layer_params + 4 * act,
                param_bytes=layer_params,
                out_bytes=act,
                deps=(prev,),
                group=stage_of(i),
            )
        )
        prev = name
    ops.append(
        Op(
            name="head",
            flops=head,
            bytes=emb_params / 2 + act,
            param_bytes=emb_params / 2,
            out_bytes=float(cell.global_batch) * 4.0,  # per-seq summary
            deps=(prev,),
            group=stage_of(cfg.n_layers - 1),
        )
    )
    graph = OpGraph(ops)
    meta = {
        "model": cfg.name,
        "shape": cell.name,
        "stages": stages,
        "n_layers": cfg.n_layers,
        "param_bytes": float(cfg.n_params * BF16),
    }
    return Workload(
        name=f"pipeline:{cfg.name}:{cell.name}:s{stages}",
        kind="pipeline",
        graph=graph,
        treeified=treeify(graph),
        meta=meta,
        configs=(cfg,),
        prefixes=("",),
    )


def default_workload(
    cfg: ModelConfig,
    shape: Union[str, ShapeCell, None] = None,
    *,
    stages: int = 4,
    skew: float = 1.0,
) -> Workload:
    """The family-natural shape: MoE configs dispatch, the rest pipeline."""
    if cfg.moe is not None:
        return moe_dispatch(cfg, shape, skew=skew)
    return pipeline(cfg, stages=min(stages, cfg.n_layers), shape=shape)


def serving_pod(
    cfgs: Sequence[Union[str, ModelConfig]],
    shape: Union[str, ShapeCell, None] = None,
    *,
    stages: int = 4,
    skew: float = 1.0,
) -> Workload:
    """Several models behind one endpoint, joined at a zero-cost pod root.

    Each member keeps its family-natural shape (:func:`default_workload`)
    under a ``m<i>.<name>/`` namespace; the members' roots become
    sibling subtrees of the virtual root :func:`treeify` inserts.
    """
    if not cfgs:
        raise ValueError("a serving pod needs at least one model")
    resolved: List[ModelConfig] = []
    for c in cfgs:
        if isinstance(c, str):
            from repro_torch import configs as _configs

            c = _configs.get(c)
        resolved.append(c)
    ops: List[Op] = []
    prefixes: List[str] = []
    members: List[Dict] = []
    for i, cfg in enumerate(resolved):
        sub = default_workload(cfg, shape, stages=stages, skew=skew)
        pfx = f"m{i}.{cfg.name}/"
        prefixes.append(pfx)
        members.append({"prefix": pfx, **sub.meta, "kind": sub.kind})
        for op in sub.graph.ops:
            ops.append(
                dataclasses.replace(
                    op,
                    name=pfx + op.name,
                    deps=tuple(pfx + dep for dep in op.deps),
                    group=(pfx + op.group) if op.group else None,
                )
            )
    graph = OpGraph(ops)
    names = "+".join(cfg.name for cfg in resolved)
    meta = {
        "models": [cfg.name for cfg in resolved],
        "members": members,
        "shape": members[0].get("shape"),
        "param_bytes": float(sum(cfg.n_params for cfg in resolved) * BF16),
    }
    return Workload(
        name=f"pod:{names}",
        kind="pod",
        graph=graph,
        treeified=treeify(graph),
        meta=meta,
        configs=tuple(resolved),
        prefixes=tuple(prefixes),
    )


# ----------------------------------------------------------------------
def sparse_solver(
    solver=None,
    *,
    grid: Optional[int] = None,
    platform=None,
    alpha: Optional[float] = None,
):
    """The paper's own workload (``configs/multifrontal.py``): a
    nested-dissection-ordered grid Laplacian through the standard
    ``Problem.from_matrix`` path."""
    from repro_torch.api.problem import Problem
    from repro_torch.configs import SOLVER
    from repro_torch.sparse import grid_laplacian_2d, nested_dissection_2d

    solver = solver or SOLVER
    g = int(grid or solver.grid)
    a = grid_laplacian_2d(g)
    perm = nested_dissection_2d(g)
    prob = Problem.from_matrix(
        a,
        alpha if alpha is not None else solver.alpha,
        ordering=perm,
        relax=solver.relax,
        name=f"sparse:{solver.name}:g{g}",
    )
    prob.meta = {
        "workload": {
            "kind": "sparse",
            "model": solver.name,
            "grid": g,
            "relax": solver.relax,
        }
    }
    return prob


# ----------------------------------------------------------------------
def analyze(
    spec,
    platform=None,
    *,
    kind: str = "auto",
    shape: Union[str, ShapeCell, None] = None,
    stages: int = 4,
    skew: float = 1.0,
    alpha: Optional[float] = None,
    estimator: str = "analytic",
):
    """Front door: spec → standard :class:`~repro_torch.api.problem.Problem`.

    ``spec`` may be a config name from :data:`repro_torch.configs.ARCHS`, a
    :class:`~repro_torch.models.config.ModelConfig`, the multifrontal
    :class:`SolverConfig`, a list of configs/names (→ serving pod), an
    already-built :class:`Workload`, or a :class:`Problem` (passed
    through).  ``kind`` forces ``"moe"``/``"pipeline"`` for a single
    model config; ``"auto"`` picks the family-natural shape.
    """
    from repro_torch.api.problem import Problem

    if isinstance(spec, Problem):
        return spec
    if isinstance(spec, Workload):
        return spec.problem(platform, alpha=alpha, estimator=estimator)
    if isinstance(spec, str):
        from repro_torch import configs as _configs

        if spec in ("sparse", "multifrontal", _configs.SOLVER.name):
            spec = _configs.SOLVER
        else:
            spec = _configs.get(spec)
    if isinstance(spec, (list, tuple)):
        wl = serving_pod(spec, shape, stages=stages, skew=skew)
        return wl.problem(platform, alpha=alpha, estimator=estimator)
    if isinstance(spec, ModelConfig):
        if kind == "moe":
            wl = moe_dispatch(spec, shape, skew=skew)
        elif kind == "pipeline":
            wl = pipeline(spec, stages=stages, shape=shape)
        elif kind in ("auto", "default"):
            wl = default_workload(spec, shape, stages=stages, skew=skew)
        else:
            raise ValueError(f"unknown workload kind {kind!r}")
        return wl.problem(platform, alpha=alpha, estimator=estimator)
    # the multifrontal SolverConfig (or anything quacking like it)
    if hasattr(spec, "grid") and hasattr(spec, "relax"):
        return sparse_solver(spec, platform=platform, alpha=alpha)
    raise TypeError(f"cannot build a workload from {type(spec).__name__}")


__all__ = [
    "Workload",
    "analyze",
    "default_workload",
    "moe_dispatch",
    "pipeline",
    "serving_pod",
    "sparse_solver",
]
