"""Multifrontal sparse Cholesky — the paper's application substrate.

matrix        sparse SPD generators (grid Laplacians, random SPD)
ordering      nested dissection (grids) and minimum degree (general)
symbolic      elimination tree, supernodes, frontal flops → TaskTree
frontal       torch.linalg reference kernels (assembly, partial Cholesky)
multifrontal  the numeric factorization (pluggable factor kernel)
plan          PM-scheduled execution plans (waves of device groups)
optimize      tree amalgamation (cull / fuse chains / merge siblings)
"""
from .frontal import assemble_front, full_cholesky_ref, partial_cholesky_ref
from .matrix import (
    grid_laplacian_2d,
    grid_laplacian_3d,
    permute_symmetric,
    random_spd,
)
from .multifrontal import (
    Factorization,
    assemble_front_np,
    extend_add_np,
    factorize,
    gather_front_entries,
    lower_csc,
    solve,
)
from .optimize import Provenance, optimize_problem
from .ordering import min_degree, nested_dissection_2d
from .plan import ExecutionPlan, make_plan, pm_projected_makespan, replan_elastic
from .symbolic import (
    SymbolicFactorization,
    Supernode,
    analyze,
    etree,
    partial_factor_flops,
)

__all__ = [k for k in dir() if not k.startswith("_")]
