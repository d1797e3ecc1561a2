"""The port's amalgamation optimizer (``repro_torch.sparse.optimize``, a
copy): twins of ``tests/test_optimize.py``, its result held equal to the
reference's, and the factor bits of optimized plans inside the port.

The invariants (partition, conservation, §4 validity, memory budget,
identity floor, JSON round-trip) live in plain ``check_*`` helpers shared
with ``tests/test_torch_optimize_props.py``.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.api as rapi
import repro.core.memory as rmem
import repro.core.trees as rtrees
import repro.sparse.optimize as ropt
from repro_torch.api import DeviceMesh, Session, SharedMemory
from repro_torch.api.problem import Problem
from repro_torch.core.graph import TaskTree
from repro_torch.core.memory import footprints_from_fronts, sequential_peak
from repro_torch.core.trees import quotient_tree, random_assembly_tree
from repro_torch.kernels.ops import factor_fn
from repro_torch.runtime import PlanExecutor
from repro_torch.sparse import (
    analyze,
    factorize,
    grid_laplacian_2d,
    nested_dissection_2d,
    permute_symmetric,
)
from repro_torch.sparse.optimize import Provenance, optimize_problem
from repro_torch.sparse.plan import make_plan

ALPHA = 0.9
CPU4 = [torch.device("cpu")] * 4


# ----------------------------------------------------------------------
# invariant checkers (plain functions: shared by seeded + property tests)
# ----------------------------------------------------------------------
def check_partition(prob: Problem, opt: Problem) -> None:
    prov = opt.provenance
    assert prov is not None
    assert prov.n_original == prob.n
    cover = sorted([m for g in prov.groups for m in g] + list(prov.culled))
    assert cover == list(range(prob.n)), "provenance is not a partition"
    assert len(prov.groups) == opt.n
    assert all(prob.tree.lengths[c] == 0 for c in prov.culled)


def check_conservation(prob: Problem, opt: Problem) -> None:
    assert np.isclose(opt.total_work(), prob.total_work())
    assert prob.eq_root <= opt.eq_root * (1 + 1e-9)
    assert opt.eq_root <= prob.total_work() * (1 + 1e-9)


def check_plans_valid(opt: Problem, p: int = 8) -> None:
    for policy in ("pm", "greedy"):
        sess = Session(SharedMemory(p)).load(opt).plan(policy)
        sess.schedule.validate(opt)


def check_budget(prob: Problem, opt: Problem, budget: float) -> None:
    fp = opt.memory_footprints()
    assert fp is not None
    assert sequential_peak(opt.tree, fp) <= budget * (1 + 1e-9)


def check_roundtrip(opt: Problem) -> None:
    prov = opt.provenance
    assert Provenance.from_dict(json.loads(json.dumps(prov.to_dict()))) == prov


def check_matches_reference(seed: int, n: int, with_fp: bool, **kw) -> None:
    """The same random problem through both optimizers: the same
    provenance, the same quotient tree, the same footprints."""
    opt = optimize_problem(random_problem(seed, n, with_fp), **kw)
    ref = ropt.optimize_problem(random_problem(seed, n, with_fp, ref=True), **kw)
    assert opt.provenance.to_dict() == ref.provenance.to_dict()
    np.testing.assert_array_equal(opt.tree.parent, ref.tree.parent)
    np.testing.assert_array_equal(opt.tree.lengths, ref.tree.lengths)
    np.testing.assert_array_equal(opt.tree.labels, ref.tree.labels)
    fp, rfp = opt.memory_footprints(), ref.memory_footprints()
    assert (fp is None) == (rfp is None)
    if fp is not None:
        for f in ("front_bytes", "factor_bytes", "cb_bytes"):
            np.testing.assert_array_equal(getattr(fp, f), getattr(rfp, f))


def random_problem(seed: int, n: int = 40, with_fp: bool = True, ref: bool = False):
    """A seeded random tree (+ random front footprints); ``ref`` builds the
    same problem from the reference's modules."""
    rng = np.random.default_rng(seed)
    gen = rtrees.random_assembly_tree if ref else random_assembly_tree
    tree = gen(n, rng)
    fp = None
    if with_fp:
        m = rng.integers(1, 24, size=n)
        nb = np.minimum(m, rng.integers(1, 8, size=n))
        fp = (rmem.footprints_from_fronts if ref else footprints_from_fronts)(m, nb)
    return (rapi.Problem if ref else Problem).from_tree(tree, ALPHA, footprints=fp)


# ----------------------------------------------------------------------
# seeded deterministic coverage
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 7])
def test_invariants_random_tree(seed):
    prob = random_problem(seed)
    opt = optimize_problem(prob)
    check_partition(prob, opt)
    check_conservation(prob, opt)
    check_plans_valid(opt)
    check_roundtrip(opt)
    assert opt.n <= prob.n
    check_matches_reference(seed, 40, True)


@pytest.mark.parametrize("seed", [0, 3])
def test_budget_backoff_certifies(seed):
    prob = random_problem(seed)
    budget = prob.min_peak_memory() * 1.05
    opt = optimize_problem(prob, memory_budget=budget)
    check_partition(prob, opt)
    check_budget(prob, opt, budget)
    sess = Session(SharedMemory(8)).load(opt)
    sess.plan("pm-bounded", memory_budget=budget)
    assert sess.schedule.memory is not None
    assert sess.schedule.memory.peak <= budget * (1 + 1e-9)
    check_matches_reference(seed, 40, True, memory_budget=budget)


def test_infeasible_budget_raises():
    prob = random_problem(0)
    with pytest.raises(ValueError, match="sequential minimum"):
        optimize_problem(prob, memory_budget=prob.min_peak_memory() * 0.5)


def test_threshold_zero_is_cull_only():
    prob = random_problem(5)
    opt = optimize_problem(prob, max_front=0)
    assert all(len(g) == 1 for g in opt.provenance.groups)
    assert np.isclose(opt.eq_root, prob.eq_root)
    assert np.isclose(
        sequential_peak(opt.tree, opt.memory_footprints()), prob.min_peak_memory()
    )
    check_matches_reference(5, 40, True, max_front=0)


def test_cull_removes_degenerate_leaves():
    tree = TaskTree(parent=np.array([-1, 0, 1, 1]), lengths=np.array([3.0, 2.0, 1.0, 0.0]))
    fp = footprints_from_fronts(np.array([4, 3, 2, 0]), np.array([4, 2, 1, 0]))
    prob = Problem.from_tree(tree, ALPHA, footprints=fp)
    opt = optimize_problem(prob, max_front=0)
    assert opt.provenance.culled == (3,)
    assert opt.n == 3
    check_partition(prob, opt)
    check_conservation(prob, opt)


def test_double_optimize_rejected():
    opt = optimize_problem(random_problem(0))
    with pytest.raises(ValueError, match="provenance"):
        optimize_problem(opt)


def test_quotient_tree_rejects_non_tree_contractions():
    tree = TaskTree(parent=np.array([-1, 0, 0, 1, 2]), lengths=np.ones(5))
    with pytest.raises(ValueError, match="not a tree"):
        quotient_tree(tree, [[0], [1], [2], [3, 4]])
    with pytest.raises(ValueError, match="twice"):
        quotient_tree(tree, [[0, 1], [1, 2], [3], [4]])
    with pytest.raises(ValueError, match="cover"):
        quotient_tree(tree, [[0], [1], [2], [3]])
    with pytest.raises(ValueError, match="culled"):
        quotient_tree(tree, [[0], [2], [3], [4]], culled=[1])
    q = quotient_tree(tree, [[0], [1, 3], [2, 4]])
    assert q.n == 3
    assert list(q.parent) == [-1, 0, 0]
    assert list(q.lengths) == [1.0, 2.0, 2.0]


def test_sparse_problem_provenance_equals_reference():
    """On a real matrix the shape classes come from the port's
    ``padded_shape``: the optimized problem equals the reference's."""
    g = 9
    a = grid_laplacian_2d(g)
    port = optimize_problem(
        Problem.from_matrix(a, ALPHA, ordering=nested_dissection_2d(g), relax=0), max_front=64)
    ref = ropt.optimize_problem(
        rapi.Problem.from_matrix(a, ALPHA, ordering=nested_dissection_2d(g), relax=0),
        max_front=64)
    assert port.provenance.to_dict() == ref.provenance.to_dict()
    np.testing.assert_array_equal(port.tree.lengths, ref.tree.lengths)


@pytest.fixture(scope="module")
def grid9_runs():
    """Poisson 9×9 (relax=0, many small fronts), f64 on CPU lanes: every
    runner on the unoptimized and the optimized plan."""
    g = 9
    a = grid_laplacian_2d(g)
    prob = Problem.from_matrix(a, ALPHA, ordering=nested_dissection_2d(g), relax=0)
    opt = optimize_problem(prob, max_front=64)
    plans = {
        "unopt": (Session(DeviceMesh(CPU4, plan_devices=8)).load(prob).plan("greedy"), None),
        "opt": (Session(DeviceMesh(CPU4, plan_devices=8)).load(opt).plan("greedy"),
                opt.provenance),
    }
    runs = {}
    for kind, (sess, prov) in plans.items():
        for mode in ("async", "waves"):
            rep = sess.execute(warmup=False, mode=mode, dtype=torch.float64)
            runs[(kind, mode)] = (rep.artifact.panels, rep.metrics["n_dispatches"])
        # sequential: one lane, one dispatch after another
        plan = sess.schedule.to_execution_plan()
        fact, report = PlanExecutor(prob.symb, plan, devices=CPU4[:1], dtype=torch.float64,
                                    mode="waves", provenance=prov).run(prob.matrix, warmup=False)
        runs[(kind, "sequential-lane")] = (fact.panels, report.n_dispatches)
    seq = factorize(prob.matrix, prob.symb, factor_fn=factor_fn(), dtype=torch.float64,
                    device="cpu")
    runs[("unopt", "factorize")] = (seq.panels, None)
    return prob, opt, plans, runs


def test_sparse_problem_counts_and_bits(grid9_runs):
    """Dispatch-level fusion on a real matrix: fewer tasks, and every runner
    on the optimized and unoptimized plans lands the same factor bits in
    the original index space."""
    prob, opt, plans, runs = grid9_runs
    assert opt.n < prob.n
    check_partition(prob, opt)
    check_conservation(prob, opt)
    check_plans_valid(opt)
    assert "provenance" in plans["opt"][0].schedule.meta
    base = runs[("unopt", "factorize")][0]
    assert len(runs) == 7
    for key, (panels, _) in runs.items():
        assert len(panels) == prob.symb.n_supernodes, key
        for s, (a, b) in enumerate(zip(base, panels)):
            np.testing.assert_array_equal(a, b, err_msg=f"{key} panel {s}")
    # one group dispatch per optimized task; fewer dispatches than fronts
    assert runs[("opt", "waves")][1] == opt.n < prob.n


def test_optimized_factor_matches_reference_executor(grid9_runs):
    """The optimized plan through the reference's executor (f64) and
    through the port's: the same factor within 1e-10."""
    prob, opt, plans, runs = grid9_runs
    jax.config.update("jax_enable_x64", True)
    try:
        g = 9
        rprob = rapi.Problem.from_matrix(
            grid_laplacian_2d(g), ALPHA, ordering=nested_dissection_2d(g), relax=0)
        ref = (rapi.Session(rapi.DeviceMesh(plan_devices=8))
               .load(ropt.optimize_problem(rprob, max_front=64)).plan("greedy")
               .execute(warmup=False, mode="waves"))
    finally:
        jax.config.update("jax_enable_x64", False)
    for a, b in zip(runs[("opt", "waves")][0], ref.artifact.panels):
        assert np.abs(a - b).max() / max(1.0, np.abs(b).max()) < 1e-10
    assert runs[("opt", "waves")][1] == ref.metrics["n_dispatches"]


def test_session_optimize_chain():
    prob = random_problem(2)
    sess = Session(SharedMemory(8)).load(prob).optimize()
    assert sess.problem.provenance is not None
    assert sess.schedule is None
    sess.plan("pm")
    assert sess.schedule.meta["provenance"]["n_original"] == prob.n


def test_provenance_of_plain_symbolic_matches_executor_contract():
    """The executor accepts the ported Provenance directly (no duck-typed
    stand-in): groups, labels and parent are what it reads."""
    ap = permute_symmetric(grid_laplacian_2d(7), nested_dissection_2d(7))
    symb = analyze(ap, relax=0)
    opt = optimize_problem(Problem.from_symbolic(symb, ALPHA, matrix=ap), max_front=64)
    plan = make_plan(opt.tree, 4, ALPHA)
    ex = PlanExecutor(symb, plan, devices=CPU4[:2], provenance=opt.provenance)
    assert isinstance(ex._prov, Provenance)
