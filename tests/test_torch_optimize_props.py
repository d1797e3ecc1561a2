"""Property-based half of the port's amalgamation suite: twins of
``tests/test_optimize_props.py``, driving the ``check_*`` helpers of
``tests/test_torch_optimize.py`` over hypothesis-generated random trees,
plus equality with the reference's optimizer on the same trees."""
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, strategies as st  # noqa: E402

from repro_torch.sparse.optimize import optimize_problem  # noqa: E402

from test_torch_optimize import (  # noqa: E402
    check_budget,
    check_conservation,
    check_matches_reference,
    check_partition,
    check_plans_valid,
    check_roundtrip,
    random_problem,
)


@given(seed=st.integers(0, 2**31 - 1), n=st.integers(2, 60), with_fp=st.booleans())
def test_prop_partition_and_conservation(seed, n, with_fp):
    prob = random_problem(seed, n=n, with_fp=with_fp)
    opt = optimize_problem(prob)
    check_partition(prob, opt)
    check_conservation(prob, opt)
    check_roundtrip(opt)
    check_matches_reference(seed, n, with_fp)


@given(seed=st.integers(0, 2**31 - 1), n=st.integers(2, 40))
def test_prop_plans_stay_valid(seed, n):
    opt = optimize_problem(random_problem(seed, n=n))
    check_plans_valid(opt)


@given(seed=st.integers(0, 2**31 - 1), n=st.integers(2, 40), slack=st.floats(1.0, 2.0))
def test_prop_budget_respected(seed, n, slack):
    prob = random_problem(seed, n=n)
    budget = prob.min_peak_memory() * slack
    opt = optimize_problem(prob, memory_budget=budget)
    check_partition(prob, opt)
    check_budget(prob, opt, budget)
