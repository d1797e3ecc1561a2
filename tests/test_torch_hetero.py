"""The port's subset-sum FPTAS and (p, q)-scheduling FPTAS
(``repro_torch.core.{subset_sum, hetero}``, paper §6.2): twins of
``tests/test_hetero.py``.  The modules are copies, so each twin runs the
reference and the port on the same drawn inputs and holds the port's
results equal to the reference's exactly, besides the reference test's
guarantees."""
import pytest

pytest.importorskip("hypothesis")  # property tests need it; skip if absent
from hypothesis import given, strategies as st  # noqa: E402

import repro.core as rcore  # noqa: E402
from repro_torch.core import (  # noqa: E402
    hetero_exact,
    hetero_fptas,
    partition_makespan,
    subset_sum_exact,
    subset_sum_fptas,
)

alphas = st.floats(min_value=0.6, max_value=0.95)


@given(
    st.lists(st.floats(0.5, 30.0), min_size=1, max_size=14),
    st.floats(1.0, 120.0),
    st.floats(0.02, 0.3),
)
def test_subset_sum_fptas_guarantee(xs, target, eps):
    best, idx = subset_sum_fptas(xs, target, eps)
    assert (best, idx) == rcore.subset_sum_fptas(xs, target, eps)
    opt, part = subset_sum_exact(xs, target)
    assert (opt, part) == rcore.subset_sum_exact(xs, target)
    assert best <= target + 1e-9
    assert best >= (1 - eps) * opt - 1e-9
    assert sum(xs[i] for i in idx) == pytest.approx(best, rel=1e-12)


@given(
    st.lists(st.floats(0.5, 10.0), min_size=2, max_size=11),
    alphas,
    st.floats(2.0, 24.0),
    st.floats(1.0, 16.0),
    st.floats(1.02, 1.5),
)
def test_hetero_fptas_guarantee(lengths, alpha, p, q, lam):
    res = hetero_fptas(lengths, p, q, alpha, lam)
    assert repr(res) == repr(rcore.hetero_fptas(lengths, p, q, alpha, lam))
    opt, part = hetero_exact(lengths, p, q, alpha)
    assert (opt, part) == rcore.hetero_exact(lengths, p, q, alpha)
    assert res.makespan <= lam * opt * (1 + 1e-9)
    assert res.makespan >= opt - 1e-9 * opt
    mk = partition_makespan(lengths, res.on_p, p, q, alpha)
    assert mk == rcore.partition_makespan(lengths, res.on_p, p, q, alpha)
    assert mk == pytest.approx(res.makespan, rel=1e-12)
    assert sorted(res.on_p + res.on_q) == list(range(len(lengths)))


def test_hetero_large_lambda_shortcut():
    """λ ≥ (1+r)^α: everything on the largest node is already good enough.
    r = 4 here, so the shortcut needs λ ≥ 5^0.9 ≈ 4.25."""
    res = hetero_fptas([3.0, 2.0, 5.0], p=8.0, q=2.0, alpha=0.9, lam=4.5)
    assert repr(res) == repr(rcore.hetero_fptas([3.0, 2.0, 5.0], p=8.0, q=2.0, alpha=0.9,
                                                lam=4.5))
    assert res.on_q == [] or res.on_p == []
    opt, _ = hetero_exact([3.0, 2.0, 5.0], 8.0, 2.0, 0.9)
    assert res.makespan <= 4.5 * opt


def test_lower_bound_is_ideal_profile():
    lengths = [4.0, 4.0, 4.0, 4.0]
    res = hetero_fptas(lengths, 6.0, 2.0, 0.8, 1.1)
    assert repr(res) == repr(rcore.hetero_fptas(lengths, 6.0, 2.0, 0.8, 1.1))
    s = sum(x ** (1 / 0.8) for x in lengths)
    assert res.lower_bound == pytest.approx((s / 8.0) ** 0.8)
    assert res.makespan >= res.lower_bound - 1e-12
