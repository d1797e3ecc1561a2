"""The port's step profiles (``repro_torch.core.profiles``, §4 p(t)): the
twin of ``tests/test_profiles.py``.  Each property runs on both packages'
``Profile`` built from the same hypothesis-drawn steps, and the port's
numbers equal the reference's exactly."""
import pytest

pytest.importorskip("hypothesis")  # property tests need it; skip if absent
from hypothesis import given, strategies as st

from repro.core import Profile as RProfile
from repro_torch.core import Profile


@st.composite
def steps(draw):
    n = draw(st.integers(1, 5))
    return [(draw(st.floats(0.1, 5.0)), draw(st.floats(0.5, 64.0))) for _ in range(n)]


@given(steps(), st.floats(0.55, 1.0), st.floats(0.01, 40.0))
def test_work_time_inversion_roundtrip(s, alpha, t):
    prof, ref = Profile.of(s), RProfile.of(s)
    w = prof.work_until(t, alpha)
    assert w == ref.work_until(t, alpha)
    assert prof.time_for_work(w, alpha) == ref.time_for_work(w, alpha)
    assert prof.time_for_work(w, alpha) == pytest.approx(t, rel=1e-9, abs=1e-9)


@given(steps(), st.floats(0.55, 1.0), st.floats(0.0, 10.0), st.floats(0.0, 10.0))
def test_work_is_monotone_and_additive(s, alpha, t1, dt):
    prof, ref = Profile.of(s), RProfile.of(s)
    w1, w2 = prof.work_until(t1, alpha), prof.work_until(t1 + dt, alpha)
    assert (w1, w2) == (ref.work_until(t1, alpha), ref.work_until(t1 + dt, alpha))
    assert w2 >= w1 - 1e-12
    rest = prof.restricted_after(t1)
    assert rest.work_until(dt, alpha) == ref.restricted_after(t1).work_until(dt, alpha)
    assert rest.work_until(dt, alpha) == pytest.approx(w2 - w1, rel=1e-6, abs=1e-9)


@given(steps(), st.floats(0.55, 1.0), st.floats(1.1, 4.0))
def test_scaling_speeds_up(s, alpha, f):
    prof, ref = Profile.of(s), RProfile.of(s)
    big = prof.scaled(f)
    w = prof.work_until(3.0, alpha)
    assert big.time_for_work(w, alpha) == ref.scaled(f).time_for_work(w, alpha)
    if w > 1e-9:
        assert big.time_for_work(w, alpha) <= prof.time_for_work(w, alpha) + 1e-9
