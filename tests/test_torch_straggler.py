"""The port's straggler module (``repro_torch.runtime.straggler``, a copy)
against the reference, and straggler injection through the port's
executor: twins of the straggler cases of ``tests/test_async_executor.py``.

The executor runs on ``[torch.device("cpu")] * 4`` — four logical lanes,
so an injected straggler can be overtaken by independent fronts.
"""
import numpy as np
import pytest
import torch

import repro.runtime.straggler as rstrag
import repro_torch.sparse as tsparse
from repro_torch.runtime import (
    FrontDelays,
    PlanExecutor,
    StragglerDetector,
    StragglerInjector,
    rebalance_two_pods,
)

from test_torch_sparse import _same

CPU4 = [torch.device("cpu")] * 4


@pytest.fixture(scope="module")
def problem():
    a = tsparse.grid_laplacian_2d(9)
    ap = tsparse.permute_symmetric(a, tsparse.nested_dissection_2d(9))
    symb = tsparse.analyze(ap, relax=1)
    plan = tsparse.make_plan(symb.task_tree(), 8, alpha=0.9)
    return ap, symb, plan


def _run(problem, mode, **kw):
    ap, symb, plan = problem
    return PlanExecutor(symb, plan, devices=CPU4, dtype=torch.float64, mode=mode,
                        **kw).run(ap, warmup=False)


def test_front_delays_random_seeded():
    d1 = FrontDelays.random(range(40), 5, 0.25, seed=3)
    d2 = FrontDelays.random(range(40), 5, 0.25, seed=3)
    assert d1.delays == d2.delays
    assert len(d1.delays) == 5
    assert d1.total() == pytest.approx(1.25)
    hit = next(iter(d1.delays))
    assert d1(hit) == 0.25
    miss = next(s for s in range(40) if s not in d1.delays)
    assert d1(miss) == 0.0
    # the same stragglers as the reference's
    assert d1.delays == rstrag.FrontDelays.random(range(40), 5, 0.25, seed=3).delays


def test_async_out_of_order_completion(problem):
    """A straggling leaf does not stall unrelated fronts (no barrier).

    The reference compares raw makespans (async < waves).  On CPU lanes the
    port's async runner costs more per dispatch than the wave runner (its
    worker threads run their plain-version fronts side by side), so here
    the stall is read from each run's own trace instead: the fronts outside
    the leaf's ancestor chain that finish after the straggler, and the time
    from the straggler's end to the end of the run.  The barrier leaves
    both behind the delay; the futures runner does that work during it."""
    ap, symb, plan = problem
    leaf = next(
        s for s in range(symb.n_supernodes)
        if not any(symb.supernodes[c].parent == s for c in range(symb.n_supernodes))
    )
    delay = 1.5  # well above the unrelated fronts' work on loaded CPU lanes
    delays = FrontDelays(delays={leaf: delay})
    # max_batch=1 keeps the straggler out of its siblings' dispatches
    fw, rw = _run(problem, "waves", delay_fn=delays, max_batch=1)
    fa, ra = _run(problem, "async", delay_fn=delays, max_batch=1)
    for pw, pa in zip(fw.panels, fa.panels):
        np.testing.assert_array_equal(pw, pa)
    ancestors = {leaf}
    p = symb.supernodes[leaf].parent
    while p >= 0:
        ancestors.add(p)
        p = symb.supernodes[p].parent
    ev = {e.front: e for e in ra.trace}
    assert ev[leaf].t_end - ev[leaf].t_start >= delay
    overtakers = [
        s for s in range(symb.n_supernodes)
        if s not in ancestors and ev[s].t_end < ev[leaf].t_end
    ]
    assert overtakers, "no front overtook the injected straggler"

    def stall(report):
        """(unrelated fronts finishing after the straggler, run end − its end)"""
        ev = {e.front: e for e in report.trace}
        late = [s for s in ev if s not in ancestors and ev[s].t_end > ev[leaf].t_end]
        return len(late), max(e.t_end for e in report.trace) - ev[leaf].t_end

    late_w, tail_w = stall(rw)
    late_a, tail_a = stall(ra)
    assert late_w > 0  # the barrier holds later waves behind the straggler
    assert late_a < late_w
    assert tail_a < tail_w


def test_detector_injector_rebalance_match_reference(rng):
    times = {node: list(rng.uniform(0.9, 1.1, 12)) for node in range(6)}
    times[4] = [3.0 * t for t in times[4]]  # one slow node
    det, rdet = StragglerDetector(n_nodes=6), rstrag.StragglerDetector(n_nodes=6)
    for node, ts in times.items():
        for t in ts:
            det.record(node, t)
            rdet.record(node, t)
    assert det.stragglers() == rdet.stragglers() == [4]
    np.testing.assert_array_equal(det.node_speeds(), rdet.node_speeds())
    inj, rinj = StragglerInjector(det), rstrag.StragglerInjector(rdet)
    ev, rev = inj.emit(1.0), rinj.emit(1.0)
    assert [(t, e.node, e.speed) for t, e in ev] == [(t, e.node, e.speed) for t, e in rev]
    assert ev and inj.emit(2.0) == []  # only changes are emitted
    lengths = list(rng.uniform(0.5, 8.0, 10))
    _same(rebalance_two_pods(lengths, 16, [1.0, 0.4], 0.9),
          rstrag.rebalance_two_pods(lengths, 16, [1.0, 0.4], 0.9))
