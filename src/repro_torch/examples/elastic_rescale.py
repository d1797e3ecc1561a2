"""Elastic scaling walkthrough: heartbeats → failure detection → PM replan,
plus straggler detection feeding the §6.2 heterogeneous rebalance (the
twin of the reference's ``examples/elastic_rescale.py``).

Host only: every number here is planned or simulated in virtual time, and
nothing runs on the devices.  The devices are still resolved (every CUDA
device, or the caller's CPU lanes) so that all the example entry points
share one device rule.

Run:  PYTHONPATH=src python -m repro_torch.examples.elastic_rescale
      PYTHONPATH=src python -m repro_torch.examples.elastic_rescale --cpu-lanes 1
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

import numpy as np

from repro_torch.core import random_assembly_tree, tree_equivalent_lengths
from repro_torch.examples import add_device_flag, resolve_devices
from repro_torch.runtime import (
    ElasticController,
    ElasticEvent,
    HeartbeatMonitor,
    StragglerDetector,
    rebalance_two_pods,
    run_elastic_schedule,
)

ALPHA = 0.9


def main(argv: Optional[Sequence[str]] = None,
         devices: Optional[Sequence] = None) -> Dict[str, object]:
    args = add_device_flag(argparse.ArgumentParser(description=__doc__.splitlines()[0])
                           ).parse_args(argv)
    devs = resolve_devices(devices, args.cpu_lanes)
    rng = np.random.default_rng(1)
    tree = random_assembly_tree(800, rng)

    print("=== failure detection ===")
    hb = HeartbeatMonitor(n_nodes=8, timeout=2.0)
    for t in np.arange(0.0, 6.0, 0.5):
        for node in range(8):
            if not (node == 5 and t >= 2.0):  # node 5 dies at t=2
                hb.beat(node, float(t))
    dead = hb.dead(5.5)
    print(f"dead at t=5.5: {dead} (expected [5])\n")

    print("=== PM elastic replan (paper p(t) machinery) ===")
    ctl = ElasticController(initial_devices=256)
    ctl.capacity_change(2.0, 224)  # 32 chips lost with node 5
    ctl.capacity_change(8.0, 256)  # replacement joins
    eq = tree_equivalent_lengths(tree, ALPHA)[tree.root]
    fluid_full = eq / 256**ALPHA
    fluid_elastic = ctl.pm_makespan(tree, ALPHA)
    print(f"fluid makespan, full mesh : {fluid_full:9.3f}")
    print(f"fluid makespan, elastic   : {fluid_elastic:9.3f}")
    mk, plans = run_elastic_schedule(
        tree, ALPHA, 256,
        [ElasticEvent(2.0, 224), ElasticEvent(8.0, 256)],
    )
    print(f"discretized elastic run   : {mk:9.3f}  ({len(plans)} plans)\n")

    print("=== straggler → heterogeneous rebalance (§6.2) ===")
    det = StragglerDetector(n_nodes=2)
    for step in range(16):
        det.record(0, 1.00 + rng.normal() * 0.02)
        det.record(1, 1.55 + rng.normal() * 0.02)  # pod 1 at ~65% speed
    speeds = det.node_speeds()
    print(f"measured speeds: {speeds.round(2)}")
    lengths = rng.uniform(1, 10, size=12)
    res = rebalance_two_pods(lengths, pod_devices=256, speeds=speeds,
                             alpha=ALPHA, lam=1.05)
    frac = sum(lengths[i] for i in res.on_p) / lengths.sum()
    print(f"work to fast pod: {frac:.0%}  (makespan {res.makespan:.3g}, "
          f"λ=1.05 guarantee vs ideal {res.lower_bound:.3g})")
    return {
        "dead": list(dead),
        "fluid_full": fluid_full,
        "fluid_elastic": fluid_elastic,
        "elastic_makespan": mk,
        "n_plans": len(plans),
        "speeds": speeds,
        "fast_pod_share": frac,
        "rebalance_makespan": res.makespan,
        "rebalance_lower_bound": res.lower_bound,
        "devices": [str(d) for d in devs],
    }


if __name__ == "__main__":
    main()
