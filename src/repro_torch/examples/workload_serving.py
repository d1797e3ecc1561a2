"""Workload frontend tour: model zoo → malleable task trees → schedules
(the twin of the reference's ``examples/workload_serving.py``).

1. Compile a routed-experts model into its MoE dispatch star and plan it
   under PM vs the speedup-unaware proportional mapping.
2. Cut a dense model into pipeline stages, check the memory timeline the
   activation footprints induce, and simulate the plan.
3. Put three models behind one endpoint (a serving pod forest) and serve
   a small multi-tenant request mix with weighted fair admission.
4. Split a task set across a genuinely mixed two-node platform (CPU host
   next to a faster accelerator pod, different α each) with the §6.2
   FPTAS generalized to unequal exponents.

Host only, in virtual time: the reference only plans and simulates these
model workloads (it executes none, and calls no ``"multifrontal"``
workload), so nothing runs on the devices and no kernel launches.  The
platforms are ``SharedMemory`` and ``MixedCluster``, whose lengths come
from the ``cpu`` calibration, as the reference's.  The devices are still
resolved (every CUDA device, or the caller's CPU lanes) so that all the
example entry points share one device rule.

Run:  PYTHONPATH=src python -m repro_torch.examples.workload_serving
      PYTHONPATH=src python -m repro_torch.examples.workload_serving --cpu-lanes 1
"""
from __future__ import annotations

import argparse
from typing import Dict, Optional, Sequence

from repro_torch.api import MixedCluster, Session, SharedMemory
from repro_torch.examples import add_device_flag, resolve_devices
from repro_torch.workloads import analyze


def main(argv: Optional[Sequence[str]] = None,
         devices: Optional[Sequence] = None) -> Dict[str, object]:
    args = add_device_flag(argparse.ArgumentParser(description=__doc__.splitlines()[0])
                           ).parse_args(argv)
    devs = resolve_devices(devices, args.cpu_lanes)

    print("=== 1. MoE dispatch star: PM vs proportional (p = 32) ===")
    sess = Session(SharedMemory(32)).analyze_workload(
        "qwen2-moe-a2.7b", shape="decode_32k"
    )
    mk = {
        p: sess.plan(policy=p).schedule.makespan
        for p in ("pm", "proportional")
    }
    n_experts = sess.schedule.meta["workload"]["n_experts"]
    print(f"{n_experts} experts + router root, {sess.problem.n} tasks")
    print(f"PM           : {mk['pm']:.4g} s")
    print(f"PROPORTIONAL : {mk['proportional']:.4g} s  "
          f"(+{100 * (mk['proportional'] / mk['pm'] - 1):.1f}%)")
    sess.plan(policy="pm").schedule.validate(sess.problem)
    print("schedule validated against the §4 conditions.\n")

    print("=== 2. Pipeline stages with activation footprints ===")
    s2 = Session(SharedMemory(32)).analyze_workload(
        "qwen3-4b", shape="prefill_32k", stages=4
    )
    sched = s2.plan(policy="pm").schedule
    rep = s2.simulate(policy="pm")
    print(f"{s2.problem.n} stage tasks; makespan {rep.makespan:.4g} s; "
          f"peak resident {sched.peak_memory() / 2**30:.2f} GiB")
    print(f"online simulation reproduces the fluid optimum: "
          f"efficiency {rep.efficiency():.3f}\n")

    print("=== 3. Serving pod + weighted fair admission ===")
    pod = SharedMemory(32)
    stream = [
        (analyze(name, pod), 0.0, tenant)
        for name, tenant in [
            ("qwen3-4b", 0), ("rwkv6-1.6b", 1), ("qwen3-4b", 0),
            ("granite-moe-3b-a800m", 1),
        ]
    ]
    served = Session(pod).serve(
        stream, admission="fair", max_concurrent=2,
        qos_weights={0: 4.0, 1: 1.0},
    )
    print(f"{len(served.detail.futures)} requests served; "
          f"mean latency {served.metrics['mean_latency']:.4g} s "
          f"(tenant 0 weighted 4x)\n")

    print("=== 4. Mixed platform: CPU host + 4x-faster pod ===")
    mixed = MixedCluster(
        [SharedMemory(40), 8], alphas=(0.85, 0.95), speeds=(1.0, 4.0)
    )
    s4 = Session(mixed).analyze_workload("qwen2-moe-a2.7b")
    placed = s4.plan(policy="hetero-mixed").schedule
    on_q = sum(1 for _, node in placed.meta["placement"] if node == 1)
    print(f"{on_q}/{s4.problem.n} tasks on the fast node; "
          f"makespan {placed.makespan:.4g} s "
          f"(lower bound {placed.fluid_makespan:.4g} s)")
    return {
        "moe_makespans": mk,
        "moe_experts": n_experts,
        "moe_tasks": sess.problem.n,
        "pipeline_tasks": s2.problem.n,
        "pipeline_makespan": rep.makespan,
        "pipeline_plan_makespan": sched.makespan,
        "pipeline_peak_bytes": sched.peak_memory(),
        "pipeline_efficiency": rep.efficiency(),
        "served": len(served.detail.futures),
        "mean_latency": served.metrics["mean_latency"],
        "mixed_on_fast": on_q,
        "mixed_tasks": s4.problem.n,
        "mixed_makespan": placed.makespan,
        "mixed_lower_bound": placed.fluid_makespan,
        "devices": [str(d) for d in devs],
    }


if __name__ == "__main__":
    main()
