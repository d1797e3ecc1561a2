"""repro_torch — the PyTorch/CUDA port of ``repro`` ("Scheduling Trees of
Malleable Tasks for Sparse Linear Algebra", Guermouche, Marchal, Simon,
Vivien; INRIA RR-8616, 2014), for an NVIDIA H100.

The package mirrors the module layout of ``repro`` and never imports it (or
JAX).  Ported so far: the paper's application end to end —

  api          the facade: Platform / Policy registry / Session
               (analyze / plan / execute / simulate / serve),
               Schedule + RunReport
  core         the scheduling model (graph, profiles, pm, schedule,
               baselines, multinode, memory, two_node, hetero, trees, ...)
  sparse       matrices, orderings, symbolic analysis, PM plans, tree
               amalgamation, the multifrontal factorization
  kernels      hand-written CUDA kernels (frontal partial Cholesky, flash
               attention), their plain PyTorch versions, torch.linalg oracles
  distributed  power-of-two device groups
  obs          event bus, metrics registry, efficiency metrics,
               chrome-trace export, the localhost dashboard and static
               HTML report
  online       the event-driven online scheduler (events, state, queue,
               scheduler) and its bridge to the executor (replay)
  runtime      the plan executor (async and wave runners), straggler and
               elastic tools
  cluster      the serving cluster: comm layer (inproc / TCP), scheduler,
               heartbeating workers factoring fronts on torch devices,
               engine facade, ``LocalCluster``
  models       the assigned architectures: configs, the models (forward,
               loss, prefill, decode), weights in and out
  configs      exact public-literature configs (+ the solver's own)
  train        AdamW and the train step (autograd, f32 microbatch
               accumulation)
  data         the seeded synthetic token pipeline
  checkpoint   atomic, async checkpoints under the reference's keys
  launch       the analytic model-flop counters, the one-card server and
               trainer
  workloads    model computation graphs → malleable task trees, per-platform
               calibrated costs (``h100`` measured on the card), the zoo
  serve        pod-level request placement and online serving
  demo         ``python -m repro_torch.demo``, the reference demo's twin

Entry point: ``repro_torch.api.Session(DeviceMesh()).analyze(A, alpha)
.plan("greedy").execute(dtype=...)``; below it ``repro_torch.sparse.analyze``
→ ``repro_torch.sparse.make_plan`` → ``repro_torch.runtime.execute_plan``;
the online path is ``repro_torch.online.execute_online`` (or
``.plan("online")`` on the Session); serving is ``Session.serve(stream)``
(virtual time) or ``Session.serve(stream, cluster=...)`` (a
``repro_torch.cluster.LocalCluster``, wall time); model workloads enter
through ``Session.analyze_workload(spec)``.

The facade re-exports lazily (PEP 562), as the reference's does: ``import
repro_torch; repro_torch.Session(...)`` imports ``repro_torch.api`` on first
touch, and only a workload name reaches ``repro_torch.models`` /
``repro_torch.configs``.
"""

__version__ = "0.1.0"

# Facade names resolvable directly on the package (touching one is what
# imports repro_torch.api).
_FACADE = frozenset(
    {
        "DeviceMesh",
        "MixedCluster",
        "MulticoreCluster",
        "Platform",
        "Policy",
        "Problem",
        "Resources",
        "RunReport",
        "Schedule",
        "Session",
        "SharedMemory",
        "ShareEntry",
        "accepts_memory_budget",
        "as_platform",
        "as_problem",
        "available_policies",
        "get_policy",
        "register_policy",
    }
)

# Cluster names (repro_torch.LocalCluster starts nothing at import time).
_CLUSTER_FACADE = frozenset(
    {
        "ClusterClient",
        "ClusterEngine",
        "ClusterScheduler",
        "LocalCluster",
        "SimEngine",
        "Worker",
    }
)

# Workload-frontend names: resolving one of these is the only path by
# which `import repro_torch` reaches repro_torch.models / .configs.
_WORKLOADS_FACADE = frozenset(
    {
        "Workload",
        "analyze_workload",
        "moe_dispatch",
        "pipeline_workload",
        "serving_pod",
    }
)

# facade name → attribute in repro_torch.workloads (renamed where the bare
# name would be ambiguous at the top level)
_WORKLOADS_ALIASES = {
    "analyze_workload": "analyze",
    "pipeline_workload": "pipeline",
}


def __getattr__(name: str):
    if name in _FACADE:
        from repro_torch import api

        return getattr(api, name)
    if name in _CLUSTER_FACADE:
        from repro_torch import cluster

        return getattr(cluster, name)
    if name in _WORKLOADS_FACADE:
        from repro_torch import workloads

        return getattr(workloads, _WORKLOADS_ALIASES.get(name, name))
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")


def __dir__():
    return sorted(
        set(globals()) | _FACADE | _CLUSTER_FACADE | _WORKLOADS_FACADE
    )
