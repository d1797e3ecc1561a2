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
  obs          event bus, metrics registry, chrome-trace export
  online       the event-driven online scheduler (events, state, queue,
               scheduler) and its bridge to the executor (replay)
  runtime      the plan executor (async and wave runners), straggler and
               elastic tools
  demo         ``python -m repro_torch.demo``, the reference demo's twin

Entry point: ``repro_torch.api.Session(DeviceMesh()).analyze(A, alpha)
.plan("greedy").execute(dtype=...)``; below it ``repro_torch.sparse.analyze``
→ ``repro_torch.sparse.make_plan`` → ``repro_torch.runtime.execute_plan``;
the online path is ``repro_torch.online.execute_online`` (or
``.plan("online")`` on the Session).
"""

__version__ = "0.1.0"
