"""repro_torch — the PyTorch/CUDA port of ``repro`` ("Scheduling Trees of
Malleable Tasks for Sparse Linear Algebra", Guermouche, Marchal, Simon,
Vivien; INRIA RR-8616, 2014), for an NVIDIA H100.

The package mirrors the module layout of ``repro`` and never imports it (or
JAX).  Ported so far: the paper's application end to end —

  api          the facade: Platform / Policy registry / Session,
               Schedule + RunReport (simulate/serve wait for ``online``)
  core         the scheduling model (graph, profiles, pm, schedule,
               baselines, multinode, memory, two_node, hetero, trees, ...)
  sparse       matrices, orderings, symbolic analysis, PM plans, tree
               amalgamation, the multifrontal factorization
  kernels      hand-written CUDA kernels (frontal partial Cholesky, flash
               attention), their plain PyTorch versions, torch.linalg oracles
  distributed  power-of-two device groups
  obs          event bus, metrics registry, chrome-trace export
  online       the discrete-event core (events)
  runtime      the plan executor (async and wave runners), straggler tools
  demo         ``python -m repro_torch.demo``, the reference demo's twin

Entry point: ``repro_torch.api.Session(DeviceMesh()).analyze(A, alpha)
.plan("greedy").execute(dtype=...)``; below it ``repro_torch.sparse.analyze``
→ ``repro_torch.sparse.make_plan`` → ``repro_torch.runtime.execute_plan``.
"""

__version__ = "0.1.0"
