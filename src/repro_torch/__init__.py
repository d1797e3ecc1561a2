"""repro_torch — the PyTorch/CUDA port of ``repro`` ("Scheduling Trees of
Malleable Tasks for Sparse Linear Algebra", Guermouche, Marchal, Simon,
Vivien; INRIA RR-8616, 2014), for an NVIDIA H100.

The package mirrors the module layout of ``repro`` and never imports it (or
JAX).  Ported so far: the paper's application end to end —

  core         the PM scheduling model the planner needs (graph, profiles,
               pm, schedule, baselines, multinode, memory)
  sparse       matrices, orderings, symbolic analysis, PM plans, the
               multifrontal factorization
  kernels      hand-written CUDA kernels for the frontal partial Cholesky,
               their plain PyTorch versions and torch.linalg oracles
  distributed  power-of-two device groups
  obs          event bus, metrics registry, chrome-trace export
  runtime      the plan executor (async and wave runners)

Entry points: ``repro_torch.sparse.analyze`` → ``repro_torch.sparse.make_plan``
→ ``repro_torch.runtime.execute_plan``.
"""

__version__ = "0.1.0"
