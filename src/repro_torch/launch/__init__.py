"""Launch-side accounting and entry points (port of ``repro.launch``).

mesh         the production meshes (16×16, 2×16×16) and the 1×1 smoke mesh
roofline     the analytic model-flop counters and the three roofline terms
hlocost      the per-rank cost counter (flops, bytes, collectives, memory)
dryrun       the dry run of a cell on a fake group of 256 or 512 ranks
serve        the serving launcher (prefill + greedy decode) on a mesh
train        the training launcher on a mesh
"""
