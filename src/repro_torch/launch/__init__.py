"""Launch-side accounting (port of ``repro.launch``, in part).

roofline     the analytic model-flop counters the workload zoo reads
serve        the serving launcher on one card (prefill + greedy decode)
train        the training launcher on one device

The meshes, the dry run and the HLO cost walker are ROADMAP queue 1
items 10 and 11.
"""
