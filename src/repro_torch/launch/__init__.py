"""Launch-side accounting (port of ``repro.launch``, in part).

roofline     the analytic model-flop counters the workload zoo reads

The meshes, launchers, dry run and HLO cost walker are ROADMAP queue 1
items 10 and 11.
"""
