"""The paper's scheduling model (Prasanna–Musicus p^α) — the part of
``repro.core`` the sparse planner and the executor need.

* graph:      SPNode / series / parallel / task, TaskTree (flat in-trees)
* profiles:   step-function processor profiles p(t)
* pm:         equivalent lengths, the unique optimal PM schedule (Thm 6)
* schedule:   explicit schedules + §4 validity checking
* baselines:  DIVISIBLE and PROPORTIONAL (Pothen–Sun) strategies (§7)
* multinode:  k-node greedy + mesh power-of-two discretization
* memory:     multifrontal footprints and resident-memory timelines
"""
from .baselines import (
    divisible_makespan,
    divisible_schedule,
    proportional_makespan,
    proportional_schedule,
    proportional_shares,
    strategies_comparison,
    subtree_weights,
)
from .graph import (
    PARALLEL,
    SERIES,
    TASK,
    SPNode,
    TaskTree,
    forest_to_sp,
    independent_tasks,
    parallel,
    series,
    task,
)
from .memory import (
    Footprints,
    MemoryTimeline,
    footprints_from_fronts,
    memory_timeline,
    pm_bounded_schedule,
    pm_peak,
    sequential_peak,
    sequential_traversal,
)
from .multinode import (
    MultiNodeResult,
    discretization_overhead,
    discretize_shares_pow2,
    k_node_greedy,
    k_node_lower_bound,
)
from .pm import (
    PMSchedule,
    cut_suffix,
    equivalent_length,
    equivalent_lengths,
    pm_makespan,
    pm_makespan_constant_p,
    pm_schedule,
    tree_equivalent_lengths,
    tree_pm_ratios,
    tree_pm_windows,
)
from .profiles import Profile
from .schedule import ExplicitSchedule, from_pm, simulate_constant_shares

__all__ = [k for k in dir() if not k.startswith("_")]
