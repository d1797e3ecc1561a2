"""The paper's scheduling model (Prasanna–Musicus p^α), copied from
``repro.core`` with its imports renamed.

* graph:      SPNode / series / parallel / task, TaskTree (flat in-trees)
* profiles:   step-function processor profiles p(t)
* pm:         equivalent lengths, the unique optimal PM schedule (Thm 6)
* schedule:   explicit schedules + §4 validity checking
* baselines:  DIVISIBLE and PROPORTIONAL (Pothen–Sun) strategies (§7)
* aggregate:  §7 sub-unit-share aggregation (tree → SP graph)
* two_node:   Algorithm 11, the (4/3)^α-approximation on 2 homogeneous nodes
* hetero:     Algorithm 12, the FPTAS on 2 heterogeneous nodes
* subset_sum: the subset-sum FPTAS Algorithm 12 is parameterized by
* multinode:  k-node greedy + mesh power-of-two discretization
* memory:     multifrontal footprints and resident-memory timelines
* trees:      tree generators for the §7-style simulation campaign
"""
from .aggregate import aggregate, min_task_share
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
from .hetero import HeteroResult, hetero_exact, hetero_fptas, partition_makespan
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
from .subset_sum import subset_sum_exact, subset_sum_fptas
from .trees import balanced_tree, chain_tree, random_assembly_tree, star_tree
from .two_node import (
    TwoNodeResult,
    homogeneous_two_node,
    split_tree,
    subtree_of,
    two_node_lower_bound,
)

__all__ = [k for k in dir() if not k.startswith("_")]
