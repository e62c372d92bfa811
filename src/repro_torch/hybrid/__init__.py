# Compute-or-load hybrid prefill (DESIGN.md §Compute-or-load): split each
# matched prefix between object-storage fetch and GPU recompute, after Cake
# (arXiv:2410.03065), on top of ObjectCache's layerwise pipeline (Eq. 3).
from .executor import HybridPlan, fetch_span_plan
from .planner import (HybridPlanner, HybridSplit, plan_split, split_ttft,
                      validate_split)
from .policy import HybridReplanner
from .simulate import crossover_sweep, hybrid_workload_ttft

__all__ = ["HybridPlan", "HybridPlanner", "HybridReplanner", "HybridSplit",
           "crossover_sweep", "fetch_span_plan", "hybrid_workload_ttft",
           "plan_split", "split_ttft", "validate_split"]
