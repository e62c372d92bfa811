# Compute-or-load hybrid prefill (DESIGN.md §Compute-or-load): the planner
# and the execution-side plan types the orchestrator and engine consume.
from .executor import HybridPlan, fetch_span_plan
from .planner import (HybridPlanner, HybridSplit, plan_split, split_ttft,
                      validate_split)

__all__ = ["HybridPlan", "HybridPlanner", "HybridSplit", "fetch_span_plan",
           "plan_split", "split_ttft", "validate_split"]
