# Trace-driven discrete-event cluster simulator (DESIGN.md §Cluster-sim):
# the time axis the paper's §5.7 concurrency claims actually live on.
from .events import Event, EventKind, EventQueue
from .metrics import (ClusterMetrics, RequestRecord, per_tenant, percentile,
                      summarize)
from .sim import ClusterResult, ClusterSim
from .trace import (PAPER_MIX, ClosedLoopTrace, TraceRequest, load_trace,
                    poisson_trace, save_trace)

__all__ = [k for k in dir() if not k.startswith("_")]
