# Fleet-scale cache economy (DESIGN.md §Fleet): eviction policies shared by
# the radix index and the tiered store, Zipfian multi-tenant workloads, and
# cache-affinity routing across simulated nodes.
from .policy import (EvictionPolicy, GDSFPolicy, LFUPolicy, LRUPolicy,
                     TTLPolicy, make_policy)
from .routing import (AffinityRouter, ConsistentHashRouter, RandomRouter,
                      Router, RoundRobinRouter, make_router)
from .workload import (ZipfSampler, rag_trace, tenant_churn_trace,
                       working_set_chunks, zipf_system_prompt_trace)

_SIM = ("ByteLedgerStore", "CacheConfig", "FleetNode", "FleetResult",
        "FleetSim", "NodeCache", "derive_chain", "request_chain")


def __getattr__(name):  # lazy: sim pulls in the whole cluster stack
    if name in _SIM:
        from . import sim
        return getattr(sim, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted([k for k in dir() if not k.startswith("_")] + list(_SIM))
