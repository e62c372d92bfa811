# Eviction policies shared by the radix index and the tiered store
# (DESIGN.md §Fleet).
from .policy import (EvictionPolicy, GDSFPolicy, LFUPolicy, LRUPolicy,
                     TTLPolicy, make_policy)

__all__ = ["EvictionPolicy", "GDSFPolicy", "LFUPolicy", "LRUPolicy",
           "TTLPolicy", "make_policy"]
