"""Execution-side types for hybrid prefill (DESIGN.md §Compute-or-load).

`Orchestrator.plan` emits a :class:`HybridPlan` when a hybrid planner is
configured and the split lands strictly inside the match;
`ServingEngine._serve_hybrid` consumes it: the fetch-span travels as a normal
layerwise descriptor (shorter prefix, same wire format) while the
recompute-span rides the suffix through prefill.  Logits are bit-for-bit
equal to a no-cache prefill because the recomputed KV is produced by exactly
the same per-layer kernels that produced it the first time.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

from repro_torch.core.types import Delivery, KVSpec, MatchResult

from .planner import HybridSplit

if TYPE_CHECKING:
    from repro_torch.serving.orchestrator import TransferPlan


@dataclasses.dataclass
class HybridPlan:
    """A `TransferPlan`-shaped plan whose match is split at ``fetch_chunks``.

    Mirrors `serving.orchestrator.TransferPlan` field-for-field (it is not a
    subclass only to keep this package importable without the serving stack).
    ``delivery`` stays LAYERWISE — it describes the fetched span's descriptor;
    the request-level mode is `Delivery.HYBRID` (reported by the engine).
    """

    match: MatchResult
    delivery: Optional[Delivery]
    rate: Optional[float]
    hedged: bool = False
    req_id: str = "req"
    fetch_chunks: int = 0
    split: Optional[HybridSplit] = None


def fetch_span_plan(plan: HybridPlan, max_chunks: int, spec: KVSpec
                    ) -> "TransferPlan":
    """The ordinary layerwise plan for chunks [0, m) of a hybrid plan.

    ``max_chunks`` caps m at what the engine may actually reuse (it always
    keeps >= 1 suffix token to produce next-token logits).
    """
    from repro_torch.serving.orchestrator import TransferPlan
    m = min(plan.fetch_chunks, max_chunks)
    match = dataclasses.replace(plan.match,
                                chunk_keys=plan.match.chunk_keys[:m],
                                matched_tokens=m * spec.chunk_tokens)
    return TransferPlan(match, Delivery.LAYERWISE, plan.rate, plan.hedged,
                        req_id=getattr(plan, "req_id", "req"))
