"""Arrival traces for the cluster simulator.

Three sources, one record type:

* :func:`poisson_trace` — seeded open-loop Poisson arrivals over a workload
  mix (the §5.7 evaluation regime LMCache/Cake use for scheduler claims).
* :class:`ClosedLoopTrace` — N clients, each re-issuing ``think_s`` after its
  previous request's first token (sim feeds completions back via
  ``on_complete``).
* :func:`load_trace` / :func:`save_trace` — a committed-JSON replay format so
  regression tests pin exact arrival schedules (tests/data/golden_trace.json).

Determinism: generators draw from ``random.Random(seed)`` only — same seed,
same trace, bit-identical floats.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Iterable, Optional, Sequence

TRACE_FORMAT = "objectcache-cluster-trace"
TRACE_VERSION = 2  # v2 adds tenant / prefix_id / hot_tokens (all defaulted)
_READABLE_VERSIONS = (1, 2)


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One arrival: a workload-grid request with an arrival timestamp.

    The fleet fields are optional: ``tenant`` names the owning tenant,
    ``prefix_id`` names the shareable prefix population member (same id =
    same leading chunk-key chain, the dedup unit of the radix namespace),
    and ``hot_tokens`` is the part of the cached prefix resident in the
    serving node's hot tier — those tokens cost neither wire bytes nor
    recompute.  v1 traces load with the defaults.
    """

    req_id: str
    arrival_s: float
    context: int  # C, tokens
    hit_rate: float  # r
    chunk_tokens: int = 64  # G
    tenant: str = ""
    prefix_id: str = ""
    hot_tokens: int = 0

    @property
    def cached_tokens(self) -> int:
        # +1e-9 absorbs fp error when hit_rate was derived as m*G/context
        # (fleet cache matching) so the product recovers exactly m*G
        return int(self.context * self.hit_rate + 1e-9)

    @property
    def fetch_tokens(self) -> int:
        """Cached tokens that must actually cross the wire (not hot)."""
        return max(0, self.cached_tokens - self.hot_tokens)


# The paper's §5.7 request mix (context, hit-rate) used as the default
# sampling population for generated traces.
PAPER_MIX: tuple[tuple[int, float], ...] = (
    (16384, 0.5), (16384, 0.875), (65536, 0.5), (65536, 0.875))


def poisson_trace(n: int, rate_rps: float, seed: int = 0,
                  mix: Sequence[tuple[int, float]] = PAPER_MIX,
                  chunk_tokens: int = 64) -> list[TraceRequest]:
    """Open-loop Poisson arrivals: exponential inter-arrival gaps at
    ``rate_rps``, workload sampled uniformly from ``mix``.  Seeded and pure
    python — bit-identical across runs."""
    rng = random.Random(seed)
    out, t = [], 0.0
    for i in range(n):
        t += rng.expovariate(rate_rps)
        context, hit = mix[rng.randrange(len(mix))]
        out.append(TraceRequest(f"r{i}", t, context, hit, chunk_tokens))
    return out


class ClosedLoopTrace:
    """``clients`` concurrent clients; each issues its next request
    ``think_s`` after its previous request's first token.  The simulator
    calls :meth:`on_complete` at every PREFILL_DONE; the trace answers with
    the client's next arrival (or None once ``requests_per_client`` ran dry).
    """

    def __init__(self, clients: int, think_s: float,
                 requests_per_client: int, seed: int = 0,
                 mix: Sequence[tuple[int, float]] = PAPER_MIX,
                 chunk_tokens: int = 64) -> None:
        self.clients = clients
        self.think_s = think_s
        self.requests_per_client = requests_per_client
        self.mix = list(mix)
        self.chunk_tokens = chunk_tokens
        self._rng = random.Random(seed)
        self._issued: dict[int, int] = {c: 0 for c in range(clients)}
        self._owner: dict[str, int] = {}

    def _issue(self, client: int, at: float) -> TraceRequest:
        i = self._issued[client]
        self._issued[client] += 1
        context, hit = self.mix[self._rng.randrange(len(self.mix))]
        req = TraceRequest(f"c{client}.{i}", at, context, hit,
                           self.chunk_tokens)
        self._owner[req.req_id] = client
        return req

    def initial(self) -> list[TraceRequest]:
        """First round: every client arrives at t=0 (order = client id)."""
        return [self._issue(c, 0.0) for c in range(self.clients)]

    def on_complete(self, req: TraceRequest, now: float
                    ) -> Optional[TraceRequest]:
        client = self._owner.pop(req.req_id)
        if self._issued[client] >= self.requests_per_client:
            return None
        return self._issue(client, now + self.think_s)


# ---------------------------------------------------------------------------
# Committed-JSON replay format
# ---------------------------------------------------------------------------
def save_trace(path: str, requests: Iterable[TraceRequest]) -> None:
    doc = {"format": TRACE_FORMAT, "version": TRACE_VERSION,
           "requests": [dataclasses.asdict(r) for r in requests]}
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")


def load_trace(path: str) -> list[TraceRequest]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("format") != TRACE_FORMAT:
        raise ValueError(f"{path}: not a {TRACE_FORMAT} file")
    if doc.get("version") not in _READABLE_VERSIONS:
        raise ValueError(f"{path}: unsupported trace version {doc.get('version')}")
    reqs = [TraceRequest(**r) for r in doc["requests"]]
    return sorted(reqs, key=lambda r: (r.arrival_s, r.req_id))
