"""Bandwidth-aware transfer scheduling (paper §3.6, Appendix Table A4).

Under a shared bandwidth cap B, each layerwise request i is characterised by
its per-layer transfer size s_i and per-layer compute window c_i (both ~constant
across layers — footnote 1).  Allocating rate r_i gives per-layer stall

    tau_i(r_i) = max(0, s_i / r_i - c_i)                       (Eq. 4)

which vanishes at the zero-stall rate r_i* = s_i / c_i.  Minimising total stall
under the budget reduces (Eq. 5 → Eq. 6) to the convex program

    min  sum_i s_i / r_i   s.t.  sum_i r_i = B,  0 < r_i <= r_i*.

KKT: uncapped requests satisfy r_i ∝ sqrt(s_i); requests whose water-filling
share exceeds their cap are pinned at it and the residual budget is re-filled —
iterative capping terminates in <= n rounds and is exact.  *Calibrated*
Stall-opt (Eq. 7) raises each cap to r̂_i = r_i* + delta so the operating point
sits on the measured TTFT plateau rather than on the knee.

This module reproduces the paper's Appendix Table A9 allocations to rounding
precision (see tests/test_scheduler.py and benchmarks/bench_scheduler.py).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Callable, Iterable, Mapping, Optional, Sequence

from .types import FlowRequest


class Policy(enum.Enum):
    EQUAL = "equal"  # B/n each, ignoring size and slack
    KV_PROP = "kv-prop"  # proportional to retrieved KV bytes
    BW_PROP = "bw-prop"  # proportional to zero-stall estimate r_i*
    STALL_OPT = "stall-opt"  # Eq. 6 exact solution
    CAL_STALL_OPT = "cal-stall-opt"  # Eq. 7: caps shifted by +delta


def zero_stall_rate(req: FlowRequest) -> float:
    return req.zero_stall_rate


def per_layer_stall(req: FlowRequest, rate: float) -> float:
    """tau_i(r_i) (Eq. 4).  A zero-byte flow (a hybrid request re-planned to
    pure recompute) never stalls, whatever its rate."""
    if req.bytes_per_layer == 0:
        return 0.0
    if rate <= 0:
        return math.inf
    return max(0.0, req.bytes_per_layer / rate - req.layer_compute_s)


def added_ttft(req: FlowRequest, rate: float) -> float:
    """Stall accumulated over the L-1 overlapped stages of Eq. 3 plus the
    first-layer exposure — the scheduler-visible part of added TTFT."""
    if req.bytes_per_layer == 0:
        return 0.0
    if rate <= 0:
        return math.inf
    x = req.bytes_per_layer / rate
    stall = max(0.0, x - req.layer_compute_s)
    return x + (req.num_layers - 1) * stall


def _waterfill(requests: Sequence[FlowRequest], budget: float,
               caps: Mapping[str, float]) -> dict[str, float]:
    """Exact solution of Eq. 6 by iterative capping.

    Uncapped allocation is r_i = R * sqrt(s_i) / sum_j sqrt(s_j); any request
    whose share meets its cap is fixed there and removed.  Because the sum of
    shares equals the remaining budget, fixing over-cap requests never
    overdraws, and each round strictly shrinks the active set.
    """
    active = list(requests)
    alloc: dict[str, float] = {}
    remaining = budget
    while active:
        denom = sum(math.sqrt(r.bytes_per_layer) for r in active)
        if denom == 0.0 or remaining <= 0.0:
            for r in active:
                alloc[r.req_id] = 0.0
            break
        shares = {r.req_id: remaining * math.sqrt(r.bytes_per_layer) / denom
                  for r in active}
        over = [r for r in active if shares[r.req_id] >= caps[r.req_id]]
        if not over:
            alloc.update(shares)
            break
        for r in over:
            alloc[r.req_id] = caps[r.req_id]
            remaining -= caps[r.req_id]
        active = [r for r in active if r not in over]
    return alloc


def allocate(requests: Sequence[FlowRequest], budget: float, policy: Policy,
             margin: float = 0.0) -> dict[str, float]:
    """Per-request rates (B/s) under a shared cap ``budget`` (B/s).

    ``margin`` is the calibration offset delta of Eq. 7 (B/s); it applies only
    to CAL_STALL_OPT.
    """
    if not requests:
        return {}
    n = len(requests)
    if policy is Policy.EQUAL:
        return {r.req_id: budget / n for r in requests}
    if policy is Policy.KV_PROP:
        total = sum(r.total_bytes for r in requests)
        if total == 0.0:  # all-zero demand: proportionality is undefined
            return allocate(requests, budget, Policy.EQUAL)
        return {r.req_id: budget * r.total_bytes / total for r in requests}
    if policy is Policy.BW_PROP:
        total = sum(r.zero_stall_rate for r in requests)
        if total == 0.0:  # zero slack everywhere: fall back to an even split
            return allocate(requests, budget, Policy.EQUAL)
        return {r.req_id: budget * r.zero_stall_rate / total for r in requests}
    delta = margin if policy is Policy.CAL_STALL_OPT else 0.0
    caps = {r.req_id: r.zero_stall_rate + delta for r in requests}
    if sum(caps.values()) <= budget:
        # Unconstrained: everyone gets its (calibrated) zero-stall rate; the
        # leftover stays idle — extra bandwidth yields no latency benefit.
        return dict(caps)
    return _waterfill(requests, budget, caps)


def total_transfer_time(requests: Sequence[FlowRequest],
                        alloc: Mapping[str, float]) -> float:
    """Objective of Eq. 6 — sum_i s_i / r_i (per layer)."""
    return sum(r.bytes_per_layer / alloc[r.req_id] for r in requests
               if alloc[r.req_id] > 0)


# ---------------------------------------------------------------------------
# Epoch-based pool (§3.6 last paragraph)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Flow:
    req: FlowRequest
    rate: float
    remaining_bytes: float
    done_reported: bool = False


class BandwidthPool:
    """Admits layerwise flows in epochs with stable per-epoch rates.

    If a flow finishes early its bandwidth returns to the pool *at the next
    epoch boundary* rather than being redistributed immediately — per-request
    transfer times stay predictable, so the serving node never reacts to
    unexpected bandwidth changes mid-epoch.

    ``replanner`` is the compute-or-load hook (DESIGN.md §Compute-or-load):
    called as ``replanner(req, rate)`` for every *newly admitted* flow whose
    water-filled rate fell below its zero-stall rate, it may return a reduced
    ``FlowRequest`` (same ``req_id``, fewer demanded bytes, longer compute
    window) for a hybrid fetch+recompute split — the request then asks for
    less bandwidth instead of stalling.  Returning ``None`` keeps the flow
    unchanged.  Demands only ever shrink, so one re-allocation round after
    re-planning can only raise the other flows' rates.
    """

    def __init__(self, budget: float, policy: Policy = Policy.CAL_STALL_OPT,
                 margin: float = 0.0, epoch_s: float = 0.1,
                 replanner: Optional[Callable[[FlowRequest, float],
                                              Optional[FlowRequest]]] = None
                 ) -> None:
        self.budget = budget
        self.policy = policy
        self.margin = margin
        self.epoch_s = epoch_s
        self.replanner = replanner
        self._flows: dict[str, _Flow] = {}
        self._pending: list[FlowRequest] = []
        self._pending_done: list[str] = []
        self._epoch_start = 0.0
        self.epochs = 0
        self.reallocs = 0
        self.replans = 0
        # Observability (DESIGN.md §Observability): a nullable `obs.Tracer`
        # and a nullable stream monitor (`obs.window.StreamMonitor` shape).
        # `reallocate`/`start_epoch` emit instants/samples stamped with the
        # caller's `now` — never a clock read — so attaching either cannot
        # perturb epoch or event timing.
        self.tracer = None
        self.trace_track = "pool"
        self.monitor = None
        # Flow-event causality (Perfetto arrows): every reallocation that
        # starts or reshapes a flow mints a flow id; the sims attach it as
        # `flow_in` on the next wire span of that request.  Plain counters —
        # maintained unconditionally, emitted only when a tracer is attached.
        self._flow_seq = 0
        self.last_flow_ids: dict[str, str] = {}

    def submit(self, req: FlowRequest) -> None:
        self._pending.append(req)

    def rates(self) -> dict[str, float]:
        return {fid: f.rate for fid, f in self._flows.items()}

    # -- event-callback surface (cluster.sim; DESIGN.md §Cluster-sim) ---------
    def live_ids(self) -> set[str]:
        """Flows still transferring (holding bandwidth until reallocation)."""
        return {fid for fid, f in self._flows.items() if f.remaining_bytes > 0}

    def flow_request(self, req_id: str) -> FlowRequest:
        """The admitted (possibly re-planned) request of a flow — the demand
        `reallocate` actually allocated for, which an event-driven caller
        must use for its transfer/compute model."""
        return self._flows[req_id].req

    def remaining_bytes(self, req_id: str) -> float:
        return self._flows[req_id].remaining_bytes

    def complete(self, req_id: str) -> None:
        """Externally-clocked completion (event-driven mode): the caller
        integrated the flow's physical transfer itself and observed it finish.
        The flow's bandwidth returns to the pool at the next `reallocate`
        (same conservative rule as epoch mode); `advance` will not re-report
        it.  A no-op for flows an intervening `reallocate` already retired
        (e.g. a zero-byte pure-recompute flow whose slot turned over before
        the caller's completion event fired)."""
        self._pending_done = [d for d in self._pending_done if d != req_id]
        f = self._flows.get(req_id)
        if f is None:
            return
        f.remaining_bytes = 0.0
        f.done_reported = True

    def start_epoch(self, now: float) -> dict[str, float]:
        """Re-admit pending + surviving flows and fix rates for this epoch."""
        self.epochs += 1
        if self.tracer is not None:
            self.tracer.instant(self.trace_track, "epoch", t=now, cat="pool",
                                epoch=self.epochs)
        return self.reallocate(now)

    def reallocate(self, now: float) -> dict[str, float]:
        """Event-callback core shared by the epoch API and the cluster
        simulator: re-admit pending + surviving flows, re-plan fresh stalling
        flows (compute-or-load hook), and fix rates until the next call.

        Epoch mode calls this on a fixed cadence via `start_epoch`; the
        event-driven simulator calls it at ARRIVE / FLOW_DONE / REALLOC
        events, so joins and leaves re-shape rates at event granularity
        rather than at epoch boundaries."""
        self._epoch_start = now
        self.reallocs += 1
        live = [f.req for f in self._flows.values() if f.remaining_bytes > 0]
        live_ids = {r.req_id for r in live}
        # Deduplicate re-submissions: a pending duplicate of a live flow must
        # not be admitted twice (it would double-count in `allocate` and
        # clobber the flow's transfer state); later duplicates within the
        # pending list lose to the first.
        fresh: list[FlowRequest] = []
        seen: set[str] = set()
        for req in self._pending:
            if req.req_id in live_ids or req.req_id in seen:
                continue
            fresh.append(req)
            seen.add(req.req_id)
        self._pending = []
        # Flows that completed but were never surfaced by advance() (e.g. a
        # zero-byte pure-recompute flow when epochs turn over back-to-back)
        # must not vanish: queue their completion for the next advance() —
        # unless the same id is being re-admitted fresh right now, in which
        # case the restart supersedes the old completion (reporting it would
        # make the in-flight new transfer look done).
        self._pending_done = [fid for fid in self._pending_done
                              if fid not in seen]
        for fid, f in self._flows.items():
            if f.remaining_bytes <= 0 and not f.done_reported:
                f.done_reported = True
                if fid not in seen:
                    self._pending_done.append(fid)
        admitted = live + fresh
        alloc = allocate(admitted, self.budget, self.policy, self.margin)
        if self.replanner is not None:
            replanned = False
            for i, req in enumerate(admitted):
                if req.req_id in live_ids:  # split is fixed once a fetch starts
                    continue
                rate = alloc[req.req_id]
                if rate >= req.zero_stall_rate * (1.0 - 1e-9):
                    continue
                new = self.replanner(req, rate)
                if new is not None and new.req_id == req.req_id \
                        and new.total_bytes < req.total_bytes:
                    admitted[i] = new
                    replanned = True
                    self.replans += 1
            if replanned:
                alloc = allocate(admitted, self.budget, self.policy, self.margin)
        old = self._flows
        self._flows = {}
        self.last_flow_ids = {}
        for req in admitted:
            if req.req_id in live_ids:
                rem = old[req.req_id].remaining_bytes
            else:  # fresh flow (or a finished flow re-submitted: restart it)
                rem = req.total_bytes
            rate = alloc[req.req_id]
            prev = old.get(req.req_id)
            if prev is None or req.req_id not in live_ids \
                    or rate != prev.rate:
                # this realloc started or reshaped the flow: mint the flow
                # id the request's next wire span will consume as `flow_in`
                self._flow_seq += 1
                self.last_flow_ids[req.req_id] = \
                    f"{self.trace_track}:{self._flow_seq}"
            self._flows[req.req_id] = _Flow(req, rate, rem)
        if self.tracer is not None:
            self.tracer.instant(
                self.trace_track, "realloc", t=now, cat="pool",
                live=len(live), fresh=len(fresh), flows=len(self._flows),
                reallocs=self.reallocs, replans=self.replans,
                rates={r.req_id: alloc[r.req_id] for r in admitted},
                flow_ids=dict(self.last_flow_ids))
        if self.monitor is not None:
            self.monitor.inc("pool.reallocs", now)
            self.monitor.observe("pool.flows", now, float(len(self._flows)))
            for req in admitted:
                self.monitor.observe("pool.alloc_bps", now,
                                     alloc[req.req_id])
        return alloc

    def advance(self, dt: float) -> list[str]:
        """Progress all flows by ``dt`` seconds; returns ids that completed.

        Completed flows keep holding their bandwidth until the next
        ``start_epoch`` (the paper's conservative rule).
        """
        done = list(self._pending_done)
        self._pending_done.clear()
        for fid, f in self._flows.items():
            if f.remaining_bytes <= 0:
                # Completion is reported exactly once — including flows that
                # were admitted with zero bytes (a hybrid request re-planned
                # to pure recompute transfers nothing but must still
                # complete, or its caller waits forever).
                if not f.done_reported:
                    f.done_reported = True
                    done.append(fid)
                continue
            f.remaining_bytes -= f.rate * dt
            if f.remaining_bytes <= 0:
                f.remaining_bytes = 0.0
                f.done_reported = True
                done.append(fid)
        return done
