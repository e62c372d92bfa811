"""Per-tenant SLO targets with multi-window burn-rate evaluation.

The paper's headline claims are *tail* claims — added TTFT at p95 under a
shared bandwidth cap (§5.7) — so the live question an operator asks is not
"what is the mean" but "is this tenant's tail budget burning faster than
its error budget allows".  This module answers it the standard SRE way
(multi-window, multi-burn-rate alerting):

* An `SLOTarget` declares what *good* means for a tenant: a TTFT ceiling
  (``ttft_s``, the p-style threshold a request must beat) and/or an
  added-TTFT budget (``added_ttft_s``, measured against the request's own
  queue+stall overhead), plus a ``goal`` fraction (e.g. 0.95 — at most 5 %
  of requests may be bad).
* The **burn rate** over a window is ``bad_fraction / (1 - goal)``:
  burn 1.0 means "exactly spending the error budget"; burn 2.0 means the
  budget is burning twice as fast as sustainable.
* A **breach** fires only when burn exceeds the threshold on **both** a
  short and a long window — the short window gives fast detection, the
  long window suppresses one-off blips (the classic two-window AND).

Like everything in `repro.obs`, evaluation is explicit-time: requests are
recorded at their completion event time, and window membership comes from
`window.window_index` on that time — no wall clock, zero perturbation.
When a tracer is attached, state *transitions* (ok→breach, breach→ok)
emit ``slo_breach`` / ``slo_recover`` instants onto the ``slo`` track at
the event time that caused them, so breaches land on the same timeline as
the spans that explain them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from .window import window_index


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """What *good* means for one tenant ("" = the fleet-wide default)."""

    tenant: str = ""
    ttft_s: Optional[float] = None        # good: ttft <= ttft_s
    added_ttft_s: Optional[float] = None  # good: queue+stall <= added_ttft_s
    goal: float = 0.95                    # fraction of requests that must be good

    def __post_init__(self) -> None:
        if not 0.0 < self.goal < 1.0:
            raise ValueError(f"goal must be in (0, 1), got {self.goal}")
        if self.ttft_s is None and self.added_ttft_s is None:
            raise ValueError("SLOTarget needs ttft_s and/or added_ttft_s")

    def is_good(self, ttft_s: float, added_ttft_s: float) -> bool:
        if self.ttft_s is not None and ttft_s > self.ttft_s:
            return False
        if self.added_ttft_s is not None and added_ttft_s > self.added_ttft_s:
            return False
        return True


class _WindowCounts:
    """good/bad counts per absolute window index for one target."""

    def __init__(self, width_s: float) -> None:
        self.width_s = width_s
        self.good: dict[int, int] = {}
        self.bad: dict[int, int] = {}

    def record(self, t: float, good: bool) -> None:
        k = window_index(t, self.width_s)
        d = self.good if good else self.bad
        d[k] = d.get(k, 0) + 1

    def burn(self, t: float, span_windows: int, goal: float) -> float:
        """Burn rate over the last ``span_windows`` windows ending at the
        window containing ``t``; NaN when the span saw no requests."""
        hi = window_index(t, self.width_s)
        lo = hi - span_windows + 1
        g = sum(n for k, n in self.good.items() if lo <= k <= hi)
        b = sum(n for k, n in self.bad.items() if lo <= k <= hi)
        if g + b == 0:
            return math.nan
        return (b / (g + b)) / (1.0 - goal)


@dataclasses.dataclass
class _TargetState:
    target: SLOTarget
    counts: _WindowCounts
    breached: bool = False
    breaches: int = 0
    total: int = 0
    bad: int = 0


class SLOMonitor:
    """Multi-window burn-rate evaluator over per-request completions.

    Duck-typed like `window.StreamMonitor` (``record_request(t, rec)``,
    ``spawn()``) so sims can carry either — or both via `MultiMonitor`.
    A request is evaluated against its tenant's target if one exists, else
    against the default ("" tenant) target if declared.

    ``short_windows``/``long_windows`` are the two AND-ed evaluation spans
    in units of ``width_s`` windows; ``burn_threshold`` is the rate both
    must exceed (1.0 = budget-neutral pace).
    """

    TRACK = "slo"

    def __init__(self, targets, *, width_s: float = 1.0,
                 short_windows: int = 1, long_windows: int = 5,
                 burn_threshold: float = 1.0, tracer=None) -> None:
        if short_windows <= 0 or long_windows < short_windows:
            raise ValueError("need 0 < short_windows <= long_windows")
        self.width_s = width_s
        self.short_windows = short_windows
        self.long_windows = long_windows
        self.burn_threshold = burn_threshold
        self.tracer = tracer
        self._states: dict[str, _TargetState] = {}
        for tgt in targets:
            if tgt.tenant in self._states:
                raise ValueError(f"duplicate target for tenant "
                                 f"{tgt.tenant!r}")
            self._states[tgt.tenant] = _TargetState(
                tgt, _WindowCounts(width_s))

    def spawn(self) -> "SLOMonitor":
        return SLOMonitor(
            [s.target for s in self._states.values()],
            width_s=self.width_s, short_windows=self.short_windows,
            long_windows=self.long_windows,
            burn_threshold=self.burn_threshold, tracer=self.tracer)

    # -- ingest ---------------------------------------------------------------
    def observe(self, name, t, v, tenant: str = "", n: int = 1) -> None:
        """Free-form series are not SLO inputs; accepted for monitor
        duck-type compatibility."""

    def inc(self, name, t, n: int = 1, tenant: str = "") -> None:
        """See `observe`."""

    def record_request(self, t: float, rec) -> None:
        tenant = getattr(rec, "tenant", "") or ""
        self.record(t, tenant=tenant, ttft_s=rec.ttft_s,
                    added_ttft_s=rec.queue_s + rec.stall_s)

    def record(self, t: float, *, tenant: str = "", ttft_s: float,
               added_ttft_s: float = 0.0) -> None:
        state = self._states.get(tenant)
        if state is None:
            state = self._states.get("")
        if state is None:
            return
        good = state.target.is_good(ttft_s, added_ttft_s)
        state.counts.record(t, good)
        state.total += 1
        if not good:
            state.bad += 1
        self._evaluate(state, t)

    # -- evaluation -----------------------------------------------------------
    def burn_rates(self, tenant: str, t: float) -> tuple[float, float]:
        state = self._states[tenant]
        goal = state.target.goal
        return (state.counts.burn(t, self.short_windows, goal),
                state.counts.burn(t, self.long_windows, goal))

    def _evaluate(self, state: _TargetState, t: float) -> None:
        short, long = self.burn_rates(state.target.tenant, t)
        breaching = (not math.isnan(short) and not math.isnan(long)
                     and short > self.burn_threshold
                     and long > self.burn_threshold)
        if breaching == state.breached:
            return
        state.breached = breaching
        if breaching:
            state.breaches += 1
        if self.tracer is not None:
            name = "slo_breach" if breaching else "slo_recover"
            self.tracer.instant(
                self.TRACK, name, t=t, cat="slo",
                tenant=state.target.tenant,
                burn_short=short, burn_long=long,
                threshold=self.burn_threshold, goal=state.target.goal)

    # -- queries --------------------------------------------------------------
    def tenants(self) -> list[str]:
        return sorted(self._states)

    def breached(self, tenant: str = "") -> bool:
        return self._states[tenant].breached

    def status(self, t: Optional[float] = None) -> dict:
        """Per-tenant SLO posture; burn rates evaluated at ``t`` when
        given (else lifetime totals only)."""
        out: dict = {}
        for tenant, state in sorted(self._states.items()):
            entry = {
                "goal": state.target.goal,
                "total": state.total,
                "bad": state.bad,
                "bad_fraction": (state.bad / state.total
                                 if state.total else math.nan),
                "breached": state.breached,
                "breaches": state.breaches,
            }
            if t is not None:
                short, long = self.burn_rates(tenant, t)
                entry["burn_short"] = short
                entry["burn_long"] = long
            out[tenant] = entry
        return out
