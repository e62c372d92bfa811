"""Trace export: Chrome trace-event JSON (Perfetto-loadable) + text waterfall.

`to_chrome_trace` maps a `Tracer`'s records onto the Chrome trace-event
*JSON object format* (the dialect both chrome://tracing and Perfetto load):
spans become ``ph:"X"`` complete events, instants ``ph:"i"``, and every
process/track gets ``ph:"M"`` metadata naming it.  Track names of the form
``"<proc>/<rest>"`` (the fleet's per-node ``"n0/req-3"`` convention) split
into process = ``<proc>``, thread = ``<rest>``, so a fleet trace renders as
one swimlane group per node.

Timestamps are exported in integer-free microseconds exactly as recorded
(floats; the format allows fractional ts) and events are ordered by
``(ts, seq)`` — a deterministic tracer therefore exports byte-identical
JSON.

Cross-track causality exports as Chrome *flow events* (arrows in the
Perfetto UI): a `BandwidthPool` realloc instant carrying a ``flow_ids``
arg (flow id per started/reshaped request) becomes a ``ph:"s"`` flow
start, and every wire span carrying a matching ``flow_in`` arg becomes a
``ph:"f"`` (binding-point ``"e"``) flow finish at the span it reshaped —
so "this realloc is why that wire span's rate changed" renders as an
arrow from the pool track to the request track.  Only matched pairs are
emitted (a realloc whose flows produced no span, or vice versa, adds no
dangling arrow).

`validate_chrome_trace` is the schema check CI runs against the exported
artifact: structural requirements of the trace-event format (required keys
per phase, value types, non-negative durations, metadata shape).  It
returns a list of human-readable violations — empty means loadable.

`render_waterfall` is the terminal view of the same data: one row per span
of a request's containment tree (indented by nesting depth), with a bar
scaled to the track's time extent — the TTFT waterfall of DESIGN.md
§Observability.
"""
from __future__ import annotations

import json
from typing import Optional

from .trace import Instant, Span, Tracer

_VALID_PH = {"X", "B", "E", "i", "I", "M", "C", "b", "e", "n", "s", "t", "f"}
_INSTANT_SCOPES = {"g", "p", "t"}


def _split_track(track: str) -> tuple[str, str]:
    """``"n0/req"`` -> (process "n0", thread "req"); bare tracks map to the
    default process."""
    if "/" in track:
        proc, rest = track.split("/", 1)
        return proc, rest
    return "repro", track


def to_chrome_trace(tracer: Tracer, *, unit_s: float = 1e-6) -> dict:
    """Render the tracer's records as a Chrome trace-event JSON object.

    ``unit_s`` is the duration of one exported ``ts`` unit (default 1 µs,
    the format's native unit).
    """
    pids: dict[str, int] = {}
    tids: dict[str, int] = {}
    events: list[dict] = []

    def ids(track: str) -> tuple[int, int]:
        proc, thread = _split_track(track)
        if proc not in pids:
            pids[proc] = len(pids) + 1
            events.append({"name": "process_name", "ph": "M",
                           "pid": pids[proc], "tid": 0,
                           "args": {"name": proc}})
        if track not in tids:
            tids[track] = len(tids) + 1
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pids[proc], "tid": tids[track],
                           "args": {"name": thread}})
        return pids[proc], tids[track]

    # pass 1: which flow ids have both a producer (realloc instant with
    # "flow_ids") and a consumer (span with "flow_in")?  Only matched pairs
    # export — no dangling arrows.
    produced: set = set()
    consumed: set = set()
    for rec in tracer.records:
        if isinstance(rec, Span):
            fid = rec.args.get("flow_in")
            if fid is not None:
                consumed.add(fid)
        else:
            for fid in (rec.args.get("flow_ids") or {}).values():
                produced.add(fid)
    live_flows = produced & consumed

    body: list[tuple[float, int, dict]] = []
    for rec in tracer.records:
        pid, tid = ids(rec.track)
        if isinstance(rec, Span):
            ev = {"name": rec.name, "cat": rec.cat or "trace", "ph": "X",
                  "ts": rec.t0 / unit_s, "dur": rec.dur_s / unit_s,
                  "pid": pid, "tid": tid}
        else:
            ev = {"name": rec.name, "cat": rec.cat or "trace", "ph": "i",
                  "ts": rec.t / unit_s, "s": "t", "pid": pid, "tid": tid}
        if rec.args:
            ev["args"] = {k: _jsonable(v) for k, v in rec.args.items()}
        body.append((ev["ts"], rec.seq, ev))
        # pass 2 (inline; stable sort keeps flow events right after their
        # source record): emit the s/f halves of each matched flow
        if isinstance(rec, Span):
            fid = rec.args.get("flow_in")
            if fid in live_flows:
                # bind at the span's END: a reshaped wire span *starts*
                # before the realloc that reshaped it, but its crossing is
                # always after — flow arrows must run forward in time
                body.append((ev["ts"] + ev["dur"], rec.seq,
                             {"name": "realloc", "cat": "flow", "ph": "f",
                              "bp": "e", "id": str(fid),
                              "ts": ev["ts"] + ev["dur"],
                              "pid": pid, "tid": tid}))
        else:
            for fid in (rec.args.get("flow_ids") or {}).values():
                if fid in live_flows:
                    body.append((ev["ts"], rec.seq,
                                 {"name": "realloc", "cat": "flow",
                                  "ph": "s", "id": str(fid),
                                  "ts": ev["ts"], "pid": pid, "tid": tid}))
    body.sort(key=lambda e: (e[0], e[1]))
    events.extend(ev for _, _, ev in body)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return repr(v)


def write_chrome_trace(tracer: Tracer, path: str) -> dict:
    doc = to_chrome_trace(tracer)
    with open(path, "w") as f:
        json.dump(doc, f, indent=None, separators=(",", ":"))
    return doc


# ---------------------------------------------------------------------------
# Schema validation (the CI gate for exported artifacts)
# ---------------------------------------------------------------------------
def validate_chrome_trace(doc) -> list[str]:
    """Structural check against the Chrome trace-event JSON object format.

    Returns a list of violations (empty = valid).  Checks: top-level shape,
    per-event required keys by phase, value types, non-negative ts/dur,
    instant scope, metadata-event shape, and flow-event pairing (every
    flow id must have a start and a finish, with the start no later than
    any step/finish carrying the same (cat, name, id)).
    """
    errors: list[str] = []
    if not isinstance(doc, dict):
        return [f"top level must be an object, got {type(doc).__name__}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-list 'traceEvents'"]
    flow_starts: dict = {}   # (cat, name, id) -> earliest start ts
    flow_others: dict = {}   # (cat, name, id) -> [(ph, ts, index), ...]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or ph not in _VALID_PH:
            errors.append(f"{where}: bad phase {ph!r}")
            continue
        if not isinstance(ev.get("name"), str):
            errors.append(f"{where}: missing/non-string 'name'")
        for key in ("pid", "tid"):
            if not isinstance(ev.get(key), int):
                errors.append(f"{where}: missing/non-int {key!r}")
        if ph == "M":
            if ev.get("name") in ("process_name", "thread_name") and \
                    not isinstance(ev.get("args", {}).get("name"), str):
                errors.append(f"{where}: metadata needs args.name string")
            continue
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or isinstance(ts, bool) or ts < 0:
            errors.append(f"{where}: missing/negative 'ts'")
        if "cat" in ev and not isinstance(ev["cat"], str):
            errors.append(f"{where}: non-string 'cat'")
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"{where}: non-object 'args'")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or isinstance(dur, bool) \
                    or dur < 0:
                errors.append(f"{where}: 'X' event needs non-negative 'dur'")
        elif ph in ("i", "I"):
            if ev.get("s", "t") not in _INSTANT_SCOPES:
                errors.append(f"{where}: bad instant scope {ev.get('s')!r}")
        elif ph in ("s", "t", "f"):
            fid = ev.get("id")
            if not isinstance(fid, (str, int)) or isinstance(fid, bool):
                errors.append(f"{where}: flow event needs str/int 'id'")
                continue
            key = (ev.get("cat"), ev.get("name"), fid)
            if ph == "s":
                prev = flow_starts.get(key)
                if prev is not None:
                    errors.append(f"{where}: duplicate flow start for "
                                  f"id {fid!r}")
                else:
                    flow_starts[key] = ts
            else:
                flow_others.setdefault(key, []).append((ph, ts, i))
    # flow pairing: every start needs a finish and vice versa, and the
    # start must not postdate any of its steps/finishes
    for key, others in flow_others.items():
        start_ts = flow_starts.get(key)
        for ph, ts, i in others:
            if start_ts is None:
                errors.append(f"traceEvents[{i}]: flow '{ph}' for id "
                              f"{key[2]!r} has no matching 's' start")
            elif isinstance(ts, (int, float)) and ts < start_ts:
                errors.append(f"traceEvents[{i}]: flow '{ph}' for id "
                              f"{key[2]!r} precedes its start "
                              f"({ts} < {start_ts})")
    for key, start_ts in flow_starts.items():
        phases = [ph for ph, _, _ in flow_others.get(key, [])]
        if "f" not in phases:
            errors.append(f"flow start id {key[2]!r} has no matching 'f' "
                          f"finish")
    return errors


def assert_valid_chrome_trace(doc) -> None:
    errors = validate_chrome_trace(doc)
    if errors:
        raise ValueError("invalid Chrome trace: " + "; ".join(errors[:10]))


# ---------------------------------------------------------------------------
# Text TTFT waterfall
# ---------------------------------------------------------------------------
def render_waterfall(tracer: Tracer, track: str, width: int = 56,
                     t0: Optional[float] = None,
                     t1: Optional[float] = None) -> str:
    """ASCII waterfall of one track's span tree.

    One row per span, indented by containment depth, with a ``#`` bar
    positioned on the ``[t0, t1]`` window (default: the track's extent).
    Times print in milliseconds relative to the window start.
    """
    roots = tracer.span_tree(track)
    rows = [(d, s) for r in roots for d, s in r.walk()]
    if not rows:
        return f"(no spans on track {track!r})"
    lo = min(s.t0 for _, s in rows) if t0 is None else t0
    hi = max(s.t1 for _, s in rows) if t1 is None else t1
    ext = max(hi - lo, 1e-12)
    label_w = max(len("  " * d + s.name) for d, s in rows) + 2
    out = [f"track {track}  [{(hi - lo) * 1e3:.3f} ms]"]
    for d, s in rows:
        a = int(round((s.t0 - lo) / ext * width))
        b = max(int(round((s.t1 - lo) / ext * width)), a + 1)
        bar = " " * a + "#" * (b - a) + " " * (width - b)
        label = ("  " * d + s.name).ljust(label_w)
        out.append(f"{label}|{bar}| {(s.t0 - lo) * 1e3:9.3f} ms "
                   f"+{s.dur_s * 1e3:8.3f} ms")
    return "\n".join(out)


# ---------------------------------------------------------------------------
# CLI: python -m repro.obs.export --validate trace.json
# ---------------------------------------------------------------------------
def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--validate":
        with open(argv[1]) as f:
            doc = json.load(f)
        errors = validate_chrome_trace(doc)
        if errors:
            for e in errors[:50]:
                print("SCHEMA:", e)
            return 1
        n = len(doc["traceEvents"])
        print(f"OK: {argv[1]} is valid Chrome trace-event JSON ({n} events)")
        return 0
    print("usage: python -m repro.obs.export --validate <trace.json>")
    return 2


if __name__ == "__main__":  # pragma: no cover - exercised via subprocess
    import sys
    raise SystemExit(main(sys.argv[1:]))
