"""The cell runner: set-up, the open-loop window, the check and the metrics.

A cell (``BENCHMARK.json`` ``workloads``) names a configuration file
(``configs/<name>.json``) and a traffic mix (``traffic/<mix>.json``); its
limits are ``limits/<cell>.json``, each metric is read by
``metrics/<metric>.py``, and the configuration's architecture is
``archs/<module>.py``.  Everything is found by name.

One run: weights on the device from the seed; the program's stack
(``Orchestrator(RadixIndex, Gateway(PacedStore), spec, theta_bytes=0)`` and
``ServingEngine``); the store filled by cold ``submit`` calls with the
prefixes the window's schedule and the warm-up use; three warm-up requests
of the mix's own shapes; then the window: requests due on a fixed Poisson
schedule enter one FIFO in front of ``ServingEngine.submit(tokens,
max_new_tokens=0)`` (the prefill pool of a disaggregated deployment: the
first token's logits are the answer), each timed from its due time to the
return of its logits.  A request due in the window that has not started by
its close is shed; the one in flight finishes.  Then the program's state is
freed and the reference judges a sample of the answers.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ocbench import archs, check, devtrace, weights
from ocbench.devtrace import Profile
from ocbench.store import PacedStore, wait_until
from ocbench.traffic import Request, Tokens, schedule, warmup_requests

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
PROFILED = 12  # requests under the profiler in a traced run


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    metrics: list[dict]  # end-to-end, then per-layer, of this cell

    def metric_specs(self, trace: bool) -> list[dict]:
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.metrics if m["kind"] == kind]


def _read(path: Path) -> dict:
    return json.loads(path.read_text())


def load_cell(workload: str) -> Cell:
    bench = _read(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json "
                         f"has {sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer")
               for m in bench[kind] if workload in m.get("workloads",
                                                         [workload])]
    return Cell(workload, w["chips"], _read(ROOT / conf["file"]),
                _read(HERE / "traffic" / f"{w['traffic']}.json"),
                _read(HERE / "limits" / f"{workload}.json"), metrics)


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file
    (``archs/<module>.py`` ``program_config``)."""
    return archs.of(cfg).program_config(cfg)


@dataclasses.dataclass
class Stack:
    """The program under test with its store, and the run's inputs."""
    cfg: dict
    params: dict
    engine: object
    store: PacedStore
    tokens: Tokens
    tracer: object
    device: torch.device

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def set_up(cell: Cell, seed: int, device, trace: bool,
           reqs: list[Request] | None = None) -> Stack:
    """Weights, the program's stack, the store filled with the prefixes that
    ``reqs`` (every prefix where None) and the warm-up requests use, and
    the warm-up requests."""
    from repro_torch.core import Gateway, RadixIndex
    from repro_torch.models import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serving import Orchestrator, ServingEngine

    t0 = time.perf_counter()
    cfg = cell.config
    mcfg = model_config(cfg)
    model = build_model(mcfg, device)
    params = weights.make(cfg, seed, model.device)
    wrong = weights.same_layout(params, model.param_spec())
    if wrong:
        raise ValueError(f"the program's parameter tree differs: {wrong}")
    G = cfg["chunk_tokens"]
    spec = mcfg.kv_spec(G, dtype_bytes=weights.dtype(cfg).itemsize,
                        codec=cfg["codec"])
    tracer = Tracer() if trace else None
    store = PacedStore(cfg["link_gbps"])
    orch = Orchestrator(RadixIndex(G), Gateway(store), spec, theta_bytes=0,
                        tracer=tracer)
    engine = ServingEngine(model, params, orch,
                           kv_resident=cfg["kv_resident"], tracer=tracer)
    stack = Stack(cfg, params, engine, store,
                  Tokens(cell.mix, seed, cfg["vocab_size"]), tracer,
                  model.device)
    stack.sync()
    t1 = time.perf_counter()
    warm = warmup_requests(cell.mix)
    if reqs is None:
        used = range(len(stack.tokens.prefixes))
    else:
        used = sorted({r.prefix for r in warm + reqs if r.prefix >= 0})
    for p in used:
        engine.submit(stack.tokens.prefixes[p], req_id=f"fill{p}")
    t2 = time.perf_counter()
    for r in warm:
        engine.submit(stack.tokens.warm_prompt(r), req_id=f"warm{r.index}")
    print(f"set-up: weights and stack {t1 - t0:.2f} s, fill of {len(used)} "
          f"of {len(stack.tokens.prefixes)} prefixes {t2 - t1:.2f} s, "
          f"warm-up {time.perf_counter() - t2:.2f} s", file=sys.stderr)
    if trace and stack.device.type == "cuda":
        # the profiler's first use sets up device tracing: pay it here
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]):
            torch.ones(1, device=stack.device).add_(1)
            stack.sync()
    stack.sync()
    return stack


@dataclasses.dataclass
class Served:
    """One request of the window: its schedule entry, times on the host's
    clock (None where it never started, being shed, or never finished), the
    prefix tokens the program reused, and its last-token logits over the
    vocabulary."""
    req: Request
    due: float
    start: float | None = None
    end: float | None = None
    matched: int = 0
    logits: np.ndarray | None = None
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.end is not None and not self.error

    @property
    def attempted(self) -> bool:
        return self.start is not None


def serve(stack: Stack, reqs: list[Request], seconds: float,
          profile: Profile | None = None) -> tuple[float, list[Served]]:
    """The open loop: each request enters at its due time and waits behind
    the ones before it; one not started by the window's close is shed.  The
    profiler, if any, covers ``PROFILED`` requests from the first that
    starts a third into the window.  Returns the window's start and every
    request's record."""
    V = stack.cfg["vocab_size"]
    t0 = time.perf_counter()
    close = t0 + seconds
    profiled = 0
    out = []
    for r in reqs:
        s = Served(r, t0 + r.due_s)
        out.append(s)
        wait_until(s.due)
        if time.perf_counter() > close:
            continue
        if profile is not None and not profiled and \
                time.perf_counter() >= t0 + seconds / 3:
            profile.start()
        s.start = time.perf_counter()
        try:
            res = stack.engine.submit(stack.tokens.prompt(r),
                                      req_id=f"r{r.index}")
        except Exception:  # one request's failure is a result, not a crash
            s.error = traceback.format_exc()
            print(f"request {r.index} failed:\n{s.error}", file=sys.stderr)
        else:
            s.end = time.perf_counter()
            s.logits = np.array(res.logits[:V], dtype=np.float32)
            s.matched = res.matched_tokens
        if profile is not None and profile.running:
            profiled += 1
            if profiled == PROFILED:
                profile.stop()
    if profile is not None and profile.running:
        profile.stop()
    return t0, out


@dataclasses.dataclass
class RunRecord:
    """What the metric readers read (``metrics/<name>.py``)."""
    cfg: dict
    seconds: float
    setup_s: float
    t0: float  # the window's start on the host's clock
    served: list[Served]
    spans: list  # the engine's tracer spans of the window's requests
    profile: Profile | None

    def request_spans(self, name: str) -> dict[int, list[float]]:
        """Durations of the engine spans ``name`` by request index."""
        out: dict[int, list[float]] = {}
        for sp in self.spans:
            if sp.name == name and sp.track.startswith("r") \
                    and sp.track[1:].isdigit():
                out.setdefault(int(sp.track[1:]), []).append(sp.t1 - sp.t0)
        return out


def load_reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "ocbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def breakdown(run: RunRecord) -> dict:
    P = devtrace
    prof = run.profile
    gaps = P.idle_gaps(prof.device, prof.t0, prof.t1)
    engine = {}
    for sp in run.spans:
        if prof.t0 <= sp.t0 < prof.t1 and "/" not in sp.track:
            engine.setdefault(sp.name, []).append((sp.t0, sp.t1))
    submits = [(s.start, s.end) for s in run.served if s.ok]
    labelled = sorted(engine.items()) + [("submit, outside the engine's "
                                          "spans", submits)]
    return {"device_ops": P.top_device_ops(prof.device),
            "idle_gaps": P.idle_by_host(gaps, labelled)}


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float | None = None) -> dict:
    """One run of ``cell``; returns the result's fields (``checks`` last)
    and, on a card, the device's."""
    t_start = time.perf_counter() if t_start is None else t_start
    reqs = schedule(cell.mix, seconds)
    stack = set_up(cell, seed, device, trace, reqs)
    setup_s = time.perf_counter() - t_start
    stack.tokens.draw(reqs)
    if stack.tracer is not None:
        stack.tracer.clear()
    before = stack.store.stats.snapshot()
    prof = Profile() if trace else None
    t0, served = serve(stack, reqs, seconds, prof)
    stack.sync()
    after = stack.store.stats.snapshot()
    on_card = stack.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(stack.device) if on_card else 0
    spans = stack.tracer.spans() if stack.tracer is not None else []
    # the program's state goes before the reference runs
    params, tokens = stack.params, stack.tokens
    del stack
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check.judge(cell, params, tokens, served, before, after, seed)
    print(f"check: {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    run = RunRecord(cell.config, seconds, setup_s, t0, served, spans, None)
    device_info = {}
    bd = None
    if prof is not None and prof.t1 > prof.t0:
        path = Path(tempfile.gettempdir()) / "ocbench" / \
            f"{cell.name}.{seed}.trace.json"
        prof.reduce(path)
        run.profile = prof
        device_info = {"busy_s": devtrace.busy_s(prof.device, prof.t0,
                                                 prof.t1),
                       "window_s": prof.t1 - prof.t0}
        bd = breakdown(run)
    metrics = {}
    for m in cell.metric_specs(trace):
        v = load_reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    tried = [s for s in served if s.attempted]
    return {"correct": all(v <= lim for v, lim in checks.values()),
            "attempted": len(tried),
            "failed": sum(not s.ok for s in tried), "metrics": metrics,
            "memory_peak_bytes": peak, "device": device_info,
            "breakdown": bd, "checks": checks}

