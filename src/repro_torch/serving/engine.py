"""Serving engine with ObjectCache layerwise prefill, in PyTorch.

Port of the reference's ``serving/engine.py``.  The paper's execution pattern
(§4.2): the inference framework waits for layer-ready notifications and
proceeds as soon as the next layer's KV has arrived.  Prefill runs *per
layer* so the engine can consume the storage server's layer events exactly
like vLLM+LMCache consume NIXL notifications.

Two timelines are tracked and composed with the Eq. 3 pipeline:
  * transfer: the calibrated transport model's layer-ready times (the 100 Gbps
    target cluster), from core.aggregation;
  * compute: REAL wall-clock of the layer steps on the engine's device.  On a
    CUDA device every timed region ends in ``torch.cuda.synchronize``, or it
    would time kernel launches only.
Bytes are real end-to-end: KV leaves prefill as KV_L2TD objects, round-trips
the object store, and re-enters attention as prefix KV.

Families: dense and vlm stream layerwise.  The quantized-resident variant
(``kv_resident="packed"``) is the next slice of the port (ROADMAP.md).

When the orchestrator carries a compute-or-load planner, `_serve_hybrid`
fetches only the planner's fetch-span and recomputes the rest with the suffix
(DESIGN.md §Compute-or-load).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import Delivery
from repro_torch.core.hashing import chunk_keys
from repro_torch.core.overlap import per_layer_stalls, pipeline_ttft
from repro_torch.hybrid.executor import HybridPlan, fetch_span_plan
from repro_torch.models import Model
from repro_torch.models import dense
from repro_torch.models import layers as nn
from repro_torch.obs.metrics import MetricsRegistry

from .kv_chunks import (cache_to_chunks, layer_payload_to_device_kv,
                        prefix_kv_from_payloads)
from .orchestrator import Orchestrator


@dataclasses.dataclass
class RequestResult:
    req_id: str
    logits: np.ndarray  # last-token logits [V]
    new_tokens: list[int]
    matched_tokens: int
    delivery: Optional[Delivery]
    ttft_model_s: float  # Eq. 3-composed TTFT (transfer model + real compute)
    compute_s: float  # real wall compute
    transfer_completion_s: float
    stalls_s: list[float]

    @property
    def hit(self) -> bool:
        return self.matched_tokens > 0


_ENGINE_FIELDS = ("requests", "prefix_tokens_reused", "tokens_computed",
                  "commits")


def EngineStats(registry: Optional[MetricsRegistry] = None):
    """Engine counters as a registry-backed `obs.metrics.StatGroup`:
    multi-field updates go through one atomic :meth:`StatGroup.add`, and
    ``snapshot()`` is a consistent cut."""
    return (registry or MetricsRegistry()).group("engine", _ENGINE_FIELDS)


class ModelRunner:
    """The per-step callables of one (model, params) pair.

    Shared by every engine that serves the model.  Stateless beyond the
    parameters, so one runner may back any number of engines.
    """

    def __init__(self, model: Model, params) -> None:
        self.model = model
        self.params = params
        self.cfg = model.cfg
        self.device = model.device

    def sync(self) -> None:
        """Wait for the device, so a host clock read after it times the
        work and not its launch."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def embed(self, tokens):
        return nn.embed(self.params["embed"], self.cfg, tokens)

    def layer(self, layer_p, x, pk, pv, positions):
        h, seg = dense.block(layer_p, self.cfg, x, positions, (pk, pv))
        return h, seg[0], seg[1]

    def final(self, x):
        h = nn.rmsnorm(self.params["final_norm"], x[:, -1:, :])
        return nn.logits(self.params["embed"], self.cfg, h)[:, 0, :]

    def prefill(self, batch, prefix=None, prefix_len: int = 0):
        return self.model.prefill(self.params, batch, prefix, prefix_len)

    def decode(self, cache, token, pos):
        return self.model.decode_step(self.params, cache, token, pos)

    def layer_params(self, l: int):
        return dense.layer_params(self.params, l)

    def payloads_to_prefix(self, payloads, n_chunks: int, spec):
        return prefix_kv_from_payloads(payloads, n_chunks, spec,
                                       nn.dt(self.cfg), self.device)


class ServingEngine:
    def __init__(self, model: Model, params, orch: Orchestrator, *,
                 max_decode_len: int = 64, sync_commit: bool = True,
                 metrics: Optional[MetricsRegistry] = None,
                 tracer=None, runner: Optional[ModelRunner] = None,
                 kv_resident: str = "fp") -> None:
        self.model = model
        self.params = params
        self.orch = orch
        self.cfg = model.cfg
        self.device = model.device
        self.spec = orch.spec
        self.sync_commit = sync_commit
        self.max_decode_len = max_decode_len
        if kv_resident == "packed":
            raise NotImplementedError(
                "kv_resident='packed' (quantized-resident prefixes with the "
                "fused dequant-attention kernels) is the next slice of the "
                "port; see ROADMAP.md")
        if kv_resident != "fp":
            raise ValueError(f"kv_resident must be 'fp' or 'packed', "
                             f"got {kv_resident!r}")
        self.kv_resident = kv_resident
        # one registry per serving stack: default to the orchestrator's so
        # engine + orch counters snapshot as a single consistent cut
        self.metrics = metrics if metrics is not None else orch.metrics
        self.stats = EngineStats(self.metrics)
        # wall-clock tracer (obs.trace.Tracer); shared with the orchestrator
        # unless the caller splits them.  Nullable: `if tracer is not None`
        # guards keep the uninstrumented path at one attribute test.
        self.tracer = tracer if tracer is not None else orch.tracer
        self.runner = runner if runner is not None else ModelRunner(model,
                                                                    params)
        self._last_cache = None

    # ------------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)[None, :]

    def submit(self, tokens: np.ndarray, req_id: str = "req",
               max_new_tokens: int = 0, layer_compute_hint_s: float = 1e-3
               ) -> RequestResult:
        """Serve one request: match -> (fetch | recompute) -> prefill ->
        greedy decode -> commit fresh chunks."""
        tokens = np.asarray(tokens, dtype=np.int32)
        self.stats.add(requests=1)
        if self.tracer is not None:
            with self.tracer.span(req_id, "plan", cat="engine") as a:
                plan = self.orch.plan(tokens, layer_compute_hint_s,
                                      req_id=req_id)
                a["matched_chunks"] = plan.match.num_chunks
        else:
            plan = self.orch.plan(tokens, layer_compute_hint_s, req_id=req_id)
        match = plan.match
        # the orchestrator already trimmed full-prompt matches (>= 1 suffix
        # token stays), so the plan's chunk count IS the reusable count
        n_chunks = match.num_chunks
        P = n_chunks * self.spec.chunk_tokens
        use_cache = plan.delivery is not None and n_chunks > 0

        if not use_cache:
            result = self._serve_full(tokens, req_id)
        elif isinstance(plan, HybridPlan):
            result = self._serve_hybrid(tokens, plan, n_chunks, req_id)
        elif plan.delivery is Delivery.LAYERWISE:
            result = self._serve_layerwise(tokens, plan, n_chunks, P, req_id)
        else:
            result = self._serve_chunkwise(tokens, plan, n_chunks, P, req_id)

        # the fetch is over: retire the pool flow, or every served request
        # would keep holding (and shrinking) the shared bandwidth forever
        if plan.delivery is not None:
            self.orch.release(req_id)

        self.stats.add(prefix_tokens_reused=result.matched_tokens,
                       tokens_computed=len(tokens) - result.matched_tokens)
        self.metrics.histogram("engine.ttft_model_s").observe(
            result.ttft_model_s)
        self.metrics.histogram("engine.compute_s").observe(result.compute_s)
        if self.tracer is not None:
            self.tracer.instant(
                req_id, "served", cat="engine",
                matched_tokens=result.matched_tokens,
                delivery=(result.delivery.name if result.delivery is not None
                          else "none"),
                ttft_model_s=result.ttft_model_s,
                compute_s=result.compute_s)

        if max_new_tokens > 0:
            result.new_tokens = self._greedy_decode(
                result, tokens, max_new_tokens)
        return result

    # ------------------------------------------------------------------
    def _host_logits(self, lg) -> np.ndarray:
        return lg[0].float().cpu().numpy()

    def _serve_full(self, tokens, req_id) -> RequestResult:
        batch = {"tokens": self._tokens(tokens)}
        t0 = time.perf_counter()
        lg, cache = self.runner.prefill(batch)
        self.runner.sync()
        dt = time.perf_counter() - t0
        lg = self._host_logits(lg)
        if self.tracer is not None:
            self.tracer.span_at(req_id, "compute", t0, t0 + dt, cat="engine")
        self._commit(tokens, cache, req_id)
        self._last_cache = cache
        return RequestResult(req_id, lg, [], 0, None, dt, dt, 0.0, [])

    def _fetch(self, plan, n_chunks, req_id):
        if self.tracer is not None:
            with self.tracer.span(req_id, "fetch", cat="engine") as a:
                res = self.orch.fetch(self._trim_plan(plan, n_chunks))
                a["completion_s"] = res.completion_s
            return res
        return self.orch.fetch(self._trim_plan(plan, n_chunks))

    def _serve_chunkwise(self, tokens, plan, n_chunks, P, req_id
                         ) -> RequestResult:
        res = self._fetch(plan, n_chunks, req_id)
        prefix = self.runner.payloads_to_prefix(res.payloads, n_chunks,
                                                self.spec)
        batch = {"tokens": self._tokens(tokens[P:])}
        t0 = time.perf_counter()
        lg, cache = self.runner.prefill(batch, prefix, P)
        self.runner.sync()
        dt = time.perf_counter() - t0
        lg = self._host_logits(lg)
        if self.tracer is not None:
            self.tracer.span_at(req_id, "compute", t0, t0 + dt, cat="engine")
        ttft = res.completion_s + dt  # Fig. 7a: transfer then compute
        self._commit(tokens, cache, req_id)
        self._last_cache = cache
        return RequestResult(req_id, lg, [], P, Delivery.CHUNKWISE, ttft, dt,
                             res.completion_s, [])

    def _serve_layerwise(self, tokens, plan, n_chunks, P, req_id
                         ) -> RequestResult:
        cfg = self.cfg
        tracer = self.tracer
        runner = self.runner
        res = self._fetch(plan, n_chunks, req_id)
        suffix = self._tokens(tokens[P:])
        positions = P + torch.arange(suffix.shape[1],
                                     device=self.device)[None, :]
        x = runner.embed(suffix)
        act = nn.dt(cfg)
        segs_k, segs_v, compute_times = [], [], []
        for l in range(cfg.num_layers):
            # wait for the layer-ready notification (virtual transfer clock);
            # quantized payloads dequantize on the device with the dequant
            # kernel, identity payloads are a bit view.  The span ends after
            # the device has finished, so it times the dequant and the layer's
            # compute time below does not include it.
            span = (tracer.span(req_id, "dequant", cat="engine", layer=l)
                    if tracer is not None else contextlib.nullcontext())
            with span:
                k_d, v_d = layer_payload_to_device_kv(
                    res.payloads[l], n_chunks, self.spec, act, layer=l,
                    device=self.device)
                runner.sync()
            pk, pv = k_d[None], v_d[None]
            t0 = time.perf_counter()
            x, sk, sv = runner.layer(runner.layer_params(l), x, pk, pv,
                                     positions)
            runner.sync()
            dt = time.perf_counter() - t0
            compute_times.append(dt)
            if tracer is not None:
                tracer.span_at(req_id, "compute", t0, t0 + dt, cat="engine",
                               layer=l)
            segs_k.append(torch.cat([pk, sk], dim=1))
            segs_v.append(torch.cat([pv, sv], dim=1))
        t0 = time.perf_counter()
        lg = runner.final(x)
        runner.sync()
        final_dt = time.perf_counter() - t0
        lg = self._host_logits(lg)
        ready = [e.t_ready_s for e in res.events]
        ttft = pipeline_ttft(ready, compute_times) + final_dt
        stalls = per_layer_stalls(ready, compute_times)
        if tracer is not None:
            self._emit_model_timeline(req_id, ready, compute_times, final_dt)
        cache = torch.stack([torch.stack([k, v])
                             for k, v in zip(segs_k, segs_v)])
        self._commit(tokens, cache, req_id)
        self._last_cache = cache
        return RequestResult(req_id, lg, [], P, Delivery.LAYERWISE, ttft,
                             sum(compute_times) + final_dt, res.completion_s,
                             stalls)

    def _emit_model_timeline(self, req_id, ready, compute_times, final_dt):
        """The Eq. 3-composed timeline on the virtual transfer clock: layer
        l's compute starts at max(ready_l, finish_{l-1}) — the same recurrence
        `pipeline_ttft` folds, laid out as spans so the TTFT waterfall shows
        where transfer gated compute (track ``"<req>/model"``)."""
        track = req_id + "/model"
        finish = 0.0
        for l, (r, c) in enumerate(zip(ready, compute_times)):
            self.tracer.instant(track, "layer_ready", t=r, cat="model",
                                layer=l)
            start = max(r, finish)
            if l > 0 and start > finish:
                self.tracer.span_at(track, "stall", finish, start,
                                    cat="model", layer=l)
            self.tracer.span_at(track, "compute", start, start + c,
                                cat="model", layer=l)
            finish = start + c
        self.tracer.span_at(track, "final", finish, finish + final_dt,
                            cat="model")

    def _serve_hybrid(self, tokens, plan: HybridPlan, n_chunks, req_id
                      ) -> RequestResult:
        """Compute-or-load split (DESIGN.md §Compute-or-load): fetch chunks
        [0, m) layerwise while chunks [m, n) are recomputed as part of the
        suffix prefill."""
        m = min(plan.fetch_chunks, n_chunks)
        if m <= 0:  # planner chose pure recompute: identical to a cache miss
            return self._serve_full(tokens, req_id)
        span = fetch_span_plan(plan, n_chunks, self.spec)
        F = m * self.spec.chunk_tokens
        result = self._serve_layerwise(tokens, span, m, F, req_id)
        result.delivery = Delivery.HYBRID
        return result

    # ------------------------------------------------------------------
    def _trim_plan(self, plan, n_chunks):
        if n_chunks == plan.match.num_chunks:
            return plan
        m = dataclasses.replace(plan.match,
                                chunk_keys=plan.match.chunk_keys[:n_chunks],
                                matched_tokens=n_chunks * self.spec.chunk_tokens)
        return dataclasses.replace(plan, match=m)

    def _commit(self, tokens, cache, req_id="req"):
        if not self.sync_commit:
            return
        if self.tracer is not None:
            with self.tracer.span(req_id, "commit", cat="engine") as a:
                keys_all = chunk_keys(tokens, self.spec.chunk_tokens)
                objs = cache_to_chunks(cache, keys_all, self.spec)
                new = self.orch.commit(tokens, objs)
                a["new_chunks"] = len(new)
        else:
            keys_all = chunk_keys(tokens, self.spec.chunk_tokens)
            objs = cache_to_chunks(cache, keys_all, self.spec)
            new = self.orch.commit(tokens, objs)
        self.stats.add(commits=len(new))

    def _greedy_decode(self, result, tokens, max_new_tokens) -> list[int]:
        cfg = self.cfg
        S0 = len(tokens)
        # room for the new tokens along the sequence dim of [L,2,B,S,KV,dh];
        # decode writes into this copy in place
        cache = torch.nn.functional.pad(
            self._last_cache, (0, 0, 0, 0, 0, max_new_tokens))
        out = []
        tok = int(np.argmax(result.logits[:cfg.vocab_size]))
        out.append(tok)
        for i in range(max_new_tokens - 1):
            pos = torch.tensor([S0 + i], dtype=torch.int64, device=self.device)
            token = torch.tensor([[tok]], dtype=torch.int64,
                                 device=self.device)
            lg, cache = self.runner.decode(cache, token, pos)
            tok = int(torch.argmax(lg[0, :cfg.vocab_size]))
            out.append(tok)
        return out
