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

Families: dense, vlm and homogeneous MoE stream layerwise, as does an MoE
stack after leading dense layers (DeepSeek-V2, `MLAConfig`), whose layers
cache one latent each (a `LatentKVSpec`: the identity codec, fp-resident);
llama4-style alternating MoE takes the chunkwise path (a layer step would
have to know which half of a super-layer it runs), also for a
compute-or-load plan, whose fetch-span it fetches whole.  SSM, hybrid and
encdec models have no [L,2,B,S,KV,dh] cache to commit: the engine refuses
them, and they are served at model level only (`Model.prefill` /
`decode_step`).
``kv_resident="packed"`` (dense and vlm only) keeps a
layerwise-fetched prefix quantized-resident (its wire image on the device)
through prefill and greedy decode: attention reads it through the fused
dequant-attention kernels (K7 in prefill, K6 in decode).  Either residency
runs the same layer loop; only the upload differs.

Every path commits only the complete chunks the store lacks
(`encode_new_chunks`): a warm hit encodes its suffix's chunks, never the
prefix it fetched.

When the orchestrator carries a compute-or-load planner, `_serve_hybrid`
fetches only the planner's fetch-span and recomputes the rest with the suffix
(DESIGN.md §Compute-or-load).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.codec import get_codec
from repro_torch.core import Delivery
from repro_torch.core.hashing import chunk_keys
from repro_torch.core.overlap import per_layer_stalls, pipeline_ttft
from repro_torch.hybrid.executor import HybridPlan, fetch_span_plan
from repro_torch.models import Model
from repro_torch.models import dense, mla, moe, timing
from repro_torch.models import layers as nn
from repro_torch.models.config import MLAConfig
from repro_torch.obs.metrics import MetricsRegistry

from .kv_chunks import (PackedLayerKV, cache_to_wire_images,
                        layer_payload_to_device_kv, layer_payload_to_packed_kv,
                        prefix_kv_from_payloads, wire_images_to_objects)
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


def layerwise_ok(cfg) -> bool:
    """Whether a warm hit can stream layer by layer: a model whose every
    layer `ModelRunner.step` can run alone (dense, vlm, homogeneous MoE, or
    DeepSeek-V2's `MLAConfig`).  llama4-style alternating MoE takes the
    chunkwise path."""
    return isinstance(cfg, MLAConfig) or cfg.family in ("dense", "vlm") or (
        cfg.family == "moe" and cfg.moe_every == 1)


def check_residency(kv_resident: str, spec, cfg) -> None:
    """Refuse a ``kv_resident`` that the engines cannot serve ``cfg`` with
    under ``spec``.  "fp" expands fetched prefixes to model width on
    arrival; "packed" keeps a layerwise prefix quantized-resident and reads
    it through the fused dequant-attention kernels."""
    if kv_resident not in ("fp", "packed"):
        raise ValueError(f"kv_resident must be 'fp' or 'packed', "
                         f"got {kv_resident!r}")
    if kv_resident == "fp":
        return
    if spec.kv_tensors == 1:
        raise ValueError(
            "kv_resident='packed' has no form for a one-tensor "
            "(latent) KV layout: its fused kernels read K and V")
    if get_codec(spec.codec).lossless:
        raise ValueError(f"kv_resident='packed' needs a quantized codec, "
                         f"got {spec.codec!r}")
    if cfg.family not in ("dense", "vlm"):
        raise ValueError(f"kv_resident='packed' supports dense/vlm families, "
                         f"got {cfg.family!r}")
    if cfg.logit_softcap:
        raise ValueError("kv_resident='packed' requires logit_softcap == 0 "
                         "(fused kernels don't implement softcap)")


def layer_upload(kv_resident: str, spec, dtype, device):
    """The upload of one layer's fetched payload, ``(payload, n_chunks, l)
    -> prefix``, in the form `ModelRunner.step` takes: at model width
    ("fp": (k, v) [1, P, KV, dh] after the dequant kernel, or a latent's
    (c,) [1, P, W]), or as its wire image ("packed": a `PackedLayerKV`)."""
    if kv_resident == "packed":
        return lambda payload, n, l: layer_payload_to_packed_kv(
            payload, n, spec, layer=l, device=device)
    return lambda payload, n, l: tuple(t[None] for t in (
        layer_payload_to_device_kv(payload, n, spec, dtype, layer=l,
                                   device=device)))


def stack_layers(layers) -> torch.Tensor:
    """Per-layer (k, v) [1, S, KV, dh], or latents (c,) [1, S, W] -> the
    model's cache [L, 2, 1, S, KV, dh], or [L, 1, S, W]."""
    return torch.stack([torch.stack(t) if len(t) == 2 else t[0]
                        for t in layers])


def encode_new_chunks(orch: Orchestrator, tokens, cache, start: int = 0):
    """The commit's rule: the wire images of the complete chunks of
    ``tokens`` that the store lacks, encoded from ``cache``, which holds the
    sequence's KV from token ``start`` (a chunk boundary) on.  Returns
    (images [N, wire_chunk_bytes] on the cache's device, their N keys).

    The chunks the store holds are the index's leading ones
    (`Orchestrator.stored_chunks`), so these are the keys the commit's
    insert finds new; a new chunk before ``start`` is not in ``cache`` and
    is left out."""
    G = orch.spec.chunk_tokens
    keys = chunk_keys(tokens, G)
    first = max(orch.stored_chunks(tokens), start // G)
    images = cache_to_wire_images(cache, len(keys) - first, orch.spec,
                                  start_token=first * G - start)
    return images, keys[first:]


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

    def step(self, l: int, x, prefix, positions):
        """Layer ``l`` over its fetched prefix in the form `layer_upload`
        made: (k, v) [1, P, KV, dh], a latent (c,) [1, P, W], or a
        `PackedLayerKV`.  Returns (x, the suffix's (k, v) or (c,)).

        The one place in `serving/` that picks a model family's block."""
        cfg = self.cfg
        if isinstance(cfg, MLAConfig):
            x, lat, _ = mla.block(mla.layer_params(self.params, cfg, l), cfg,
                                  x, positions, prefix[0])
            return x, (lat,)
        p = dense.layer_params(self.params, l)
        if isinstance(prefix, PackedLayerKV):
            return dense.block_packed(p, cfg, x, positions, prefix.as_tuple(),
                                      bits=prefix.bits, group=prefix.group,
                                      chunk_tokens=prefix.chunk_tokens)
        if cfg.family == "moe":
            return moe.moe_block(p, cfg, x, positions, prefix)[:2]
        return dense.block(p, cfg, x, positions, prefix)

    def final(self, x):
        h = nn.rmsnorm(self.params["final_norm"], x[:, -1:, :])
        return nn.logits(self.params["embed"], self.cfg, h)[:, 0, :]

    def prefill(self, batch, prefix=None, prefix_len: int = 0):
        return self.model.prefill(self.params, batch, prefix, prefix_len)

    def decode(self, cache, token, pos):
        return self.model.decode_step(self.params, cache, token, pos)

    def decode_packed(self, packed_layers, cache, token, pos):
        """One decode step over packed prefixes (one `PackedLayerKV` per
        layer, each with its own bits and group) and an fp suffix cache
        [L, 2, B, S_suf, KV, dh] written in place.  Returns (logits [B, V],
        cache)."""
        cfg = self.cfg
        x = nn.embed(self.params["embed"], cfg, token)
        for l, pkv in enumerate(packed_layers):
            x, _, _ = dense.decode_block_packed(
                dense.layer_params(self.params, l), cfg, x, pkv.as_tuple(),
                cache[l, 0], cache[l, 1], pos, bits=pkv.bits,
                group=pkv.group, chunk_tokens=pkv.chunk_tokens)
        x = nn.rmsnorm(self.params["final_norm"], x)
        lg = nn.logits(self.params["embed"], cfg, x)[:, 0, :]
        return lg, cache

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
        if self.cfg.family in ("ssm", "hybrid", "encdec"):
            raise ValueError(
                f"ServingEngine serves dense, vlm and moe models, got family "
                f"{self.cfg.family!r}: its cache is not one [L,2,B,S,KV,dh] "
                f"KV array to commit as chunks; serve it at model level "
                f"(Model.prefill / decode_step)")
        check_residency(kv_resident, self.spec, self.cfg)
        self.kv_resident = kv_resident
        self._upload = layer_upload(kv_resident, self.spec, nn.dt(self.cfg),
                                    self.device)
        # one registry per serving stack: default to the orchestrator's so
        # engine + orch counters snapshot as a single consistent cut
        self.metrics = metrics if metrics is not None else orch.metrics
        self.stats = EngineStats(self.metrics)
        # wall-clock tracer (obs.trace.Tracer); shared with the orchestrator
        # unless the caller splits them.  Nullable: untraced, `_span` runs
        # the same steps under a context that records nothing.
        self.tracer = tracer if tracer is not None else orch.tracer
        self._layerwise_ok = layerwise_ok(self.cfg)
        self.runner = runner if runner is not None else ModelRunner(model,
                                                                    params)
        # what the last serve leaves for greedy decode: (prefix, cache,
        # start).  ``cache`` holds tokens [start, S) as the commit got them;
        # a layerwise hit's ``prefix`` holds [0, start), one entry a layer in
        # the form `layer_upload` made (None where start == 0)
        self._last_kv = None
        # traced: when the last request's logits reached the host
        self._logits_at = None

    # ------------------------------------------------------------------
    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(np.asarray(tokens, np.int64),
                               device=self.device)[None, :]

    def _span(self, req_id, name, **args):
        """The tracer's span over a ``with`` body, yielding the dict of its
        counters; untraced, the same body runs under a context that
        records nothing."""
        if self.tracer is None:
            return contextlib.nullcontext({})
        return self.tracer.span(req_id, name, cat="engine", **args)

    def submit(self, tokens: np.ndarray, req_id: str = "req",
               max_new_tokens: int = 0, layer_compute_hint_s: float = 1e-3
               ) -> RequestResult:
        """Serve one request: match -> (fetch | recompute) -> prefill ->
        greedy decode -> commit fresh chunks."""
        t_in = time.perf_counter() if self.tracer is not None else None
        tokens = np.asarray(tokens, dtype=np.int32)
        self.stats.add(requests=1)
        with self._span(req_id, "plan") as a:
            plan = self.orch.plan(tokens, layer_compute_hint_s, req_id=req_id)
            a["matched_chunks"] = plan.match.num_chunks
        match = plan.match
        # the orchestrator already trimmed full-prompt matches (>= 1 suffix
        # token stays), so the plan's chunk count IS the reusable count
        n_chunks = match.num_chunks
        P = n_chunks * self.spec.chunk_tokens
        use_cache = plan.delivery is not None and n_chunks > 0

        if not use_cache:
            result = self._serve_full(tokens, req_id)
        elif isinstance(plan, HybridPlan):
            if self._layerwise_ok:
                result = self._serve_hybrid(tokens, plan, n_chunks, req_id)
            else:
                # the split still governs how many bytes move: fetch the
                # fetch-span as whole chunks, recompute the rest with the
                # suffix
                span = fetch_span_plan(plan, n_chunks, self.spec)
                m = span.match.num_chunks
                result = self._serve_chunkwise(
                    tokens, span, m, m * self.spec.chunk_tokens, req_id)
        elif plan.delivery is Delivery.LAYERWISE and self._layerwise_ok:
            result = self._serve_layerwise(tokens, plan, n_chunks, P, req_id)
        else:
            result = self._serve_chunkwise(tokens, plan, n_chunks, P, req_id)

        # the fetch is over: retire the pool flow, or every served request
        # would keep holding (and shrinking) the shared bandwidth forever
        if plan.delivery is not None:
            self.orch.release(req_id)

        self.stats.add(prefix_tokens_reused=result.matched_tokens,
                       tokens_computed=len(tokens) - result.matched_tokens)
        if self.tracer is not None:
            # the answer of a prefill: the last-token logits on the host,
            # before the commit
            self.tracer.span_at(req_id, "to_logits", t_in, self._logits_at,
                                cat="engine")
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
        out = lg[0].float().cpu().numpy()
        if self.tracer is not None:
            self._logits_at = time.perf_counter()  # the end of `to_logits`
        return out

    def _compute(self, req_id, step, **span_args):
        """Run ``step()`` (a runner call) to completion on the device;
        returns (its result, wall seconds).  Traced: a `compute` span over
        the whole and, from the same start, `compute.launch` up to the
        return of ``step``, before the wait for the device: the host's
        enqueue time; inside `compute`, a span ``compute.<region>`` for each
        region the model marked (`models.timing`: ``expand``, ``experts``),
        timed on the device and read after the step's own sync."""
        t0 = time.perf_counter()
        if self.tracer is None:
            out = step()
            self.runner.sync()
            return out, time.perf_counter() - t0
        with timing.Recorder(self.device) as regions:
            out = step()
        t_launch = time.perf_counter()
        self.runner.sync()
        dt = time.perf_counter() - t0
        self.tracer.span_at(req_id, "compute", t0, t0 + dt, cat="engine",
                            **span_args)
        self.tracer.span_at(req_id, "compute.launch", t0, t_launch,
                            cat="engine", **span_args)
        for name, a, b, counters in regions.regions():
            self.tracer.span_at(req_id, f"compute.{name}", max(a, t0),
                                min(b, t0 + dt), cat="engine", **span_args,
                                **counters)
        return out, dt

    def _serve_full(self, tokens, req_id) -> RequestResult:
        batch = {"tokens": self._tokens(tokens)}
        (lg, cache), dt = self._compute(req_id,
                                        lambda: self.runner.prefill(batch))
        lg = self._host_logits(lg)
        self._commit(tokens, cache, req_id)
        self._last_kv = (None, cache, 0)
        return RequestResult(req_id, lg, [], 0, None, dt, dt, 0.0, [])

    def _fetch(self, plan, n_chunks, req_id):
        with self._span(req_id, "fetch") as a:
            res = self.orch.fetch(self._trim_plan(plan, n_chunks))
            a["completion_s"] = res.completion_s
        return res

    def _serve_chunkwise(self, tokens, plan, n_chunks, P, req_id
                         ) -> RequestResult:
        res = self._fetch(plan, n_chunks, req_id)
        prefix = self.runner.payloads_to_prefix(res.payloads, n_chunks,
                                                self.spec)
        batch = {"tokens": self._tokens(tokens[P:])}
        (lg, cache), dt = self._compute(
            req_id, lambda: self.runner.prefill(batch, prefix, P))
        lg = self._host_logits(lg)
        ttft = res.completion_s + dt  # Fig. 7a: transfer then compute
        self._commit(tokens, cache, req_id)
        # chunkwise stays fp-resident: the whole prefix is on the device
        # before prefill starts, so there is no residency window to shrink
        self._last_kv = (None, cache, 0)
        return RequestResult(req_id, lg, [], P, Delivery.CHUNKWISE, ttft, dt,
                             res.completion_s, [])

    def _serve_layerwise(self, tokens, plan, n_chunks, P, req_id
                         ) -> RequestResult:
        """The §4.2 loop: each layer's prefix is uploaded as it lands
        (`layer_upload`: at model width, or kept as its wire image that
        the fused kernels read) and the layer runs over it; the suffix's
        segments are what the commit encodes, from token P."""
        runner = self.runner
        res = self._fetch(plan, n_chunks, req_id)
        suffix = self._tokens(tokens[P:])
        positions = P + torch.arange(suffix.shape[1],
                                     device=self.device)[None, :]
        x = runner.embed(suffix)
        # same "dequant" span name on both residencies (critical-path
        # attribution keys on it); packed, it times the packed upload
        resident = {"resident": "packed"} if self.kv_resident == "packed" \
            else {}
        prefix, segs, compute_times = [], [], []
        for l in range(self.cfg.num_layers):
            # wait for the layer-ready notification (virtual transfer clock);
            # quantized payloads dequantize on the device with the dequant
            # kernel, identity payloads are a bit view.  The span ends after
            # the device has finished, so it times the upload and the
            # layer's compute time below does not include it.
            with self._span(req_id, "dequant", layer=l, **resident):
                pre = self._upload(res.payloads[l], n_chunks, l)
                runner.sync()
            (x, seg), dt = self._compute(
                req_id, lambda: runner.step(l, x, pre, positions), layer=l)
            compute_times.append(dt)
            prefix.append(pre)
            segs.append(seg)
        result = self._finish_layerwise(x, res, compute_times, P, req_id)
        cache = stack_layers(segs)
        self._commit(tokens, cache, req_id, start=P)
        self._last_kv = (prefix, cache, P)
        return result

    def _finish_layerwise(self, x, res, compute_times, P, req_id
                          ) -> RequestResult:
        """Final norm and logits after the layer loop, and the Eq. 3
        composition of the transfer and compute timelines."""
        t0 = time.perf_counter()
        lg = self.runner.final(x)
        self.runner.sync()
        final_dt = time.perf_counter() - t0
        lg = self._host_logits(lg)
        ready = [e.t_ready_s for e in res.events]
        ttft = pipeline_ttft(ready, compute_times) + final_dt
        stalls = per_layer_stalls(ready, compute_times)
        if self.tracer is not None:
            self._emit_model_timeline(req_id, ready, compute_times, final_dt)
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

    def _commit(self, tokens, cache, req_id="req", start=0):
        """Encode and commit the complete chunks of ``tokens`` that the
        store lacks (`encode_new_chunks`), from ``cache``, which holds the
        sequence from token ``start`` on."""
        if not self.sync_commit:
            return
        # the three parts, each with its own remedy: the encode where the
        # cache lives (K9 on the card for a quantized codec), the copy of
        # the wire images to the host, the index insert and puts
        with self._span(req_id, "commit") as a:
            with self._span(req_id, "commit.encode") as c:
                images, keys = encode_new_chunks(self.orch, tokens, cache,
                                                 start)
                c["chunks"] = len(keys)
                c["wire_bytes"] = images.nbytes
                # chunks whose image the encode kernel built
                c["on_device"] = 0 if images.device.type == "cpu" or \
                    get_codec(self.spec.codec).lossless else len(keys)
            with self._span(req_id, "commit.d2h") as c:
                objs = wire_images_to_objects(images, keys)
                c["bytes"] = images.nbytes
            with self._span(req_id, "commit.put") as c:
                new = self.orch.commit(tokens, objs)
                c["new_chunks"] = len(new)
                c["bytes"] = sum(len(objs[k]) for k in new if k in objs)
            a["new_chunks"] = len(new)
        self.stats.add(commits=len(new))

    def _greedy_decode(self, result, tokens, max_new_tokens) -> list[int]:
        """Greedy decode from what the last serve left (`_last_kv`).  A
        packed prefix stays packed: every step reads it through the fused
        decode kernel (K6, once per layer) and only the suffix cache grows.
        Otherwise the prefix joins the cache at model width."""
        prefix, cache, start = self._last_kv
        # dims after the sequence dim of [L,2,B,S,KV,dh] (of the latents'
        # [L,B,S,W])
        tail = 2 if self.spec.kv_tensors == 2 else 1
        if start and isinstance(prefix[0], PackedLayerKV):
            decode = functools.partial(self.runner.decode_packed, prefix)
        else:
            decode = self.runner.decode
            if start:
                cache = torch.cat([stack_layers(prefix), cache],
                                  dim=-tail - 1)
        # room for the new tokens; decode writes into this copy in place
        cache = torch.nn.functional.pad(cache,
                                        (0, 0) * tail + (0, max_new_tokens))
        cfg = self.cfg
        S0 = len(tokens)
        out = []
        tok = int(np.argmax(result.logits[:cfg.vocab_size]))
        out.append(tok)
        for i in range(max_new_tokens - 1):
            pos = torch.tensor([S0 + i], dtype=torch.int64, device=self.device)
            token = torch.tensor([[tok]], dtype=torch.int64,
                                 device=self.device)
            lg, cache = decode(cache, token, pos)
            tok = int(torch.argmax(lg[0, :cfg.vocab_size]))
            out.append(tok)
        return out
