"""The serving engine's spans inside `commit` and `compute`, and its
`to_logits` span, on the port's CPU smoke model.

`commit` holds `commit.encode` (the wire images built where the cache
lives), `commit.d2h` (their copy to the host) and `commit.put` (the index
insert and the puts), each once, in that order, for every codec, with their
counters (`commit.d2h` moves the wire bytes; `on_device` counts the chunks
the encode kernel built, none on the CPU); every `compute` holds
one `compute.launch` from its start to the return of the runner call (the
host's enqueue time); `to_logits` runs from the entry of `submit` to the
last-token logits on the host, before the commit.  A commit encodes only
the chunks the store lacks, on every path of both engines, and stores the
bytes a full encode of the serve's cache would.  A tracer changes no
answer and no stored byte.  The port alone: no JAX.
"""
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import core  # noqa: E402
from repro_torch.codec import get_codec  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Delivery, compute_model, transport  # noqa: E402
from repro_torch.core.hashing import chunk_keys  # noqa: E402
from repro_torch.hybrid import HybridPlanner  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import export  # noqa: E402
from repro_torch.obs.attribution import attribute_trace  # noqa: E402
from repro_torch.obs.trace import Tracer  # noqa: E402
from repro_torch.serving import (AsyncEngine, AsyncRequest,  # noqa: E402
                                 ModelRunner, Orchestrator, ServingEngine)
from repro_torch.serving import async_engine, kv_chunks  # noqa: E402
from repro_torch.serving.engine import stack_layers  # noqa: E402

ARCH = "qwen3-0.6b"
G = 8  # chunk tokens
PARTS = ("commit.encode", "commit.d2h", "commit.put")
# path -> (codec, theta_bytes, kv_resident, hybrid planner, warm delivery);
# "cold" serves the cold prompt only
PATHS = {
    "cold": ("int8", 0, "fp", False, None),
    "layerwise-fp": ("int8", 0, "fp", False, Delivery.LAYERWISE),
    "layerwise-packed": ("int8", 0, "packed", False, Delivery.LAYERWISE),
    "chunkwise": ("int8", 1 << 60, "fp", False, Delivery.CHUNKWISE),
    "hybrid": ("identity", 0, "fp", True, Delivery.HYBRID),
}
CODECS = ["identity", "int8", "int4", "gw8/g16", "gw4/g16", "mixed/84/g16"]


@functools.lru_cache(maxsize=None)
def _model():
    model = build_model(get_smoke_config(ARCH), device="cpu")
    return model, model.init_params(torch.Generator().manual_seed(0))


def _prompts():
    rng = np.random.default_rng(7)
    shared = rng.integers(0, 200, size=4 * G)
    cold = np.concatenate([shared, rng.integers(0, 200, size=G + 3)])
    warm = np.concatenate([shared, rng.integers(0, 200, size=2 * G + 5)])
    return cold, warm


def _engine(path, tracer=None):
    codec, theta, resident, hybrid, _ = PATHS[path]
    model, params = _model()
    spec = model.cfg.kv_spec(G, dtype_bytes=4, codec=codec)
    kw = {}
    if hybrid:
        compute = compute_model.MeasuredCompute(
            num_layers=spec.num_layers, base_s=0.0, per_token_s=1e-3,
            bytes_per_token_per_layer=spec.bytes_per_token_per_layer)
        # a cap at which the planner fetches half the prefix, recomputes
        # the rest
        kw = dict(bandwidth_cap=1.8e5, hybrid=HybridPlanner(
            compute, transport.LOCAL_DRAM, session_setup=False))
    store = core.InMemoryStore()
    orch = Orchestrator(core.RadixIndex(G), core.Gateway(store), spec,
                        theta_bytes=theta, tracer=tracer, **kw)
    return ServingEngine(model, params, orch, kv_resident=resident), store


def _serve(path, tracer=None, max_new_tokens=0):
    """The path's submits; returns (engine, store, [(result, bytes the
    store took, objects it took)] by request)."""
    engine, store = _engine(path, tracer)
    cold, warm = _prompts()
    prompts = {"cold": cold}
    if PATHS[path][4] is not None:
        prompts["warm"] = warm
    out = []
    for req_id, tokens in prompts.items():
        before = store.stats.snapshot()
        r = engine.submit(tokens, req_id, max_new_tokens=max_new_tokens)
        after = store.stats.snapshot()
        out.append((r, after["bytes_written"] - before["bytes_written"],
                    after["puts"] - before["puts"]))
    return engine, store, out


@functools.lru_cache(maxsize=None)
def _traced(path):
    tracer = Tracer()
    engine, store, out = _serve(path, tracer)
    return engine, tracer, out


def _one(tracer, track, name):
    got = tracer.spans(track, name)
    assert len(got) == 1, (track, name, got)
    return got[0]


@pytest.mark.parametrize("path", sorted(PATHS))
def test_the_path_is_served_as_named(path):
    _, _, out = _traced(path)
    want = PATHS[path][4]
    assert out[-1][0].delivery is want
    assert out[-1][0].hit == (want is not None)
    if want is Delivery.HYBRID:
        assert 0 < out[-1][0].matched_tokens < 4 * G


@pytest.mark.parametrize("path", sorted(PATHS))
def test_commit_holds_its_three_parts_in_order(path):
    _, tracer, out = _traced(path)
    for r, _, _ in out:
        commit = _one(tracer, r.req_id, "commit")
        parts = [_one(tracer, r.req_id, n) for n in PARTS]
        assert all(commit.contains(p) for p in parts)
        assert all(a.t1 <= b.t0 for a, b in zip(parts, parts[1:]))
        assert all(p.cat == "engine" for p in parts)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_commit_counters(path):
    engine, tracer, out = _traced(path)
    spec = engine.spec
    cfg = engine.cfg
    cold, warm = _prompts()
    for (r, put_bytes, put_objects), tokens in zip(out, (cold, warm)):
        # only the chunks the store lacks are encoded: every chunk of the
        # cold prompt, the warm one's after the 4 it shares
        n = len(tokens) // G - (4 if r.req_id == "warm" else 0)
        enc, d2h, put = (_one(tracer, r.req_id, p) for p in PARTS)
        assert enc.args["chunks"] == n == put.args["new_chunks"]
        assert enc.args["wire_bytes"] == n * spec.wire_chunk_bytes
        assert enc.args["on_device"] == 0  # the CPU's plain version
        assert d2h.args["bytes"] == enc.args["wire_bytes"]
        if engine.spec.codec != "identity":
            assert d2h.args["bytes"] < \
                cfg.num_layers * 2 * n * G * spec.width * 4
        assert put.args["new_chunks"] == put_objects > 0
        assert put.args["bytes"] == put_bytes
        assert _one(tracer, r.req_id, "commit").args["new_chunks"] \
            == put_objects


def _full_cache(prefix, cache, start):
    """The whole sequence's cache of a serve: ``cache`` from token
    ``start`` on, after the fetched ``prefix`` (one entry a layer, expanded
    to model width where it stayed packed)."""
    if not start:
        return cache
    layers = [kv_chunks.packed_layer_to_fp(p, cache.dtype)
              if isinstance(p, kv_chunks.PackedLayerKV) else p
              for p in prefix]
    return torch.cat([stack_layers(layers), cache],
                     dim=3 if cache.dim() == 6 else 2)


def _serve_and_keep_caches(monkeypatch, path):
    """The cold prompt, then its warm hit, through ``path``: one of PATHS,
    "latent" (DeepSeek-V2's smoke model over latent objects, layerwise),
    or "async-fp" / "async-packed" (`AsyncEngine`, int8).  Returns (spec,
    store, [(tokens, the serve's whole cache, the keys it stored)])."""
    if path in PATHS:
        engine, store = _engine(path)
        model = engine.model
    else:
        if path == "latent":
            model = build_model(get_smoke_config("deepseek-v2-lite"),
                                device="cpu")
            params = model.init_params(torch.Generator().manual_seed(0))
            spec = model.cfg.kv_spec(G, dtype_bytes=4)
        else:
            model, params = _model()
            spec = model.cfg.kv_spec(G, dtype_bytes=4, codec="int8")
        store = core.InMemoryStore()
        orch = Orchestrator(core.RadixIndex(G), core.Gateway(store), spec,
                            theta_bytes=0, clock=transport.VirtualClock())
        if path == "latent":
            engine = ServingEngine(model, params, orch)
        else:
            engine = AsyncEngine(
                model, params, orch,
                compute=compute_model.PaperComputeModel(
                    num_layers=spec.num_layers),
                kv_resident=path.split("-")[1])
    # what each async commit encoded from, and the prefix of its flight
    commits, flights = [], []
    encode, done = async_engine.encode_new_chunks, AsyncEngine._on_prefill_done

    def spy_encode(orch, tokens, cache, start=0):
        commits.append((cache, start))
        return encode(orch, tokens, cache, start)

    def spy_done(self, ev):
        flights.append(self._active[ev.req_id].prefix)
        done(self, ev)
    monkeypatch.setattr(async_engine, "encode_new_chunks", spy_encode)
    monkeypatch.setattr(AsyncEngine, "_on_prefill_done", spy_done)
    cold, warm = _prompts()
    prompts = {"cold": cold}
    if path not in PATHS or PATHS[path][4] is not None:
        prompts["warm"] = warm
    out = []
    for req_id, tokens in prompts.items():
        before = set(store._data)
        if isinstance(engine, AsyncEngine):
            r = engine.serve([AsyncRequest(req_id, tuple(map(int, tokens)))])
            r = r[req_id]
            cache, start = commits[-1]
            full = _full_cache(flights[-1], cache, start)
        else:
            r = engine.submit(tokens, req_id)
            full = _full_cache(*engine._last_kv)
        assert r.hit == (req_id == "warm")
        out.append((tokens, full, set(store._data) - before))
    return engine.spec, store, out


@pytest.mark.parametrize("path", sorted(PATHS) + [
    "latent", "async-fp", "async-packed"])
def test_the_store_holds_what_a_full_encode_makes(monkeypatch, path):
    """Each chunk is stored once, by the serve that first held it, as the
    bytes that encoding that serve's whole cache makes."""
    spec, store, out = _serve_and_keep_caches(monkeypatch, path)
    keys = [chunk_keys(tokens, G) for tokens, _, _ in out]
    assert set(store._data) == set().union(*keys)
    for (tokens, full, stored), ks in zip(out, keys):
        assert stored and stored <= set(ks)
        for i, key in enumerate(ks):
            if key in stored:
                want = kv_chunks.cache_to_chunks(full, [key], spec,
                                                 start_token=i * G)
                assert store._data[key] == want[key], (path, i)


@functools.lru_cache(maxsize=None)
def _cold_by_codec(codec, traced):
    """The cold prompt, committed once by an engine of ``codec``: (tracer
    or None, result, the store's objects)."""
    model, params = _model()
    spec = model.cfg.kv_spec(G, dtype_bytes=4, codec=codec)
    tracer = Tracer() if traced else None
    store = core.InMemoryStore()
    orch = Orchestrator(core.RadixIndex(G), core.Gateway(store), spec,
                        tracer=tracer)
    r = ServingEngine(model, params, orch).submit(_prompts()[0], "cold")
    return tracer, r, dict(store._data)


@pytest.mark.parametrize("codec", CODECS)
def test_every_codec_commits_encode_then_copy_then_put(codec):
    tracer, r, stored = _cold_by_codec(codec, True)
    spec = _model()[0].cfg.kv_spec(G, dtype_bytes=4, codec=codec)
    commit = _one(tracer, "cold", "commit")
    enc, d2h, put = parts = [_one(tracer, "cold", n) for n in PARTS]
    assert all(commit.contains(p) for p in parts)
    assert all(a.t1 <= b.t0 for a, b in zip(parts, parts[1:]))
    n = len(_prompts()[0]) // G
    assert enc.args["chunks"] == n and enc.args["on_device"] == 0
    assert d2h.args["bytes"] == enc.args["wire_bytes"] \
        == n * spec.wire_chunk_bytes == sum(map(len, stored.values()))
    assert put.args["new_chunks"] == len(stored) == n
    # the store keeps bytes of its own, not views of the commit's image
    assert all(type(v) is bytes for v in stored.values())
    # the untraced commit stores the same objects
    assert _cold_by_codec(codec, False)[2] == stored


@pytest.mark.parametrize("path", sorted(PATHS))
def test_each_compute_holds_one_launch_from_its_start(path):
    _, tracer, out = _traced(path)
    for r, _, _ in out:
        computes = tracer.spans(r.req_id, "compute")
        launches = tracer.spans(r.req_id, "compute.launch")
        assert computes and len(launches) == len(computes)
        for c, lc in zip(computes, launches):
            assert lc.t0 == c.t0 and lc.t1 <= c.t1
            assert lc.args.get("layer") == c.args.get("layer")
        if r.delivery in (Delivery.LAYERWISE, Delivery.HYBRID):
            assert len(computes) == _model()[0].cfg.num_layers
        else:
            assert len(computes) == 1


@pytest.mark.parametrize("path", sorted(PATHS))
def test_compute_launch_ends_before_the_wait_for_the_device(monkeypatch,
                                                            path):
    """The runner's sync (a no-op on the CPU) made to take a millisecond:
    each `compute.launch` ends before a sync that its `compute` holds."""
    syncs = []

    def slow_sync(self):
        t0 = time.perf_counter()
        time.sleep(1e-3)
        syncs.append((t0, time.perf_counter()))
    monkeypatch.setattr(ModelRunner, "sync", slow_sync)
    tracer = Tracer()
    _, _, out = _serve(path, tracer)
    for r, _, _ in out:
        for c, lc in zip(tracer.spans(r.req_id, "compute"),
                         tracer.spans(r.req_id, "compute.launch")):
            assert any(lc.t1 <= a and b <= c.t1 for a, b in syncs)
            assert c.t1 - lc.t1 >= 1e-3


@pytest.mark.parametrize("path", sorted(PATHS))
def test_to_logits_runs_from_entry_to_the_logits(path):
    _, tracer, out = _traced(path)
    for r, _, _ in out:
        span = _one(tracer, r.req_id, "to_logits")
        assert span.t0 <= _one(tracer, r.req_id, "plan").t0
        assert max(c.t1 for c in tracer.spans(r.req_id, "compute")) \
            <= span.t1 <= _one(tracer, r.req_id, "commit").t0


@pytest.mark.parametrize("path", sorted(PATHS))
def test_a_tracer_changes_no_answer_and_no_stored_byte(path):
    runs = []
    for tracer in (None, Tracer()):
        engine, store, out = _serve(path, tracer, max_new_tokens=3)
        runs.append(([(r.logits, r.new_tokens) for r, _, _ in out],
                     dict(store._data)))
    (plain, plain_store), (traced, traced_store) = runs
    for (lg0, toks0), (lg1, toks1) in zip(plain, traced):
        np.testing.assert_array_equal(lg0, lg1)
        assert toks0 == toks1 and len(toks0) == 3
    assert plain_store == traced_store


def test_submit_writes_no_histogram():
    engine, _, _ = _traced("layerwise-fp")
    assert engine.metrics.snapshot()["histograms"] == {}


def test_the_trace_tools_take_the_new_spans():
    _, tracer, _ = _traced("layerwise-packed")
    attribute_trace(tracer)
    export.assert_valid_chrome_trace(export.to_chrome_trace(tracer))


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_to_chunks_is_the_copy_then_the_encode(codec, dtype):
    """`cache_to_chunks` is the encode where the cache lives, then the copy
    of the images to the host, and writes the numpy codec's bytes."""
    model, _ = _model()
    cfg = model.cfg
    spec = cfg.kv_spec(G, dtype_bytes=torch.empty((), dtype=dtype)
                       .element_size(), codec=codec)
    gen = torch.Generator().manual_seed(3)
    # [L, 2, B, S, KV, dh]; chunks from token 5 of batch row 1
    cache = torch.randn(cfg.num_layers, 2, 2, 4 * G, cfg.num_kv_heads,
                        cfg.head_dim, generator=gen).to(dtype)
    keys = [bytes([i]) * 4 for i in range(3)]
    images = kv_chunks.cache_to_wire_images(cache, 3, spec, batch_row=1,
                                            start_token=5)
    assert images.shape == (3, spec.wire_chunk_bytes)
    assert images.dtype == torch.uint8
    want = kv_chunks.cache_to_chunks(cache, keys, spec, batch_row=1,
                                     start_token=5)
    assert kv_chunks.wire_images_to_objects(images, keys) == want
    assert [len(v) for v in want.values()] == [spec.wire_chunk_bytes] * 3
    codec_ = get_codec(codec)
    for i, key in enumerate(keys):
        sl = cache[:, :, 1, 5 + i * G:5 + (i + 1) * G].reshape(
            cfg.num_layers, 2, G, spec.width)
        if codec_.lossless:
            sl = sl.contiguous()
            words = (sl.view(torch.int16).numpy().view(np.uint16)
                     if dtype == torch.bfloat16 else sl.numpy())
        else:
            words = sl.float().numpy()
        assert want[key] == codec_.encode_chunk(words[:, 0], words[:, 1],
                                                spec)
