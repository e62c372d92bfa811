"""The port's concurrent serving path: `AsyncEngine` over one
`BandwidthPool`, decode in `ContinuousBatcher` slots, and its oracle, the
port's `ClusterSim`.

Model: the 2-layer ``qwen3-0.6b`` smoke config (fp32) that the reference's
own async tests use, with reference-initialised parameters bridged to torch,
chunks of G = 8 tokens.  Tolerances:

* virtual timeline (admit / flow_done / prefill_done / ttft): 1e-9, the
  reference tests' bound (host arithmetic, the same on both sides);
* port against the reference engine: logits within 1e-4 (the bound of
  `tests/test_torch_serving.py::TestCrossEngine`: two fp32 implementations
  sum in other orders), tokens, matched tokens and delivery equal;
* port async against port sequential: logits bit-equal, tokens equal (the
  same ops at the same shapes on the same bytes).
"""
import functools
import json
import os
import random
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as ref_core  # noqa: E402
import repro.core.compute_model as ref_compute_model  # noqa: E402
import repro.core.scheduler as ref_scheduler  # noqa: E402
import repro.core.transport as ref_transport  # noqa: E402
import repro.obs as ref_obs  # noqa: E402
import repro.serving as ref_serving  # noqa: E402
from repro.configs import get_smoke_config as ref_get_smoke  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch import core, serving  # noqa: E402
from repro_torch.bridge import params_from_reference  # noqa: E402
from repro_torch.cluster import ClusterSim, TraceRequest, load_trace  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import Delivery  # noqa: E402
from repro_torch.core import compute_model, scheduler, transport  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import SLOMonitor, SLOTarget, StreamMonitor, Tracer  # noqa: E402
from repro_torch.obs.attribution import attribute_trace, check_identity  # noqa: E402
from repro_torch.serving import (AsyncRequest, ContinuousBatcher,  # noqa: E402
                                 SlotRequest)

ARCH = "qwen3-0.6b"
G = 8
CTX = 4 * G + G // 2  # four warm chunks and half a chunk of suffix
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")

# the classes each side builds its stack from
PORT = types.SimpleNamespace(core=core, serving=serving, sched=scheduler,
                             transport=transport, compute=compute_model,
                             Tracer=Tracer)
REF = types.SimpleNamespace(core=ref_core, serving=ref_serving,
                            sched=ref_scheduler, transport=ref_transport,
                            compute=ref_compute_model, Tracer=ref_obs.Tracer)


@functools.lru_cache(maxsize=None)
def _models():
    """One reference init, bridged once: {side: (model, params, runner)}."""
    ref_model = ref_build_model(ref_get_smoke(ARCH))
    ref_params = jax.jit(ref_model.init_params)(jax.random.PRNGKey(0))
    params = params_from_reference(jax.tree.map(np.asarray, ref_params),
                                   device="cpu")
    model = build_model(get_smoke_config(ARCH), device="cpu")
    return {"port": (model, params, serving.ModelRunner(model, params)),
            "ref": (ref_model, ref_params,
                    ref_serving.ModelRunner(ref_model, ref_params))}


def _spec(codec="identity"):
    return get_smoke_config(ARCH).kv_spec(G, dtype_bytes=4, codec=codec)


def _compute(ns=PORT):
    return ns.compute.PaperComputeModel(num_layers=_spec().num_layers)


def _cap(n_chunks=4, context=CTX, codec="identity") -> float:
    """2x one flow's zero-stall rate, so three or more flows contend."""
    c = _compute().layer_compute_s(context, n_chunks * G / context)
    return 2.0 * n_chunks * _spec(codec).mean_wire_layer_bytes / c


def _mk_stack(side="port", codec="identity", cap_bps=None, theta=0,
              max_flows=None, tracer=None, monitor=None, slo=None,
              kv_resident="fp"):
    """(sequential engine, async engine, tracer) sharing one orchestrator,
    built from the port's classes or the reference's."""
    ns = PORT if side == "port" else REF
    model, params, runner = _models()[side]
    tracer = tracer if tracer is not None else ns.Tracer()
    pool = None
    if cap_bps is not None:
        pool = ns.sched.BandwidthPool(cap_bps, ns.sched.Policy.CAL_STALL_OPT)
        pool.tracer = tracer
    spec = model.cfg.kv_spec(G, dtype_bytes=4, codec=codec)
    orch = ns.serving.Orchestrator(
        ns.core.RadixIndex(G), ns.core.Gateway(ns.core.InMemoryStore()),
        spec, theta_bytes=theta, pool=pool,
        clock=ns.transport.VirtualClock(), tracer=tracer)
    seq = ns.serving.ServingEngine(model, params, orch, runner=runner,
                                   kv_resident=kv_resident)
    eng = ns.serving.AsyncEngine(
        model, params, orch, compute=_compute(ns),
        profile=ns.transport.S3_RDMA_AGG, session_setup=True,
        max_flows=max_flows, runner=runner, tracer=tracer, monitor=monitor,
        slo=slo, kv_resident=kv_resident)
    return seq, eng, tracer


def _warm_and_prompts(seq, n, warm_chunks=4, extra=None, seed=0):
    """Warm ``n`` distinct prefixes through the sequential engine and return
    prompts extending each by ``extra`` suffix tokens (so the async match is
    exactly ``warm_chunks`` chunks)."""
    extra = G // 2 if extra is None else extra
    rng = np.random.default_rng(seed)
    warm = [rng.integers(0, 200, size=warm_chunks * G) for _ in range(n)]
    for i, w in enumerate(warm):
        seq.submit(w, req_id=f"warm{i}")
    return [np.concatenate([w, rng.integers(0, 200, size=extra)])
            for w in warm]


def _requests(prompts, arrivals, max_new_tokens=0, ns=PORT):
    return [ns.serving.AsyncRequest(f"r{i}", tuple(map(int, p)), arrivals[i],
                                    max_new_tokens=max_new_tokens)
            for i, p in enumerate(prompts)]


def _sim_for(trace, cap_bps=None, mode="layerwise", max_flows=None):
    tr = Tracer()
    sim = ClusterSim(cap_bps=cap_bps, policy=scheduler.Policy.CAL_STALL_OPT,
                     compute=_compute(), profile=transport.S3_RDMA_AGG,
                     spec=_spec(), mode=mode, session_setup=True,
                     max_flows=max_flows, tracer=tr)
    return sim.run(trace), tr


def _assert_records_match(results, records, tol=1e-9):
    """``records``: req_id -> a record of the sim or of another engine."""
    assert set(records) <= set(results)
    for rid, rec in records.items():
        e = results[rid].record
        for field in ("admit_s", "flow_done_s", "prefill_done_s", "ttft_s"):
            assert getattr(e, field) == pytest.approx(
                getattr(rec, field), rel=tol, abs=tol), (rid, field)


def _poisson(n, seed=7, mean_gap_s=0.004):
    rng, t, out = random.Random(seed), 0.0, []
    for _ in range(n):
        t += rng.expovariate(1.0 / mean_gap_s)
        out.append(t)
    return out


class TestClusterSimConformance:
    """The port's engine against the port's oracle on the same trace."""

    def test_layerwise_ttft_matches_sim(self):
        n = 4
        seq, eng, _ = _mk_stack(cap_bps=_cap())
        prompts = _warm_and_prompts(seq, n)
        results = eng.serve(_requests(prompts, [0.002 * i for i in range(n)]))
        assert eng.peak_transfers >= 2
        assert all(r.delivery is Delivery.LAYERWISE for r in results.values())
        trace = [TraceRequest(f"r{i}", 0.002 * i, CTX, 4 * G / CTX,
                              chunk_tokens=G) for i in range(n)]
        res, _ = _sim_for(trace, cap_bps=_cap())
        _assert_records_match(results, res.by_id())

    def test_mixed_recompute_and_queueing_matches_sim(self):
        """max_flows=1 queues arrivals; a cold request rides along as a
        recompute flight (zero wire bytes)."""
        seq, eng, _ = _mk_stack(cap_bps=_cap(), max_flows=1)
        prompts = _warm_and_prompts(seq, 2)
        cold = np.random.default_rng(99).integers(200, 250, size=CTX)
        reqs = [AsyncRequest("r0", tuple(map(int, prompts[0])), 0.0),
                AsyncRequest("r1", tuple(map(int, prompts[1])), 0.001),
                AsyncRequest("rc", tuple(map(int, cold)), 0.002)]
        results = eng.serve(reqs)
        trace = [TraceRequest("r0", 0.0, CTX, 4 * G / CTX, chunk_tokens=G),
                 TraceRequest("r1", 0.001, CTX, 4 * G / CTX, chunk_tokens=G),
                 TraceRequest("rc", 0.002, CTX, 0.0, chunk_tokens=G)]
        res, _ = _sim_for(trace, cap_bps=_cap(), max_flows=1)
        by = res.by_id()
        _assert_records_match(results, by)
        assert by["r1"].queue_s > 0
        assert results["rc"].delivery is None
        assert results["rc"].record.bytes_total == 0.0

    def test_chunkwise_ttft_matches_sim(self):
        """theta = 2^60 forces chunkwise delivery; the unthrottled oracle in
        chunkwise mode agrees."""
        seq, eng, _ = _mk_stack(theta=1 << 60)
        prompts = _warm_and_prompts(seq, 2)
        results = eng.serve(_requests(prompts, [0.0, 0.001]))
        assert all(r.delivery is Delivery.CHUNKWISE
                   for r in results.values())
        trace = [TraceRequest(f"r{i}", 0.001 * i, CTX, 4 * G / CTX,
                              chunk_tokens=G) for i in range(2)]
        res, _ = _sim_for(trace, mode="chunkwise")
        _assert_records_match(results, res.by_id())

    def test_golden_async_trace(self):
        """The committed replay trace and expected timeline: the port's
        engine and the port's oracle both reproduce the pinned times."""
        trace = load_trace(os.path.join(DATA, "golden_async_trace.json"))
        with open(os.path.join(DATA, "golden_async_trace_expected.json")) as f:
            expected = json.load(f)
        cap = expected["cap_bps"]
        seq, eng, _ = _mk_stack(cap_bps=cap, max_flows=expected["max_flows"])
        rng = np.random.default_rng(expected["prompt_seed"])
        reqs = []
        for tr in trace:
            prompt = rng.integers(0, 200, size=tr.context)
            if tr.cached_tokens:
                seq.submit(prompt[:tr.cached_tokens], req_id="w" + tr.req_id)
            reqs.append(AsyncRequest(tr.req_id, tuple(map(int, prompt)),
                                     tr.arrival_s))
        results = eng.serve(reqs)
        res, _ = _sim_for(trace, cap_bps=cap, max_flows=expected["max_flows"])
        by = res.by_id()
        assert set(expected["requests"]) == set(results)
        for rid, exp in expected["requests"].items():
            for src in (results[rid].record, by[rid]):
                for field in ("admit_s", "flow_done_s", "prefill_done_s"):
                    assert getattr(src, field) == pytest.approx(
                        exp[field], abs=1e-9), (rid, field)


def test_attribution_identity_on_engine_and_sim_traces():
    """The engine emits the sim's span vocabulary: one `attribute_trace`
    pass works on both traces, `check_identity` holds on both, and the
    per-request components agree at 1e-9."""
    n = 3
    seq, eng, tracer = _mk_stack(cap_bps=_cap(), max_flows=2)
    prompts = _warm_and_prompts(seq, n)
    eng.serve(_requests(prompts, [0.001 * i for i in range(n)]))
    spans = {s.name for s in tracer.spans()
             if s.track.startswith("r") and "/" not in s.track}
    assert {"wire", "compute", "serve", "queue"} <= spans
    wall = {s.name for s in tracer.spans() if s.track.endswith("/wall")}
    assert {"dequant", "compute"} <= wall
    trace = [TraceRequest(f"r{i}", 0.001 * i, CTX, 4 * G / CTX,
                          chunk_tokens=G) for i in range(n)]
    _, sim_tr = _sim_for(trace, cap_bps=_cap(), max_flows=2)
    a_eng = {k: v for k, v in attribute_trace(tracer).items()
             if not k.startswith("warm")}
    a_sim = attribute_trace(sim_tr)
    assert set(a_eng) == set(a_sim) == {f"r{i}" for i in range(n)}
    check_identity(a_eng)
    check_identity(a_sim)
    for rid in a_sim:
        for comp in ("queue_s", "bandwidth_stall_s", "gate_stall_s",
                     "ttft_s"):
            assert getattr(a_eng[rid], comp) == pytest.approx(
                getattr(a_sim[rid], comp), rel=1e-9, abs=1e-9), (rid, comp)


class TestAgainstReference:
    """The same prompts through the port's and the reference's engines,
    each warming its own store with its own sequential engine."""

    @staticmethod
    def _serve_both(codec, make_reqs, kv_resident="fp", cap=True, warm=3):
        out = {}
        for side, ns in (("port", PORT), ("ref", REF)):
            seq, eng, _ = _mk_stack(
                side, codec, cap_bps=_cap(codec=codec) if cap else None,
                kv_resident=kv_resident)
            prompts = _warm_and_prompts(seq, warm) if warm else None
            out[side] = (eng.serve(make_reqs(prompts, ns)),
                         eng.peak_transfers)
        return out

    @staticmethod
    def _compare(out, n_tokens):
        (port, port_peak), (ref, ref_peak) = out["port"], out["ref"]
        assert port_peak == ref_peak
        assert set(port) == set(ref)
        _assert_records_match(port, {rid: r.record for rid, r in ref.items()})
        for rid, r in ref.items():
            p = port[rid]
            diff = float(np.abs(p.logits - np.asarray(r.logits)).max())
            print(f"max_abs_diff port vs reference async {rid}: {diff:.3g}")
            assert diff <= 1e-4, (rid, diff)
            assert p.new_tokens == r.new_tokens and \
                len(p.new_tokens) == n_tokens, rid
            assert p.matched_tokens == r.matched_tokens, rid
            assert (p.delivery.name if p.delivery else None) == \
                (r.delivery.name if r.delivery else None), rid
            assert p.record.bytes_total == r.record.bytes_total, rid

    @pytest.mark.parametrize("codec", ["identity", "int8"])
    def test_fp_resident(self, codec):
        """Three warm hits under a contended pool and one cold request, all
        decoding 3 tokens through two batcher slots."""
        arrivals = _poisson(4)
        cold = np.random.default_rng(99).integers(200, 250, size=CTX)

        def reqs(prompts, ns):
            return (_requests(prompts, arrivals, 3, ns)
                    + [ns.serving.AsyncRequest("rc", tuple(map(int, cold)),
                                               arrivals[3],
                                               max_new_tokens=3)])

        out = self._serve_both(codec, reqs)
        self._compare(out, 3)
        port = out["port"][0]
        assert port["rc"].delivery is None
        assert all(port[f"r{i}"].delivery is Delivery.LAYERWISE
                   and port[f"r{i}"].matched_tokens == 4 * G
                   for i in range(3))

    def test_packed_resident_gw8(self):
        """The reference's packed async case (`TestPackedAsyncEngine`):
        gw8/g16, a cold request, then a warm one that keeps its 40-token
        prefix quantized-resident and decodes through the batcher."""
        rng = np.random.default_rng(41)
        shared = tuple(int(t) for t in rng.integers(0, 200, size=40))
        p1 = shared + tuple(int(t) for t in rng.integers(0, 200, size=8))
        p2 = shared + tuple(int(t) for t in rng.integers(0, 200, size=8))

        def reqs(_, ns):
            return [ns.serving.AsyncRequest("a", p1, 0.0, max_new_tokens=3),
                    ns.serving.AsyncRequest("b", p2, 0.5, max_new_tokens=3)]

        out = self._serve_both("gw8/g16", reqs, kv_resident="packed",
                               cap=False, warm=0)
        self._compare(out, 3)
        port = out["port"][0]
        assert port["b"].matched_tokens == 40
        assert port["b"].delivery is Delivery.LAYERWISE


class TestSequentialEquivalence:
    def test_poisson_load_bit_identical_to_sequential(self):
        """>= 8 Poisson arrivals with >= 2 fetches in flight: every
        request's logits bit-equal, and its greedy tokens equal, to the
        port's sequential engine serving the same prompt."""
        n = 8
        seq, eng, _ = _mk_stack(cap_bps=_cap())
        prompts = _warm_and_prompts(seq, n)
        results = eng.serve(_requests(prompts, _poisson(n), 3))
        assert len(results) == n and eng.peak_transfers >= 2
        seq2, _, _ = _mk_stack(cap_bps=_cap())
        for i, p in enumerate(_warm_and_prompts(seq2, n)):
            ref = seq2.submit(p, req_id=f"r{i}", max_new_tokens=3)
            np.testing.assert_array_equal(ref.logits, results[f"r{i}"].logits)
            assert ref.new_tokens == results[f"r{i}"].new_tokens
            assert ref.matched_tokens == results[f"r{i}"].matched_tokens

    def test_packed_matches_fp(self):
        """Residency is a memory layout: packed async logits within 1e-4 of
        fp async ones at fp32 (the reference's bar), tokens equal."""
        rng = np.random.default_rng(41)
        shared = tuple(int(t) for t in rng.integers(0, 200, size=40))
        p1 = shared + tuple(int(t) for t in rng.integers(0, 200, size=8))
        p2 = shared + tuple(int(t) for t in rng.integers(0, 200, size=8))
        reqs = [AsyncRequest("a", p1, 0.0, max_new_tokens=3),
                AsyncRequest("b", p2, 0.5, max_new_tokens=3)]
        rf = _mk_stack(codec="gw8/g16")[1].serve(reqs)
        rp = _mk_stack(codec="gw8/g16", kv_resident="packed")[1].serve(reqs)
        assert rp["b"].matched_tokens == 40
        for rid in ("a", "b"):
            np.testing.assert_allclose(rp[rid].logits, rf[rid].logits,
                                       rtol=0, atol=1e-4)
            assert rp[rid].new_tokens == rf[rid].new_tokens

    def test_decode_runs_in_batcher_slots(self, monkeypatch):
        """Decode goes through the continuous batcher: slots turn over (a
        request waits in its queue) and all requests finish their budget."""
        seq, eng, _ = _mk_stack(cap_bps=_cap())
        prompts = _warm_and_prompts(seq, 3)
        waited = []
        enqueue = ContinuousBatcher.enqueue

        def enqueue_and_look(self, req, slot_cache, first_token):
            enqueue(self, req, slot_cache, first_token)
            waited.extend(r.req_id for r, _, _ in self.queue)

        monkeypatch.setattr(ContinuousBatcher, "enqueue", enqueue_and_look)
        results = eng.serve(_requests(prompts, [0.0, 0.001, 0.002], 4))
        assert eng.batcher is not None and eng.batcher.steps > 0
        assert eng.batcher.num_slots == 2 and waited
        assert all(len(r.new_tokens) == 4 for r in results.values())
        assert eng.batcher.cache.device.type == "cpu"

    def test_live_monitors_change_no_virtual_timestamp(self):
        """StreamMonitor and SLOMonitor attached leave every virtual
        timestamp bit-identical while still recording every request."""
        n = 3

        def serve(monitor=None, slo=None):
            seq, eng, _ = _mk_stack(cap_bps=_cap(), monitor=monitor, slo=slo)
            prompts = _warm_and_prompts(seq, n)
            reqs = [AsyncRequest(f"r{i}", tuple(map(int, p)), 0.001 * i,
                                 tenant=("gold" if i == 0 else "bronze"))
                    for i, p in enumerate(prompts)]
            return eng, eng.serve(reqs)

        _, bare = serve()
        monitor = StreamMonitor(width_s=0.01)
        slo = SLOMonitor([SLOTarget(ttft_s=1e-9)], width_s=0.01)
        eng, monitored = serve(monitor=monitor, slo=slo)
        for rid in bare:
            a, b = bare[rid].record, monitored[rid].record
            assert (a.admit_s, a.flow_done_s, a.prefill_done_s) \
                == (b.admit_s, b.flow_done_s, b.prefill_done_s)  # exact
        assert monitor.series("ttft_s").total().count == n
        assert sorted(monitor.tenants("ttft_s")) == ["bronze", "gold"]
        assert slo.status()[""]["total"] == n
        assert slo.status()[""]["bad"] == n  # 1 ns target: all bad
        snap = eng.metrics.snapshot()["histograms"]
        assert snap["engine.ttft_model_s{tenant=gold}"]["count"] == 1
        assert snap["engine.ttft_model_s{tenant=bronze}"]["count"] == n - 1

    def test_commit_makes_later_requests_hit(self):
        """Write-behind commit in virtual event order: a cold request's
        chunks are visible to a later arrival with the same prefix."""
        _, eng, _ = _mk_stack(cap_bps=_cap())
        rng = np.random.default_rng(3)
        base = rng.integers(0, 200, size=4 * G)
        p0 = np.concatenate([base, rng.integers(0, 200, size=G // 2)])
        p1 = np.concatenate([base, rng.integers(0, 200, size=G)])
        results = eng.serve([AsyncRequest("r0", tuple(map(int, p0)), 0.0),
                             AsyncRequest("r1", tuple(map(int, p1)), 10.0)])
        assert results["r0"].matched_tokens == 0
        assert results["r1"].matched_tokens == 4 * G
        assert results["r1"].delivery is Delivery.LAYERWISE


@pytest.mark.parametrize("codec,kv_resident,match", [
    ("identity", "packed", "quantized codec"),
    ("int8", "half", "kv_resident")])
def test_refuses_what_the_sequential_engine_refuses(codec, kv_resident,
                                                    match):
    model, params, _ = _models()["port"]
    orch = serving.Orchestrator(core.RadixIndex(G),
                                core.Gateway(core.InMemoryStore()),
                                _spec(codec))
    with pytest.raises(ValueError, match=match):
        serving.AsyncEngine(model, params, orch, compute=_compute(),
                            kv_resident=kv_resident)


# ---------------------------------------------------------------------------
# ContinuousBatcher
# ---------------------------------------------------------------------------
def _prefill(prompt):
    model, _, runner = _models()["port"]
    lg, cache = runner.prefill({"tokens": torch.as_tensor(
        np.asarray(prompt, np.int64))[None]})
    return int(lg[0, :model.cfg.vocab_size].argmax()), cache


def _batcher(num_slots=2, max_seq=64, eos_id=None):
    model, params, _ = _models()["port"]
    return ContinuousBatcher(model, params, num_slots, max_seq, eos_id=eos_id)


def _run_one(batcher, prompt, max_new_tokens, req_id="r"):
    first, cache = _prefill(prompt)
    req = SlotRequest(req_id, len(prompt), max_new_tokens)
    batcher.enqueue(req, cache, first)
    batcher.drain()
    return req


def _prompt(seed):
    return np.random.default_rng(seed).integers(0, 200, size=16)


class TestBatcher:
    def test_length_exit(self):
        req = _run_one(_batcher(), _prompt(0), 6)
        assert req.done and len(req.tokens_out) == 6

    def test_eos_exit(self):
        """Decoding stops the moment a decoded token equals ``eos_id`` and
        keeps that token.  The EOS is taken from an unconstrained run: every
        decoded token (index >= 1) whose value did not appear earlier among
        the decoded tokens, so the first step that samples it is that index
        (a repeated value would stop the batcher at its first occurrence).
        The prefill token (index 0) is never checked against EOS."""
        prompt = _prompt(1)
        ref = _run_one(_batcher(), prompt, 8).tokens_out
        assert len(ref) == 8
        firsts = [i for i in range(1, len(ref)) if ref[i] not in ref[1:i]]
        for i in firsts:
            req = _run_one(_batcher(eos_id=ref[i]), prompt, 8)
            assert req.done
            assert req.tokens_out == ref[:i + 1], (i, ref)

    def test_eos_none_never_triggers(self):
        req = _run_one(_batcher(eos_id=None), _prompt(2), 5)
        assert len(req.tokens_out) == 5

    def test_last_cache_slot_is_usable(self):
        """With room for k decode writes a request emits k + 1 tokens, and
        the token that used the last cache slot decodes as it does in an
        unconstrained cache."""
        prompt, k = _prompt(3), 4
        req = _run_one(_batcher(max_seq=len(prompt) + k), prompt, 100)
        assert req.done and len(req.tokens_out) == k + 1
        assert req.tokens_out == _run_one(_batcher(), prompt,
                                          k + 1).tokens_out

    def test_slot_left_at_max_seq_stays_empty_while_others_decode(self):
        """A request that leaves on the max_seq rule keeps its position at
        max_seq; the next steps of the other slot must not write there (one
        past the cache), and the survivor decodes as it does alone."""
        short, long_ = _prompt(6)[:12], _prompt(7)
        max_seq = len(short) + 2
        b = _batcher(max_seq=max_seq)
        reqs = []
        for i, (p, n) in enumerate(((short, 100), (long_[:max_seq - 6], 5))):
            first, cache = _prefill(p)
            reqs.append(SlotRequest(f"r{i}", len(p), n))
            b.enqueue(reqs[-1], cache, first)
        b.drain()
        assert len(reqs[0].tokens_out) == 3 and len(reqs[1].tokens_out) == 5
        solo = _run_one(_batcher(max_seq=max_seq), long_[:max_seq - 6], 5)
        assert reqs[1].tokens_out == solo.tokens_out

    def test_queued_request_enters_freed_slot(self):
        b = _batcher(num_slots=1)
        reqs = []
        for i, n in enumerate((3, 5)):
            first, cache = _prefill(_prompt(4 + i))
            reqs.append(SlotRequest(f"r{i}", 16, n))
            b.enqueue(reqs[-1], cache, first)
        assert b.active[0] is reqs[0] and len(b.queue) == 1
        done = b.drain()
        assert [r.req_id for r in done] == ["r0", "r1"]
        assert len(reqs[0].tokens_out) == 3 and len(reqs[1].tokens_out) == 5

    def test_batched_decode_matches_solo_decode(self):
        """Two requests sharing a slot batch decode the tokens they decode
        alone: per-slot positions isolate the KV."""
        prompts = [_prompt(5), _prompt(8)]
        solo = [_run_one(_batcher(), p, 4, f"s{i}").tokens_out
                for i, p in enumerate(prompts)]
        b = _batcher()
        reqs = []
        for i, p in enumerate(prompts):
            first, cache = _prefill(p)
            reqs.append(SlotRequest(f"b{i}", len(p), 4))
            b.enqueue(reqs[-1], cache, first)
        b.drain()
        assert [r.tokens_out for r in reqs] == solo
