#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each one fails the run, with a non-zero exit, if it goes wrong):
  1. device and build: the card's name and power limit, torch and CUDA
     versions; builds every CUDA kernel of ``src/repro_torch/kernels/csrc``
     from scratch with nvcc (sm_90a) and prints the build time;
  2. kernels against their plain PyTorch versions on the card, at the
     serving path's shape and on ragged shapes, with tolerance 0 (each output
     is one fp32 multiply and one rounding in both versions); device time of
     each kernel (CUDA events), of its plain version, and its bound;
  3. the serving path at full width: llama3-1-8b (32 layers, d_model 4096,
     bf16, random weights from seed 0), for each wire codec a cold request of
     4096 tokens then a warm request that shares 15 chunks of 256 tokens and
     is served layerwise, plus the same warm request served chunkwise;
  4. checks on that path: layerwise delivery, 3840 matched tokens, exactly 64
     launches of the codec's dequant kernel per quantized warm request,
     wire-sized commits, layerwise == chunkwise logits, identity warm ==
     full prefill within a bf16 tolerance, finite logits, in-vocab tokens.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits with an error and prints no result.
"""
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
ARCH = "llama3-1-8b"
CHUNK = 256
COLD_TOKENS = 4096
WARM_PREFIX = 3840  # 15 chunks
NEW_TOKENS = 8
CODECS = ("identity", "int8", "int4", "gw8", "gw4")
# which dequant kernel each quantized codec's layers run (all 32 layers share
# the codec's width): 2 launches (K, V) per layer
KERNEL_OF = {"int8": "kv_dequant", "gw8": "kv_dequant",
             "int4": "kv_dequant_packed4", "gw4": "kv_dequant_packed4"}
# H100 SXM data sheet peaks (the card's power limit is printed beside them)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# identity warm (suffix of 256 over a 3840-token prefix) against a full
# prefill of the same 4096 tokens: the matrix products have other shapes, so
# cuBLAS may sum in another order and a bf16 activation may come out one
# rounding step apart.  Bound on max |dlogit|: two bf16 rounding steps at the
# scale of the largest logit, 2 * 2**(floor(log2(max|logit|)) - 7).
IDENTITY_VS_FULL_ULPS = 2
# layerwise vs chunkwise of the same warm prompt: both paths feed the same
# dequantized bf16 values into the same ops at the same shapes, so the
# logits must be bit-equal.
LAYERWISE_VS_CHUNKWISE_TOL = 0.0

FAILURES = []


def check(name: str, ok: bool, detail: str = "") -> None:
    print(f"check {'PASS' if ok else 'FAIL'} {name} {detail}".rstrip())
    if not ok:
        FAILURES.append(name)


def device_ms(fn, arg_sets, reps: int = 20, batches: int = 25) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    back-to-back calls that rotate over ``arg_sets`` (whose inputs together
    exceed the 50 MB L2, so each call reads device memory).  A sleep kernel
    queued first lets the host enqueue the whole batch before the device
    starts, so the events time the device, not the launches."""
    for args in arg_sets[:3]:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for b in range(batches):
        torch.cuda._sleep(20_000_000)
        start.record()
        for i in range(reps):
            fn(*arg_sets[(b * reps + i) % len(arg_sets)])
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, args, reps: int = 200) -> float:
    """Wall time of one call as the host issues them back to back (launch
    overhead included), ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e6


def phase_device_and_build():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from repro_torch.kernels import build
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)  # build from scratch
    t0 = time.perf_counter()
    report = build.build()
    wall = time.perf_counter() - t0
    for name, r in report.items():
        regs = [ln.strip() for ln in r["log"].splitlines() if "registers" in ln]
        print(f"built {name} in {r['seconds']:.2f} s: {'; '.join(regs)}")
    print(f"build wall time {wall:.2f} s for {len(report)} source(s)")


def phase_kernels():
    """Each kernel bit-equal to its plain version; times at the path's shape.
    Returns per-kernel records (launches filled in after the serving path)."""
    from repro_torch.kernels import kv_dequant as K
    g = torch.Generator(device="cuda").manual_seed(1)

    def inputs(N, R, W, group, packed):
        if packed:
            q = torch.randint(0, 256, (N, R, W // 2), generator=g,
                              device="cuda", dtype=torch.uint8)
        else:
            q = torch.randint(-128, 128, (N, R, W), generator=g,
                              device="cuda", dtype=torch.int8)
        s = torch.randn((N, W // group), generator=g, device="cuda").half()
        return q, s

    kernels = {
        "kv_dequant": (K.kv_dequant, K.kv_dequant_ref, False,
                       "src/repro/kernels/kv_dequant.py:88"),
        "kv_dequant_packed4": (K.kv_dequant_packed4, K.kv_dequant_packed4_ref,
                               True, "src/repro/kernels/kv_dequant.py:108"),
    }
    main_shape = (15, CHUNK, 1024)  # N chunks, R tokens, W = KV * dh
    cases = [(main_shape, grp, od) for grp in (1, 128)
             for od in (torch.bfloat16, torch.float32)]
    # ragged: odd chunk and row counts on the vector path, and widths that
    # are not a multiple of 8 (scalar path, flat size not a multiple of a
    # thread's 8 outputs)
    cases += [((3, 5, 24), 8, torch.bfloat16), ((2, 7, 40), 2, torch.float32),
              ((1, 3, 1030), 2, torch.bfloat16), ((2, 3, 20), 4, torch.float32)]
    records = []
    for name, (kern, plain, packed, replaces) in kernels.items():
        max_err = 0.0
        for (N, R, W), grp, od in cases:
            q, s = inputs(N, R, W, grp, packed)
            got = kern(q, s, group=grp, out_dtype=od)
            want = plain(q, s, group=grp, out_dtype=od)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            equal = torch.equal(got, want)
            max_err = max(max_err, err)
            check(f"{name} bit-equal to plain N={N} R={R} W={W} group={grp} "
                  f"out={str(od).split('.')[-1]}", equal,
                  f"max_abs_err={err}")
        # time at the serving path's shape, bf16 out, per-channel scales
        N, R, W = main_shape
        arg_sets = [inputs(N, R, W, 1, packed) for _ in range(16)]
        kern_ms = device_ms(lambda q, s: kern(q, s, group=1,
                                              out_dtype=torch.bfloat16),
                            arg_sets)
        plain_ms = device_ms(lambda q, s: plain(q, s, group=1,
                                                out_dtype=torch.bfloat16),
                             arg_sets)
        launch_us = host_us(lambda q, s: kern(q, s, group=1,
                                              out_dtype=torch.bfloat16),
                            arg_sets[0])
        in_bytes = N * R * (W // 2 if packed else W)
        nbytes = in_bytes + N * W * 2 + N * R * W * 2
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = N * R * W / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel {name} N={N} R={R} W={W} group=1 out=bf16: "
              f"{kern_ms * 1e3:.2f} us device, {launch_us:.2f} us host per "
              f"call back to back, plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.2f} us ({nbytes} B; "
              f"{bound_ms / kern_ms * 100:.1f}% of bound)")
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kv_dequant.cu",
            "replaces": replaces, "launches": None, "max_abs_err": max_err,
            "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None})
    return records


def phase_serving():
    """Cold + warm requests per codec at full width; returns the launch count
    of each kernel over the whole serving run."""
    from repro_torch.configs import get_config
    from repro_torch.core import (Delivery, Gateway, InMemoryStore,
                                  RadixIndex)
    from repro_torch.kernels import kv_dequant as K
    from repro_torch.models import build_model
    from repro_torch.obs import Tracer
    from repro_torch.serving import ModelRunner, Orchestrator, ServingEngine

    cfg = get_config(ARCH)
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads, head_dim "
          f"{cfg.head_dim}, {cfg.compute_dtype}; {cfg.param_count() / 1e9:.2f}"
          f" B params initialised in {time.perf_counter() - t0:.1f} s")
    runner = ModelRunner(model, params)
    rng = np.random.default_rng(0)
    cold = rng.integers(0, cfg.vocab_size, size=COLD_TOKENS)
    warm = np.concatenate([cold[:WARM_PREFIX],
                           rng.integers(0, cfg.vocab_size,
                                        size=COLD_TOKENS - WARM_PREFIX)])

    def make_engine(codec, theta):
        spec = cfg.kv_spec(CHUNK, dtype_bytes=2, codec=codec)
        store = InMemoryStore()
        orch = Orchestrator(RadixIndex(CHUNK), Gateway(store), spec,
                            theta_bytes=theta)
        return ServingEngine(model, params, orch, runner=runner), store

    def serve(engine, tokens, req, label):
        before = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        r = engine.submit(tokens, req, max_new_tokens=NEW_TOKENS)
        wall = time.perf_counter() - t0
        delta = {k: K.LAUNCHES[k] - before[k] for k in K.LAUNCHES}
        print(f"request {label} {req}: delivery="
              f"{r.delivery.name if r.delivery else 'none'} matched="
              f"{r.matched_tokens} ttft_model_s={r.ttft_model_s:.6f} "
              f"compute_s={r.compute_s:.6f} transfer_completion_s="
              f"{r.transfer_completion_s:.6f} submit_wall_s={wall:.3f} "
              f"launches={delta} tokens={r.new_tokens}")
        lg = r.logits[:cfg.vocab_size]
        check(f"{label} {req} logits finite", bool(np.isfinite(lg).all()))
        check(f"{label} {req} tokens in vocab",
              len(r.new_tokens) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.new_tokens))
        return r, delta

    def profile_warm(orch, tokens, codec):
        """One more warm hit on the same store, traced by the engine's
        tracer and torch.profiler, with no commit and no decode: where a warm
        request's time goes, layer by layer, and how busy the card is."""
        tracer = Tracer()
        engine = ServingEngine(model, params, orch, runner=runner,
                               sync_commit=False, tracer=tracer)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            r = engine.submit(tokens, "profiled")
        wall = time.perf_counter() - t0

        def ms(name):
            return [(sp.t1 - sp.t0) * 1e3 for sp in tracer.spans("profiled",
                                                                 name)]
        deq, comp = ms("dequant"), ms("compute")
        # device-side events only (kernels, copies): a CPU op's device time
        # is the sum of these, so counting both would count twice
        kernels = sorted(((e.key, e.self_device_time_total)
                          for e in prof.key_averages()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda kv: -kv[1])
        device_ms = sum(t for _, t in kernels) / 1e3
        print(f"profile {codec} warm (no commit, no decode, under the "
              f"profiler): wall {wall * 1e3:.1f} ms, ttft_model_s "
              f"{r.ttft_model_s:.6f}; plan {sum(ms('plan')):.2f} ms, fetch "
              f"{sum(ms('fetch')):.2f} ms; per layer dequant {np.mean(deq):.3f}"
              f" ms (sum {sum(deq):.1f}), compute {np.mean(comp):.3f} ms (sum "
              f"{sum(comp):.1f}); device kernel time {device_ms:.2f} ms = "
              f"{device_ms / (wall * 1e3) * 100:.1f}% of wall")
        for key, t in kernels[:6]:
            print(f"  device {t / 1e3:8.3f} ms  {key[:90]}")
        ours = [(k, t) for k, t in kernels if "dequant" in k]
        print(f"  dequant kernels on the device: "
              f"{sum(t for _, t in ours) / 1e3:.3f} ms in {len(ours)} "
              f"kernel name(s)")

    # the profiler's first use sets up device tracing (seconds): pay it here
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()  # the serving run's counts start here
    for codec in CODECS:
        lw, lw_store = make_engine(codec, 0)
        cw, cw_store = make_engine(codec, 1 << 60)
        serve(lw, cold, "cold", f"{codec}/layerwise")
        warm_lw, d_lw = serve(lw, warm, "warm", f"{codec}/layerwise")
        check(f"{codec} warm delivery is LAYERWISE",
              warm_lw.delivery is Delivery.LAYERWISE)
        check(f"{codec} warm matched_tokens", warm_lw.matched_tokens
              == WARM_PREFIX, f"{warm_lw.matched_tokens}")
        want = {k: 0 for k in K.LAUNCHES}
        if codec in KERNEL_OF:
            want[KERNEL_OF[codec]] = 2 * cfg.num_layers
        check(f"{codec} warm dequant launches", d_lw == want,
              f"got {d_lw} want {want}")
        serve(cw, cold, "cold", f"{codec}/chunkwise")
        warm_cw, d_cw = serve(cw, warm, "warm", f"{codec}/chunkwise")
        check(f"{codec} chunkwise warm delivery is CHUNKWISE",
              warm_cw.delivery is Delivery.CHUNKWISE)
        check(f"{codec} chunkwise dequantizes on the host",
              all(v == 0 for v in d_cw.values()), f"{d_cw}")
        diff = float(np.abs(warm_lw.logits - warm_cw.logits).max())
        check(f"{codec} layerwise vs chunkwise logits",
              diff <= LAYERWISE_VS_CHUNKWISE_TOL,
              f"max_abs_diff={diff} tol={LAYERWISE_VS_CHUNKWISE_TOL}")
        for label, engine, store in (("layerwise", lw, lw_store),
                                     ("chunkwise", cw, cw_store)):
            written = store.stats.snapshot()["bytes_written"]
            expect = engine.stats.commits * engine.spec.wire_chunk_bytes
            check(f"{codec}/{label} bytes_written == commits x "
                  f"wire_chunk_bytes", written == expect,
                  f"{written} vs {engine.stats.commits} x "
                  f"{engine.spec.wire_chunk_bytes}")
        if codec == "identity":
            tokens = torch.as_tensor(warm, dtype=torch.int64,
                                     device="cuda")[None]
            lg_full, _ = runner.prefill({"tokens": tokens})
            full = lg_full[0].float().cpu().numpy()
            diff = float(np.abs(warm_lw.logits - full).max())
            scale = float(np.abs(full[:cfg.vocab_size]).max())
            tol = IDENTITY_VS_FULL_ULPS * 2.0 ** (np.floor(np.log2(scale)) - 7)
            check("identity warm vs full prefill logits", diff <= tol,
                  f"max_abs_diff={diff} max_abs_logit={scale} "
                  f"tol={tol} argmax_equal="
                  f"{int(np.argmax(full)) == int(np.argmax(warm_lw.logits))}")
        if codec in ("identity", "int8", "int4"):
            profile_warm(lw.orch, warm, codec)
        del lw, cw
    counts = dict(K.LAUNCHES)
    print(f"serving run launches: {counts}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for name, n in counts.items():
        check(f"serving path launched {name}", n > 0, f"{n} launches")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one "
              "NVIDIA H100 and has no CPU path", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_device_and_build()
    records = phase_kernels()
    counts = phase_serving()
    for rec in records:
        rec["launches"] = counts[rec["name"]]
    print(f"total wall time {time.perf_counter() - t0:.1f} s")
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
