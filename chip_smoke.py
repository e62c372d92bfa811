#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each one fails the run, with a non-zero exit, if it goes wrong):
  1. device and build: the card's name and power limit, torch and CUDA
     versions; builds every CUDA kernel of ``src/repro_torch/kernels/csrc``
     from scratch with nvcc (sm_90a) and prints the build time;
  2. kernels against their plain PyTorch versions on the card, at the
     serving path's shapes and on ragged shapes: the dequant kernels K1/K2
     with tolerance 0 (each output is one fp32 multiply and one rounding in
     both versions), the fused dequant-attention kernels K6/K7 (with the
     in-kernel tile dequant K3) within the tolerances of `attention_close`;
     device time of each kernel (CUDA events), host time per call, the plain
     version's time, and the bound;
  3. the serving path at full width: llama3-1-8b (32 layers, d_model 4096,
     bf16, random weights from seed 0), for each wire codec a cold request of
     4096 tokens then a warm request that shares 15 chunks of 256 tokens and
     is served layerwise, plus the same warm request served chunkwise
     (fp-resident); then, for each quantized codec, the same two requests on
     a packed-resident engine (``kv_resident="packed"``) on a fresh store;
  4. checks on those paths: layerwise delivery, 3840 matched tokens, exactly
     64 launches of the codec's dequant kernel per fp-resident quantized warm
     request, exactly 32 K7 and 224 K6 launches (and no K1/K2) per packed
     warm request, wire-sized commits, layerwise == chunkwise logits,
     identity warm == full prefill within a bf16 tolerance, packed warm ==
     fp-resident warm within a bf16 tolerance, a packed prefix smaller than
     the fp-resident one, finite logits, in-vocab tokens.

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
PACKED_CODECS = ("int8", "int4", "gw8", "gw4")
# H100 SXM data sheet peaks (the card's power limit is printed beside them)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12  # for the note beside K7's bound only
# K6/K7 against their plain versions: the sums run in another order, so bit
# equality is not asked.  fp32 out within ATTN_FP32_TOL; a bf16 out within
# one bf16 rounding step of the plain version's beyond that (both round
# their fp32 result once); m within ATTN_FP32_TOL (relative above 1); l, a
# sum of up to S terms of size <= 1, within ATTN_L_RTOL relative.
ATTN_FP32_TOL = 1e-5
ATTN_L_RTOL = 1e-5
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
# packed-resident warm against fp-resident warm of the same codec and bytes:
# both run fp32 attention over the same dequantized values, but they round
# to bf16 at different places.  The fp path rounds every dequantized prefix
# K/V value and the softmax probabilities to bf16 before the value product;
# the packed path rounds only the prefix's attention output (as the
# reference's fused kernel does) and merges in fp32.  Each layer's attention
# output therefore differs by about one bf16 rounding step, and the residual
# stream carries those steps through all 32 layers to the logits.  Bound on
# max |dlogit|: PACKED_VS_FP_ULPS bf16 steps at the scale of the largest
# logit.  A wrong chunk, scale row or head would move logits by whole units.
PACKED_VS_FP_ULPS = 8

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


def bf16_step(x: torch.Tensor) -> torch.Tensor:
    """One bf16 rounding step at the magnitude of each element of x."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


def logit_step(logits: np.ndarray) -> float:
    """One bf16 rounding step at the largest |logit|."""
    return float(2.0 ** (np.floor(np.log2(np.abs(logits).max())) - 7))


def device_breakdown(fn, args, reps: int = 20) -> dict:
    """Device time (ms) per call of each kernel that ``fn`` launches, from
    torch.profiler over ``reps`` calls on the same inputs."""
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / reps / 1e3
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


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


def attention_close(got, want):
    """(within tolerance, max |out error|) of a fused attention kernel's
    (out, m, l) against its plain version's (module constants)."""
    (o, m, l), (ow, mw, lw) = got, want
    err = float((o.float() - ow.float()).abs().max())
    if o.dtype != ow.dtype or o.shape != ow.shape:
        return False, err
    tol = ATTN_FP32_TOL
    if o.dtype == torch.bfloat16:
        tol = bf16_step(torch.maximum(o.float().abs(), ow.float().abs())) \
            + ATTN_FP32_TOL
    ok = bool(((o.float() - ow.float()).abs() <= tol).all())
    ok &= torch.equal(torch.isinf(m), torch.isinf(mw))
    fin = torch.isfinite(mw)
    ok &= bool(((m[fin] - mw[fin]).abs()
                <= ATTN_FP32_TOL * mw[fin].abs().clamp_min(1.0)).all())
    ok &= bool(((l - lw).abs() <= ATTN_L_RTOL * lw.abs()).all())
    return ok, err


def phase_attention_kernels():
    """K6 and K7 against their plain versions at the serving path's shapes
    and on ragged ones; times at the path's shapes.  K3 (the tile dequant of
    csrc/dequant_tile.cuh) has no launch of its own: it is held to the plain
    dequant through every K6/K7 case.  Returns per-kernel records."""
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import flash_attention as F
    g = torch.Generator(device="cuda").manual_seed(2)

    def packed(B, S, KV, dh, G, bits, group):
        if bits == 4:
            q = torch.randint(0, 256, (B, S, KV, dh // 2), generator=g,
                              device="cuda", dtype=torch.uint8)
        else:
            q = torch.randint(-127, 128, (B, S, KV, dh), generator=g,
                              device="cuda", dtype=torch.int8)
        # scales of the codecs' magnitude: dequantized values are O(1)
        s = (0.5 + torch.rand((B, S // G, KV * dh // group), generator=g,
                              device="cuda")) / (127 if bits == 8 else 7)
        return q, s.half()

    def query(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, S, H, KV, dh, G, lengths, bits, group, q dtype)
    path6 = (1, WARM_PREFIX, 32, 8, 128, CHUNK)
    k6_cases = [(*path6, [WARM_PREFIX], bits, grp, dt) for bits in (8, 4)
                for grp in (1, 128) for dt in (bf16, f32)]
    # ragged: S not a multiple of a CTA's split of 64, a row shorter than S,
    # an empty row; and the other head widths the kernels are built for
    # (MQA at head_dim 256, as gemma-2b; MHA at 64)
    k6_cases += [(2, 200, 8, 2, 64, 8, [200, 77], 8, 1, bf16),
                 (2, 200, 8, 2, 64, 8, [200, 77], 4, 8, f32),
                 (3, 96, 8, 1, 256, 16, [0, 1, 95], 8, 1, f32),
                 (1, 64, 4, 4, 64, 16, [64], 4, 1, bf16)]
    # (B, Sq, Sk, H, KV, dh, G, causal, q_offset, bits, group, q dtype)
    path7 = (1, CHUNK, WARM_PREFIX, 32, 8, 128, CHUNK, False, 0)
    k7_cases = [(*path7, bits, grp, dt) for bits in (8, 4)
                for grp in (1, 128) for dt in (bf16, f32)]
    # ragged: causal with q_offset > 0, Sq*H/KV not a multiple of a CTA's 64
    # query vectors
    k7_cases += [(2, 37, 96, 8, 2, 64, 16, True, 50, 8, 1, bf16),
                 (2, 37, 96, 8, 2, 64, 16, True, 50, 4, 8, f32),
                 (1, 300, WARM_PREFIX, 32, 8, 128, CHUNK, True, 3600, 4, 128,
                  bf16),
                 (1, 20, 64, 8, 1, 256, 32, True, 0, 8, 128, bf16),
                 (1, 9, 32, 4, 4, 64, 16, False, 0, 4, 1, f32)]
    err6 = err7 = 0.0
    for B, S, H, KV, dh, G, lens, bits, grp, dt in k6_cases:
        kq, ks = packed(B, S, KV, dh, G, bits, grp)
        vq, vs = packed(B, S, KV, dh, G, bits, grp)
        q = query((B, H, dh), dt)
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        args = dict(bits=bits, group=grp, chunk_tokens=G)
        got = D.decode_attention_quant(q, kq, vq, ks, vs, ln, **args)
        want = D.decode_attention_quant_ref(q, kq, vq, ks, vs, ln, **args)
        torch.cuda.synchronize()
        ok, err = attention_close(got, want)
        err6 = max(err6, err)
        check(f"decode_attention_quant vs plain B={B} S={S} H={H} KV={KV} "
              f"dh={dh} G={G} lengths={lens} bits={bits} group={grp} "
              f"q={str(dt).split('.')[-1]}", ok, f"max_abs_err={err}")
    for B, Sq, Sk, H, KV, dh, G, causal, off, bits, grp, dt in k7_cases:
        kq, ks = packed(B, Sk, KV, dh, G, bits, grp)
        vq, vs = packed(B, Sk, KV, dh, G, bits, grp)
        q = query((B, Sq, H, dh), dt)
        args = dict(bits=bits, group=grp, chunk_tokens=G, causal=causal,
                    q_offset=off)
        got = F.flash_attention_quant(q, kq, vq, ks, vs, **args)
        want = F.flash_attention_quant_ref(q, kq, vq, ks, vs, **args)
        torch.cuda.synchronize()
        ok, err = attention_close(got, want)
        err7 = max(err7, err)
        check(f"flash_attention_quant vs plain B={B} Sq={Sq} Sk={Sk} H={H} "
              f"KV={KV} dh={dh} G={G} causal={causal} q_offset={off} "
              f"bits={bits} group={grp} q={str(dt).split('.')[-1]}", ok,
              f"max_abs_err={err}")
    print("K3 dequant_tile (csrc/dequant_tile.cuh) has no launch of its own; "
          "it is held through every K6/K7 case above")

    records = []
    B, S, H, KV, dh, G = path6
    for bits in (8, 4):
        args = dict(bits=bits, group=1, chunk_tokens=G)
        ln = torch.tensor([S], dtype=torch.int32, device="cuda")
        arg_sets = []
        for _ in range(16):
            kq, ks = packed(B, S, KV, dh, G, bits, 1)
            vq, vs = packed(B, S, KV, dh, G, bits, 1)
            arg_sets.append((query((B, H, dh), bf16), kq, vq, ks, vs))
        kern_ms = device_ms(lambda *a: D.decode_attention_quant(
            *a, ln, **args), arg_sets)
        plain_ms = device_ms(lambda *a: D.decode_attention_quant_ref(
            *a, ln, **args), arg_sets)
        host = host_us(lambda *a: D.decode_attention_quant(*a, ln, **args),
                       arg_sets[0])
        nbytes = sum(t.numel() * t.element_size() for t in arg_sets[0]) \
            + ln.numel() * 4 + B * H * dh * 2 + 2 * B * H * 4
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * B * H * S * dh / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel decode_attention_quant int{bits} B={B} S={S} H={H} "
              f"KV={KV} dh={dh} q=bf16: {kern_ms * 1e3:.2f} us device, "
              f"{host:.2f} us host per call back to back, plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes} B, {4 * B * H * S * dh} FLOP; "
              f"{bound_ms / kern_ms * 100:.1f}% of bound)")
        parts = device_breakdown(lambda *a: D.decode_attention_quant(
            *a, ln, **args), arg_sets[0])
        print("  per call on the device (torch.profiler): " + "; ".join(
            f"{k.split('namespace)::')[-1].split('<')[0][:40]} "
            f"{v * 1e3:.2f} us" for k, v in parts.items()))
        if bits == 8:
            records.append(dict(
                name="decode_attention_quant", route="cuda",
                source="src/repro_torch/kernels/csrc/"
                       "decode_attention_quant.cu",
                replaces="src/repro/kernels/decode_attention.py:252",
                launches=None, max_abs_err=err6, ms=kern_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None,
                inlines="K3 dequant_tile, csrc/dequant_tile.cuh "
                        "(src/repro/kernels/kv_dequant.py:41)"))
    B, Sq, Sk, H, KV, dh, G, _, _ = path7
    for bits in (8, 4):
        args = dict(bits=bits, group=1, chunk_tokens=G, causal=False)
        arg_sets = []
        for _ in range(8):
            kq, ks = packed(B, Sk, KV, dh, G, bits, 1)
            vq, vs = packed(B, Sk, KV, dh, G, bits, 1)
            arg_sets.append((query((B, Sq, H, dh), bf16), kq, vq, ks, vs))
        kern_ms = device_ms(lambda *a: F.flash_attention_quant(*a, **args),
                            arg_sets, reps=5, batches=9)
        plain_ms = device_ms(lambda *a: F.flash_attention_quant_ref(
            *a, **args), arg_sets, reps=5, batches=9)
        host = host_us(lambda *a: F.flash_attention_quant(*a, **args),
                       arg_sets[0], reps=20)
        nbytes = sum(t.numel() * t.element_size() for t in arg_sets[0]) \
            + B * Sq * H * dh * 2 + 2 * B * Sq * H * 4
        flops = 4 * B * Sq * H * Sk * dh
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel flash_attention_quant int{bits} B={B} Sq={Sq} Sk={Sk} "
              f"H={H} KV={KV} dh={dh} q=bf16: {kern_ms * 1e3:.2f} us device, "
              f"{host:.2f} us host per call back to back, plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes} B, {flops} FLOP at the fp32 peak; "
              f"{bound_ms / kern_ms * 100:.1f}% of bound; "
              f"{flops / BF16_TENSOR_OPS_PER_S * 1e6:.2f} us at the bf16 "
              f"tensor-core peak)")
        if bits == 8:
            records.append(dict(
                name="flash_attention_quant", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention_quant.cu",
                replaces="src/repro/kernels/flash_attention.py:237",
                launches=None, max_abs_err=err7, ms=kern_ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=None,
                inlines="K3 dequant_tile, csrc/dequant_tile.cuh "
                        "(src/repro/kernels/kv_dequant.py:41)"))
    return records


def phase_serving():
    """Cold + warm requests per codec at full width, fp-resident and then
    packed-resident; returns the launch count of each kernel over each of
    the two paths (counts set to 0 just before a path, read just after)."""
    from repro_torch.configs import get_config
    from repro_torch.core import (Delivery, Gateway, InMemoryStore,
                                  RadixIndex)
    from repro_torch.kernels import launches
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

    def make_engine(codec, theta, kv_resident="fp"):
        spec = cfg.kv_spec(CHUNK, dtype_bytes=2, codec=codec)
        store = InMemoryStore()
        orch = Orchestrator(RadixIndex(CHUNK), Gateway(store), spec,
                            theta_bytes=theta)
        return ServingEngine(model, params, orch, runner=runner,
                             kv_resident=kv_resident), store

    def serve(engine, tokens, req, label):
        before = launches.snapshot()
        t0 = time.perf_counter()
        r = engine.submit(tokens, req, max_new_tokens=NEW_TOKENS)
        wall = time.perf_counter() - t0
        delta = {k: n - before[k] for k, n in launches.snapshot().items()}
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

    def profile_warm(orch, tokens, codec, kv_resident="fp"):
        """One more warm hit on the same store, traced by the engine's
        tracer and torch.profiler, with no commit and no decode: where a warm
        request's time goes, layer by layer, and how busy the card is."""
        tracer = Tracer()
        engine = ServingEngine(model, params, orch, runner=runner,
                               sync_commit=False, tracer=tracer,
                               kv_resident=kv_resident)
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
        ours = [(k, t) for k, t in kernels if any(
            n in k for n in ("dequant_", "flash_quant", "decode_split",
                             "decode_merge"))]
        print(f"  the port's kernels on the device: "
              f"{sum(t for _, t in ours) / 1e3:.3f} ms in {len(ours)} "
              f"kernel name(s)")

    # the profiler's first use sets up device tracing (seconds): pay it here
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    warm_fp, fp_prefix_bytes = {}, {}
    launches.reset()  # the fp-resident path's counts start here
    for codec in CODECS:
        lw, lw_store = make_engine(codec, 0)
        cw, cw_store = make_engine(codec, 1 << 60)
        serve(lw, cold, "cold", f"{codec}/layerwise")
        warm_lw, d_lw = serve(lw, warm, "warm", f"{codec}/layerwise")
        check(f"{codec} warm delivery is LAYERWISE",
              warm_lw.delivery is Delivery.LAYERWISE)
        check(f"{codec} warm matched_tokens", warm_lw.matched_tokens
              == WARM_PREFIX, f"{warm_lw.matched_tokens}")
        want = {k: 0 for k in launches.LAUNCHES}
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
        warm_fp[codec] = warm_lw.logits
        prefix = lw._last_cache[:, :, :, :WARM_PREFIX]
        fp_prefix_bytes[codec] = prefix.numel() * prefix.element_size()
        del lw, cw, prefix
    fp_counts = launches.snapshot()
    print(f"fp-resident serving run launches: {fp_counts}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for name in ("kv_dequant", "kv_dequant_packed4"):
        check(f"fp-resident serving path launched {name}",
              fp_counts[name] > 0, f"{fp_counts[name]} launches")

    torch.cuda.reset_peak_memory_stats()
    launches.reset()  # the packed-resident path's counts start here
    for codec in PACKED_CODECS:
        pk, pk_store = make_engine(codec, 0, kv_resident="packed")
        serve(pk, cold, "cold", f"{codec}/packed")
        warm_pk, d_pk = serve(pk, warm, "warm", f"{codec}/packed")
        check(f"{codec}/packed warm delivery is LAYERWISE",
              warm_pk.delivery is Delivery.LAYERWISE)
        check(f"{codec}/packed warm matched_tokens", warm_pk.matched_tokens
              == WARM_PREFIX, f"{warm_pk.matched_tokens}")
        want = {k: 0 for k in launches.LAUNCHES}
        want["flash_attention_quant"] = cfg.num_layers
        want["decode_attention_quant"] = cfg.num_layers * (NEW_TOKENS - 1)
        check(f"{codec}/packed warm launches", d_pk == want,
              f"got {d_pk} want {want}")
        written = pk_store.stats.snapshot()["bytes_written"]
        expect = pk.stats.commits * pk.spec.wire_chunk_bytes
        check(f"{codec}/packed bytes_written == commits x wire_chunk_bytes",
              written == expect, f"{written} vs {pk.stats.commits} x "
              f"{pk.spec.wire_chunk_bytes}")
        held = sum(pkv.resident_bytes for pkv in pk._last_packed[0])
        check(f"{codec}/packed resident prefix below the fp-resident one",
              held < fp_prefix_bytes[codec],
              f"packed {held} B vs fp-resident {fp_prefix_bytes[codec]} B "
              f"({held / fp_prefix_bytes[codec]:.4f})")
        diff = float(np.abs(warm_pk.logits - warm_fp[codec]).max())
        step = logit_step(warm_fp[codec][:cfg.vocab_size])
        tol = PACKED_VS_FP_ULPS * step
        same_argmax = int(np.argmax(warm_pk.logits)) \
            == int(np.argmax(warm_fp[codec]))
        check(f"{codec} packed vs fp-resident warm logits", diff <= tol,
              f"max_abs_diff={diff} ({diff / step:.2f} bf16 steps) tol={tol}"
              f" argmax_equal={same_argmax}")
        if codec in ("int8", "int4"):
            profile_warm(pk.orch, warm, f"{codec}/packed",
                         kv_resident="packed")
        del pk
    packed_counts = launches.snapshot()
    print(f"packed-resident serving run launches: {packed_counts}; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} "
          f"GiB")
    for name in ("flash_attention_quant", "decode_attention_quant"):
        check(f"packed-resident serving path launched {name}",
              packed_counts[name] > 0, f"{packed_counts[name]} launches")
    return fp_counts, packed_counts


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
    records = phase_kernels() + phase_attention_kernels()
    fp_counts, packed_counts = phase_serving()
    for rec in records:
        path = fp_counts if rec["name"].startswith("kv_dequant") \
            else packed_counts
        rec["launches"] = path[rec["name"]]
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
