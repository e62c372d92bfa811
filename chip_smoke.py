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
     both versions; also at every config's width with every group of
     DEQUANT_GROUPS that divides it, at ragged widths, and on views at a
     storage offset of one element, which take the per-element path), the
     fused dequant-attention kernels K6/K7 (with the
     in-kernel tile dequant K3) within the tolerances of `attention_close`
     (K6 also on long caches, both at every query-head group of the
     configs, GQA_CASES, K7 also with the gw codecs' scales, and K7
     with bf16 q scaled by 16 against the same formula in float64), the
     count of HGMMA instructions in K7's library (its bf16 path runs on the
     tensor cores), and the profiler's kernels of one call (K6: the split
     decode alone; K7 bf16: the wgmma loop alone); device time of each
     kernel (CUDA events), host time per call, the plain version's time,
     and the bound (K1/K2 also beside one eager PyTorch conversion that
     moves the same bytes, a yardstick, not the same function);
 2b. the attention kernels over fp K/V, K4 (flash) and K5 (decode), within
     the tolerances of `out_close` of their plain versions (K4 with q
     scaled by 16 of the same formula in float64: at such logits the plain
     version's own fp32 rounding exceeds them), the count of HGMMA
     instructions in K4's library (its bf16 path runs on the tensor
     cores), and the chunk-tile gather K8 with
     tolerance 0, against their plain versions at llama3-1-8b's attention
     shapes (32 heads, 8 KV heads, head_dim 128, bf16; chunks of 256
     tokens) and on ragged ones; device, host, plain and bound times, and
     the time of the one PyTorch call that computes the same function (a
     yardstick the port never calls);
 2c. the public kernel ops `flash_attention_op`, `decode_attention_op` and
     `kv_gather_op` (counts set to 0 just before, read just after) on the
     served model's own data: K4 on layer 0's roped q/k/v of the cold
     4096-token prompt, K5 on the next token's q against that layer's cache,
     each held to its plain version and to the model's `attention_scores`
     within a stated bound; K8 on an arena of the identity store's chunk
     objects, byte-equal to the layer payloads the storage server
     aggregates for the warm request;
  3. the serving path at full width: llama3-1-8b (32 layers, d_model 4096,
     bf16, random weights from seed 0), for each wire codec a cold request of
     4096 tokens then a warm request that shares 15 chunks of 256 tokens and
     is served layerwise, plus the same warm request served chunkwise
     (fp-resident); then, for each quantized codec, the same two requests on
     a packed-resident engine (``kv_resident="packed"``) on a fresh store;
  4. checks on those paths: layerwise delivery, 3840 matched tokens, exactly
     64 launches of the codec's dequant kernel per fp-resident quantized warm
     request, exactly 32 K7 and 224 K6 launches (and no K1/K2) per packed
     warm request, no K4, K5 or K8 launch on either, wire-sized commits,
     layerwise == chunkwise logits, identity warm == full prefill within a
     bf16 tolerance, packed warm == fp-resident warm within a bf16
     tolerance, a packed prefix smaller than the fp-resident one, finite
     logits, in-vocab tokens;
  5. concurrent serving at the same width: `AsyncEngine` over one
     `BandwidthPool` (a cap of twice one warm flow's zero-stall rate, at
     most four fetches admitted) with decode in two `ContinuousBatcher`
     slots, int8 fp-resident and then int8 packed-resident, each on a fresh
     store whose three 3840-token prefixes a sequential engine warmed first.
     Five warm requests cycle over the prefixes with tails of their own, one
     cold 4096-token request rides along as a recompute flight; Poisson
     arrivals on the virtual clock, 8 greedy tokens each; then, on the
     fp-resident engine, a burst of one more warm request per prefix at one
     instant.  Checks: two or more fetches in flight at once; layerwise
     delivery of 3840 tokens (the cold one: none, no wire bytes); each
     request's admit, flow-done, prefill-done and ttft equal to the port's
     `ClusterSim` on the same trace within 1e-9; fp-resident prefill logits
     bit-equal to a sequential engine's on a fresh stack warmed the same
     way, and its decode steps within BATCHED_VS_SOLO_ULPS of the
     sequential ones, the tokens equal or parting only at a near tie;
     packed logits within PACKED_VS_FP_ULPS of the fp ones, under the same
     rule for tokens; exactly 64 K1 launches per warm request fp-resident,
     32 K7 and 64 K1 (the packed -> batcher boundary) per warm request
     packed-resident, no other kernel; decode slots turned over, and in the
     burst a request waited for a slot.  Printed per request: the virtual
     times (the transport model and `PaperComputeModel`, not card times),
     the wall time the card spent on it (`wall_compute_s`,
     `wall_dequant_s`), and each `serve()`'s wall time.

The last two lines of standard output are the kernels' JSON record (all
seven kernels; K1/K2 launches from phase 3's fp-resident path, K6/K7 from
its packed-resident one, K4/K5/K8 from phase 2c; phase 5's counts are
printed before it) and
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits with an error and prints no result.
"""
import collections
import json
import math
import random
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
FP32_OPS_PER_S = 67e12  # outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # dense, on the tensor cores
# llama3-1-8b's attention shape (the served model's)
HEADS, KV_HEADS, HEAD_DIM = 32, 8, 128
# (H, KV, dh) of the query-head groups the other configs use, beside
# llama's 4: 2 (qwen3-0.6b 16/8), 3 (smollm-135m 9/3, dh 64), 5 (llama4 and
# qwen3-14b 40/8), 6 (internvl2 48/8), and 1 (MHA)
GQA_CASES = [(16, 8, 128), (9, 3, 64), (40, 8, 128), (48, 8, 128),
             (8, 8, 128)]
# K1/K2 widths W = KV * dh: the configs' (smollm 192, gemma-2b 256,
# llama3-1-8b / qwen3 / internvl2 1024, whisper 1280, zamba2 2048) and
# ragged ones, each with every group of DEQUANT_GROUPS that divides it
CONFIG_WIDTHS = (192, 256, 1024, 1280, 2048)
RAGGED_WIDTHS = (20, 24, 40, 1030)
DEQUANT_GROUPS = (1, 2, 3, 8, 64, 128)
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
# K4/K5 on the served model's data against the model's own
# `layers.attention_scores`: the model rounds the softmax probabilities to
# bf16 before the value product; the kernels keep them in fp32 and round only
# the output.  A probability moves by at most 2**-9 of itself in that
# rounding, so element (row, head, d) of the value sum moves by at most
# 2**-9 * sum_j p_j |v_jd|; each side then rounds its fp32 sum to bf16 once,
# half a step at most.  The logits are fp32 products of the same bf16 inputs
# on both sides (sums in another order, ~1e-6).  The model's value product is
# run with fp32 reductions (no reduced-precision split-K).  Bound on each
# |dout|, element by element so that a fault in a few rows cannot hide under
# the largest ones: MODEL_OUT_ULPS bf16 steps at that |out| + MODEL_P_ROUND *
# sum_j p_j |v_jd| (the model's own probabilities, twice the rounding for the
# fp32 sums' order).  A wrong head, mask or GQA mapping moves outputs by
# whole units.
MODEL_OUT_ULPS = 2
MODEL_P_ROUND = 2.0 ** -8
# phase 5, concurrent serving: five warm requests cycling over three
# 3840-token prefixes (each with its own 256-token tail) and one cold
# 4096-token request, Poisson arrivals on the virtual clock (mean gap 4 ms,
# random.Random(7)), 8 greedy tokens each through two decode slots; a
# bandwidth cap of twice one warm flow's zero-stall rate, so three or more
# flows contend, and at most four fetches admitted at once.  The virtual
# timeline is host arithmetic, so it must equal the oracle's within
# ASYNC_TIMELINE_TOL (the reference tests' bound).
ASYNC_PREFIXES = 3
ASYNC_WARM = 5
ASYNC_SLOTS = 2
ASYNC_MAX_SEQ = 4352
ASYNC_MAX_FLOWS = 4
ASYNC_MEAN_GAP_S = 0.004
ASYNC_TIMELINE_TOL = 1e-9
# Poisson arrivals this sparse let the 32-layer flights dispatch so many
# events (one decode step each) that the two slots drain before the next
# prefill ends: no request waits for a slot.  A burst of one warm request per
# prefix at one instant, on the same engine after the Poisson run, ends three
# prefills together, so the third waits.
ASYNC_BURST_AT_S = 1.0
# async (two slots over a 4352-token cache) against sequential (one sequence
# over its own 4104-token cache) decode: the same prefill logits, but each
# decode step's matrix products and softmax run at other shapes, so a bf16
# activation may round one step apart per op, as in the packed-vs-fp case,
# and the residual stream carries those steps through 32 layers.  Bound on
# each step's max |dlogit|, until the streams part: BATCHED_VS_SOLO_ULPS
# bf16 steps at the scale of the largest logit; a parting is allowed only
# at a near tie (top two within that bound).  A wrong slot, position or
# cache row moves logits by whole units.
BATCHED_VS_SOLO_ULPS = 8

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


def ops_per_s(dtype: torch.dtype) -> float:
    """The card's peak rate for the attention products of inputs of this
    type, which bounds K4-K7 whatever units a kernel uses: q (fp32 or bf16)
    sets it, since the packed caches' int8 or int4 values widen exactly to
    bf16 and int8's tensor-core peak is above bf16's."""
    return FP32_OPS_PER_S if dtype == torch.float32 else BF16_TENSOR_OPS_PER_S


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


def kernel_name(key: str) -> str:
    """A profiler kernel name without its template arguments and
    parameters: ``void ds::decode_split_kernel<...>(...)`` ->
    ``ds::decode_split_kernel``."""
    key = key.replace("(anonymous namespace)::", "")
    return key.split("<")[0].split("(")[0].split()[-1][:40]


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
        regs = [ln.strip() for ln in r["log"].splitlines()
                if "registers" in ln or "warning" in ln.lower()
                or ("spill" in ln and not ln.strip().startswith("0 bytes"))]
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
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(main_shape, grp, od) for grp in (1, 128) for od in (bf16, f32)]
    # ragged: odd chunk and row counts, and widths that are not a multiple
    # of a thread's strip (the per-element path)
    cases += [((3, 5, 24), 8, bf16), ((2, 7, 40), 2, f32),
              ((1, 3, 1030), 2, bf16), ((2, 3, 20), 4, f32)]
    # (label, cases of ((N, R, W), group, out dtype)); each label is one
    # check.  The configs' widths at 4 chunks of 256 tokens, ragged widths
    # at odd chunk and row counts (a strip the width cuts, or no whole
    # strip on 16-byte boundaries: the per-element path)
    groups = {W: [g for g in DEQUANT_GROUPS if W % g == 0]
              for W in CONFIG_WIDTHS + RAGGED_WIDTHS}
    case_sets = [(f"N=4 R={CHUNK} W={W}",
                   [((4, CHUNK, W), g, od) for g in groups[W]
                    for od in (bf16, f32)]) for W in CONFIG_WIDTHS]
    case_sets += [(f"ragged W={W}",
                   [((3, 5, W), g, od) for g in groups[W]
                    for od in (bf16, f32)]
                   + [((2, 7, W), groups[W][-1], f32)])
                  for W in RAGGED_WIDTHS]
    # what any launch costs in this measurement: a kernel that writes one
    # float, back to back (the launch and the gap between two kernels)
    one = torch.zeros(1, device="cuda")
    floor_ms = device_ms(lambda: one.zero_(), [()])
    print(f"one-float kernel (zero_) back to back: {floor_ms * 1e3:.2f} us "
          f"device a call")
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
        for label, width_cases in case_sets:
            bad = []
            for (N, R, W), grp, od in width_cases:
                q, s = inputs(N, R, W, grp, packed)
                got = kern(q, s, group=grp, out_dtype=od)
                want = plain(q, s, group=grp, out_dtype=od)
                torch.cuda.synchronize()
                err = float((got.float() - want.float()).abs().max())
                max_err = max(max_err, err)
                if not torch.equal(got, want):
                    bad.append(f"N={N} R={R} group={grp} "
                               f"out={str(od).split('.')[-1]} err={err}")
            check(f"{name} bit-equal to plain {label}: {len(width_cases)} "
                  f"cases, groups {groups[W]}, fp32 and bf16 out", not bad,
                  "; ".join(bad))
        # views at a storage offset of one element (q, then the scales):
        # no 16-byte boundary, so every strip takes the per-element path
        N, R, W = 4, CHUNK, 1024
        for which in ("q", "scales"):
            q, s = inputs(N, R, W, 1, packed)
            if which == "q":
                q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
            else:
                s = torch.cat([s.new_zeros(1), s.flatten()])[1:].view(s.shape)
            plan = K.dequant_plan(N, R, W, q.data_ptr(), s.data_ptr(),
                                  0)
            got = kern(q, s, group=1, out_dtype=bf16)
            want = plain(q, s, group=1, out_dtype=bf16)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            max_err = max(max_err, err)
            check(f"{name} bit-equal to plain N={N} R={R} W={W} with {which} "
                  f"at a storage offset of 1 (per-element path)",
                  torch.equal(got, want) and not plan.vec,
                  f"max_abs_err={err} vec={plan.vec}")
        # time at the serving path's shape, bf16 out, per-channel scales
        N, R, W = main_shape
        plan = K.dequant_plan(N, R, W, 0, 0, 0)
        arg_sets = [inputs(N, R, W, 1, packed) for _ in range(16)]
        kern_ms = device_ms(lambda q, s: kern(q, s, group=1,
                                              out_dtype=bf16), arg_sets)
        plain_ms = device_ms(lambda q, s: plain(q, s, group=1,
                                                out_dtype=bf16), arg_sets)
        launch_us = host_us(lambda q, s: kern(q, s, group=1,
                                              out_dtype=bf16), arg_sets[0])
        # the same bytes through one eager PyTorch conversion: the codes
        # read, 2 bytes a channel written, no scales (int8 -> bf16; K2's
        # packed bytes -> fp32, 4 bytes a byte)
        widen = (lambda q, s: q.to(f32)) if packed else \
            (lambda q, s: q.to(bf16))
        same_bytes_ms = device_ms(widen, arg_sets)
        def moved(N):  # bytes of a call of N chunks: codes, scales, out
            return N * R * (W // 2 if packed else W) + N * W * 2 \
                + N * R * W * 2

        nbytes = moved(N)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = N * R * W / FP32_OPS_PER_S * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        # four times the chunks: the rate of the bytes a call adds, apart
        # from what every launch costs
        wide = [inputs(4 * N, R, W, 1, packed) for _ in range(4)]
        wide_ms = device_ms(lambda q, s: kern(q, s, group=1,
                                              out_dtype=bf16), wide)
        del wide
        rate = (moved(4 * N) - nbytes) / ((wide_ms - kern_ms) * 1e-3)
        print(f"kernel {name} N={N} R={R} W={W} group=1 out=bf16: "
              f"{kern_ms * 1e3:.2f} us device, {launch_us:.2f} us host per "
              f"call back to back, plain {plain_ms * 1e3:.2f} us, bound "
              f"{bound_ms * 1e3:.2f} us ({nbytes} B; "
              f"{bound_ms / kern_ms * 100:.1f}% of bound); same bytes "
              f"through q.to({'float32' if packed else 'bfloat16'}) "
              f"{same_bytes_ms * 1e3:.2f} us "
              f"({bound_ms / same_bytes_ms * 100:.1f}% of bound); plan "
              f"{plan.threads_x}x{plan.threads_y} threads, {plan.rows} rows "
              f"a thread, grid {plan.grid(N)}; N={4 * N} {wide_ms * 1e3:.2f} "
              f"us: the {moved(4 * N) - nbytes} B more at "
              f"{rate / 1e12:.2f} TB/s")
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/kv_dequant.cu",
            "replaces": replaces, "launches": None, "max_abs_err": max_err,
            "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "host_us": launch_us,
            "same_bytes_ms": same_bytes_ms})
    return records


def out_close(o, ow):
    """(within tolerance, max |error|) of an attention kernel's out against
    its plain version's: fp32 within ATTN_FP32_TOL, bf16 within one bf16
    step beyond that."""
    if o.dtype != ow.dtype or o.shape != ow.shape:
        return False, float("inf")
    err = float((o.float() - ow.float()).abs().max())
    tol = ATTN_FP32_TOL
    if o.dtype == torch.bfloat16:
        tol = bf16_step(torch.maximum(o.float().abs(), ow.float().abs())) \
            + ATTN_FP32_TOL
    return bool(((o.float() - ow.float()).abs() <= tol).all()), err


def attention_close(got, want):
    """(within tolerance, max |out error|) of a fused attention kernel's
    (out, m, l) against its plain version's (module constants)."""
    (o, m, l), (ow, mw, lw) = got, want
    ok, err = out_close(o, ow)
    ok &= torch.equal(torch.isinf(m), torch.isinf(mw))
    fin = torch.isfinite(mw)
    ok &= bool(((m[fin] - mw[fin]).abs()
                <= ATTN_FP32_TOL * mw[fin].abs().clamp_min(1.0)).all())
    ok &= bool(((l - lw).abs() <= ATTN_L_RTOL * lw.abs()).all())
    return ok, err


def large_logits_close(got, want):
    """`attention_close` for logits of tens of units, against float64: out
    and m as there; l within twice m's bound, relative.  l's relative error
    follows the logits' absolute error, which m's bound (ATTN_FP32_TOL
    relative above 1) lets grow with |m|; a term's exponent moves by its
    logit's error less m's.  ATTN_L_RTOL alone is below what fp32 logits
    allow at |m| ~ 30."""
    (o, m, l), (ow, mw, lw) = got, want
    ok, err = out_close(o, ow)
    ok &= torch.equal(torch.isinf(m), torch.isinf(mw))
    bound = ATTN_FP32_TOL * mw.abs().clamp_min(1.0)
    ok &= bool(((m - mw).abs() <= bound).all())
    ok &= bool(((l - lw).abs() <= 2 * bound * lw.abs()).all())
    return ok, err


def phase_attention_kernels():
    """K6 and K7 against their plain versions at the serving path's shapes
    and on ragged ones; times at the path's shapes.  K3 (the tile dequant of
    csrc/dequant_tile.cuh) has no launch of its own: it is held to the plain
    dequant through every K6/K7 case.  Returns per-kernel records."""
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels.kv_dequant import dequant_cache_ref
    from repro_torch.kernels.residency import cache_bytes
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

    def gw_packed(B, S, KV, dh, G, bits, group):
        """A cache quantized as the group-wise codecs do: one scale per
        chunk and group of channels, the absmax over both / qmax, codes
        round(x / scale) (they reach +-qmax)."""
        qmax = 127 if bits == 8 else 7
        x = torch.randn((B, S // G, G, KV * dh // group, group), generator=g,
                        device="cuda")
        s = (x.abs().amax(dim=(2, 4)) / qmax).half()
        codes = torch.clamp(torch.round(x / s.float()[:, :, None, :, None]),
                            -qmax - (bits == 4), qmax).to(torch.int32)
        codes = codes.reshape(B, S, KV, dh)
        if bits == 8:
            q = codes.to(torch.int8)
        else:
            biased = (codes + 8).to(torch.uint8)
            q = (biased[..., 0::2] | (biased[..., 1::2] << 4)).contiguous()
        return q, s.reshape(B, S // G, KV * dh // group)

    bf16, f32 = torch.bfloat16, torch.float32
    # (B, S, H, KV, dh, G, lengths, bits, group, q dtype)
    path6 = (1, WARM_PREFIX, 32, 8, 128, CHUNK)
    k6_cases = [(*path6, [WARM_PREFIX], bits, grp, dt) for bits in (8, 4)
                for grp in (1, 128) for dt in (bf16, f32)]
    # ragged: S not a multiple of a CTA's split (`decode_split_tokens`: at
    # least 128 tokens), a row shorter than S,
    # an empty row; and the other head widths the kernels are built for
    # (MQA at head_dim 256, as gemma-2b; MHA at 64)
    k6_cases += [(2, 200, 8, 2, 64, 8, [200, 77], 8, 1, bf16),
                 (2, 200, 8, 2, 64, 8, [200, 77], 4, 8, f32),
                 (3, 96, 8, 1, 256, 16, [0, 1, 95], 8, 1, f32),
                 (1, 64, 4, 4, 64, 16, [64], 4, 1, bf16)]
    # the query-head groups of the other configs and MHA (GQA_CASES)
    k6_cases += [(2, 2048, H, KV, dh, CHUNK, [2048, 777], bits, 1, dt)
                 for H, KV, dh in GQA_CASES for bits in (8, 4)
                 for dt in (bf16, f32)]
    # long caches, as K5's: splits of ~1000 tokens; 4 rows of every length
    k6_cases += [(1, 32768, 32, 8, 128, CHUNK, [32768], bits, 1, bf16)
                 for bits in (8, 4)]
    k6_cases += [(4, 8192, 32, 8, 128, CHUNK, [1, 129, 4097, 8192], bits, 1,
                  bf16) for bits in (8, 4)]
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
                 (1, 9, 32, 4, 4, 64, 16, False, 0, 4, 1, f32),
                 # few rows over a long prefix: bf16 splits a row block's
                 # keys over 7 CTAs (a causal tail), or over 4 of which
                 # some hold no tile
                 (1, 64, WARM_PREFIX, 32, 8, 128, CHUNK, True, 3776, 8, 1,
                  bf16),
                 (1, 128, WARM_PREFIX, 32, 8, 128, CHUNK, True, 0, 4, 128,
                  bf16)]
    # the query-head groups of the other configs and MHA (GQA_CASES), causal
    # with q_offset 2000 over 2048 keys (bf16: the keys split over 4 CTAs);
    # Sq = 37, so Sq x H/KV is a multiple of no row block and the row
    # blocks of groups 3, 5 and 6 cut a position's heads
    k7_cases += [(1, 37, 2048, H, KV, dh, CHUNK, True, 2000, bits, 1, dt)
                 for H, KV, dh in GQA_CASES for bits in (8, 4)
                 for dt in (bf16, f32)]
    # the gw codecs at the serving shape: group 128, their scales (gw_packed)
    k7_gw = [(*path7, bits, 128, dt) for bits in (8, 4) for dt in (bf16, f32)]
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
    for i, (B, Sq, Sk, H, KV, dh, G, causal, off, bits, grp, dt) in \
            enumerate(k7_cases + k7_gw):
        gw = i >= len(k7_cases)
        kq, ks = (gw_packed if gw else packed)(B, Sk, KV, dh, G, bits, grp)
        vq, vs = (gw_packed if gw else packed)(B, Sk, KV, dh, G, bits, grp)
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
              f"bits={bits} group={grp} q={str(dt).split('.')[-1]}"
              + (" (gw codec scales)" if gw else ""), ok,
              f"max_abs_err={err}")
    # bf16 q scaled by 16 at the serving shape: logits of tens of units, so
    # the running max moves and the rescale carries the result.  Held, as
    # K4's case, to the same function in float64 over the dequantized
    # cache: at such logits the plain version's own fp32 rounding moves
    # small outputs by more than out_close allows
    B, Sq, Sk, H, KV, dh, G, _, _ = path7
    for bits in (8, 4):
        kq, ks = packed(B, Sk, KV, dh, G, bits, 1)
        vq, vs = packed(B, Sk, KV, dh, G, bits, 1)
        q = (query((B, Sq, H, dh), f32) * 16).to(bf16)
        args = dict(bits=bits, group=1, chunk_tokens=G, causal=False)
        got = F.flash_attention_quant(q, kq, vq, ks, vs, **args)
        want = F.flash_attention_quant_ref(q, kq, vq, ks, vs, **args)
        exact = flash_attention_quant_f64(
            q, dequant_cache_ref(kq, ks, bits=bits, group=1, chunk_tokens=G),
            dequant_cache_ref(vq, vs, bits=bits, group=1, chunk_tokens=G))
        torch.cuda.synchronize()
        ok, err = large_logits_close(got, exact)
        plain_ok, plain_err = large_logits_close(want, exact)
        l_rel = float(((got[2] - exact[2]).abs() / exact[2]).max())
        err7 = max(err7, err)
        check(f"flash_attention_quant vs float64 B={B} Sq={Sq} Sk={Sk} H={H} "
              f"KV={KV} dh={dh} bits={bits} q=bf16 q_scale=16", ok,
              f"max_abs_err={err} max l rel err={l_rel} (the plain version "
              f"{'within' if plain_ok else 'outside'} attention_close of "
              f"it, max_abs_err={plain_err})")
        del exact
    print("K3 (csrc/dequant_tile.cuh) has no launch of its own; it is held "
          "through every K6/K7 case above")
    sass = subprocess.run(
        [str(Path(build.nvcc()).with_name("cuobjdump")), "-sass",
         str(build.library_path("flash_attention_quant"))],
        capture_output=True, text=True, check=True).stdout
    hgmma = sass.count("HGMMA")
    check("flash_attention_quant's library runs bf16 q on the tensor cores",
          hgmma > 0, f"{hgmma} HGMMA instructions in its SASS")

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
        cache = sum(t.numel() * t.element_size() for t in arg_sets[0][1:])
        model = cache_bytes(S, KV, dh, bits=bits, group=1, chunk_tokens=G)
        check(f"decode_attention_quant int{bits} cache bytes == "
              f"residency.cache_bytes", cache == model.wire_resident,
              f"{cache} B read vs {model.wire_resident} B modelled")
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = 4 * B * H * S * dh / ops_per_s(bf16) * 1e3
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
            f"{kernel_name(k)} "
            f"{v * 1e3:.2f} us" for k, v in parts.items()))
        names = [kernel_name(k) for k in parts]
        check(f"decode_attention_quant int{bits} is one kernel, the split "
              f"decode", names == ["ds::decode_split_kernel"], f"{names}")
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
        parts = device_breakdown(lambda *a: F.flash_attention_quant(
            *a, **args), arg_sets[0], reps=5)
        names = [kernel_name(k) for k in parts]
        print("  per call on the device (torch.profiler): " + "; ".join(
            f"{kernel_name(k)} {v * 1e3:.2f} us" for k, v in parts.items()))
        check(f"flash_attention_quant int{bits} bf16 is one kernel, the "
              f"wgmma loop", names == ["fw::flash_wgmma_kernel"], f"{names}")
        nbytes = sum(t.numel() * t.element_size() for t in arg_sets[0]) \
            + B * Sq * H * dh * 2 + 2 * B * Sq * H * 4
        flops = 4 * B * Sq * H * Sk * dh
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = flops / ops_per_s(bf16) * 1e3
        bound_ms = max(bytes_ms, ops_ms)
        print(f"kernel flash_attention_quant int{bits} B={B} Sq={Sq} Sk={Sk} "
              f"H={H} KV={KV} dh={dh} q=bf16: {kern_ms * 1e3:.2f} us device, "
              f"{host:.2f} us host per call back to back, plain "
              f"{plain_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us "
              f"({nbytes} B, {flops} FLOP at the bf16 tensor-core peak; "
              f"{bound_ms / kern_ms * 100:.1f}% of bound; the kernel issues "
              f"{3 * flops} FLOP of wgmma: three K pieces for S, the p and "
              f"V splits for P V)")
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


def visible_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """(query, key) pairs K4 computes: row i sees min(i + 1, Sk) keys under
    the top-left causal mask, all Sk without it."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + (Sq - n) * Sk


def flash_attention_f64(q, k, v, causal: bool):
    """K4's function (the plain version's formula, top-left causal mask) in
    float64: q [B, H, Sq, dh], k/v [B, KV, Sk, dh] -> out float64."""
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     q.double().reshape(B, KV, H // KV, Sq, dh),
                     k.double()) / math.sqrt(dh)
    if causal:
        rows = torch.arange(Sq, device=q.device)[:, None]
        s = torch.where(rows >= torch.arange(Sk, device=q.device)[None], s,
                        float("-inf"))
    out = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1),
                       v.double())
    return out.reshape(B, H, Sq, dh)


def flash_attention_quant_f64(q, k, v):
    """K7's function (full mask) in float64 over a dequantized cache: q
    [B, Sq, H, dh], k/v [B, Sk, KV, dh] -> (out in q's dtype, m, l in
    fp32), to compare with `attention_close`."""
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    s = torch.einsum("bqkgd,bskd->bqkgs",
                     q.double().reshape(B, Sq, KV, H // KV, dh),
                     k.double()) / math.sqrt(dh)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, v.double()) / l[..., None]
    return (out.reshape(B, Sq, H, dh).to(q.dtype),
            m.reshape(B, Sq, H).float(), l.reshape(B, Sq, H).float())


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def report(name, shape, kern_ms, host, plain_ms, lib_ms, lib_name, bytes_ms,
           ops_ms, detail):
    bound_ms = max(bytes_ms, ops_ms)
    print(f"kernel {name} {shape}: {kern_ms * 1e3:.2f} us device, "
          f"{host:.2f} us host per call back to back, plain "
          f"{plain_ms * 1e3:.2f} us, library ({lib_name}) "
          f"{lib_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us ({detail}; "
          f"{bound_ms / kern_ms * 100:.1f}% of bound)")
    return dict(ms=kern_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                library_ms=lib_ms)


def phase_fp_kernels():
    """K4, K5 and K8 against their plain versions at llama3-1-8b's shapes
    and on ragged ones; times at those shapes (bf16) beside the bound and
    the one PyTorch call that computes the same function.  Returns
    per-kernel records (launches filled in after the op path)."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import kv_gather as K8
    g = torch.Generator(device="cuda").manual_seed(3)
    bf16, f32 = torch.bfloat16, torch.float32
    H, KV, dh = HEADS, KV_HEADS, HEAD_DIM

    def normal(shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    def fp_case(B, Hq, KVq, Sq, Sk, d, dtype, q_scale=1.0):
        q = (torch.randn((B, Hq, Sq, d), generator=g, device="cuda")
             * q_scale).to(dtype)
        return q, normal((B, KVq, Sk, d), dtype), normal((B, KVq, Sk, d),
                                                        dtype)

    sass = subprocess.run(
        [str(Path(build.nvcc()).with_name("cuobjdump")), "-sass",
         str(build.library_path("flash_attention"))], capture_output=True,
        text=True, check=True).stdout
    hgmma = sass.count("HGMMA")
    check("flash_attention's library runs bf16 on the tensor cores",
          hgmma > 0, f"{hgmma} HGMMA instructions in its SASS")

    # (B, H, KV, Sq, Sk, dh, causal, dtype[, q scale]): the cold prefill
    # causal in both dtypes and full; Sq != Sk both ways, where the top-left
    # mask is not the bottom-right one; ragged rows and keys (not multiples
    # of 64); MQA at dh 256 and MHA at 64, as K7's cases; qwen3-14b's group
    # of 5; bf16 (the tensor-core path) causal ragged, causal at dh 64, with
    # q scaled by 16 (logits of tens of units: the running max moves and the
    # accumulator is rescaled tile after tile), and full over few rows
    k4_cases = [(1, H, KV, COLD_TOKENS, COLD_TOKENS, dh, True, dt)
                for dt in (bf16, f32)]
    k4_cases += [(1, H, KV, COLD_TOKENS, COLD_TOKENS, dh, False, bf16),
                 (1, H, KV, CHUNK, COLD_TOKENS, dh, True, bf16),
                 (1, H, KV, COLD_TOKENS, CHUNK, dh, True, f32),
                 (2, H, KV, 1000, 777, dh, True, f32),
                 (2, H, KV, 1000, 777, dh, False, bf16),
                 (1, 8, 1, 300, 300, 256, True, bf16),
                 (1, 4, 4, 200, 130, 64, True, f32),
                 (1, 40, 8, 130, 130, dh, True, bf16),
                 (2, H, KV, 1000, 777, dh, True, bf16),
                 (1, H, KV, 1000, 1000, 64, True, bf16),
                 (1, H, KV, COLD_TOKENS, COLD_TOKENS, dh, True, bf16, 16.0),
                 (1, H, KV, 128, COLD_TOKENS, dh, False, bf16)]
    err4 = 0.0
    for B, Hq, KVq, Sq, Sk, d, causal, dt, *q_scale in k4_cases:
        q, k, v = fp_case(B, Hq, KVq, Sq, Sk, d, dt, *q_scale)
        got = F.flash_attention(q, k, v, causal=causal)
        want = F.flash_attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if q_scale:
            # logits of tens of units: the plain version's own fp32 rounding
            # of them moves small outputs by more than out_close allows, so
            # the kernel is held to the same formula in float64
            exact = flash_attention_f64(q, k, v, causal).to(dt)
            ok, err = out_close(got, exact)
            plain_ok, plain_err = out_close(want, exact)
            detail = (f"max_abs_err={err} (vs float64; the plain version "
                      f"{'within' if plain_ok else 'outside'} out_close of "
                      f"it, max_abs_err={plain_err})")
            del exact
        else:
            ok, err = out_close(got, want)
            detail = f"max_abs_err={err}"
        err4 = max(err4, err)
        check(f"flash_attention vs {'float64' if q_scale else 'plain'} B={B} "
              f"H={Hq} KV={KVq} Sq={Sq} Sk={Sk} dh={d} causal={causal} "
              f"q={str(dt).split('.')[-1]}"
              + (f" q_scale={q_scale[0]}" if q_scale else ""), ok, detail)
        del q, k, v, got, want

    # (B, S, H, KV, dh, lengths, dtype): the decode after the cold prompt in
    # both dtypes; 8 rows with lengths spread over [1, S] plus a 0; S not a
    # multiple of a split; MQA at dh 256; a group of 5; a long cache (splits
    # of ~1000 tokens); 4 rows of every length.  Rows past each length hold
    # NaN, which must not reach the result.
    S5 = COLD_TOKENS + NEW_TOKENS
    k5_cases = [(1, S5, H, KV, dh, [COLD_TOKENS + 1], dt)
                for dt in (bf16, f32)]
    k5_cases += [(8, S5, H, KV, dh, [0, 1, 63, 64, 1000, 2049, 4097, S5],
                  bf16),
                 (2, 1000, H, KV, dh, [1000, 999], f32),
                 (3, 96, 8, 1, 256, [0, 1, 95], bf16),
                 (2, 200, 40, 8, dh, [200, 77], f32),
                 (1, 32768, H, KV, dh, [32768], bf16),
                 (4, 8192, H, KV, dh, [1, 129, 4097, 8192], bf16)]
    err5 = 0.0
    for B, S, Hq, KVq, d, lens, dt in k5_cases:
        q = normal((B, Hq, d), dt)
        kc, vc = normal((B, S, KVq, d), dt), normal((B, S, KVq, d), dt)
        for b, n in enumerate(lens):
            kc[b, n:] = float("nan")
            vc[b, n:] = float("nan")
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        got = D.decode_attention(q, kc, vc, ln)
        want = D.decode_attention_ref(q, kc, vc, ln)
        torch.cuda.synchronize()
        ok, err = out_close(got, want)
        ok &= bool(torch.isfinite(got).all())
        ok &= all(bool((got[b] == 0).all()) for b, n in enumerate(lens)
                  if n == 0)
        err5 = max(err5, err)
        check(f"decode_attention vs plain B={B} S={S} H={Hq} KV={KVq} "
              f"dh={d} lengths={lens} q={str(dt).split('.')[-1]} (NaN past "
              f"each length)", ok, f"max_abs_err={err}")

    # (P, G, W, dtype, N, index dtype): an arena of 256 layer slices of a
    # chunk (256 tokens x 2048 bf16 words, 1 MiB) gathered for the warm
    # prefix (15) and for 64 indices with repeats; int8 and fp32 arenas of
    # the same tile bytes; tiles that are not a multiple of 16 bytes
    k8_cases = [(256, CHUNK, 2048, bf16, 15, torch.int32),
                (256, CHUNK, 2048, bf16, 64, torch.int64),
                (256, CHUNK, 4096, torch.int8, 15, torch.int32),
                (256, CHUNK, 1024, f32, 15, torch.int64),
                (64, 3, 5, torch.int8, 40, torch.int32),
                (64, 7, 3, bf16, 40, torch.int32)]
    for P, G, W, dt, N, it in k8_cases:
        if dt == torch.int8:
            pool = torch.randint(-128, 128, (P, G, W), generator=g,
                                 device="cuda", dtype=dt)
        else:
            pool = normal((P, G, W), dt)
        idx = torch.randint(0, P, (N,), generator=g, device="cuda").to(it)
        if N > 15:
            idx[1::4] = idx[0]  # repeats
        got = K8.kv_gather(pool, idx)
        want = K8.kv_gather_ref(pool, idx)
        torch.cuda.synchronize()
        check(f"kv_gather bit-equal to plain P={P} G={G} W={W} "
              f"{str(dt).split('.')[-1]} N={N} {str(it).split('.')[-1]} "
              f"indices", torch.equal(got, want))
        del pool

    records = []
    # K4 at the cold prefill, bf16: 3 input sets of 48 MiB exceed the L2
    B, Sq = 1, COLD_TOKENS
    sets = [fp_case(B, H, KV, Sq, Sq, dh, bf16) for _ in range(3)]
    kern_ms = device_ms(lambda *a: F.flash_attention(*a, causal=True), sets,
                        reps=3, batches=5)
    plain_ms = device_ms(lambda *a: F.flash_attention_ref(*a, causal=True),
                         sets, reps=2, batches=3)
    lib_ms = device_ms(lambda q, k, v: sdpa(q, k, v, is_causal=True,
                                            enable_gqa=True), sets,
                       reps=10, batches=5)
    host = host_us(lambda *a: F.flash_attention(*a, causal=True), sets[0],
                   reps=5)
    q, k, v = sets[0]
    lib_err = float((sdpa(q, k, v, is_causal=True, enable_gqa=True).float()
                     - F.flash_attention(q, k, v).float()).abs().max())
    flops = 4 * dh * H * B * visible_pairs(Sq, Sq, True)
    moved = nbytes(q, k, v) + nbytes(q)
    rec = report("flash_attention", f"B={B} Sq=Sk={Sq} H={H} KV={KV} "
                 f"dh={dh} causal bf16", kern_ms, host, plain_ms, lib_ms,
                 "scaled_dot_product_attention is_causal enable_gqa",
                 moved / HBM_BYTES_PER_S * 1e3,
                 flops / ops_per_s(bf16) * 1e3,
                 f"{moved} B, {flops} FLOP at the bf16 tensor-core peak; "
                 f"the kernel issues {3 * flops // 2} FLOP of wgmma, the p "
                 f"split doubling P V; max |library - kernel| {lib_err}")
    parts = device_breakdown(lambda *a: F.flash_attention(*a, causal=True),
                             sets[0], reps=3)
    print("  per call on the device (torch.profiler): " + "; ".join(
        f"{kernel_name(key)} "
        f"{t * 1e3:.2f} us" for key, t in parts.items()))
    records.append(dict(name="flash_attention", route="cuda",
                        source="src/repro_torch/kernels/csrc/"
                               "flash_attention.cu",
                        replaces="src/repro/kernels/flash_attention.py:106",
                        launches=None, max_abs_err=err4, **rec))
    del sets, q, k, v

    # K5 at the decode after the cold prompt, bf16: 16 sets of 16.8 MB
    B, S, n = 1, S5, COLD_TOKENS + 1
    ln = torch.tensor([n], dtype=torch.int32, device="cuda")
    sets = [(normal((B, H, dh), bf16), normal((B, S, KV, dh), bf16),
             normal((B, S, KV, dh), bf16)) for _ in range(16)]
    mask = (torch.arange(S, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]  # [B, 1, 1, S]
    kern_ms = device_ms(lambda *a: D.decode_attention(*a, ln), sets)
    plain_ms = device_ms(lambda *a: D.decode_attention_ref(*a, ln), sets)
    lib_ms = device_ms(lambda q, kc, vc: sdpa(
        q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2),
        attn_mask=mask, enable_gqa=True), sets)
    host = host_us(lambda *a: D.decode_attention(*a, ln), sets[0])
    q, kc, vc = sets[0]
    moved = nbytes(q, ln, q) + 2 * B * n * KV * dh * 2  # rows read: length
    rec = report("decode_attention", f"B={B} S={S} lengths=[{n}] H={H} "
                 f"KV={KV} dh={dh} bf16", kern_ms, host, plain_ms, lib_ms,
                 "scaled_dot_product_attention attn_mask enable_gqa",
                 moved / HBM_BYTES_PER_S * 1e3,
                 4 * B * H * n * dh / ops_per_s(bf16) * 1e3,
                 f"{moved} B, {4 * B * H * n * dh} FLOP")
    parts = device_breakdown(lambda *a: D.decode_attention(*a, ln), sets[0])
    print("  per call on the device (torch.profiler): " + "; ".join(
        f"{kernel_name(key)} "
        f"{t * 1e3:.2f} us" for key, t in parts.items()))
    records.append(dict(name="decode_attention", route="cuda",
                        source="src/repro_torch/kernels/csrc/"
                               "decode_attention.cu",
                        replaces="src/repro/kernels/decode_attention.py:130",
                        launches=None, max_abs_err=err5, **rec))
    del sets

    # K8 at the warm prefix: 15 of 256 arena tiles of 1 MiB, 16 index sets
    P, N = 256, WARM_PREFIX // CHUNK
    pool = normal((P, CHUNK, 2048), bf16)
    sets = [(pool, torch.randperm(P, generator=g, device="cuda")[:N].to(
        torch.int32)) for _ in range(16)]
    kern_ms = device_ms(K8.kv_gather, sets)
    plain_ms = device_ms(K8.kv_gather_ref, sets)
    lib_ms = device_ms(lambda p, i: torch.index_select(p, 0, i), sets)
    host = host_us(K8.kv_gather, sets[0])
    moved = 2 * N * nbytes(pool[0]) + N * 4
    rec = report("kv_gather", f"P={P} N={N} tiles of {CHUNK}x2048 bf16",
                 kern_ms, host, plain_ms, lib_ms, "torch.index_select",
                 moved / HBM_BYTES_PER_S * 1e3, 0.0, f"{moved} B")
    records.append(dict(name="kv_gather", route="cuda",
                        source="src/repro_torch/kernels/csrc/kv_gather.cu",
                        replaces="src/repro/kernels/kv_gather.py:48",
                        launches=None, max_abs_err=0.0, **rec))
    del sets, pool
    torch.cuda.empty_cache()
    return records


def build_served_model():
    """llama3-1-8b at full width from seed 0, and the two prompts every
    phase on the model serves: a cold one of 4096 tokens and a warm one that
    shares its first 15 chunks."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import ModelRunner

    cfg = get_config(ARCH)
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads} heads / {cfg.num_kv_heads} kv heads, head_dim "
          f"{cfg.head_dim}, {cfg.compute_dtype}; {cfg.param_count() / 1e9:.2f}"
          f" B params initialised in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    cold = rng.integers(0, cfg.vocab_size, size=COLD_TOKENS)
    warm = np.concatenate([cold[:WARM_PREFIX],
                           rng.integers(0, cfg.vocab_size,
                                        size=COLD_TOKENS - WARM_PREFIX)])
    return cfg, model, params, ModelRunner(model, params), cold, warm


def new_engine(served, codec, theta, kv_resident="fp"):
    """A serving engine on a fresh in-memory store; returns (engine,
    store)."""
    from repro_torch.core import Gateway, InMemoryStore, RadixIndex
    from repro_torch.serving import Orchestrator, ServingEngine
    cfg, model, params, runner = served[:4]
    spec = cfg.kv_spec(CHUNK, dtype_bytes=2, codec=codec)
    store = InMemoryStore()
    orch = Orchestrator(RadixIndex(CHUNK), Gateway(store), spec,
                        theta_bytes=theta)
    return ServingEngine(model, params, orch, runner=runner,
                         kv_resident=kv_resident), store


def model_close(got, want, p_abs_v):
    """(within the MODEL_* bound everywhere, max |error|, detail) of a
    kernel's bf16 out against the model's `attention_scores` on the same
    q/k/v; ``p_abs_v`` is sum_j p_j |v_j| per output element."""
    diff = (got.float() - want.float()).abs()
    tol = MODEL_OUT_ULPS * bf16_step(torch.maximum(got.float().abs(),
                                                   want.float().abs())) \
        + MODEL_P_ROUND * p_abs_v
    worst = float((diff / tol).max())
    detail = (f"max_abs_err={float(diff.max())} worst err/bound={worst:.3f} "
              f"median |out|={float(want.float().abs().median())} median "
              f"bound={float(tol.median())}")
    return worst <= 1.0, float(diff.max()), detail


def phase_ops_on_model(served):
    """K4, K5 and K8 through `kernels.ops` on the served model's own data;
    returns the launch counts of that run (set to 0 just before it)."""
    from repro_torch.core import Delivery
    from repro_torch.kernels import decode_attention as D
    from repro_torch.kernels import flash_attention as F
    from repro_torch.kernels import launches, ops
    from repro_torch.models import layers as nn
    from repro_torch.models.dense import layer_params
    cfg, model, params, runner, cold, warm = served
    H, KV, dh, L = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, \
        cfg.num_layers

    # the identity store after the cold prompt: 16 chunk objects
    engine, store = new_engine(served, "identity", 0)
    r = engine.submit(cold, "cold", max_new_tokens=1)
    nxt = int(r.new_tokens[0])
    lp = layer_params(params, 0)
    theta = cfg.rope_theta

    def qkv(tokens, pos0):
        x = nn.embed(params["embed"], cfg, torch.as_tensor(
            tokens, dtype=torch.int64, device="cuda")[None])
        q, k, v = nn.project_qkv(lp["attn"], cfg, nn.rmsnorm(lp["ln1"], x))
        pos = pos0 + torch.arange(x.shape[1], device="cuda")[None]
        return nn.rope(q, pos, theta), nn.rope(k, pos, theta), v

    def model_attention(q, k, v, mask):
        """The model's attention output, and sum_j p_j |v_j| from the same
        probabilities (an fp32 v keeps them in fp32)."""
        # fp32 reductions in the bf16 value product (see MODEL_P_ROUND)
        matmul = torch.backends.cuda.matmul
        flag = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = False
        k, v = (torch.repeat_interleave(t, H // KV, 2) for t in (k, v))
        try:
            return (nn.attention_scores(q, k, v, mask),
                    nn.attention_scores(q, k, v.float().abs(), mask))
        finally:
            matmul.allow_bf16_reduced_precision_reduction = flag

    q, k, v = qkv(cold, 0)  # [1, 4096, heads, dh], roped
    qn, kn, vn = qkv([nxt], COLD_TOKENS)  # the next token, position 4096
    S5 = COLD_TOKENS + NEW_TOKENS
    g = torch.Generator(device="cuda").manual_seed(4)

    def stale():  # a cache buffer whose rows past the length are stale
        return torch.randn((1, S5, KV, dh), generator=g,
                           device="cuda").to(k.dtype)

    kc, vc = stale(), stale()
    kc[:, :COLD_TOKENS], vc[:, :COLD_TOKENS] = k, v
    kc[:, COLD_TOKENS], vc[:, COLD_TOKENS] = kn[:, 0], vn[:, 0]
    ln = torch.tensor([COLD_TOKENS + 1], dtype=torch.int32, device="cuda")
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))

    # K8's arena: the chunk objects on the device in a shuffled order, each
    # object L tiles (its layer slices [K(G, W); V(G, W)], 2048 words a row)
    match = engine.orch.index.match(cold)
    keys = list(match.chunk_keys)
    order = np.random.default_rng(1).permutation(len(keys))
    slot = {keys[i]: s for s, i in enumerate(order)}
    arena = torch.frombuffer(bytearray(b"".join(
        store.get(keys[i]) for i in order)), dtype=torch.int16).to(
        "cuda").view(len(keys) * L, CHUNK, 2 * KV * dh)
    plan = engine.orch.plan(warm, 0.0, req_id="gather")
    check("gather plan is LAYERWISE over the warm prefix",
          plan.delivery is Delivery.LAYERWISE
          and plan.match.num_chunks == WARM_PREFIX // CHUNK,
          f"{plan.delivery} {plan.match.num_chunks} chunks")
    payloads = engine.orch.fetch(plan).payloads
    engine.orch.release("gather")
    torch.cuda.synchronize()

    launches.reset()  # this slice's path: the three ops on the model's data
    out4 = ops.flash_attention_op(qh, kh, vh, causal=True)
    out5 = ops.decode_attention_op(qn[:, 0].contiguous(), kc, vc, ln)
    gathered = {}
    for layer in (0, 1, L // 2, L - 1):
        idx = torch.tensor([slot[key] * L + layer
                            for key in plan.match.chunk_keys],
                           dtype=torch.int32, device="cuda")
        gathered[layer] = ops.kv_gather_op(arena, idx)
    torch.cuda.synchronize()
    counts = launches.snapshot()
    print(f"kernel-op path on the model's data, launches: {counts}")

    ok, err = out_close(out4, F.flash_attention_ref(qh, kh, vh, causal=True))
    check(f"flash_attention_op on layer 0 of the cold prompt vs plain "
          f"(Sq=Sk={COLD_TOKENS})", ok, f"max_abs_err={err}")
    rows = torch.arange(COLD_TOKENS, device="cuda")
    mask = (rows[None, :] <= rows[:, None])[None, None]
    want, p_abs_v = (t.transpose(1, 2) for t in model_attention(q, k, v,
                                                                 mask))
    ok, err, detail = model_close(out4, want, p_abs_v)
    check("flash_attention_op vs the model's attention_scores (causal)", ok,
          f"{detail} row0_err="
          f"{float((out4[:, :, 0] - want[:, :, 0]).float().abs().max())}")
    del want, p_abs_v

    ok, err = out_close(out5, D.decode_attention_ref(qn[:, 0].contiguous(),
                                                     kc, vc, ln))
    check(f"decode_attention_op on the next token (position {COLD_TOKENS}) "
          f"vs plain", ok, f"max_abs_err={err}")
    cols = torch.arange(S5, device="cuda")
    want, p_abs_v = (t[:, 0] for t in model_attention(
        qn, kc, vc, (cols <= COLD_TOKENS)[None, None, None, :]))
    ok, err, detail = model_close(out5, want, p_abs_v)
    check("decode_attention_op vs the model's attention_scores "
          "(decode_attention's mask)", ok, detail)

    for layer, got in gathered.items():
        same = got.cpu().numpy().tobytes() == payloads[layer]
        check(f"kv_gather_op layer {layer} byte-equal to the aggregated "
              f"layer payload", same, f"{got.numel() * 2} B vs "
              f"{len(payloads[layer])} B")
    want_counts = {name: 0 for name in counts}
    want_counts.update(flash_attention=1, decode_attention=1, kv_gather=4)
    check("kernel-op path launches", counts == want_counts,
          f"got {counts} want {want_counts}")
    del engine, store, arena, q, k, v, kc, vc, qh, kh, vh
    torch.cuda.empty_cache()
    return counts


def phase_serving(served):
    """Cold + warm requests per codec at full width, fp-resident and then
    packed-resident; returns the launch count of each kernel over each of
    the two paths (counts set to 0 just before a path, read just after)."""
    from repro_torch.core import Delivery
    from repro_torch.kernels import launches
    from repro_torch.obs import Tracer
    from repro_torch.serving import ServingEngine

    cfg, model, params, runner, cold, warm = served

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
        # the port's kernels of this path by name: K1/K2 (fp), K7 (packed;
        # the wgmma loop with the dequantizing policy)
        counts = {e.key: e.count for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
        for label, part in (("K1/K2", "dequant_"),
                            ("K7", "flash_wgmma_kernel")):
            ours = [(k, t) for k, t in kernels if part in k]
            if ours:
                print(f"  {label} on the device: "
                      f"{sum(t for _, t in ours) / 1e3:.3f} ms in "
                      f"{sum(counts[k] for k, _ in ours)} launches")

    # the profiler's first use sets up device tracing (seconds): pay it here
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    warm_fp, fp_prefix_bytes = {}, {}
    launches.reset()  # the fp-resident path's counts start here
    for codec in CODECS:
        lw, lw_store = new_engine(served, codec, 0)
        cw, cw_store = new_engine(served, codec, 1 << 60)
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
        pk, pk_store = new_engine(served, codec, 0, kv_resident="packed")
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


class DecodeRecorder:
    """The model as the decode batcher sees it: every call goes to the model
    unchanged, and each decode step's logits are kept per request, with the
    requests each slot held and the longest queue of requests that waited
    for a slot."""

    def __init__(self, model):
        self.model, self.cfg, self.device = model, model.cfg, model.device
        self.batcher = None
        self.logits = collections.defaultdict(list)
        self.slot_reqs = collections.defaultdict(set)
        self.max_waiting = 0

    def init_cache(self, batch, seq_len):
        return self.model.init_cache(batch, seq_len)

    def decode_step(self, params, cache, token, pos):
        lg, cache = self.model.decode_step(params, cache, token, pos)
        rows = lg.float().cpu().numpy()[:, :self.cfg.vocab_size]
        for s, req in enumerate(self.batcher.active):
            if req is not None:
                self.logits[req.req_id].append(rows[s])
                self.slot_reqs[s].add(req.req_id)
        self.max_waiting = max(self.max_waiting, len(self.batcher.queue))
        return lg, cache


def top_two_gap(logits: np.ndarray) -> float:
    a, b = np.partition(logits, -2)[-2:]
    return float(abs(a - b))


def streams_agree(name, a_tokens, a_logits, b_tokens, b_logits, ulps):
    """Two greedy streams of one prompt, token i chosen by logits
    ``a_logits[i]`` / ``b_logits[i]`` (the prefill's at 0, decode step i-1's
    after it).  Up to the first token where the streams part (or through
    the last), each step's logits agree within ``ulps`` bf16 steps at the
    scale of the largest logit; where they part, ``b``'s top two logits
    were within that bound, a near tie that rounding may break either way.
    Past the parting the contexts differ and nothing is compared."""
    part = next((i for i, (x, y) in enumerate(zip(a_tokens, b_tokens))
                 if x != y), None)
    last = len(b_tokens) - 1 if part is None else part
    ok = len(a_tokens) == len(b_tokens) == len(a_logits) == len(b_logits)
    worst = 0.0
    for i in range(last + 1):
        step = logit_step(b_logits[i])
        worst = max(worst, float(np.abs(a_logits[i] - b_logits[i]).max())
                    / step)
    ok = ok and worst <= ulps
    detail = f"worst step {worst:.2f} bf16 steps (bound {ulps})"
    if part is not None:
        gap = top_two_gap(b_logits[part])
        tol = ulps * logit_step(b_logits[part])
        ok = ok and gap <= tol
        detail += (f"; part at token {part}: top-two gap {gap} tol {tol}; "
                   f"{a_tokens} vs {b_tokens}")
    check(name, ok, detail)


def phase_async(served):
    """Phase 5: the concurrent serving path (`AsyncEngine` over one
    `BandwidthPool`, decode in `ContinuousBatcher` slots) at full width, for
    int8 fp-resident and int8 packed-resident, each on a fresh store, held
    to the port's `ClusterSim` and to the sequential engine.  Returns the
    launch counts of the two Poisson ``serve`` calls (each set to 0 just
    before, read just after)."""
    from repro_torch.cluster import ClusterSim, TraceRequest
    from repro_torch.core import Delivery, Gateway, InMemoryStore, RadixIndex
    from repro_torch.core.compute_model import PaperComputeModel
    from repro_torch.core.scheduler import BandwidthPool, Policy
    from repro_torch.core.transport import S3_RDMA_AGG, VirtualClock
    from repro_torch.kernels import launches
    from repro_torch.serving import (AsyncEngine, AsyncRequest,
                                     ContinuousBatcher, ModelRunner,
                                     Orchestrator, ServingEngine)

    cfg, model, params, runner = served[:4]
    L, V = cfg.num_layers, cfg.vocab_size
    codec = "int8"
    spec = cfg.kv_spec(CHUNK, dtype_bytes=2, codec=codec)
    compute = PaperComputeModel(num_layers=L)
    cap = 2 * (WARM_PREFIX // CHUNK) * spec.mean_wire_layer_bytes \
        / compute.layer_compute_s(COLD_TOKENS, WARM_PREFIX / COLD_TOKENS)
    rng = np.random.default_rng(5)
    prefixes = [rng.integers(0, V, size=WARM_PREFIX)
                for _ in range(ASYNC_PREFIXES)]
    tail = COLD_TOKENS - WARM_PREFIX
    prompts = {f"r{i}": np.concatenate([prefixes[i % ASYNC_PREFIXES],
                                        rng.integers(0, V, size=tail)])
               for i in range(ASYNC_WARM)}
    prompts["rc"] = np.random.default_rng(6).integers(0, V, size=COLD_TOKENS)
    # the burst: one more warm request per prefix, all at one instant
    burst = {f"b{j}": np.concatenate([p, rng.integers(0, V, size=tail)])
             for j, p in enumerate(prefixes)}
    # the cold request arrives third, so it rides along with warm flights
    order = ["r0", "r1", "rc"] + [f"r{i}" for i in range(2, ASYNC_WARM)]
    gaps, t, arrival = random.Random(7), 0.0, {}
    for rid in order:
        t += gaps.expovariate(1.0 / ASYNC_MEAN_GAP_S)
        arrival[rid] = t
    reqs = [AsyncRequest(rid, tuple(int(x) for x in prompts[rid]),
                         arrival[rid], max_new_tokens=NEW_TOKENS)
            for rid in order]
    burst_reqs = [AsyncRequest(rid, tuple(int(x) for x in p),
                               ASYNC_BURST_AT_S, max_new_tokens=NEW_TOKENS)
                  for rid, p in burst.items()]
    print(f"phase 5: {cfg.name} codec {codec}, {len(reqs)} requests "
          f"(arrivals {[round(arrival[r], 6) for r in order]} s on the "
          f"virtual clock), then a burst of {len(burst_reqs)} at "
          f"{ASYNC_BURST_AT_S} s; cap {cap:.6g} B/s, max_flows "
          f"{ASYNC_MAX_FLOWS}, {ASYNC_SLOTS} decode slots of {ASYNC_MAX_SEQ} "
          f"tokens")

    def warmed_stack(kv_resident, engine_runner=runner):
        """(sequential engine, async engine with a recording batcher) on one
        orchestrator over a fresh store, the three prefixes warmed through
        the sequential engine."""
        orch = Orchestrator(RadixIndex(CHUNK), Gateway(InMemoryStore()), spec,
                            theta_bytes=0,
                            pool=BandwidthPool(cap, Policy.CAL_STALL_OPT),
                            clock=VirtualClock())
        seq = ServingEngine(model, params, orch, runner=engine_runner,
                            kv_resident=kv_resident)
        eng = AsyncEngine(model, params, orch, compute=compute,
                          profile=S3_RDMA_AGG, session_setup=True,
                          max_flows=ASYNC_MAX_FLOWS, num_slots=ASYNC_SLOTS,
                          max_seq=ASYNC_MAX_SEQ, runner=runner,
                          kv_resident=kv_resident)
        recorder = DecodeRecorder(model)
        eng.batcher = ContinuousBatcher(recorder, params, ASYNC_SLOTS,
                                        ASYNC_MAX_SEQ)
        recorder.batcher = eng.batcher
        for j, prefix in enumerate(prefixes):
            seq.submit(prefix, req_id=f"warm{j}")
        return seq, eng, recorder

    def drive(eng, recorder, reqs, label):
        """One ``serve`` call, its printout and the checks every request
        of it passes; returns (results, launch counts of the call)."""
        trace = [TraceRequest(r.req_id, r.arrival_s, len(r.tokens),
                              (0 if r.req_id == "rc" else WARM_PREFIX)
                              / len(r.tokens), chunk_tokens=CHUNK)
                 for r in reqs]
        oracle = ClusterSim(cap_bps=cap, policy=Policy.CAL_STALL_OPT,
                            compute=compute, profile=S3_RDMA_AGG, spec=spec,
                            mode="layerwise", session_setup=True,
                            max_flows=ASYNC_MAX_FLOWS).run(trace).by_id()
        recorder.max_waiting = 0
        torch.cuda.synchronize()
        launches.reset()  # this serve() call's counts start here
        t0 = time.perf_counter()
        results = eng.serve(reqs)
        wall = time.perf_counter() - t0
        counts = launches.snapshot()
        for req in reqs:
            r, rec = results[req.req_id], results[req.req_id].record
            print(f"async {label} {req.req_id}: delivery="
                  f"{r.delivery.name if r.delivery else 'none'} matched="
                  f"{r.matched_tokens} arrival_s={rec.arrival_s:.6f} admit_s="
                  f"{rec.admit_s:.6f} flow_done_s={rec.flow_done_s:.6f} "
                  f"prefill_done_s={rec.prefill_done_s:.6f} ttft_s="
                  f"{rec.ttft_s:.6f} (virtual: transport model + "
                  f"PaperComputeModel, not a card time) wall_compute_s="
                  f"{r.wall_compute_s:.6f} wall_dequant_s="
                  f"{r.wall_dequant_s:.6f} tokens={r.new_tokens}")
        print(f"async {label} serve() wall {wall:.3f} s; peak transfers "
              f"{eng.peak_transfers}; batcher steps {eng.batcher.steps}, "
              f"most requests waiting for a slot {recorder.max_waiting}; "
              f"launches {counts}")
        n_warm = 0
        for req in reqs:
            rid, r = req.req_id, results[req.req_id]
            if rid == "rc":
                check(f"async {label} rc is a recompute flight",
                      r.delivery is None and r.record.bytes_total == 0.0,
                      f"delivery={r.delivery} bytes={r.record.bytes_total}")
            else:
                n_warm += 1
                check(f"async {label} {rid} LAYERWISE over {WARM_PREFIX}",
                      r.delivery is Delivery.LAYERWISE
                      and r.matched_tokens == WARM_PREFIX,
                      f"{r.delivery} {r.matched_tokens}")
            worst = max(abs(getattr(r.record, f) - getattr(oracle[rid], f))
                        for f in ("admit_s", "flow_done_s", "prefill_done_s",
                                  "ttft_s"))
            check(f"async {label} {rid} virtual timeline == ClusterSim",
                  worst <= ASYNC_TIMELINE_TOL,
                  f"max |diff| {worst} tol {ASYNC_TIMELINE_TOL}")
            check(f"async {label} {rid} logits finite",
                  bool(np.isfinite(r.logits[:V]).all()))
            check(f"async {label} {rid} {NEW_TOKENS} tokens in vocab",
                  len(r.new_tokens) == NEW_TOKENS
                  and all(0 <= x < V for x in r.new_tokens),
                  f"{r.new_tokens}")
        want = {k: 0 for k in launches.LAUNCHES}
        want["kv_dequant"] = 2 * L * n_warm
        if eng.kv_resident == "packed":
            # K7 once per layer step; K1 at the packed -> batcher boundary
            want["flash_attention_quant"] = L * n_warm
        check(f"async {label} launches", counts == want,
              f"got {counts} want {want}")
        return results, counts

    def stream(results, recorder, rid):
        """(tokens, the logits that chose each) of one async request."""
        r = results[rid]
        return r.new_tokens, [r.logits[:V]] + recorder.logits[rid]

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _, eng, fp_decode = warmed_stack("fp")
    fp, fp_counts = drive(eng, fp_decode, reqs, f"{codec}/fp")
    check(f"async {codec}/fp transfers overlap", eng.peak_transfers >= 2,
          f"peak_transfers={eng.peak_transfers}")
    held = {s: sorted(r) for s, r in fp_decode.slot_reqs.items()}
    check(f"async {codec}/fp decode slots turned over",
          eng.batcher.steps > 0 and max(len(r) for r in held.values()) >= 2,
          f"steps={eng.batcher.steps} slots held {held}")
    # the same engine and store, later: three warm requests at one instant
    # finish prefill together, so the third waits for a decode slot
    bursty, _ = drive(eng, fp_decode, burst_reqs, f"{codec}/fp burst")
    check(f"async {codec}/fp burst: a request waited for a decode slot",
          fp_decode.max_waiting >= 1, f"max {fp_decode.max_waiting}")
    del eng, bursty
    torch.cuda.empty_cache()

    # the sequential engine on a fresh stack warmed the same way serves
    # each prompt: the same ops at the same shapes on the same bytes in
    # prefill; its decode runs one sequence at a time where the batcher
    # runs two slots over a longer cache, so decode steps may round apart
    class DecodeLog(ModelRunner):
        """The runner with each greedy decode step's logits kept."""

        def decode(self, cache, token, pos):
            lg, cache = super().decode(cache, token, pos)
            self.steps.append(lg[0, :V].float().cpu().numpy())
            return lg, cache

    seq_runner = DecodeLog(model, params)
    seq, _, _ = warmed_stack("fp", engine_runner=seq_runner)
    for rid in order:
        seq_runner.steps = []
        t0 = time.perf_counter()
        s = seq.submit(prompts[rid], req_id=rid, max_new_tokens=NEW_TOKENS)
        wall = time.perf_counter() - t0
        diff = float(np.abs(s.logits - fp[rid].logits).max())
        check(f"async {codec}/fp {rid} logits bit-equal to sequential",
              np.array_equal(s.logits, fp[rid].logits)
              and s.matched_tokens == fp[rid].matched_tokens,
              f"max_abs_diff={diff} matched {fp[rid].matched_tokens} vs "
              f"{s.matched_tokens}; sequential submit wall {wall:.3f} s")
        streams_agree(f"async {codec}/fp {rid} tokens vs sequential",
                      *stream(fp, fp_decode, rid), s.new_tokens,
                      [s.logits[:V]] + seq_runner.steps, BATCHED_VS_SOLO_ULPS)
    del seq
    torch.cuda.empty_cache()

    _, eng, packed_decode = warmed_stack("packed")
    packed, packed_counts = drive(eng, packed_decode, reqs,
                                  f"{codec}/packed")
    del eng
    torch.cuda.empty_cache()
    for rid in order:
        f_lg, p_lg = fp[rid].logits[:V], packed[rid].logits[:V]
        step = logit_step(f_lg)
        diff = float(np.abs(p_lg - f_lg).max())
        check(f"async {codec} packed vs fp {rid} logits",
              diff <= PACKED_VS_FP_ULPS * step,
              f"max_abs_diff={diff} ({diff / step:.2f} bf16 steps) "
              f"tol={PACKED_VS_FP_ULPS * step}")
        streams_agree(f"async {codec} packed vs fp {rid} tokens",
                      *stream(packed, packed_decode, rid),
                      *stream(fp, fp_decode, rid), PACKED_VS_FP_ULPS)
    print(f"phase 5 wall {time.perf_counter() - t_phase:.1f} s; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
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
    records = phase_kernels() + phase_attention_kernels() \
        + phase_fp_kernels()
    served = build_served_model()
    ops_counts = phase_ops_on_model(served)
    fp_counts, packed_counts = phase_serving(served)
    async_fp_counts, async_packed_counts = phase_async(served)
    print(f"phase 5 launches: int8/fp serve() {async_fp_counts}; int8/packed "
          f"serve() {async_packed_counts}")
    for rec in records:
        path = {"kv_dequant": fp_counts, "kv_dequant_packed4": fp_counts,
                "decode_attention_quant": packed_counts,
                "flash_attention_quant": packed_counts}.get(rec["name"],
                                                            ops_counts)
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
