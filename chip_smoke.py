#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each one fails the run, with a non-zero exit, if it goes wrong):
  1. device and build: the card's name and power limit, torch and CUDA
     versions; builds every CUDA kernel of ``src/repro_torch/kernels/csrc``
     from scratch with nvcc (sm_90a) and prints the build time;
  2. kernels against their plain PyTorch versions on the card, at the
     serving path's shapes (K1/K2 also at qwen3-moe's, W=512) and on ragged
     shapes: the dequant kernels K1/K2
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
 2a. the commit's encode K9 (`kernels.kv_encode`) bit-equal to its plain
     version at the served configs' shapes (qwen3-14b one, two and eight
     chunks, bf16 and fp32; llama3-1-8b; qwen3-moe-30b-a3b; a 100-token
     chunk) for every quantized codec, mixed-bit maps included, and its
     device time at qwen3-14b's serving shape (int8, bf16, 1, 2 and 8
     chunks) beside its bytes bound, with the host time a call and the
     plain version's time;
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
     warm request, one K9 launch per quantized commit (none for identity),
     no K4, K5 or K8 launch on either, wire-sized commits, a traced int8
     commit whose every chunk K9 encoded (`commit.encode` `on_device`),
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
     packed-resident, one K9 a request (its commit), no other kernel;
     decode slots turned over, and in the
     burst a request waited for a slot.  Printed per request: the virtual
     times (the transport model and `PaperComputeModel`, not card times),
     the wall time the card spent on it (`wall_compute_s`,
     `wall_dequant_s`), and each `serve()`'s wall time.
  6. mixture of experts at full width: llama3-1-8b is freed first, then
     qwen3-moe-30b-a3b at its published widths and depth (48 layers,
     d_model 2048, 32/4 heads, head_dim 128, 128 experts top-8, expert d_ff
     768, bf16, random weights from seed 0).  For each codec of MOE_CODECS,
     on a fresh store: a cold 4096-token request, then the warm one served
     layerwise and the same warm prompt served chunkwise (8 greedy tokens
     each).  Checks: LAYERWISE / CHUNKWISE delivery of 3840 tokens, 96
     launches of the codec's dequant kernel and one K9 (the commit) per
     quantized layerwise warm request and no other kernel (chunkwise: the
     K9 alone), layerwise == chunkwise logits and tokens
     bit for bit, wire-sized commits, finite logits, in-vocab tokens.  The
     identity warm request against a no-cache prefill of the same prompt:
     every routing choice of the two runs is recorded (`RouteRecorder`),
     and every one that differs must be a near tie (ROUTER_INPUT_ULPS);
     until the first, logits within IDENTITY_VS_FULL_ULPS and tokens under
     phase 5's rule.  A profile of one identity and one int8 warm hit (the
     expert MLP's time a layer, the card's busy share; on the last layer's
     input the kernels one expert-MLP call launches, and its grouped
     products held to the per-expert chain within GROUPED_VS_CHAIN_ULPS,
     both timed).  Then `AsyncEngine` with a
     `ContinuousBatcher`, int8: two warm requests and one cold, the
     virtual timeline == the port's `ClusterSim` within 1e-9, 192 K1
     launches, prefill logits bit-equal to a sequential engine's;
 6b. alternating MoE: llama4-maverick-400b-a17b at its published widths
     with its depth cut from 48 to LLAMA4_LAYERS (one dense, one MoE layer;
     48 would not fit the card): the layerwise gate is off, a warm request
     is served CHUNKWISE, and warm vs a no-cache prefill under phase 6's
     routing rule;
  7. the other families at full width, model level, each built alone and
     freed after: mamba2-2.7b, zamba2-1.2b, whisper-large-v3 (1500 stub
     frame embeddings from a seed).  bf16: prefill of FAMILY_TOKENS tokens
     and 8 greedy decode steps, timed, logits finite.  fp32 (the same
     config, dtype changed): prefill(1023) + `decode_step` of the last
     token against prefill(1024), and for mamba2 / zamba2 prefill(512) +
     prefill(512, prefix state) against prefill(1024), within
     FAMILY_FP32_RTOL of the largest logit;
  8. training (kernel launch counts set to 0 before, read after: none may
     launch, since the reference's training reaches no Pallas kernel):
     8a llama3-1-8b at full width with TRAIN_LAYERS layers, SyntheticLM
     batches of 4 x 1024, remat: step 0's loss within the arch smoke
     test's bounds, remat == no remat (loss bit-equal, gradients within
     one bf16 step, the bit-equal share printed), bf16 against an fp32
     copy of the weights (loss within 2%, every gradient leaf at cosine
     >= 0.99), microbatches=4 against 1 (loss within 1e-3, parameters
     within one bf16 step), then TRAIN_STEPS AdamW steps: finite loss and
     gradient norm, the loss falling; the median step time, tokens/s,
     peak memory, the model FLOP share of 989 TFLOP/s and a profiled
     step's busy share and top kernels printed.  8b qwen3-moe-30b-a3b at
     its published widths with MOE_TRAIN_LAYERS layers: finite loss with
     the aux term, non-zero router gradients; the capacity dispatch on
     layer 0's real input (no drops: == ragged within one bf16 step; at
     1.25: drops counted, bit-equal over two calls); the grouped expert
     products against the per-expert chain there (output within
     GROUPED_VS_CHAIN_ULPS, gradients within GROUPED_GRAD_ULPS);
     MOE_TRAIN_STEPS steps timed, the expert MLP's forward share
     printed.  8c every
     arch's fp32 smoke config: one train step on the card == the same
     code on the CPU.  8d smollm-135m at full width and depth under
     `TrainSupervisor` (checkpoints in a temporary directory, removed
     after): a node failure and a NaN loss, losses after the restart ==
     the uninterrupted run's, the last checkpoint restored to the same
     tensors; then `python -m repro_torch.launch.train` as a subprocess;
  9. the dry run and the roofline: 9a `python -m repro_torch.launch.dryrun`
     for llama3-1-8b on the 16x16 mesh (every shape; the "opt" variant of
     prefill_32k and decode_32k) and on one device, nine subprocesses at
     once on the host over fake process groups: status ok (long_500k
     skipped), per-device memory, FLOPs, bytes, collective bytes and the
     H100 roofline terms and the floor printed, with the collective bytes
     by kind and what the peak is made of, counted on the busier of
     the first and the last rank (O2's prefill: the last, checked), every
     pod cell's arguments below 80 GB, train_4k's per-device FLOPs within
     ONE_DEVICE_FLOPS_RTOL of the closed form / 256 and its peak below
     80 GB, decode_32k opt's collective bytes below
     DECODE_OPT_COLLECTIVE_MAX, the one-device FLOPs within
     ONE_DEVICE_FLOPS_RTOL of the closed form; 9b three steps on the card
     through the sharded step's DTensor path on a 1x1 mesh over a
     one-rank NCCL group (MEASURED_CELLS): the median of MEASURED_STEPS
     synchronised steps after a warm-up, the port's counts and terms
     (n_dev 1), measured / bound and measured / floor (the bytes the step
     must move and its useful FLOPs), a profiled step's busy share,
     finite outputs; and blocked == naive at BLOCKED_CHECK_TOKENS, prefill
     and decode, within BLOCKED_VS_NAIVE_ULPS;
 10. the three model examples, `examples/torch_quickstart.py`,
     `torch_hybrid_prefill.py` and `torch_train_ft.py`, each a subprocess
     with `--device cuda`: exit 0 and the `OK:` lines their reference
     examples print, with each one's wall time.

The last two lines of standard output are the kernels' JSON record (all
eight kernels; K1/K2 and K9 launches from phase 3's fp-resident path, with phase
6's as ``moe_launches``, K6/K7 from its packed-resident one, K4/K5/K8 from
phase 2c; phase 5's counts are printed before it) and
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits with an error and prints no result.
"""
import collections
import gc
import json
import math
import os
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
# qwen3-moe-30b-a3b 512, llama3-1-8b / qwen3 / internvl2 / llama4 1024,
# whisper 1280, zamba2 2048) and ragged ones, each with every group of
# DEQUANT_GROUPS that divides it
CONFIG_WIDTHS = (192, 256, 512, 1024, 1280, 2048)
# qwen3-moe-30b-a3b's serving shape for K1/K2 (4 KV heads x head_dim 128),
# timed beside the main shape
MOE_SHAPE = (15, 256, 512)
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

# phase 6: qwen3-moe-30b-a3b at its published widths and depth
MOE_ARCH = "qwen3-moe-30b-a3b"
MOE_CODECS = ("identity", "int8", "int4", "gw8", "gw4")
# routing of warm against cold (a no-cache prefill of the warm prompt): a
# bf16 rounding apart in the hidden state can flip a top-k choice where the
# k-th and (k+1)-th router logits nearly tie.  A router input element that
# is ROUTER_INPUT_ULPS bf16 steps (2**-7 of itself each) apart moves logit e
# by at most ROUTER_INPUT_ULPS * 2**-7 * sum_i |x_i| |W_ie|, so two runs can
# swap experts a and b only if the cold run's logit gap z_a - z_b is at most
# twice that, at the larger sum of the two (in probability: p_b * (exp(gap)
# - 1)).  The same 2 steps as the dense logit bound.  A misrouted token, a
# wrong expert or a wrong weight moves choices at any gap.
ROUTER_INPUT_ULPS = 2
# rows of each router call kept by `RouteRecorder` (the suffix's tokens)
ROUTE_ROWS = 256
# the expert MLP's grouped products (`moe._expert_grouped`) against the
# per-expert chain (`moe._expert_loop`) on one layer's warm input: each
# product multiplies the same bf16 rows by the same expert weights, so bit
# equality is expected and printed; held within GROUPED_VS_CHAIN_ULPS bf16
# steps of the output's largest |value| (a kernel may sum K in another
# order).  A wrong offset, a misplaced row or a tail left undefined moves
# outputs by whole units.  In training (8b) the gradients sum over a
# group's rows in other kernels: within GROUPED_GRAD_ULPS steps of each
# tensor's largest |value|.
GROUPED_VS_CHAIN_ULPS = 1
GROUPED_GRAD_ULPS = 2
# phase 6, concurrent: two warm requests over two prefixes and one cold
MOE_ASYNC_ARRIVALS = {"r0": 0.0, "rc": 0.002, "r1": 0.004}
# phase 6b: llama4-maverick-400b-a17b at its published widths, 2 layers
LLAMA4_ARCH = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 2
# phase 7: the other families, model level
FAMILY_ARCHS = ("mamba2-2.7b", "zamba2-1.2b", "whisper-large-v3")
FAMILY_TOKENS = 1024  # a multiple of the SSD chunk (128)
# fp32 continuation (chunked SSD against the recurrent step; prefill of a
# prefix + suffix against one prefill): the sums run in other orders and
# other groupings (the SSD chunk's quadratic form against the recurrence),
# each op rounding at 2**-24 relative, through up to 64 layers.  Bound on
# max |dlogit|: FAMILY_FP32_RTOL of the largest |logit|.  A state carried
# wrong (a dropped chunk, a stale conv window, a position off by one) moves
# logits by their own size.
FAMILY_FP32_RTOL = 1e-3

# phase 8: training, on the card (TRAIN_DEVICE).  8a llama3-1-8b at its published widths with the depth
# cut from 32 to TRAIN_LAYERS (one card: 32 layers need 8.03 B params x 12
# bytes = 96 GB of parameters, gradients and fp32 moments before any
# activation; 8 layers 2.80 B, 33.5 GB), SyntheticLM batches of
# TRAIN_BATCH x TRAIN_SEQ (4096 tokens, as phase 3's prompt), remat, AdamW
# at TRAIN_LR with TRAIN_WARMUP warmup steps, TRAIN_STEPS steps.
TRAIN_LAYERS = 8
TRAIN_BATCH, TRAIN_SEQ = 4, 1024
TRAIN_STEPS = 20
TRAIN_LR, TRAIN_WARMUP = 3e-4, 5
# step 0 of the bf16 model against an fp32 copy of the same weights on the
# card: bf16 activations round at 2**-9 relative per op, so the loss moves
# by far less than BF16_VS_FP32_LOSS_RTOL and each gradient leaf keeps a
# cosine of at least BF16_VS_FP32_MIN_COS with the fp32 one (a relative
# error e gives a cosine of about 1 - e**2 / 2: 0.99 allows 14%).  A wrong
# gradient (a transposed product, a missing term) gives cosines far below.
BF16_VS_FP32_LOSS_RTOL = 0.02
BF16_VS_FP32_MIN_COS = 0.99
# microbatches=4 against 1 on the same batch: the loss is a mean of four
# means in fp32 (the reference test's 1e-3), and the parameters after the
# step may differ by one bf16 step at each leaf's largest |value| (the bf16
# gradient of the full batch against four accumulated in fp32; Adam's
# first step is lr * g / (|g| + eps), lr x 2 where a vanishing g's sign
# flips, below one such step for every leaf at this lr).
MICRO_LOSS_RTOL = 1e-3
# 8b qwen3-moe-30b-a3b at its published widths, 48 -> MOE_TRAIN_LAYERS
# layers (3.11 B params, 37 GB with fp32 moments), MOE_TRAIN_BATCH x
# MOE_TRAIN_SEQ tokens, MOE_TRAIN_STEPS steps of the ragged dispatch.
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 2, 1024
MOE_TRAIN_STEPS = 5
# 8c every arch's fp32 smoke config: one train step on the card against the
# same port code on the CPU.  Loss within SMOKE_LOSS_RTOL; gradients and
# the parameters after the step within SMOKE_TOL of each leaf's largest
# |value| (fp32 sums in other orders, ~1e-6).  AdamW's eps is
# SMOKE_ADAM_EPS: at the default 1e-8 Adam's first step lr * g / (|g| +
# eps) turns the rounding difference of a gradient near eps into a change
# of up to 2 lr, and a zero-initialised bias is lr in size after it.
SMOKE_LOSS_RTOL = 1e-5
SMOKE_TOL = 1e-4
SMOKE_ADAM_EPS = 1e-3
# 8d smollm-135m at its published widths and depth under `TrainSupervisor`:
# SUP_STEPS steps of SUP_BATCH x SUP_SEQ, a checkpoint every SUP_EVERY
# steps, SUP_KEEP kept, a node failure at SUP_FAIL_AT and a NaN loss at
# SUP_NAN_AT (once), against the same run without the failure.  The
# replayed steps run the same code on the same inputs: losses within
# RESTART_LOSS_RTOL (bit-equality printed, not required: on the card a
# kernel may add in another order from one call to the next).
SUP_ARCH = "smollm-135m"
SUP_STEPS, SUP_EVERY, SUP_KEEP = 30, 10, 2
SUP_BATCH, SUP_SEQ = 8, 256
SUP_FAIL_AT, SUP_NAN_AT = 15, 25
RESTART_LOSS_RTOL = 1e-4
TRAIN_DEVICE = "cuda"
# phase 9: the dry run (host only, subprocesses over a fake process group)
# and the roofline read against the card.  9a: llama3-1-8b on the 16x16
# mesh for every shape (long_500k recorded as skipped) and the "opt"
# variant of prefill_32k and decode_32k; the same three shapes on one
# device, whose counted FLOPs must match the closed form within
# ONE_DEVICE_FLOPS_RTOL; every pod cell's per-device argument bytes below
# the card's 80 GB
DRYRUN_CELLS = (("train_4k", "base"), ("prefill_32k", "base"),
                ("decode_32k", "base"), ("long_500k", "base"),
                ("prefill_32k", "opt"), ("decode_32k", "opt"))
DRYRUN_ONE = ("train_4k", "prefill_32k", "decode_32k")
ONE_DEVICE_FLOPS_RTOL = 0.01
CARD_HBM_BYTES = 80e9
# on the pod: train_4k's per-device FLOPs within ONE_DEVICE_FLOPS_RTOL of
# the closed form / 256 and its peak below the card's 80 GB, whatever
# DTensor's version; decode_32k opt keeps the weights sharded (its tokens
# cross the mesh, not ZeRO-3's 1.0e9 B of weights a step): collective
# bytes per device below DECODE_OPT_COLLECTIVE_MAX
DECODE_OPT_COLLECTIVE_MAX = 2.0e8
# 9b: three cells measured on the card through the sharded step's DTensor
# path on a 1x1 mesh over a one-rank NCCL group, cut by `input_specs`'
# batch_override and in depth: (shape, variant, batch, layers).
# decode_32k B=8 at full depth: cache 32x2x8x32768x8x128x2 B = 34.4 GB +
# 16.1 GB of weights; prefill_32k B=1 needs the blocked attention (the
# naive scores alone would be 128 GiB), cut to 8 of 32 layers because a
# 32-layer step takes four times an 8-layer one (its passes over fp32
# score tiles) and the cell runs it eight times; train_4k B=1 of 4096
# tokens at phase 8a's TRAIN_LAYERS layers
MEASURED_CELLS = (("decode_32k", "base", 8, 32), ("prefill_32k", "opt", 1, 8),
                  ("train_4k", "base", 1, TRAIN_LAYERS))
MEASURED_STEPS = 5  # timed, after one warm-up
# blocked == naive at 4096 tokens (prefill, and decode over its cache):
# logits within BLOCKED_VS_NAIVE_ULPS bf16 steps of the largest |logit|;
# the two sum each layer's attention in other orders and round p to bf16
# at other points, as packed vs fp do (PACKED_VS_FP_ULPS)
BLOCKED_CHECK_TOKENS = 4096
BLOCKED_VS_NAIVE_ULPS = 8
# phase 10: the three model examples on the card, each a subprocess given
# `--device cuda`, with the `OK:` lines `tests/test_examples.py` asserts
# for their reference examples
EXAMPLES = {
    "torch_quickstart.py": (
        "OK: cached-prefix logits == from-scratch logits",),
    "torch_hybrid_prefill.py": (
        "OK: hybrid <= min(pure-fetch, pure-recompute)",
        "OK: hybrid-prefill logits == no-cache logits"),
    "torch_train_ft.py": ("OK: training survived failure and converged",),
}
EXAMPLE_TIMEOUT_S = 300

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
        # qwen3-moe's shape: half the width, so half the bytes of a call
        Nm, Rm, Wm = MOE_SHAPE
        moe_sets = [inputs(Nm, Rm, Wm, 1, packed) for _ in range(32)]
        moe_ms = device_ms(lambda q, s: kern(q, s, group=1, out_dtype=bf16),
                           moe_sets)
        moe_bytes = Nm * Rm * (Wm // 2 if packed else Wm) + Nm * Wm * 2 \
            + Nm * Rm * Wm * 2
        moe_bound_ms = max(moe_bytes / HBM_BYTES_PER_S,
                           Nm * Rm * Wm / FP32_OPS_PER_S) * 1e3
        moe_plan = K.dequant_plan(Nm, Rm, Wm, 0, 0, 0)
        print(f"kernel {name} N={Nm} R={Rm} W={Wm} (qwen3-moe) group=1 "
              f"out=bf16: {moe_ms * 1e3:.2f} us device, bound "
              f"{moe_bound_ms * 1e3:.2f} us ({moe_bytes} B; "
              f"{moe_bound_ms / moe_ms * 100:.1f}% of bound); plan "
              f"{moe_plan.threads_x}x{moe_plan.threads_y} threads, "
              f"{moe_plan.rows} rows a thread, grid {moe_plan.grid(Nm)}")
        del moe_sets
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
            "same_bytes_ms": same_bytes_ms, "moe_ms": moe_ms,
            "moe_bound_ms": moe_bound_ms})
    return records


def phase_encode_kernel():
    """K9 (the commit's encode) bit-equal to its plain version on the card at
    the served configs' shapes, for every quantized codec; its time at the
    serving shape beside its bound.  Returns its record."""
    from repro_torch.codec import get_codec, mixed_codec_name
    from repro_torch.core import KVSpec
    from repro_torch.kernels import kv_encode as E
    g = torch.Generator(device="cuda").manual_seed(9)

    def params(spec):
        codec = get_codec(spec.codec)
        layers = range(spec.num_layers)
        return ([codec.layer_bits(spec, l) for l in layers],
                [codec.layer_group(spec, l) for l in layers])

    def view(L, KV, dh, N, dtype, G=CHUNK):
        """Chunks 1..N of batch row 1 of a [L, 2, 2, (N+1) G, KV, dh]
        cache: the strided view the engine's commit encodes."""
        cache = (torch.randn(L, 2, 2, (N + 1) * G, KV, dh, generator=g,
                             device="cuda") * 3).to(dtype)
        return cache[:, :, 1, G:(N + 1) * G]

    def codecs(L, W):
        """Every quantized codec at depth L whose groups divide W, and a
        mixed map whose group is the whole width (several passes over the
        rows where the width is wide)."""
        names = ["int8", "int4", "gw8/g16", "gw4/g16",
                 mixed_codec_name([8, 4] * (L // 2), 16),
                 mixed_codec_name([8, 4] * (L // 2), W)]
        return names + (["gw8", "gw4"] if W % 128 == 0 else [])

    # (label, L, KV, dh, N, dtype, G): the served configs' shapes
    # (qwen3-14b, llama3-1-8b, qwen3-moe-30b-a3b), one and eight chunks, an
    # fp32 cache, and a ragged chunk length (several passes over the rows
    # at the widest group)
    shapes = [("qwen3-14b", 40, 8, 128, 1, torch.bfloat16, CHUNK),
              ("qwen3-14b", 40, 8, 128, 8, torch.bfloat16, CHUNK),
              ("qwen3-14b fp32", 40, 8, 128, 2, torch.float32, CHUNK),
              ("llama3-1-8b", 32, 8, 128, 2, torch.bfloat16, CHUNK),
              ("qwen3-moe-30b-a3b", 48, 4, 128, 2, torch.bfloat16, CHUNK),
              ("smollm G=100", 2, 3, 64, 3, torch.bfloat16, 100)]
    max_err = 0
    for label, L, KV, dh, N, dtype, G in shapes:
        x = view(L, KV, dh, N, dtype, G)
        bad = []
        names = codecs(L, KV * dh)
        for name in names:
            spec = KVSpec(L, G, KV, dh, dtype_bytes=2, codec=name)
            bits, groups = params(spec)
            got = E.kv_quant_encode(x, chunk_tokens=G, bits=bits,
                                    groups=groups)
            want = E.kv_quant_encode_ref(x, chunk_tokens=G, bits=bits,
                                         groups=groups)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                diff = int((got != want).sum())
                max_err = max(max_err, diff)
                bad.append(f"{name.split('/')[0]}/g{groups[0]}: {diff} "
                           f"bytes differ")
        plan = E.encode_plan(G, KV * dh, [1])
        check(f"kv_quant_encode bit-equal to plain {label} L={L} KV={KV} "
              f"dh={dh} G={G} N={N} {str(dtype).split('.')[-1]}: "
              f"{len(names)} codecs", not bad,
              "; ".join(bad) + f" plan strip={plan.strip} row_groups="
              f"{plan.row_groups} passes={plan.passes(G)}")
        del x

    # time at the serving shape: qwen3-14b, int8, bf16, one chunk (four
    # caches rotate: 168 MB of input, past the 50 MB L2), then 2 and 8
    L, KV, dh = 40, 8, 128
    spec = KVSpec(L, CHUNK, KV, dh, dtype_bytes=2, codec="int8")
    bits, groups = params(spec)
    plan = E.encode_plan(CHUNK, KV * dh, groups)

    def kern(x):
        return E.kv_quant_encode(x, chunk_tokens=CHUNK, bits=bits,
                                 groups=groups)

    def plain(x):
        return E.kv_quant_encode_ref(x, chunk_tokens=CHUNK, bits=bits,
                                     groups=groups)

    def moved(N):  # the KV read once, the images written once
        return 2 * L * N * CHUNK * KV * dh * 2 + N * spec.wire_chunk_bytes

    times = {}
    for N in (1, 2, 8):
        arg_sets = [(view(L, KV, dh, N, torch.bfloat16),)
                    for _ in range(4 if N < 8 else 2)]
        times[N] = device_ms(kern, arg_sets)
        if N == 1:
            plain_ms = device_ms(plain, arg_sets, reps=4, batches=5)
            launch_us = host_us(kern, arg_sets[0], reps=100)
        del arg_sets
    bound = {N: moved(N) / HBM_BYTES_PER_S * 1e3 for N in times}
    for N, ms in times.items():
        print(f"kernel kv_quant_encode qwen3-14b int8 bf16 N={N}: "
              f"{ms * 1e3:.2f} us device, bound {bound[N] * 1e3:.2f} us "
              f"({moved(N)} B; {bound[N] / ms * 100:.1f}% of bound)"
              + (f", {launch_us:.2f} us host per call back to back, plain "
                 f"{plain_ms * 1e3:.2f} us" if N == 1 else "")
              + f"; plan strip {plan.strip}, {plan.threads} threads, "
              f"grid {plan.grid(KV * dh, L, N)}")
    rate = (moved(8) - moved(1)) / ((times[8] - times[1]) * 1e-3)
    print(f"kernel kv_quant_encode: the {moved(8) - moved(1)} B of seven "
          f"more chunks at {rate / 1e12:.2f} TB/s")
    return [{"name": "kv_quant_encode", "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/kv_quant_encode.cu",
             "replaces": "none (the reference encodes in numpy: "
                         "src/repro/codec/quant.py:47)",
             "launches": None, "max_abs_err": max_err, "ms": times[1],
             "plain_ms": plain_ms, "bound_ms": bound[1],
             "bound_by": "bytes", "library_ms": None, "host_us": launch_us,
             "ms_n2": times[2], "ms_n8": times[8]}]


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
            want["kv_quant_encode"] = 1  # the commit's encode
        check(f"{codec} warm dequant launches", d_lw == want,
              f"got {d_lw} want {want}")
        serve(cw, cold, "cold", f"{codec}/chunkwise")
        warm_cw, d_cw = serve(cw, warm, "warm", f"{codec}/chunkwise")
        check(f"{codec} chunkwise warm delivery is CHUNKWISE",
              warm_cw.delivery is Delivery.CHUNKWISE)
        check(f"{codec} chunkwise dequantizes on the host",
              d_cw == {k: int(k == "kv_quant_encode" and codec in KERNEL_OF)
                       for k in d_cw}, f"{d_cw}")
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
        # the warm hit's fetched prefix as it stayed on the card, (k, v) a
        # layer at model width
        fp_prefix_bytes[codec] = sum(t.numel() * t.element_size()
                                     for kv in lw._last_kv[0] for t in kv)
        del lw, cw
    fp_counts = launches.snapshot()
    print(f"fp-resident serving run launches: {fp_counts}; peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    for name in ("kv_dequant", "kv_dequant_packed4", "kv_quant_encode"):
        check(f"fp-resident serving path launched {name}",
              fp_counts[name] > 0, f"{fp_counts[name]} launches")
    # a traced int8 commit on the card: every chunk's image built by the
    # encode kernel, and the copy to the host moving wire bytes alone
    traced, _ = new_engine(served, "int8", 0)
    traced.tracer = Tracer()
    traced.submit(cold, "traced")
    enc, d2h = (traced.tracer.spans("traced", n)[0]
                for n in ("commit.encode", "commit.d2h"))
    check("int8 traced commit encodes every chunk on the card",
          enc.args["on_device"] == enc.args["chunks"] == COLD_TOKENS // CHUNK
          and d2h.args["bytes"] == enc.args["wire_bytes"]
          == enc.args["chunks"] * traced.spec.wire_chunk_bytes,
          f"encode {enc.args} {(enc.t1 - enc.t0) * 1e3:.3f} ms; d2h "
          f"{d2h.args} {(d2h.t1 - d2h.t0) * 1e3:.3f} ms")
    del traced

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
        want["kv_quant_encode"] = 1  # the suffix chunk's commit
        check(f"{codec}/packed warm launches", d_pk == want,
              f"got {d_pk} want {want}")
        written = pk_store.stats.snapshot()["bytes_written"]
        expect = pk.stats.commits * pk.spec.wire_chunk_bytes
        check(f"{codec}/packed bytes_written == commits x wire_chunk_bytes",
              written == expect, f"{written} vs {pk.stats.commits} x "
              f"{pk.spec.wire_chunk_bytes}")
        held = sum(pkv.resident_bytes for pkv in pk._last_kv[0])
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


def decode_log_runner(model, params):
    """A `ModelRunner` that keeps each greedy decode step's logits (the
    model's vocabulary) in ``.steps``."""
    from repro_torch.serving import ModelRunner

    class DecodeLog(ModelRunner):
        def decode(self, cache, token, pos):
            lg, cache = super().decode(cache, token, pos)
            self.steps.append(
                lg[0, :self.cfg.vocab_size].float().cpu().numpy())
            return lg, cache

    runner = DecodeLog(model, params)
    runner.steps = []
    return runner


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
                                     ContinuousBatcher, Orchestrator,
                                     ServingEngine)

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
        want["kv_quant_encode"] = len(reqs)  # one commit a request
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
    seq_runner = decode_log_runner(model, params)
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


# ---------------------------------------------------------------------------
# phases 6, 6b, 7: the other model families
# ---------------------------------------------------------------------------
def free_device(what: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    print(f"device memory after freeing {what}: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")


def build_full_width(arch, **changes):
    """A model of ``arch`` at its published widths (``changes`` replace
    config fields) with random weights from seed 0."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    cfg = dataclasses.replace(get_config(arch), **changes)
    model = build_model(cfg, device="cuda")
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    print(f"model {cfg.name} ({cfg.family}): {cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.compute_dtype}; "
          f"{cfg.param_count() / 1e9:.2f} B params initialised in "
          f"{time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    return cfg, model, params


class RouteRecorder:
    """Wraps `moe._route` while active: for the last ROUTE_ROWS rows of
    every call's input, keeps the router logits, the chosen experts and
    sum_i |x_i| |W_ie|, one entry a call, in order."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.route = moe, moe._route
        self.calls = []

    def __enter__(self):
        self.moe._route = self._record
        return self

    def __exit__(self, *exc):
        self.moe._route = self.route

    def _record(self, p, cfg, xf, *args, **kwargs):
        topw, topi, aux = self.route(p, cfg, xf, *args, **kwargs)
        w = p["router"].float()
        z = (xf.float() @ w)[-ROUTE_ROWS:]  # the product `_route` computes
        x = xf[-ROUTE_ROWS:].float()
        self.calls.append((z, topi[-ROUTE_ROWS:], x.abs() @ w.abs()))
        return topw, topi, aux


def routing_flips(warm_calls, cold_calls):
    """Per call: (rows compared, [(row, gap, bound)] of the rows whose
    chosen experts differ).  For each expert a the cold run chose and the
    warm run did not, and each b the other way round, the cold run's logit
    gap z_a - z_b must be within the ROUTER_INPUT_ULPS bound of the pair;
    the pair nearest its bound is kept."""
    out = []
    for (_, tw, _), (zc, tc, ac) in zip(warm_calls, cold_calls):
        differ = (tw.sort(-1).values != tc.sort(-1).values).any(-1)
        flips = []
        for r in differ.nonzero().flatten().tolist():
            cold_only = set(tc[r].tolist()) - set(tw[r].tolist())
            warm_only = set(tw[r].tolist()) - set(tc[r].tolist())
            pairs = [(float(zc[r, a] - zc[r, b]),
                      2 * ROUTER_INPUT_ULPS * 2.0 ** -7
                      * float(torch.maximum(ac[r, a], ac[r, b])))
                     for a in cold_only for b in warm_only]
            gap, bound = max(pairs, key=lambda gb: gb[0] / gb[1])
            flips.append((r, gap, bound))
        out.append((int(tw.shape[0]), flips))
    return out


def warm_vs_cold(label, cfg, warm_res, warm_steps, warm_route, cold_res,
                 cold_steps, cold_route, dense_ulps):
    """Warm against cold of one prompt, 8 greedy tokens each.  Every routing
    difference in the calls both runs made on the same inputs (the prefill
    and the decode steps before the tokens part) must be a near tie (the
    ROUTER_INPUT_ULPS bound).  Until the first one, each step's logits are
    held to ``dense_ulps`` bf16 steps of the largest logit, and the tokens
    may part only where the cold run's top two are within that bound; from
    the first flip on the logits are printed, not held."""
    V = cfg.vocab_size
    n_moe = cfg.num_layers // cfg.moe_every
    a_tok, b_tok = warm_res.new_tokens, cold_res.new_tokens
    a_lg = [warm_res.logits[:V]] + warm_steps
    b_lg = [cold_res.logits[:V]] + cold_steps
    part = next((i for i, (x, y) in enumerate(zip(a_tok, b_tok)) if x != y),
                None)
    groups = (part if part is not None else len(a_tok) - 1) + 1
    flips = routing_flips(warm_route[:groups * n_moe],
                          cold_route[:groups * n_moe])
    per_group = [sum(len(f) for _, f in flips[g * n_moe:(g + 1) * n_moe])
                 for g in range(groups)]
    # where in the prefill's layers the flips fall, and the first layer's:
    # a flip changes its token's hidden state by far more than a rounding,
    # so later layers' flips of that token follow from it
    per_layer = [len(f) for _, f in flips[:n_moe]]
    first_layer = next((l for l, n in enumerate(per_layer) if n), None)
    if first_layer is not None:
        print(f"{label}: prefill flips per MoE layer {per_layer}; first at "
              f"layer {first_layer}, cold gaps there "
              f"{[round(g, 5) for _, g, _ in flips[first_layer][1]]}")
    rows = sum(n for n, _ in flips)
    first = next((g for g, n in enumerate(per_group) if n), None)
    all_flips = [f for _, fl in flips for f in fl]
    bad = [f for f in all_flips if f[1] > f[2]]
    gaps = [g for _, g, _ in all_flips]
    check(f"{label} routing warm vs cold: every flip a near tie", not bad,
          f"{len(all_flips)} flips in {rows} token-layer choices "
          f"(prefill {per_group[0]}, decode steps {per_group[1:]}); "
          f"largest flip gap {max(gaps) if gaps else None}, bounds "
          f"{min(b for *_, b in all_flips) if all_flips else None}-"
          f"{max(b for *_, b in all_flips) if all_flips else None}; "
          f"beyond their bound: {bad[:5]}")
    if all_flips:
        zc = torch.cat([z for z, _, _ in cold_route[:n_moe]])
        top = torch.topk(zc, cfg.experts_per_token + 1, dim=-1).values
        gap_all = (top[:, -2] - top[:, -1]).float()
        print(f"{label}: cold prefill gaps between ranks "
              f"{cfg.experts_per_token} and {cfg.experts_per_token + 1}: "
              f"median {float(gap_all.median()):.4g}, share at or below the "
              f"largest flip gap {float((gap_all <= max(gaps)).float().mean()):.4f}")
    last = min(len(a_lg), len(b_lg)) - 1 if part is None else part
    for i in range(last + 1):
        step = logit_step(b_lg[i])
        diff = float(np.abs(a_lg[i] - b_lg[i]).max())
        held = first is None or i < first
        if held:
            check(f"{label} warm vs cold logits at token {i}",
                  diff <= dense_ulps * step,
                  f"max_abs_diff={diff} ({diff / step:.2f} bf16 steps, "
                  f"bound {dense_ulps})")
        else:
            print(f"{label} warm vs cold logits at token {i} (after a "
                  f"routing flip, not held): max_abs_diff={diff} "
                  f"({diff / step:.2f} bf16 steps)")
    if part is not None:
        gap = top_two_gap(b_lg[part])
        tol = dense_ulps * logit_step(b_lg[part])
        after_flip = first is not None and part >= first
        check(f"{label} warm vs cold tokens part at a near tie",
              after_flip or gap <= tol,
              f"part at token {part}: top-two gap {gap} tol {tol}; after a "
              f"routing flip: {after_flip}; {a_tok} vs {b_tok}")
    else:
        print(f"{label} warm vs cold tokens equal: {a_tok}")


def moe_engine(served, codec, theta=0, runner=None, sync_commit=True):
    from repro_torch.core import Gateway, InMemoryStore, RadixIndex
    from repro_torch.serving import Orchestrator, ServingEngine
    cfg, model, params, default_runner = served
    store = InMemoryStore()
    orch = Orchestrator(RadixIndex(CHUNK), Gateway(store),
                        cfg.kv_spec(CHUNK, dtype_bytes=2, codec=codec),
                        theta_bytes=theta)
    return ServingEngine(model, params, orch, sync_commit=sync_commit,
                         runner=runner or default_runner), store


def serve_counted(engine, tokens, req, label, cfg, route=None):
    """One submit with 8 greedy tokens: its launch counts (set to 0 just
    before, read just after), printout and per-request checks."""
    from repro_torch.kernels import launches
    launches.reset()
    t0 = time.perf_counter()
    if route is not None:
        with route:
            r = engine.submit(tokens, req, max_new_tokens=NEW_TOKENS)
    else:
        r = engine.submit(tokens, req, max_new_tokens=NEW_TOKENS)
    wall = time.perf_counter() - t0
    counts = launches.snapshot()
    print(f"request {label} {req}: delivery="
          f"{r.delivery.name if r.delivery else 'none'} matched="
          f"{r.matched_tokens} ttft_model_s={r.ttft_model_s:.6f} "
          f"compute_s={r.compute_s:.6f} transfer_completion_s="
          f"{r.transfer_completion_s:.6f} submit_wall_s={wall:.3f} "
          f"launches={counts} tokens={r.new_tokens}")
    check(f"{label} {req} logits finite",
          bool(np.isfinite(r.logits[:cfg.vocab_size]).all()))
    check(f"{label} {req} tokens in vocab",
          len(r.new_tokens) == NEW_TOKENS
          and all(0 <= t < cfg.vocab_size for t in r.new_tokens))
    return r, counts


def profile_moe_warm(served, orch, tokens, codec):
    """Two more warm hits on the same store, no commit and no decode: one
    with each call of the expert MLP (`moe._moe_ragged`: sort, three grouped
    products with the group offsets on the device, combine) timed on the
    host between two synchronizes, one under torch.profiler for the card's
    busy share.  On the last layer's input: the kernels one expert-MLP call
    launches, and the grouped products held against the per-expert chain
    (`moe.grouped_dispatch` patched to False), which is timed beside
    them."""
    from repro_torch.models import moe
    from repro_torch.serving import ServingEngine
    cfg, model, params, runner = served
    orch.theta = 0  # layerwise
    engine = ServingEngine(model, params, orch, runner=runner,
                           sync_commit=False)
    ragged, times, active, last = moe._moe_ragged, [], [], []

    def timed(p, cfg_, xf, topw, topi):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = ragged(p, cfg_, xf, topw, topi)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        active.append(int(torch.unique(topi).numel()))
        last[:] = [(p, cfg_, xf, topw, topi)]
        return y

    moe._moe_ragged = timed
    try:
        t0 = time.perf_counter()
        r = engine.submit(tokens, "timed")
        wall = time.perf_counter() - t0
    finally:
        moe._moe_ragged = ragged
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        engine.submit(tokens, "profiled")
    pwall = time.perf_counter() - t0
    device_ms = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f"profile moe/{codec} warm (no commit, no decode): wall "
          f"{wall * 1e3:.1f} ms, compute_s {r.compute_s:.6f}; expert MLP "
          f"(sync to sync) {sum(times) * 1e3:.1f} ms over {len(times)} "
          f"layers ({np.mean(times) * 1e3:.3f} ms a layer, "
          f"{np.mean(active):.1f} of {cfg.num_experts} experts active); "
          f"under the profiler wall {pwall * 1e3:.1f} ms, device kernel "
          f"time {device_ms:.2f} ms = {device_ms / (pwall * 1e3) * 100:.1f}%"
          f" of wall")
    args, real = last[0], moe.grouped_dispatch
    with torch.no_grad():
        launches_of = {}
        for name in ("grouped", "chain"):
            if name == "chain":
                moe.grouped_dispatch = lambda x: False
            try:
                y = ragged(*args)
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as one:
                    ragged(*args)
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    ragged(*args)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 5 * 1e3
            finally:
                moe.grouped_dispatch = real
            n = sum(e.count for e in one.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
            launches_of[name] = (y, n, ms)
    (yg, ng, msg), (yc, nc, msc) = launches_of["grouped"], launches_of["chain"]
    scale = float(yc.float().abs().max())
    step = 2.0 ** (math.floor(math.log2(max(scale, 2.0 ** -126))) - 7)
    diff = float((yg.float() - yc.float()).abs().max())
    print(f"profile moe/{codec} expert MLP on the last layer's input "
          f"({args[2].shape[0]} tokens): grouped {msg:.3f} ms, {ng} kernel "
          f"launches a MoE layer; per-expert chain {msc:.3f} ms, {nc} "
          f"launches")
    check(f"moe/{codec} grouped expert products == per-expert chain within "
          f"{GROUPED_VS_CHAIN_ULPS} bf16 step", diff <= GROUPED_VS_CHAIN_ULPS
          * step, f"max_abs_diff={diff} ({diff / step:.3g} steps at the "
          f"largest |out| {scale:.4g}); bit-equal {bool(torch.equal(yg, yc))}")


def phase_moe_serving():
    """Phase 6: qwen3-moe-30b-a3b served at full width; returns the K1/K2
    launch counts of the fp-resident path (counts set to 0 just before each
    request, summed over the phase's requests)."""
    from repro_torch.core import Delivery
    from repro_torch.kernels import launches
    from repro_torch.serving import ModelRunner

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = build_full_width(MOE_ARCH)
    served = (cfg, model, params, ModelRunner(model, params))
    L, V = cfg.num_layers, cfg.vocab_size
    rng = np.random.default_rng(0)
    cold = rng.integers(0, V, size=COLD_TOKENS)
    warm = np.concatenate([cold[:WARM_PREFIX],
                           rng.integers(0, V, size=COLD_TOKENS - WARM_PREFIX)])
    print(f"phase 6: {cfg.name} at its published widths and depth ({L} "
          f"layers, {cfg.num_heads}/{cfg.num_kv_heads} heads, head_dim "
          f"{cfg.head_dim}, {cfg.num_experts} experts top-"
          f"{cfg.experts_per_token}, expert d_ff {cfg.moe_d_ff}, vocab {V}); "
          f"cold {COLD_TOKENS} tokens, warm shares {WARM_PREFIX}")
    totals = collections.Counter()

    # cold: a no-cache prefill of the warm prompt, its routing recorded
    cold_log = decode_log_runner(model, params)
    full_eng, _ = moe_engine(served, "identity", runner=cold_log,
                             sync_commit=False)
    cold_route = RouteRecorder()
    cold_res, _ = serve_counted(full_eng, warm, "nocache", "moe/full", cfg,
                                route=cold_route)
    del full_eng
    for codec in MOE_CODECS:
        warm_log = decode_log_runner(model, params)
        eng, store = moe_engine(served, codec, runner=warm_log)
        serve_counted(eng, cold, "cold", f"moe/{codec}", cfg)
        warm_route = RouteRecorder() if codec == "identity" else None
        warm_log.steps = []  # this request's decode steps only
        lw, d_lw = serve_counted(eng, warm, "warm", f"moe/{codec}/layerwise",
                                 cfg, route=warm_route)
        totals.update(d_lw)
        warm_steps, warm_log.steps = warm_log.steps, []
        check(f"moe/{codec} warm delivery is LAYERWISE over {WARM_PREFIX}",
              lw.delivery is Delivery.LAYERWISE
              and lw.matched_tokens == WARM_PREFIX,
              f"{lw.delivery} {lw.matched_tokens}")
        want = {k: 0 for k in launches.LAUNCHES}
        if codec in KERNEL_OF:
            want[KERNEL_OF[codec]] = 2 * L
            want["kv_quant_encode"] = 1  # the commit's encode
        check(f"moe/{codec} warm launches (dequant and encode kernels only)",
              d_lw == want, f"got {d_lw} want {want}")
        # the same warm prompt on the same store, chunkwise
        eng.orch.theta = 1 << 60
        cw, d_cw = serve_counted(eng, warm, "warm", f"moe/{codec}/chunkwise",
                                 cfg)
        check(f"moe/{codec} chunkwise warm is CHUNKWISE over {WARM_PREFIX}",
              cw.delivery is Delivery.CHUNKWISE
              and cw.matched_tokens == WARM_PREFIX,
              f"{cw.delivery} {cw.matched_tokens}")
        # the layerwise request stored every chunk of the prompt, so the
        # commit encodes none
        check(f"moe/{codec} chunkwise launches nothing",
              not any(d_cw.values()), f"{d_cw}")
        diff = float(np.abs(lw.logits - cw.logits).max())
        check(f"moe/{codec} layerwise == chunkwise logits bit for bit",
              lw.logits.shape == cw.logits.shape
              and np.array_equal(lw.logits, cw.logits)
              and lw.new_tokens == cw.new_tokens,
              f"max_abs_diff={diff} tokens {lw.new_tokens} vs "
              f"{cw.new_tokens}")
        written = store.stats.snapshot()["bytes_written"]
        check(f"moe/{codec} bytes_written == commits x wire_chunk_bytes",
              written == eng.stats.commits * eng.spec.wire_chunk_bytes,
              f"{written} vs {eng.stats.commits} x "
              f"{eng.spec.wire_chunk_bytes}")
        if codec in ("identity", "int8"):
            profile_moe_warm(served, eng.orch, warm, codec)
        if codec == "identity":
            warm_vs_cold("moe/identity", cfg, lw, warm_steps,
                         warm_route.calls, cold_res, cold_log.steps,
                         cold_route.calls, IDENTITY_VS_FULL_ULPS)
            del warm_route, cold_route
        del eng, store
    print(f"phase 6 sequential: launches over the layerwise warm requests "
          f"{dict(totals)}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; wall "
          f"{time.perf_counter() - t_phase:.1f} s")
    async_counts = phase_moe_async(served)
    return totals, async_counts


def phase_moe_async(served):
    """Phase 6, concurrent: `AsyncEngine` with a `ContinuousBatcher` on the
    MoE model, int8: two warm requests and one cold; records == the port's
    `ClusterSim`, prefill logits bit-equal to a sequential engine's."""
    from repro_torch.cluster import ClusterSim, TraceRequest
    from repro_torch.core import Delivery, Gateway, InMemoryStore, RadixIndex
    from repro_torch.core.compute_model import PaperComputeModel
    from repro_torch.core.scheduler import BandwidthPool, Policy
    from repro_torch.core.transport import S3_RDMA_AGG, VirtualClock
    from repro_torch.kernels import launches
    from repro_torch.serving import (AsyncEngine, AsyncRequest, Orchestrator,
                                     ServingEngine)

    cfg, model, params, runner = served
    L, V = cfg.num_layers, cfg.vocab_size
    spec = cfg.kv_spec(CHUNK, dtype_bytes=2, codec="int8")
    compute = PaperComputeModel(num_layers=L)
    cap = 2 * (WARM_PREFIX // CHUNK) * spec.mean_wire_layer_bytes \
        / compute.layer_compute_s(COLD_TOKENS, WARM_PREFIX / COLD_TOKENS)
    rng = np.random.default_rng(8)
    prefixes = [rng.integers(0, V, size=WARM_PREFIX) for _ in range(2)]
    tail = COLD_TOKENS - WARM_PREFIX
    prompts = {f"r{i}": np.concatenate([p, rng.integers(0, V, size=tail)])
               for i, p in enumerate(prefixes)}
    prompts["rc"] = rng.integers(0, V, size=COLD_TOKENS)

    def stack(with_async):
        orch = Orchestrator(RadixIndex(CHUNK), Gateway(InMemoryStore()), spec,
                            theta_bytes=0,
                            pool=BandwidthPool(cap, Policy.CAL_STALL_OPT),
                            clock=VirtualClock())
        seq = ServingEngine(model, params, orch, runner=runner)
        for j, prefix in enumerate(prefixes):
            seq.submit(prefix, req_id=f"warm{j}")
        eng = AsyncEngine(model, params, orch, compute=compute,
                          profile=S3_RDMA_AGG, session_setup=True,
                          num_slots=ASYNC_SLOTS, max_seq=ASYNC_MAX_SEQ,
                          runner=runner) if with_async else None
        return seq, eng

    t0 = time.perf_counter()
    _, eng = stack(True)
    reqs = [AsyncRequest(rid, tuple(int(x) for x in prompts[rid]), at,
                         max_new_tokens=NEW_TOKENS)
            for rid, at in MOE_ASYNC_ARRIVALS.items()]
    trace = [TraceRequest(r.req_id, r.arrival_s, len(r.tokens),
                          (0 if r.req_id == "rc" else WARM_PREFIX)
                          / len(r.tokens), chunk_tokens=CHUNK) for r in reqs]
    oracle = ClusterSim(cap_bps=cap, policy=Policy.CAL_STALL_OPT,
                        compute=compute, profile=S3_RDMA_AGG, spec=spec,
                        mode="layerwise",
                        session_setup=True).run(trace).by_id()
    torch.cuda.synchronize()
    launches.reset()  # this serve() call's counts start here
    ts = time.perf_counter()
    results = eng.serve(reqs)
    wall = time.perf_counter() - ts
    counts = launches.snapshot()
    for req in reqs:
        rid, r = req.req_id, results[req.req_id]
        rec = r.record
        print(f"async moe/int8 {rid}: delivery="
              f"{r.delivery.name if r.delivery else 'none'} matched="
              f"{r.matched_tokens} admit_s={rec.admit_s:.6f} flow_done_s="
              f"{rec.flow_done_s:.6f} prefill_done_s={rec.prefill_done_s:.6f}"
              f" ttft_s={rec.ttft_s:.6f} (virtual) wall_compute_s="
              f"{r.wall_compute_s:.6f} wall_dequant_s={r.wall_dequant_s:.6f}"
              f" tokens={r.new_tokens}")
        worst = max(abs(getattr(rec, f) - getattr(oracle[rid], f))
                    for f in ("admit_s", "flow_done_s", "prefill_done_s",
                              "ttft_s"))
        check(f"async moe/int8 {rid} virtual timeline == ClusterSim",
              worst <= ASYNC_TIMELINE_TOL, f"max |diff| {worst}")
        if rid == "rc":
            check("async moe/int8 rc is a recompute flight",
                  r.delivery is None and rec.bytes_total == 0.0)
        else:
            check(f"async moe/int8 {rid} LAYERWISE over {WARM_PREFIX}",
                  r.delivery is Delivery.LAYERWISE
                  and r.matched_tokens == WARM_PREFIX,
                  f"{r.delivery} {r.matched_tokens}")
        check(f"async moe/int8 {rid} {NEW_TOKENS} finite-logit tokens in "
              f"vocab", bool(np.isfinite(r.logits[:V]).all())
              and len(r.new_tokens) == NEW_TOKENS
              and all(0 <= x < V for x in r.new_tokens), f"{r.new_tokens}")
    want = {k: 0 for k in launches.LAUNCHES}
    want["kv_dequant"] = 2 * L * 2
    want["kv_quant_encode"] = len(reqs)  # one commit a request
    check("async moe/int8 launches", counts == want,
          f"got {counts} want {want}")
    print(f"async moe/int8 serve() wall {wall:.3f} s; batcher steps "
          f"{eng.batcher.steps}; launches {counts}")
    del eng
    seq, _ = stack(False)
    for req in reqs:
        s = seq.submit(prompts[req.req_id], req_id=req.req_id)
        a = results[req.req_id]
        check(f"async moe/int8 {req.req_id} prefill logits bit-equal to "
              f"sequential", np.array_equal(s.logits, a.logits)
              and s.matched_tokens == a.matched_tokens,
              f"max_abs_diff={float(np.abs(s.logits - a.logits).max())}")
    del seq
    print(f"phase 6 async wall {time.perf_counter() - t0:.1f} s")
    return counts


def phase_llama4():
    """Phase 6b: alternating MoE (llama4-maverick) at its published widths
    with the depth cut to LLAMA4_LAYERS, served chunkwise."""
    from repro_torch.core import Delivery
    from repro_torch.kernels import launches
    from repro_torch.serving import ModelRunner
    from repro_torch.serving.engine import layerwise_ok

    t_phase = time.perf_counter()
    cfg, model, params = build_full_width(LLAMA4_ARCH,
                                          num_layers=LLAMA4_LAYERS)
    print(f"phase 6b: {cfg.name} at its published widths (d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
          f"{cfg.num_experts} experts top-{cfg.experts_per_token}, expert "
          f"and shared d_ff {cfg.moe_d_ff}/{cfg.shared_expert_d_ff}, dense "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}); depth cut from 48 to "
          f"{cfg.num_layers} layers (one dense, one MoE): 48 would hold "
          f"about 800 GB of bf16 weights")
    served = (cfg, model, params, ModelRunner(model, params))
    rng = np.random.default_rng(4)
    V = cfg.vocab_size
    cold = rng.integers(0, V, size=COLD_TOKENS)
    warm = np.concatenate([cold[:WARM_PREFIX],
                           rng.integers(0, V, size=COLD_TOKENS - WARM_PREFIX)])
    cold_log = decode_log_runner(model, params)
    full_eng, _ = moe_engine(served, "identity", runner=cold_log,
                             sync_commit=False)
    cold_route = RouteRecorder()
    cold_res, _ = serve_counted(full_eng, warm, "nocache", "llama4/full",
                                cfg, route=cold_route)
    del full_eng
    warm_log = decode_log_runner(model, params)
    eng, store = moe_engine(served, "identity", runner=warm_log)
    check("llama4 layerwise gate is off (alternating MoE)",
          not eng._layerwise_ok and not layerwise_ok(cfg))
    serve_counted(eng, cold, "cold", "llama4/identity", cfg)
    warm_log.steps = []  # the warm request's decode steps only
    warm_route = RouteRecorder()
    w, counts = serve_counted(eng, warm, "warm", "llama4/identity", cfg,
                              route=warm_route)
    check(f"llama4 warm is CHUNKWISE over {WARM_PREFIX} (theta 0 plans "
          f"layerwise)", w.delivery is Delivery.CHUNKWISE
          and w.matched_tokens == WARM_PREFIX,
          f"{w.delivery} {w.matched_tokens}")
    check("llama4 warm launches nothing", not any(counts.values()),
          f"{counts}")
    warm_vs_cold("llama4/identity", cfg, w, warm_log.steps, warm_route.calls,
                 cold_res, cold_log.steps, cold_route.calls,
                 IDENTITY_VS_FULL_ULPS)
    print(f"phase 6b wall {time.perf_counter() - t_phase:.1f} s")


def grow_kv(cache, n):
    """Room for ``n`` more tokens along the sequence dim of a cache's
    [*, 2, B, S, KV, dh] KV parts (hybrid ``attn``, encdec ``self``); SSM
    states stay as they are."""
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 0, 0, n))  # noqa
    return {k: pad(v) if k in ("attn", "self") else v
            for k, v in cache.items()}


def phase_families():
    """Phase 7: mamba2, zamba2 and whisper at their published widths and
    depths, model level: bf16 prefill + greedy decode, then fp32
    continuation checks."""
    for arch in FAMILY_ARCHS:
        t_arch = time.perf_counter()
        for dtype in ("bfloat16", "float32"):
            cfg, model, params = build_full_width(
                arch, param_dtype=dtype, compute_dtype=dtype)
            V = cfg.vocab_size
            tokens = torch.as_tensor(
                np.random.default_rng(9).integers(0, V, size=FAMILY_TOKENS),
                device="cuda")[None]
            batch = {"tokens": tokens}
            if cfg.family == "encdec":
                g = torch.Generator(device="cuda").manual_seed(1)
                batch["embeds"] = torch.randn(
                    (1, cfg.cross_kv_len, cfg.d_model), generator=g,
                    device="cuda").to(torch.bfloat16)

            def prefill(n0, n1, prefix=None):
                b = dict(batch, tokens=tokens[:, n0:n1])
                return model.prefill(params, b, prefix, n0)

            if dtype == "bfloat16":
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, cache = prefill(0, FAMILY_TOKENS)
                torch.cuda.synchronize()
                t_pre = time.perf_counter() - t0
                if isinstance(cache, dict):
                    cache = grow_kv(cache, NEW_TOKENS)
                out, finite = [], bool(torch.isfinite(lg[0, :V]).all())
                t0 = time.perf_counter()
                for i in range(NEW_TOKENS):
                    tok = int(torch.argmax(lg[0, :V]))
                    out.append(tok)
                    pos = torch.tensor([FAMILY_TOKENS + i], device="cuda")
                    lg, cache = model.decode_step(
                        params, cache, torch.tensor([[tok]], device="cuda"),
                        pos)
                    finite = finite and bool(torch.isfinite(lg[0, :V]).all())
                torch.cuda.synchronize()
                t_dec = time.perf_counter() - t0
                print(f"{cfg.name} bf16: prefill {FAMILY_TOKENS} tokens "
                      f"{t_pre:.3f} s, {NEW_TOKENS} decode steps "
                      f"{t_dec:.3f} s ({t_dec / NEW_TOKENS * 1e3:.1f} ms a "
                      f"step); tokens {out}")
                check(f"{cfg.name} bf16 logits finite, tokens in vocab",
                      finite and all(0 <= t < V for t in out))
            else:
                full, _ = prefill(0, FAMILY_TOKENS)
                full = full[0, :V].float().cpu().numpy()
                scale = float(np.abs(full).max())
                tol = FAMILY_FP32_RTOL * scale
                last = FAMILY_TOKENS - 1
                if cfg.family in ("ssm", "hybrid"):
                    # the chunked scan needs S % min(chunk, S) == 0: whole
                    # chunks, then the rest (1023 = 896 + 127)
                    split = last - last % cfg.ssm_chunk
                    _, c = prefill(0, split)
                    _, c = prefill(split, last, c)
                else:
                    _, c = prefill(0, last)
                if isinstance(c, dict):
                    c = grow_kv(c, 1)
                lg, _ = model.decode_step(
                    params, c, tokens[:, last:], torch.tensor([last],
                                                              device="cuda"))
                diff = float(np.abs(lg[0, :V].float().cpu().numpy()
                                    - full).max())
                check(f"{cfg.name} fp32 prefill({last}) + decode_step == "
                      f"prefill({FAMILY_TOKENS})", diff <= tol,
                      f"max_abs_diff={diff} max_abs_logit={scale} tol={tol}")
                if cfg.family in ("ssm", "hybrid"):
                    half = FAMILY_TOKENS // 2
                    _, c = prefill(0, half)
                    lg, _ = prefill(half, FAMILY_TOKENS, c)
                    diff = float(np.abs(lg[0, :V].float().cpu().numpy()
                                        - full).max())
                    check(f"{cfg.name} fp32 prefill({half}) + prefill({half},"
                          f" prefix state) == prefill({FAMILY_TOKENS})",
                          diff <= tol, f"max_abs_diff={diff} tol={tol}")
            del model, params, batch
            free_device(f"{cfg.name} {dtype}")
        print(f"phase 7 {arch} wall {time.perf_counter() - t_arch:.1f} s")


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------
def leaf_paths(tree, prefix=""):
    """'a/b/c' of every leaf, in the order of `training.tree.tree_leaves`."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in leaf_paths(tree[k], f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def on_device(batch, device=None):
    device = device or TRAIN_DEVICE
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def within_bf16_step(a, b) -> tuple[bool, float]:
    """(max |a - b| <= one bf16 step at the larger tensor's largest |value|,
    that difference in such steps)."""
    scale = max(float(a.abs().max()), float(b.abs().max()))
    step = 2.0 ** (math.floor(math.log2(max(scale, 2.0 ** -126))) - 7)
    diff = float((a.float() - b.float()).abs().max())
    return diff <= step, diff / step


def grads_apart(ga, gb):
    """(leaves bit-equal, leaves in all, largest difference in bf16 steps at
    each leaf's scale)."""
    from repro_torch.training.tree import tree_leaves
    same, worst = 0, 0.0
    la, lb = tree_leaves(ga), tree_leaves(gb)
    for a, b in zip(la, lb):
        same += bool(torch.equal(a, b))
        worst = max(worst, within_bf16_step(a, b)[1])
    return same, len(la), worst


def timed_step(step, params, opt, batch):
    """One train step, its wall time from a synchronize to the loss on the
    host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, opt, m = step(params, opt, batch)
    loss, gnorm = m["loss"].item(), m["grad_norm"].item()
    torch.cuda.synchronize()
    return params, opt, loss, gnorm, time.perf_counter() - t0


def profile_step(step, params, opt, batch, label):
    """One step under torch.profiler: the card's busy share (kernel time
    over wall) and its top kernels by time."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = step(params, opt, batch)
        out[2]["loss"].item()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    print(f"profile {label}: wall {wall * 1e3:.1f} ms, device kernel time "
          f"{busy:.1f} ms = {busy / (wall * 1e3) * 100:.1f}% of wall; top "
          f"kernels: " + "; ".join(
              f"{kernel_name(e.key)} {e.self_device_time_total / 1e3:.1f} ms"
              f" x{e.count}" for e in top))
    del out


def phase_train_dense():
    """Phase 8a: llama3-1-8b at full width, TRAIN_LAYERS layers."""
    from repro_torch.training import (AdamWConfig, SyntheticLM, adamw_init,
                                      make_train_step)
    import dataclasses
    from repro_torch.models import build_model
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    cfg, model, params = build_full_width(ARCH, num_layers=TRAIN_LAYERS)
    n_layers = sum(t.numel() for t in tree_leaves(params["layers"]))
    n_all = sum(t.numel() for t in tree_leaves(params))
    print(f"phase 8a: {cfg.name} at full width, {TRAIN_LAYERS} of 32 layers: "
          f"{n_all / 1e9:.3f} B params ({n_layers / 1e9:.3f} B in layers); "
          f"batch {TRAIN_BATCH} x {TRAIN_SEQ}, remat")
    data = SyntheticLM(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)
    b0 = on_device(data.batch_at(0))
    torch.cuda.reset_peak_memory_stats()
    loss, g = value_and_grad(model, params, b0, remat=True)
    loss = loss.item()
    lo, hi = 0.5 * math.log(cfg.vocab_size), \
        2.5 * math.log(cfg.padded_vocab)
    check("8a step-0 loss within [0.5 ln V, 2.5 ln V_pad]", lo < loss < hi,
          f"loss={loss:.6f} bounds=({lo:.3f}, {hi:.3f})")
    check("8a step-0 gradients finite", all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(g)))
    loss_n, g_n = value_and_grad(model, params, b0, remat=False)
    same, n, worst = grads_apart(g, g_n)
    check("8a remat=True == remat=False: loss bit-equal",
          loss_n.item() == loss, f"{loss_n.item()!r} vs {loss!r}")
    check("8a remat=True vs remat=False: gradients within one bf16 step",
          worst <= 1.0, f"{same} of {n} leaves bit-equal, largest "
          f"difference {worst:.3g} bf16 steps at the leaf's scale")
    del g_n
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    model32 = build_model(cfg32, device=TRAIN_DEVICE)
    p32 = tree_map(lambda t: t.float(), params)
    loss32, g32 = value_and_grad(model32, p32, b0, remat=True)
    del p32
    rel = abs(loss - loss32.item()) / abs(loss32.item())
    check("8a step-0 bf16 loss within 2% of the fp32 copy's",
          rel <= BF16_VS_FP32_LOSS_RTOL,
          f"bf16 {loss:.6f} fp32 {loss32.item():.6f} rel {rel:.3g}")
    cos = {}
    for path, a, b in zip(leaf_paths(g), tree_leaves(g), tree_leaves(g32)):
        a, b = a.float().flatten(), b.flatten()
        cos[path] = float(torch.dot(a, b) / (a.norm() * b.norm()))
    del a, b
    worst_leaf = min(cos, key=cos.get)
    check("8a step-0 bf16 gradients: cosine >= 0.99 with fp32, every leaf",
          min(cos.values()) >= BF16_VS_FP32_MIN_COS,
          f"min {cos[worst_leaf]:.6f} ({worst_leaf}); " + ", ".join(
              f"{k} {v:.5f}" for k, v in cos.items()))
    del g, g32, model32
    peak_checks = torch.cuda.max_memory_allocated() / 2**30
    print(f"8a after the step-0 checks: "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated (the "
          f"parameters {sum(t.nbytes for t in tree_leaves(params)) / 2**30:.2f}"
          f" GiB)")

    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                       total_steps=TRAIN_STEPS)
    opt = adamw_init(params, ocfg)
    torch.cuda.reset_peak_memory_stats()
    s4 = make_train_step(model, ocfg, remat=True, microbatches=4)
    p4, o4, m4 = s4(params, opt, b0)
    loss4 = m4["loss"].item()
    del o4
    step = make_train_step(model, ocfg, remat=True)
    params, opt, loss0, gnorm0, t0 = timed_step(step, params, opt, b0)
    rel = abs(loss4 - loss0) / loss0
    check("8a microbatches=4 vs 1: loss within 1e-3 relative",
          rel <= MICRO_LOSS_RTOL, f"{loss4:.6f} vs {loss0:.6f} rel {rel:.3g}")
    apart = [within_bf16_step(a, b) for a, b in
             zip(tree_leaves(p4), tree_leaves(params))]
    check("8a microbatches=4 vs 1: parameters within one bf16 step",
          all(ok for ok, _ in apart),
          f"largest {max(s for _, s in apart):.3g} bf16 steps at the leaf's "
          f"scale")
    del p4
    print(f"8a after step 0: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated (parameters and AdamW state)")
    losses, gnorms, times = [loss0], [gnorm0], [t0]
    for s in range(1, TRAIN_STEPS):
        params, opt, loss, gnorm, dt = timed_step(step, params, opt,
                                                  data.batch_at(s))
        losses.append(loss)
        gnorms.append(gnorm)
        times.append(dt)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("8a losses " + " ".join(f"{x:.4f}" for x in losses))
    print("8a grad norms " + " ".join(f"{x:.4f}" for x in gnorms))
    print("8a step times (s) " + " ".join(f"{x:.4f}" for x in times))
    check("8a loss and gradient norm finite on every step",
          all(math.isfinite(x) for x in losses + gnorms))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    check("8a loss falls over 20 steps (mean of last 5 < first 5)",
          last < first, f"{first:.4f} -> {last:.4f}")
    med = statistics.median(times[5:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    H, dh, L = cfg.num_heads, cfg.head_dim, TRAIN_LAYERS
    # attention's two products (QK^T, PV) over every (query, key) pair, as
    # the naive attention computes them; backward twice the forward
    attn_fwd = 2 * 2 * TRAIN_BATCH * H * TRAIN_SEQ ** 2 * dh * L
    model_flops = 6 * n_layers * tokens + 3 * attn_fwd
    remat_flops = 2 * n_layers * tokens + attn_fwd
    logit_flops = 6 * cfg.padded_vocab * cfg.d_model * tokens
    print(f"8a median step {med:.4f} s over steps 5-{TRAIN_STEPS - 1} "
          f"({tokens / med:.0f} tokens/s); peak device memory {peak:.1f} GiB "
          f"over the steps (microbatch step included), {peak_checks:.1f} GiB "
          f"over the step-0 checks; model FLOPs "
          f"{model_flops / 1e12:.2f} TFLOP a step (6 N_nonembed T "
          f"{6 * n_layers * tokens / 1e12:.2f} + attention "
          f"{3 * attn_fwd / 1e12:.2f}) = "
          f"{model_flops / med / BF16_TENSOR_OPS_PER_S * 100:.2f}% of 989 "
          f"TFLOP/s; with remat's extra forward "
          f"({remat_flops / 1e12:.2f} TFLOP) "
          f"{(model_flops + remat_flops) / med / BF16_TENSOR_OPS_PER_S * 100:.2f}%"
          f"; the unembedding (fp32 products, not in N_nonembed) "
          f"{logit_flops / 1e12:.2f} TFLOP more")
    from repro_torch.configs.shapes import Shape
    from repro_torch.roofline import model_flops as roofline_model_flops
    mf = roofline_model_flops(cfg, Shape("8a", TRAIN_SEQ, TRAIN_BATCH,
                                         "train"))
    print(f"8a re-read with roofline.model_flops (6 N T, N = all "
          f"{n_all / 1e9:.3f} B params, embeddings included; no attention "
          f"term): {mf / 1e12:.2f} TFLOP a step = "
          f"{mf / med / BF16_TENSOR_OPS_PER_S * 100:.2f}% of 989 TFLOP/s")
    profile_step(step, params, opt, on_device(data.batch_at(TRAIN_STEPS)),
                 "8a step")
    print(f"phase 8a wall {time.perf_counter() - t_phase:.1f} s")


def phase_train_moe():
    """Phase 8b: qwen3-moe-30b-a3b at its published widths, 4 layers."""
    import dataclasses
    from repro_torch.models import dense, moe
    from repro_torch.models import layers as nn
    from repro_torch.training import AdamWConfig, SyntheticLM, adamw_init, \
        make_train_step
    from repro_torch.training.train_step import value_and_grad
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = build_full_width(MOE_ARCH,
                                          num_layers=MOE_TRAIN_LAYERS)
    data = SyntheticLM(cfg.vocab_size, MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, seed=0)
    b0 = on_device(data.batch_at(0))
    with torch.no_grad():
        _, aux = moe.forward(params, cfg, b0["tokens"])
    loss, g = value_and_grad(model, params, b0, remat=True)
    router = g["layers"]["moe"]["router"]  # [L, d, E]
    nonzero = [float(router[i].abs().sum()) for i in range(router.shape[0])]
    check("8b step-0 loss finite (aux term included)",
          math.isfinite(loss.item()) and math.isfinite(aux.item()),
          f"loss {loss.item():.6f} = CE + {moe.LOAD_BALANCE_COEF} x aux "
          f"{aux.item():.6f}")
    check("8b router gradients finite and non-zero in every layer",
          bool(torch.isfinite(router).all()) and min(nonzero) > 0,
          f"sum |grad| per layer {[f'{x:.4g}' for x in nonzero]}")
    del g
    # the capacity dispatch on layer 0's real input
    p0 = dense.take(params["layers"], 0)
    with torch.no_grad():
        x = nn.embed(params["embed"], cfg, b0["tokens"])
        pos = torch.arange(x.shape[1], device=x.device)[None]
        h = x + nn.attention(p0["attn"], cfg, nn.rmsnorm(p0["ln1"], x),
                             positions=pos)[0]
        inp = nn.rmsnorm(p0["ln2"], h)
        E, k, T = cfg.num_experts, cfg.experts_per_token, inp.shape[0] * \
            inp.shape[1]
        rag, _ = moe.moe_mlp(p0["moe"], cfg, inp, "ragged")
        big = dataclasses.replace(cfg, capacity_factor=float(E))  # C = T*k
        cap, _ = moe.moe_mlp(p0["moe"], big, inp, "capacity")
        ok, steps = within_bf16_step(cap, rag)
        check("8b capacity dispatch with C >= T*k (nothing dropped) == "
              "ragged within one bf16 step", ok,
              f"C={T * k}, largest difference {steps:.3g} bf16 steps at the "
              f"output's scale")
        del cap
        C = max(1, int(T * k / E * cfg.capacity_factor))
        _, topi, _ = moe._route(p0["moe"], cfg, inp.reshape(T, -1))
        _, slot = moe.capacity_slots(topi, E, C)
        dropped = int((slot == E * C).sum())
        a, _ = moe.moe_mlp(p0["moe"], cfg, inp, "capacity")
        b, _ = moe.moe_mlp(p0["moe"], cfg, inp, "capacity")
        check("8b capacity dispatch at factor 1.25: forward bit-equal over "
              "two calls", bool(torch.equal(a, b)),
              f"C={C}: {dropped} of {T * k} (token, rank) pairs dropped")
        del a, b, rag, h, x
    # the ragged dispatch's grouped products against the per-expert chain
    # on layer 0's input: output, and the gradients of the input and the
    # expert stacks
    real, got = moe.grouped_dispatch, {}
    for name in ("grouped", "chain"):
        if name == "chain":
            moe.grouped_dispatch = lambda t: False
        try:
            xin = inp.detach().requires_grad_()
            pm = {n: w.detach().requires_grad_()
                  for n, w in p0["moe"].items() if n != "router"}
            y, _ = moe.moe_mlp({**p0["moe"], **pm}, cfg, xin, "ragged")
            y.float().square().mean().backward()
            got[name] = [y.detach(), xin.grad] \
                + [pm[n].grad for n in sorted(pm)]
        finally:
            moe.grouped_dispatch = real
    worst = [within_bf16_step(a, b)[1]
             for a, b in zip(got["grouped"], got["chain"])]
    check(f"8b grouped expert products == per-expert chain: output within "
          f"{GROUPED_VS_CHAIN_ULPS} bf16 step, gradients within "
          f"{GROUPED_GRAD_ULPS}", worst[0] <= GROUPED_VS_CHAIN_ULPS
          and max(worst[1:]) <= GROUPED_GRAD_ULPS,
          f"bf16 steps at each tensor's largest |value|: output "
          f"{worst[0]:.3g}, input grad {worst[1]:.3g}, "
          f"{'/'.join(sorted(pm))} grads "
          f"{', '.join(f'{w:.3g}' for w in worst[2:])}")
    del got, xin, pm, y, inp
    peak_checks = torch.cuda.max_memory_allocated() / 2**30
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=1,
                       total_steps=MOE_TRAIN_STEPS)
    opt = adamw_init(params, ocfg)
    torch.cuda.reset_peak_memory_stats()
    step = make_train_step(model, ocfg, remat=True)
    losses, times = [], []
    for s in range(MOE_TRAIN_STEPS):
        params, opt, loss, _, dt = timed_step(step, params, opt,
                                              data.batch_at(s))
        losses.append(loss)
        times.append(dt)
    check("8b loss finite on every step", all(map(math.isfinite, losses)),
          " ".join(f"{x:.4f}" for x in losses))
    # one more step with every expert-MLP call timed sync to sync: the
    # forward's, and remat's recomputation, which stops inside the call
    # once it has the tensors the backward needs; its backward runs in
    # autograd, not timed apart
    ragged, loop = moe._moe_ragged, []

    def timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return ragged(*args)
        finally:
            torch.cuda.synchronize()
            loop.append(time.perf_counter() - t0)

    moe._moe_ragged = timed
    try:
        params, opt, _, _, dt = timed_step(step, params, opt,
                                           data.batch_at(MOE_TRAIN_STEPS))
    finally:
        moe._moe_ragged = ragged
    print("8b step times (s) " + " ".join(f"{x:.4f}" for x in times)
          + f"; median {statistics.median(times):.4f} s; with the expert "
          f"MLP timed: step {dt:.4f} s, its {len(loop)} calls "
          f"(forward and recomputation) {sum(loop):.4f} s = "
          f"{sum(loop) / dt * 100:.1f}% of it; "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f}"
          f" GiB over the steps, {peak_checks:.1f} GiB over the step-0 and "
          f"capacity checks")
    print(f"phase 8b wall {time.perf_counter() - t_phase:.1f} s")


def smoke_batch(cfg, seed=0):
    """A SyntheticLM batch of 2 x 16 (encdec: 8 tokens over 12 frames; vlm:
    with its patches) as numpy arrays."""
    from repro_torch.training import SyntheticLM
    b = SyntheticLM(cfg.vocab_size, 16, 2, seed=seed).batch_at(0)
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        b = {k: v[:, :8] for k, v in b.items()}
        b["embeds"] = rng.standard_normal((2, 12, cfg.d_model), np.float32)
    elif cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((2, cfg.num_patches, cfg.d_model),
                                          np.float32)
    return b


def phase_train_smoke():
    """Phase 8c: every arch's fp32 smoke config, one step card vs CPU."""
    from repro_torch.configs import ARCH_IDS, get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.training import AdamWConfig, adamw_init, make_train_step
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_leaves, tree_map
    t_phase = time.perf_counter()
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, eps=SMOKE_ADAM_EPS)
    for arch in ARCH_IDS + [ARCH]:
        cfg = get_smoke_config(arch)
        out = {}
        for device in ("cpu", TRAIN_DEVICE):
            model = build_model(cfg, device=device)
            if device == "cpu":
                p = model.init_params(torch.Generator().manual_seed(0))
            else:
                p = tree_map(lambda t: t.to(device), out["cpu"][0])
            b = on_device(smoke_batch(cfg), device)
            _, g = value_and_grad(model, p, b, remat=True)
            step = make_train_step(model, ocfg, remat=True)
            new, _, m = step(p, adamw_init(p, ocfg), b)
            out[device] = (p, g, new, m["loss"].item())
        lc, lg = out["cpu"][3], out[TRAIN_DEVICE][3]
        worst = {}
        for what, i in (("grads", 1), ("params", 2)):
            r = 0.0
            for a, c in zip(tree_leaves(out[TRAIN_DEVICE][i]),
                            tree_leaves(out["cpu"][i])):
                scale = max(float(c.abs().max()), 1e-30)
                r = max(r, float((a.cpu() - c).abs().max()) / scale)
            worst[what] = r
        check(f"8c {arch} smoke fp32 train step: card == CPU",
              abs(lg - lc) <= SMOKE_LOSS_RTOL * abs(lc)
              and worst["grads"] <= SMOKE_TOL and worst["params"] <= SMOKE_TOL,
              f"loss {lg:.7f} vs {lc:.7f}; largest |diff| / leaf max: grads "
              f"{worst['grads']:.3g}, params after the step "
              f"{worst['params']:.3g}")
    print(f"phase 8c wall {time.perf_counter() - t_phase:.1f} s")


class StepLog:
    """A supervisor's train step and batches, recorded: the data step of
    each call that returned a finite loss (the accepted ones), its loss,
    and a NaN loss injected at data step ``nan_at`` once."""

    def __init__(self, step, data, nan_at):
        self.step, self.data, self.nan_at = step, data, nan_at
        self.current, self.log, self.poisoned = None, [], False

    def batch_at(self, s):
        self.current = s
        return self.data.batch_at(s)

    def train_step(self, params, opt, batch):
        params, opt, m = self.step(params, opt, batch)
        if self.current == self.nan_at and not self.poisoned:
            self.poisoned = True
            m = {**m, "loss": torch.full_like(m["loss"], float("nan"))}
        elif math.isfinite(m["loss"].item()):
            self.log.append((self.current, m["loss"].item()))
        return params, opt, m


def phase_train_supervisor():
    """Phase 8d: smollm-135m at full width and depth under TrainSupervisor,
    then the training launcher as a subprocess."""
    import tempfile
    from repro_torch.training import (AdamWConfig, SimulatedFailure,
                                      SyntheticLM, TrainSupervisor,
                                      adamw_init, latest_step,
                                      make_train_step, restore_checkpoint)
    from repro_torch.training.tree import tree_leaves
    t_phase = time.perf_counter()
    cfg, model, params = build_full_width(SUP_ARCH)
    data = SyntheticLM(cfg.vocab_size, SUP_SEQ, SUP_BATCH, seed=0)
    ocfg = AdamWConfig(lr=TRAIN_LR, warmup_steps=3, total_steps=SUP_STEPS)
    opt = adamw_init(params, ocfg)
    step = make_train_step(model, ocfg, remat=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        runs = {}
        for name, fail_at in (("uninterrupted", None), ("failed", SUP_FAIL_AT)):
            log = StepLog(step, data, SUP_NAN_AT)
            fired = []

            def inject(s, fail_at=fail_at, fired=fired):
                if s == fail_at and not fired:
                    fired.append(s)
                    raise SimulatedFailure("node lost")

            ckpt = f"{tmp}/{name}"
            sup = TrainSupervisor(log.train_step, params, opt, ckpt_dir=ckpt,
                                  ckpt_every=SUP_EVERY, keep=SUP_KEEP)
            t0 = time.perf_counter()
            stats = sup.run(log.batch_at, SUP_STEPS, failure_injector=inject)
            wall = time.perf_counter() - t0
            kept = sorted(d for d in os.listdir(ckpt) if d.startswith("step_"))
            print(f"8d {name}: {stats.steps_done} steps done, restarts "
                  f"{stats.restarts}, rollbacks {stats.rollbacks}, "
                  f"stragglers {stats.stragglers}, {wall:.1f} s; "
                  f"checkpoints kept {kept}")
            runs[name] = (log.log, stats, sup, ckpt)
        clean, fail = runs["uninterrupted"][0], runs["failed"][0]
        stats = runs["failed"][1]
        check("8d failed run: 1 restart and 1 rollback",
              stats.restarts == 1 and stats.rollbacks == 1,
              f"restarts {stats.restarts} rollbacks {stats.rollbacks}")
        # the failed run replays the clean run's steps from the last
        # checkpoint before the failure (step 10) on
        cut = SUP_FAIL_AT - SUP_FAIL_AT % SUP_EVERY
        want = clean[:SUP_FAIL_AT] + clean[cut:]
        same_steps = [s for s, _ in fail] == [s for s, _ in want]
        rel = max((abs(a - b) / abs(b) for (_, a), (_, b) in zip(fail, want)),
                  default=math.inf)
        bits = all(a == b for (_, a), (_, b) in zip(fail, want))
        check("8d losses after the restart == the uninterrupted run's",
              same_steps and rel <= RESTART_LOSS_RTOL,
              f"{len(fail)} steps compared ({len(fail) - SUP_FAIL_AT} after "
              f"the restart), largest relative difference {rel:.3g}; "
              f"bit-equal: {bits}")
        _, _, sup, ckpt = runs["failed"]
        last = latest_step(ckpt)
        tree, _ = restore_checkpoint(ckpt, last, {"params": sup.params,
                                                  "opt": sup.opt_state})
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(tree), tree_leaves({"params": sup.params,
                                            "opt": sup.opt_state})))
        check("8d the port's last checkpoint restores to the same tensors",
              same and last == SUP_STEPS, f"step {last}")
        del runs, sup, tree, model, params, opt, step
        shutil.rmtree(tmp, ignore_errors=True)
        free_device(SUP_ARCH)
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
               SUP_ARCH, "--steps", "10", "--batch", "8", "--seq", "256",
               "--ckpt-dir", f"{tmp}/launch"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=600, env=dict(
                               os.environ, PYTHONPATH=str(ROOT / "src")))
        lines = r.stdout.strip().splitlines()
        print(f"8d {' '.join(cmd[1:])}: exit {r.returncode} in "
              f"{time.perf_counter() - t0:.1f} s; " + " | ".join(lines[-2:]))
        check("8d launch.train exits 0 with its closing line",
              r.returncode == 0 and bool(lines)
              and lines[-1].startswith("done: steps="),
              r.stderr[-2000:] if r.returncode else "")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"phase 8d wall {time.perf_counter() - t_phase:.1f} s")


def phase_training():
    """Phase 8: the training path; no kernel K1-K8 may launch in it."""
    from repro_torch.kernels import launches
    t_phase = time.perf_counter()
    launches.reset()
    phase_train_dense()
    free_device(f"{ARCH} ({TRAIN_LAYERS} layers)")
    phase_train_moe()
    free_device(f"{MOE_ARCH} ({MOE_TRAIN_LAYERS} layers)")
    phase_train_smoke()
    phase_train_supervisor()
    counts = launches.snapshot()
    check("phase 8 training launched no kernel", not any(counts.values()),
          f"{counts}")
    print(f"phase 8 wall {time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 9: the dry run and the roofline on the card
# ---------------------------------------------------------------------------
def closed_form_flops(cfg, kind: str, B: int, T: int) -> float:
    """A dense step's matmul FLOPs on one device, naive attention: 2 x
    (matmul parameters) x tokens + 4 B H Sq Sk dh per layer + the logits'
    product (prefill: the last token's); train (remat) = three forwards
    plus remat's recomputation, which stops before each layer's MLP output
    product."""
    d, H, KV, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ff, L, V = cfg.d_ff, cfg.num_layers, cfg.padded_vocab
    per_token = L * (d * H * dh + 2 * d * KV * dh + H * dh * d + 3 * d * ff)
    if kind == "decode":
        return 2 * per_token * B + 4 * B * H * T * dh * L + 2 * B * d * V
    attention = 4 * B * H * T * T * dh * L
    if kind == "prefill":
        return 2 * per_token * B * T + attention + 2 * B * d * V
    forward = 2 * per_token * B * T + attention
    return 4 * forward - 2 * B * T * ff * d * L + 3 * 2 * B * T * d * V


def phase_dryrun(smi: str):
    """9a: the port's dry run of llama3-1-8b, one subprocess per cell, all
    at once (a process holds one process group; the card is not used)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    jobs = [(shape, variant, "pod") for shape, variant in DRYRUN_CELLS] \
        + [(shape, "base", "one") for shape in DRYRUN_ONE]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", shape, "--mesh", mesh, "--variant", variant, "--force"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for shape, variant, mesh in jobs]
    for (shape, variant, mesh), p in zip(jobs, procs):
        out, err = p.communicate(timeout=900)
        check(f"9a dry run {shape} {variant} {mesh} exits 0",
              p.returncode == 0, err[-1500:] if p.returncode else "")
    print(f"9a dry run: {len(jobs)} processes in "
          f"{time.perf_counter() - t0:.1f} s (host only; {smi})")
    cfg = get_config(ARCH)
    for shape, variant, mesh in jobs:
        with open(dryrun.cell_path(ARCH, shape, mesh, variant)) as f:
            rec = json.load(f)
        if shape == "long_500k":
            check("9a long_500k recorded as skipped for a full-attention "
                  "arch", rec["status"] == "skipped", rec.get("reason", ""))
            continue
        check(f"9a {shape} {variant} {mesh} status ok",
              rec["status"] == "ok", rec.get("error", ""))
        if rec["status"] != "ok":
            continue
        mem, r = rec["memory_analysis"], rec["roofline"]
        print(f"9a {ARCH} {shape} {variant} mesh {mesh} "
              f"({rec['num_devices']} devices), per device: arguments "
              f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB, outputs "
              f"{mem['output_size_in_bytes'] / 1e9:.3f} GB, peak allocated "
              f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB; FLOPs "
              f"{rec['flops']:.6e}, bytes {rec['bytes_accessed']:.6e}, "
              f"collective bytes {rec['collective_bytes']:.6e} "
              f"({rec['collective_ops']} collectives); terms compute "
              f"{r['compute_s']:.6g} s, memory {r['memory_s']:.6g} s, "
              f"collective {r['collective_s']:.6g} s, bound "
              f"{r['step_time_bound_s']:.6g} s ({r['bottleneck']}), useful "
              f"{r['useful_flops_ratio']:.4f}, perf fraction "
              f"{r['perf_fraction']:.6f}; floor (bytes it must move "
              f"{rec['moved_bytes']:.6e}, useful FLOPs) "
              f"{rec['floor']['step_time_floor_s']:.6g} s "
              f"({rec['floor']['floor_bound_by']}); counted rank "
              f"{rec['counted_rank']} of {rec['num_devices']} (bounds "
              + ", ".join(f"rank {k} {v['bound_s']:.6g} s, {v['flops']:.6e}"
                          f" FLOPs" for k, v in rec["per_rank"].items())
              + f"); dry run {rec['run_s']} s")
        print(f"9a {shape} {variant} {mesh}: collective bytes by kind "
              f"{rec['collective_bytes_by_kind']}; at the peak "
              f"{mem['peak_by_op']}")
        if mesh == "pod" and shape == "train_4k":
            want = closed_form_flops(cfg, "train", SHAPES[shape].global_batch,
                                     SHAPES[shape].seq_len) / 256
            rel = abs(rec["flops"] - want) / want
            check(f"9a train_4k pod: FLOPs per device within "
                  f"{ONE_DEVICE_FLOPS_RTOL:.0%} of the closed form / 256",
                  rel <= ONE_DEVICE_FLOPS_RTOL,
                  f"{rec['flops']:.6e} vs {want:.6e} (rel {rel:.3g})")
            check("9a train_4k pod: peak allocated per device below 80 GB",
                  mem["temp_size_in_bytes"] < CARD_HBM_BYTES,
                  f"{mem['temp_size_in_bytes'] / 1e9:.3f} GB")
        if mesh == "pod" and variant == "opt" and shape == "decode_32k":
            check(f"9a decode_32k opt pod: collective bytes per device "
                  f"below {DECODE_OPT_COLLECTIVE_MAX:.1e} (weights kept "
                  f"sharded)", rec["collective_bytes"]
                  < DECODE_OPT_COLLECTIVE_MAX,
                  f"{rec['collective_bytes']:.6e} B; bound by "
                  f"{r['bottleneck']}")
        if mesh == "pod" and variant == "opt" and shape == "prefill_32k":
            check("9a prefill_32k opt pod: O2's last 'model' rank does "
                  "more work than the first, and is the rank counted",
                  rec["counted_rank"] == rec["num_devices"] - 1
                  and rec["per_rank"]["0"]["flops"] < rec["flops"],
                  json.dumps(rec["per_rank"]))
        if mesh == "pod":
            check(f"9a {shape} {variant} pod: per-device arguments below "
                  f"80 GB", mem["argument_size_in_bytes"] < CARD_HBM_BYTES,
                  f"{mem['argument_size_in_bytes'] / 1e9:.3f} GB")
        else:
            sh = SHAPES[shape]
            want = closed_form_flops(cfg, sh.kind, sh.global_batch,
                                     sh.seq_len)
            rel = abs(rec["flops"] - want) / want
            check(f"9a {shape} one device: FLOPs within "
                  f"{ONE_DEVICE_FLOPS_RTOL:.0%} of the closed form",
                  rel <= ONE_DEVICE_FLOPS_RTOL,
                  f"{rec['flops']:.6e} vs {want:.6e} (rel {rel:.3g})")


def step_args(cfg, shape: str, specs, params, seq: int):
    """Real arguments for a step built by `make_step` (its meta specs):
    random inputs from seed 1, a zero cache, AdamW state for training."""
    from repro_torch.configs import SHAPES
    from repro_torch.launch import dryrun
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    g = torch.Generator().manual_seed(1)
    kind = SHAPES[shape].kind
    if kind == "decode":
        r = dryrun.realize({"cache": specs[1], "token": specs[2],
                            "pos": specs[3]}, cfg, g, "cuda", seq)
        return [params, r["cache"], r["token"], r["pos"]]
    if kind == "prefill":
        return [params, dryrun.realize(specs[1], cfg, g, "cuda", seq)]
    return [params, adamw_init(params, AdamWConfig()),
            dryrun.realize(specs[2], cfg, g, "cuda", seq)]


def run_step(step, placed, kind: str):
    """One step, synchronised; the placed args for the next (a train step
    continues from its outputs) and the step's output."""
    out = step(*placed)
    if kind == "train":
        out[2]["loss"].item()
        placed = [out[0], out[1], placed[2]]
    torch.cuda.synchronize()
    return placed, out


def measure_cell(mesh, shape: str, variant: str, B: int, L: int, smi: str):
    """9b: one cell on the card: the port's counts and terms (n_dev 1), the
    median of MEASURED_STEPS synchronised steps after a warm-up, its share
    of the bound, a profiled step's busy share, finite outputs."""
    import dataclasses
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_step
    from repro_torch.models import build_model
    from repro_torch.roofline import CostMode, floor_terms, roofline_terms
    t_cell = time.perf_counter()
    sh = SHAPES[shape]
    cfg = dryrun.apply_variant(
        dataclasses.replace(get_config(ARCH), num_layers=L), shape, variant)
    step, specs, in_sh, _ = make_step(cfg, shape, mesh, batch_override=B)
    params = build_model(cfg, "cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    placed = [distribute(a, s) for a, s in
              zip(step_args(cfg, shape, specs, params, sh.seq_len), in_sh)]
    del params
    torch.cuda.reset_peak_memory_stats()
    placed, out = run_step(step, placed, sh.kind)  # warm-up
    times = []
    for _ in range(MEASURED_STEPS):
        del out
        t0 = time.perf_counter()
        placed, out = run_step(step, placed, sh.kind)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    peak = torch.cuda.max_memory_allocated() / 1e9
    val = out[2]["loss"] if sh.kind == "train" else out[0].full_tensor()
    ok = bool(torch.isfinite(val).all())
    check(f"9b {shape} {variant}: finite {'loss' if sh.kind == 'train' else 'logits'}",
          ok, f"shape {tuple(val.shape)}")
    del out, val
    held = dryrun.local_storages(placed)
    mode = CostMode()
    with mode:
        placed, out = run_step(step, placed, sh.kind)
    moved = dryrun.moved_bytes(held, dryrun.local_storages(out))
    del out, held
    cut = dataclasses.replace(sh, global_batch=B)
    terms = roofline_terms(cfg, cut, mode.flops, mode.bytes_accessed,
                           mode.collective_bytes(), 1)
    floor = floor_terms(cfg, cut, moved, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        placed, out = run_step(step, placed, sh.kind)
    wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    del out, placed
    print(f"9b {ARCH} {shape} {variant} on the card ({smi}): B={B} of "
          f"{sh.global_batch}, {sh.seq_len} tokens, {L} of 32 layers; "
          f"median step {med:.6f} s over {MEASURED_STEPS} (steps "
          + " ".join(f"{t:.4f}" for t in times) + f"); peak "
          f"{peak:.1f} GB; counted FLOPs {mode.flops:.6e}, bytes "
          f"{mode.bytes_accessed:.6e}, collective bytes "
          f"{mode.collective_bytes():.6e}; terms (n_dev 1) compute "
          f"{terms['compute_s']:.6g} s, memory {terms['memory_s']:.6g} s, "
          f"collective {terms['collective_s']:.6g} s, bound "
          f"{terms['step_time_bound_s']:.6g} s ({terms['bottleneck']}); "
          f"measured / bound {med / terms['step_time_bound_s']:.3f}; "
          f"floor: bytes it must move {moved:.6e}, "
          f"{floor['step_time_floor_s']:.6g} s "
          f"({floor['floor_bound_by']}), measured / floor "
          f"{med / floor['step_time_floor_s']:.3f}; "
          f"model FLOPs {terms['model_flops_global']:.6e} = "
          f"{terms['model_flops_global'] / med / BF16_TENSOR_OPS_PER_S * 100:.3f}"
          f"% of 989 TFLOP/s; profiled step: {busy:.1f} ms of kernels in "
          f"{wall * 1e3:.1f} ms = {busy / (wall * 1e3) * 100:.1f}% busy; top "
          f"kernels: " + "; ".join(
              f"{kernel_name(e.key)} {e.self_device_time_total / 1e3:.1f} ms"
              f" x{e.count}" for e in top))
    check(f"9b {shape} {variant}: measured step above its bound",
          med >= terms["step_time_bound_s"],
          f"{med:.4f} s vs {terms['step_time_bound_s']:.4f} s")
    check(f"9b {shape} {variant}: measured step above its floor",
          med >= floor["step_time_floor_s"],
          f"{med:.4f} s vs {floor['step_time_floor_s']:.4f} s")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"9b {shape} wall {time.perf_counter() - t_cell:.1f} s")


def blocked_vs_naive(mesh):
    """9b: the opt variant's blocked prefill and blocked decode against the
    naive path at BLOCKED_CHECK_TOKENS, through the same sharded steps."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch import dryrun
    from repro_torch.launch.steps import make_step
    from repro_torch.models import build_model
    T = BLOCKED_CHECK_TOKENS
    base = get_config(ARCH)
    params = build_model(base, "cuda").init_params(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.randint(0, base.vocab_size, (1, T),
                           generator=torch.Generator().manual_seed(2))
    res = {}
    for variant in ("base", "opt"):
        cfg = dryrun.apply_variant(base, "prefill_32k", variant)
        step, _, (psh, bsh), _ = make_step(cfg, "prefill_32k", mesh,
                                           batch_override=1, seq_override=T)
        p = distribute(params, psh)
        lg, cache = step(p, distribute({"tokens": tokens.to(torch.int32)
                                        .cuda()}, bsh))
        cache = cache.full_tensor()
        # decode the last token again at position T - 1 over a cache of T
        dcfg = dryrun.apply_variant(base, "decode_32k", variant)
        dstep, _, (_, csh, tsh, qsh), _ = make_step(
            dcfg, "decode_32k", mesh, batch_override=1, seq_override=T)
        d, _ = dstep(p, distribute(cache, csh),
                     distribute(tokens[:, -1:].to(torch.int32).cuda(), tsh),
                     distribute(torch.full((1,), T - 1, dtype=torch.int32,
                                           device="cuda"), qsh))
        res[variant] = (lg.full_tensor().float().cpu().numpy(),
                        d.full_tensor().float().cpu().numpy())
        del lg, cache, d, p
    for i, what in enumerate(("prefill", "decode")):
        naive, blocked = res["base"][i], res["opt"][i]
        step_ = logit_step(naive)
        diff = float(np.abs(naive - blocked).max())
        check(f"9b blocked == naive {what} at {T} tokens (within "
              f"{BLOCKED_VS_NAIVE_ULPS} bf16 steps of the largest logit)",
              diff <= BLOCKED_VS_NAIVE_ULPS * step_,
              f"max diff {diff:.4g} = {diff / step_:.2f} steps; top tokens "
              f"{int(naive.argmax())} / {int(blocked.argmax())}")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def phase_roofline():
    """Phase 9: the dry run (9a) and three cells measured on the card
    against the port's roofline terms (9b)."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh
    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    phase_dryrun(smi)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        for shape, variant, B, L in MEASURED_CELLS:
            measure_cell(mesh, shape, variant, B, L, smi)
        blocked_vs_naive(mesh)
    finally:
        dist.destroy_process_group()
    print(f"phase 9 wall {time.perf_counter() - t_phase:.1f} s")


def phase_examples():
    """Phase 10: the three model examples (`examples/torch_*.py`) as users
    run them, each a subprocess on the card."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    for name, want in EXAMPLES.items():
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                            "--device", "cuda"], cwd=ROOT, env=env,
                           capture_output=True, text=True,
                           timeout=EXAMPLE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lines = r.stdout.strip().splitlines()
        print(f"10 {name} --device cuda: exit {r.returncode} in {wall:.1f} "
              f"s; " + " | ".join(ln for ln in lines if ln.startswith(
                  ("OK:", "max |dlogit|", "device=", "steps="))))
        check(f"10 {name} exits 0 with its OK lines",
              r.returncode == 0 and all(
                  any(ln.startswith(w) for ln in lines) for w in want),
              r.stderr[-2000:] if r.returncode else "")
    print(f"phase 10 wall {time.perf_counter() - t_phase:.1f} s")


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
    records = phase_kernels() + phase_encode_kernel() \
        + phase_attention_kernels() + phase_fp_kernels()
    served = build_served_model()
    ops_counts = phase_ops_on_model(served)
    fp_counts, packed_counts = phase_serving(served)
    async_fp_counts, async_packed_counts = phase_async(served)
    print(f"phase 5 launches: int8/fp serve() {async_fp_counts}; int8/packed "
          f"serve() {async_packed_counts}")
    # free llama3-1-8b: qwen3-moe alone holds about 61 GB of bf16 weights
    del served
    free_device(ARCH)
    moe_counts, moe_async_counts = phase_moe_serving()
    free_device(MOE_ARCH)
    print(f"phase 6 launches: layerwise warm requests {dict(moe_counts)}; "
          f"int8 async serve() {moe_async_counts}")
    for name in ("kv_dequant", "kv_dequant_packed4"):
        check(f"phase 6 MoE serving path launched {name}",
              moe_counts[name] > 0, f"{moe_counts[name]} launches")
    phase_llama4()
    free_device(LLAMA4_ARCH)
    phase_families()
    phase_training()
    phase_roofline()
    phase_examples()
    for rec in records:
        path = {"kv_dequant": fp_counts, "kv_dequant_packed4": fp_counts,
                "kv_quant_encode": fp_counts,
                "decode_attention_quant": packed_counts,
                "flash_attention_quant": packed_counts}.get(rec["name"],
                                                            ops_counts)
        rec["launches"] = path[rec["name"]]
        if rec["name"] in moe_counts:
            rec["moe_launches"] = moe_counts[rec["name"]]
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
