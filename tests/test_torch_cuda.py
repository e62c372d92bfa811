"""The port's CUDA kernels on the card against their plain PyTorch
versions: K1/K2 and K8 bit for bit, K4-K7 within the tolerances of
`_assert_out_close` and `_assert_close`.
Imports no JAX, so it runs on a machine with a GPU and without the
reference's dependencies:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without a CUDA device every case skips."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.kernels import kv_dequant as K  # noqa: E402
from repro_torch.kernels import launches  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_quant, decode_attention_quant_ref,
    decode_attention_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_quant, flash_attention_quant_ref,
    flash_attention_ref)
from repro_torch.kernels.kv_gather import kv_gather, kv_gather_ref  # noqa

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")


def _inputs(seed, N, R, W, group, packed):
    rng = np.random.default_rng(seed)
    if packed:
        q = rng.integers(0, 256, size=(N, R, W // 2), dtype=np.uint8)
    else:
        q = rng.integers(-128, 128, size=(N, R, W), dtype=np.int8)
    s = rng.standard_normal((N, W // group)).astype(np.float16)
    return torch.from_numpy(q).cuda(), torch.from_numpy(s).cuda()


# K1/K2 widths W = KV * dh: the configs' (smollm 192, gemma-2b 256,
# qwen3-moe-30b-a3b 512, llama3-1-8b / qwen3 / internvl2 / llama4 1024,
# whisper 1280, zamba2 2048) at 4 chunks of 256 tokens and ragged ones at
# odd counts, each with every group of GROUPS that divides it; and the
# serving shapes of llama3-1-8b (W 1024) and qwen3-moe (W 512)
CONFIG_WIDTHS = (192, 256, 512, 1024, 1280, 2048)
RAGGED_WIDTHS = (20, 24, 40, 1030)
GROUPS = (1, 2, 3, 8, 64, 128)
DEQUANT_CASES = [
    ((15, 256, 1024), 1), ((15, 256, 1024), 128), ((15, 256, 512), 1),
    ((15, 256, 512), 128), ((3, 5, 24), 8),
    ((1, 3, 1030), 2), ((2, 3, 20), 4)]
DEQUANT_CASES += [((4, 256, W), g) for W in CONFIG_WIDTHS for g in GROUPS
                  if W % g == 0]
DEQUANT_CASES += [((3, 5, W), g) for W in RAGGED_WIDTHS for g in GROUPS
                  if W % g == 0]


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape,group", DEQUANT_CASES)
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_bit_equal(packed, shape, group, out):
    q, s = _inputs(7, *shape, group, packed)
    kern = K.kv_dequant_packed4 if packed else K.kv_dequant
    plain = K.kv_dequant_packed4_ref if packed else K.kv_dequant_ref
    before = launches.LAUNCHES[kern.__name__]
    got = kern(q, s, group=group, out_dtype=out)
    torch.cuda.synchronize()
    assert launches.LAUNCHES[kern.__name__] == before + 1
    assert torch.equal(got, plain(q, s, group=group, out_dtype=out))


@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("which", ["q", "scales"])
@pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
def test_bit_equal_misaligned(packed, which, out):
    """A view at a storage offset of one element starts on no 16-byte
    boundary: every strip takes the per-element path, bit-equal still."""
    N, R, W = 4, 256, 1024
    q, s = _inputs(11, N, R, W, 1, packed)
    if which == "q":
        q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
    else:
        s = torch.cat([s.new_zeros(1), s.flatten()])[1:].view(s.shape)
    assert not K.dequant_plan(N, R, W, q.data_ptr(), s.data_ptr(),
                              0).vec
    kern = K.kv_dequant_packed4 if packed else K.kv_dequant
    plain = K.kv_dequant_packed4_ref if packed else K.kv_dequant_ref
    got = kern(q, s, group=1, out_dtype=out)
    torch.cuda.synchronize()
    assert torch.equal(got, plain(q, s, group=1, out_dtype=out))


def test_kernel_rejects_non_contiguous():
    q, _ = _inputs(8, 2, 4, 64, 1, False)
    q_t = q.transpose(1, 2)  # [2, 64, 4], not contiguous
    s = torch.ones((2, 4), dtype=torch.float16, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        K.kv_dequant(q_t, s)


# -- K6 / K7: fused dequant-attention ---------------------------------------

def _packed(rng, B, S, KV, dh, G, bits, group):
    """A packed cache with scales of the codecs' magnitude (values O(1))."""
    if bits == 4:
        q = rng.integers(0, 256, size=(B, S, KV, dh // 2), dtype=np.uint8)
    else:
        q = rng.integers(-127, 128, size=(B, S, KV, dh), dtype=np.int8)
    qmax = 127 if bits == 8 else 7
    s = ((0.5 + rng.random((B, S // G, KV * dh // group))) / qmax)
    return torch.from_numpy(q).cuda(), torch.from_numpy(
        s.astype(np.float16)).cuda()


def _assert_out_close(o, ow):
    """fp32 out within 1e-5 (the sums run in another order); bf16 out
    within one bf16 rounding step of the plain version beyond that (both
    round their fp32 result once, and near zero the two fp32 results may
    differ by more than a step)."""
    assert o.dtype == ow.dtype and o.shape == ow.shape
    fp32 = o.dtype == torch.float32
    o, ow = o.float(), ow.float()
    if fp32:
        tol = torch.full_like(ow, 1e-5)
    else:
        big = torch.maximum(o.abs(), ow.abs()).clamp_min(2.0 ** -126)
        tol = torch.exp2(torch.floor(torch.log2(big)) - 7) + 1e-5
    assert bool(((o - ow).abs() <= tol).all()), float((o - ow).abs().max())


def _assert_close(got, want):
    """out as `_assert_out_close`; m within 1e-5 (relative above 1), l
    within 1e-5 relative, -inf and 0 exactly where the plain version has
    them."""
    (o, m, l), (ow, mw, lw) = got, want
    _assert_out_close(o, ow)
    assert torch.equal(torch.isinf(m), torch.isinf(mw))
    fin = torch.isfinite(mw)
    assert bool(((m[fin] - mw[fin]).abs()
                 <= 1e-5 * mw[fin].abs().clamp_min(1.0)).all())
    assert bool(((l - lw).abs() <= 1e-5 * lw.abs()).all())


Q_DTYPES = [torch.float32, torch.bfloat16]
PACKINGS = [(8, 1), (8, 128), (4, 1), (4, 128)]


@pytest.mark.parametrize("dtype", Q_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group", PACKINGS)
@pytest.mark.parametrize("B,S,H,KV,dh,G,lengths", [
    (1, 3840, 32, 8, 128, 256, [3840]),       # the serving path's shape
    (2, 200, 8, 2, 64, 8, [200, 77]),         # S not a multiple of a split
    (3, 96, 8, 1, 256, 16, [0, 1, 95]),       # MQA, dh 256, an empty row
    (1, 64, 4, 4, 64, 16, [64]),              # MHA
    (1, 32768, 32, 8, 128, 256, [32768]),     # a long cache: long splits
    (4, 8192, 32, 8, 128, 256, [1, 129, 4097, 8192]),  # rows of every length
])
def test_decode_attention_quant(B, S, H, KV, dh, G, lengths, bits, group,
                                dtype):
    rng = np.random.default_rng(B * 1000 + S + bits + group)
    kq, ks = _packed(rng, B, S, KV, dh, G, bits, group)
    vq, vs = _packed(rng, B, S, KV, dh, G, bits, group)
    q = torch.from_numpy(rng.standard_normal((B, H, dh)).astype(
        np.float32)).cuda().to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    args = dict(bits=bits, group=group, chunk_tokens=G)
    before = launches.LAUNCHES["decode_attention_quant"]
    got = decode_attention_quant(q, kq, vq, ks, vs, ln, **args)
    torch.cuda.synchronize()
    assert launches.LAUNCHES["decode_attention_quant"] == before + 1
    _assert_close(got, decode_attention_quant_ref(q, kq, vq, ks, vs, ln,
                                                  **args))
    if 0 in lengths:
        b = lengths.index(0)
        assert bool((got[0][b] == 0).all()) and bool((got[2][b] == 0).all())
        assert bool(torch.isinf(got[1][b]).all())


@pytest.mark.parametrize("dtype", Q_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("bits,group", PACKINGS)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,dh,G,causal,q_offset", [
    (1, 256, 3840, 32, 8, 128, 256, False, 0),  # the serving path's shape
    (2, 37, 96, 8, 2, 64, 16, True, 50),        # Sq not a multiple of a block
    (1, 20, 64, 8, 1, 256, 32, True, 0),        # MQA, dh 256, top-left
    (1, 9, 32, 4, 4, 64, 16, False, 0),         # MHA
    # few rows over a long prefix: each row block's keys split over CTAs
    (1, 64, 3840, 32, 8, 128, 256, True, 3776),  # 7 splits, causal tail
    (1, 128, 3840, 32, 8, 128, 256, True, 0),    # splits with no tile
])
def test_flash_attention_quant(B, Sq, Sk, H, KV, dh, G, causal, q_offset,
                               bits, group, dtype):
    rng = np.random.default_rng(B * 1000 + Sq + Sk + bits + group)
    kq, ks = _packed(rng, B, Sk, KV, dh, G, bits, group)
    vq, vs = _packed(rng, B, Sk, KV, dh, G, bits, group)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, dh)).astype(
        np.float32)).cuda().to(dtype)
    args = dict(bits=bits, group=group, chunk_tokens=G, causal=causal,
                q_offset=q_offset)
    before = launches.LAUNCHES["flash_attention_quant"]
    got = flash_attention_quant(q, kq, vq, ks, vs, **args)
    torch.cuda.synchronize()
    assert launches.LAUNCHES["flash_attention_quant"] == before + 1
    _assert_close(got, flash_attention_quant_ref(q, kq, vq, ks, vs, **args))


# (H, KV, dh) of the query-head groups the other configs use, beside
# llama's 4: 2 (qwen3-0.6b 16/8), 3 (smollm-135m 9/3, dh 64), 5 (llama4 and
# qwen3-14b 40/8), 6 (internvl2 48/8), and 1 (MHA)
GQA_CASES = [(16, 8, 128), (9, 3, 64), (40, 8, 128), (48, 8, 128),
             (8, 8, 128)]


@pytest.mark.parametrize("dtype", Q_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("H,KV,dh", GQA_CASES)
def test_decode_attention_quant_gqa(H, KV, dh, bits, dtype):
    rng = np.random.default_rng(H * 100 + KV + dh + bits)
    B, S, G, lengths = 2, 2048, 256, [2048, 777]
    kq, ks = _packed(rng, B, S, KV, dh, G, bits, 1)
    vq, vs = _packed(rng, B, S, KV, dh, G, bits, 1)
    q = torch.from_numpy(rng.standard_normal((B, H, dh)).astype(
        np.float32)).cuda().to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    args = dict(bits=bits, group=1, chunk_tokens=G)
    got = decode_attention_quant(q, kq, vq, ks, vs, ln, **args)
    torch.cuda.synchronize()
    _assert_close(got, decode_attention_quant_ref(q, kq, vq, ks, vs, ln,
                                                  **args))


@pytest.mark.parametrize("dtype", Q_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
@pytest.mark.parametrize("H,KV,dh", GQA_CASES)
def test_flash_attention_quant_gqa(H, KV, dh, bits, dtype):
    """Causal with q_offset 2000 over 2048 keys; Sq = 37, so Sq x H/KV is
    a multiple of no row block and the blocks of groups 3, 5 and 6 cut a
    position's heads."""
    rng = np.random.default_rng(H * 100 + KV + dh + bits + 1)
    B, Sq, Sk, G = 1, 37, 2048, 256
    kq, ks = _packed(rng, B, Sk, KV, dh, G, bits, 1)
    vq, vs = _packed(rng, B, Sk, KV, dh, G, bits, 1)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, dh)).astype(
        np.float32)).cuda().to(dtype)
    args = dict(bits=bits, group=1, chunk_tokens=G, causal=True,
                q_offset=2000)
    got = flash_attention_quant(q, kq, vq, ks, vs, **args)
    torch.cuda.synchronize()
    _assert_close(got, flash_attention_quant_ref(q, kq, vq, ks, vs, **args))


def _gw_packed(rng, B, S, KV, dh, G, bits, group):
    """A cache quantized as the group-wise codecs do it: one scale per chunk
    of G tokens and group of channels, the absmax over both / qmax, codes
    round(x / scale) (they reach +-qmax)."""
    qmax = 127 if bits == 8 else 7
    x = rng.standard_normal((B, S // G, G, KV * dh // group, group))
    s = (np.abs(x).max(axis=(2, 4)) / qmax).astype(np.float16)
    sf = s.astype(np.float32)[:, :, None, :, None]
    codes = np.clip(np.rint(x / sf), -qmax - (bits == 4), qmax).astype(
        np.int32).reshape(B, S, KV, dh)
    if bits == 8:
        q = codes.astype(np.int8)
    else:
        biased = (codes + 8).astype(np.uint8)
        q = biased[..., 0::2] | (biased[..., 1::2] << 4)
    return (torch.from_numpy(np.ascontiguousarray(q)).cuda(),
            torch.from_numpy(s.reshape(B, S // G, KV * dh // group)).cuda())


@pytest.mark.parametrize("dtype", Q_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("bits", [8, 4], ids=["gw8", "gw4"])
def test_flash_attention_quant_gw(bits, dtype):
    """The serving shape with the gw codecs' group of 128 channels and
    their scales (absmax of a chunk's group): codes up to +-qmax."""
    rng = np.random.default_rng(128 + bits)
    B, Sq, Sk, H, KV, dh, G = 1, 256, 3840, 32, 8, 128, 256
    kq, ks = _gw_packed(rng, B, Sk, KV, dh, G, bits, 128)
    vq, vs = _gw_packed(rng, B, Sk, KV, dh, G, bits, 128)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, dh)).astype(
        np.float32)).cuda().to(dtype)
    args = dict(bits=bits, group=128, chunk_tokens=G, causal=False)
    got = flash_attention_quant(q, kq, vq, ks, vs, **args)
    torch.cuda.synchronize()
    _assert_close(got, flash_attention_quant_ref(q, kq, vq, ks, vs, **args))


def _flash_quant_f64(q, k, v):
    """K7's function, full mask, in float64 over a dequantized cache:
    q [B, Sq, H, dh], k/v [B, Sk, KV, dh] -> (out, m, l)."""
    import math
    B, Sq, H, dh = q.shape
    KV = k.shape[2]
    s = torch.einsum("bqkgd,bskd->bqkgs",
                     q.double().reshape(B, Sq, KV, H // KV, dh),
                     k.double()) / math.sqrt(dh)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    out = torch.einsum("bqkgs,bskd->bqkgd", p, v.double()) / l[..., None]
    return (out.reshape(B, Sq, H, dh), m.reshape(B, Sq, H),
            l.reshape(B, Sq, H))


@pytest.mark.parametrize("bits", [8, 4], ids=["int8", "int4"])
def test_flash_attention_quant_large_logits(bits):
    """bf16 q scaled by 16 at the serving shape: logits of tens of units,
    so the running max moves and the rescale carries the result.  Held to
    the same function in float64 over the dequantized cache, as K4's case
    is: at such logits the plain version's own fp32 rounding moves small
    outputs by more than one bf16 step.  l's relative error follows the
    logits' absolute error, which the m bound lets grow with |m| (1e-5
    relative above 1): l is held within twice that, per row."""
    from repro_torch.kernels.kv_dequant import dequant_cache_ref
    rng = np.random.default_rng(16 + bits)
    B, Sq, Sk, H, KV, dh, G = 1, 256, 3840, 32, 8, 128, 256
    kq, ks = _packed(rng, B, Sk, KV, dh, G, bits, 1)
    vq, vs = _packed(rng, B, Sk, KV, dh, G, bits, 1)
    q = torch.from_numpy(rng.standard_normal((B, Sq, H, dh)).astype(
        np.float32)).cuda().mul(16).bfloat16()
    args = dict(bits=bits, group=1, chunk_tokens=G)
    got = flash_attention_quant(q, kq, vq, ks, vs, causal=False, **args)
    torch.cuda.synchronize()
    out, m, l = _flash_quant_f64(q, dequant_cache_ref(kq, ks, **args),
                                 dequant_cache_ref(vq, vs, **args))
    _assert_out_close(got[0], out.bfloat16())
    bound = 1e-5 * m.float().abs().clamp_min(1.0)
    assert bool(((got[1] - m.float()).abs() <= bound).all())
    assert bool(((got[2] - l.float()).abs() <= 2 * bound * l.float()).all())


def test_flash_attention_quant_bf16_runs_on_the_tensor_cores():
    """K7's bf16 path is the wgmma loop: HGMMA in its library's SASS."""
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    build.load("flash_attention_quant")
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass",
         str(build.library_path("flash_attention_quant"))],
        capture_output=True, text=True, check=True).stdout
    assert sass.count("HGMMA") > 0


def test_attention_kernels_refuse_unbuilt_head_dim():
    rng = np.random.default_rng(9)
    kq, ks = _packed(rng, 1, 16, 2, 16, 8, 8, 1)
    q = torch.zeros((1, 4, 16), device="cuda")
    ln = torch.tensor([16], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention_quant(q, kq, kq, ks, ks, ln, bits=8, group=1,
                               chunk_tokens=8)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_quant(q[:, None], kq, kq, ks, ks, bits=8, group=1,
                              chunk_tokens=8)


# -- K4 / K5: attention over fp32 or bf16 K/V --------------------------------

def _normal(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(dtype)


@pytest.mark.parametrize("dtype", Q_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,dh,causal", [
    (1, 32, 8, 4096, 4096, 128, True),  # llama3-1-8b's cold prefill
    (1, 32, 8, 256, 4096, 128, True),   # Sq < Sk: top-left != bottom-right
    (1, 32, 8, 4096, 256, 128, True),   # Sq > Sk: late rows see every key
    (2, 6, 2, 100, 77, 64, False),      # ragged, not multiples of 64
    (2, 6, 2, 100, 77, 64, True),
    (1, 12, 4, 33, 65, 128, True),      # a group of 3
    (1, 8, 1, 130, 130, 256, True),     # MQA at dh 256
    (1, 4, 4, 70, 50, 64, True),        # MHA at dh 64
    (1, 16, 1, 20, 40, 64, False),      # the largest group, 16
    (2, 32, 8, 1000, 777, 128, True),   # ragged causal at llama's heads
    (1, 32, 8, 512, 512, 64, True),     # causal at dh 64
    (1, 32, 8, 128, 4096, 128, False),  # full, few rows over many keys
])
def test_flash_attention(B, H, KV, Sq, Sk, dh, causal, dtype):
    rng = np.random.default_rng(B * 100 + H + Sq + Sk + dh)
    q = _normal(rng, (B, H, Sq, dh), dtype)
    k = _normal(rng, (B, KV, Sk, dh), dtype)
    v = _normal(rng, (B, KV, Sk, dh), dtype)
    before = launches.LAUNCHES["flash_attention"]
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert launches.LAUNCHES["flash_attention"] == before + 1
    _assert_out_close(got, flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", Q_DTYPES, ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,KV,dh,lengths", [
    (1, 4104, 32, 8, 128, [4097]),   # llama3-1-8b's decode after 4096
    (8, 1000, 32, 8, 128, [0, 1, 63, 64, 65, 500, 999, 1000]),
    (2, 200, 6, 2, 64, [200, 77]),   # S not a multiple of a split, group 3
    (3, 96, 8, 1, 256, [0, 1, 95]),  # MQA, dh 256, an empty row
    (1, 64, 4, 4, 64, [100]),        # a length above S reads S rows
    (1, 32768, 32, 8, 128, [32768]),  # a long cache: splits of ~1000
    (4, 8192, 32, 8, 128, [1, 129, 4097, 8192]),  # rows of every length
])
def test_decode_attention(B, S, H, KV, dh, lengths, dtype):
    rng = np.random.default_rng(B * 100 + S + H + dh)
    q = _normal(rng, (B, H, dh), dtype)
    kc = _normal(rng, (B, S, KV, dh), dtype)
    vc = _normal(rng, (B, S, KV, dh), dtype)
    for b, n in enumerate(lengths):  # stale rows past a length: NaN
        kc[b, n:] = float("nan")
        vc[b, n:] = float("nan")
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    before = launches.LAUNCHES["decode_attention"]
    got = decode_attention(q, kc, vc, ln)
    torch.cuda.synchronize()
    assert launches.LAUNCHES["decode_attention"] == before + 1
    assert bool(torch.isfinite(got).all())
    _assert_out_close(got, decode_attention_ref(q, kc, vc, ln))
    for b, n in enumerate(lengths):
        if n == 0:
            assert bool((got[b] == 0).all())


def test_flash_attention_online_rescale():
    """q scaled by 16 at the cold prefill's shape: logits of tens of units,
    so the running max moves tile after tile and the rescale of the
    accumulator carries the result.  At such logits the plain version's
    own fp32 rounding moves small outputs by more than one bf16 step, so
    the kernel is held to the same formula in float64."""
    import math
    rng = np.random.default_rng(16)
    q = _normal(rng, (1, 32, 4096, 128), torch.float32).mul(16).bfloat16()
    k = _normal(rng, (1, 8, 4096, 128), torch.bfloat16)
    v = _normal(rng, (1, 8, 4096, 128), torch.bfloat16)
    got = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     q.double().reshape(1, 8, 4, 4096, 128),
                     k.double()) / math.sqrt(128)
    rows = torch.arange(4096, device="cuda")
    s = torch.where(rows[:, None] >= rows[None], s, float("-inf"))
    exact = torch.einsum("bkgqs,bksd->bkgqd", torch.softmax(s, dim=-1),
                         v.double()).reshape(1, 32, 4096, 128)
    _assert_out_close(got, exact.bfloat16())


def test_flash_bf16_runs_on_the_tensor_cores():
    """The bf16 path of K4's library is built of wgmma (HGMMA in SASS)."""
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    build.load("flash_attention")
    cuobjdump = Path(build.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(build.library_path("flash_attention"))],
        capture_output=True, text=True, check=True).stdout
    assert sass.count("HGMMA") > 0


def test_fp_attention_kernels_refuse_unbuilt_head_dim():
    q = torch.zeros((1, 4, 16), device="cuda")
    kc = torch.zeros((1, 8, 2, 16), device="cuda")
    ln = torch.tensor([8], dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(q, kc, kc, ln)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q[:, :, None], kc.transpose(1, 2).contiguous(),
                        kc.transpose(1, 2).contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        decode_attention(torch.zeros((1, 128, 4), device="cuda").mT,
                         torch.zeros((1, 8, 2, 128), device="cuda"),
                         torch.zeros((1, 8, 2, 128), device="cuda"), ln)


# -- K8: chunk-tile gather ---------------------------------------------------

@pytest.mark.parametrize("P,G,W,dtype,idx", [
    (256, 256, 2048, torch.bfloat16, list(range(15))),  # the warm prefix
    (256, 256, 2048, torch.bfloat16, [3, 3, 0, 255] * 16),  # 64, repeats
    (64, 16, 128, torch.int8, [5, 63, 5, 0]),
    (16, 8, 32, torch.float32, [15, 2, 2]),
    (10, 3, 5, torch.int8, [9, 0, 4, 4]),       # 15-byte tiles: byte words
    (10, 3, 3, torch.bfloat16, [1, 8, 1]),      # 18-byte tiles: 2-byte words
    (12, 4, 6, torch.float32, [11, 0]),         # 96-byte tiles, 16-byte words
])
@pytest.mark.parametrize("index_dtype", [torch.int32, torch.int64],
                         ids=["int32", "int64"])
def test_kv_gather(P, G, W, dtype, idx, index_dtype):
    g = torch.Generator(device="cuda").manual_seed(P + G + W)
    pool = torch.randint(-128, 128, (P, G, W), generator=g, device="cuda",
                         dtype=torch.int8) if dtype == torch.int8 else \
        torch.randn((P, G, W), generator=g, device="cuda").to(dtype)
    ind = torch.tensor(idx, dtype=index_dtype, device="cuda")
    before = launches.LAUNCHES["kv_gather"]
    got = kv_gather(pool, ind)
    torch.cuda.synchronize()
    assert launches.LAUNCHES["kv_gather"] == before + 1
    assert torch.equal(got, kv_gather_ref(pool, ind))
    assert torch.equal(got, pool[ind.long()])


def test_kv_gather_clamps_and_refuses():
    pool = torch.arange(4 * 2 * 8, device="cuda",
                        dtype=torch.float32).reshape(4, 2, 8)
    ind = torch.tensor([-3, 7], dtype=torch.int32, device="cuda")
    got = kv_gather(pool, ind)
    assert torch.equal(got, pool[[0, 3]])
    assert torch.equal(got, kv_gather_ref(pool, ind))
    with pytest.raises(ValueError, match="contiguous"):
        kv_gather(pool.transpose(1, 2), ind)
    assert kv_gather(pool, ind[:0]).shape == (0, 2, 8)


# -- the MoE serving path on the card ---------------------------------------

@pytest.mark.parametrize("codec", ["int8", "int4"])
def test_moe_layerwise_equals_chunkwise(codec):
    """qwen3-moe's smoke config in bf16 on the card, random weights: a warm
    hit served layerwise (K1/K2 twice a layer) and the same prompt served
    chunkwise on the same store give the same logits bit for bit (the same
    ops at the same shapes, and the expert combine has no atomics)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.core import Delivery, Gateway, InMemoryStore, RadixIndex
    from repro_torch.models import build_model
    from repro_torch.serving import Orchestrator, ServingEngine

    cfg = dataclasses.replace(get_smoke_config("qwen3-moe-30b-a3b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = build_model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    G = 16
    orch = Orchestrator(RadixIndex(G), Gateway(InMemoryStore()),
                        cfg.kv_spec(G, dtype_bytes=2, codec=codec),
                        theta_bytes=0)
    engine = ServingEngine(model, params, orch)
    rng = np.random.default_rng(3)
    cold = rng.integers(0, cfg.vocab_size, size=96)
    # 5 chunks: once committed, the same prompt matches 4 again (the last
    # token stays a suffix)
    warm = np.concatenate([cold[:64], rng.integers(0, cfg.vocab_size,
                                                   size=16)])
    engine.submit(cold, "cold")
    kern = "kv_dequant" if codec == "int8" else "kv_dequant_packed4"
    before = launches.LAUNCHES[kern]
    lw = engine.submit(warm, "lw", max_new_tokens=4)
    torch.cuda.synchronize()
    assert lw.delivery is Delivery.LAYERWISE and lw.matched_tokens == 64
    assert launches.LAUNCHES[kern] == before + 2 * cfg.num_layers
    orch.theta = 1 << 60
    cw = engine.submit(warm, "cw", max_new_tokens=4)
    assert cw.delivery is Delivery.CHUNKWISE and cw.matched_tokens == 64
    np.testing.assert_array_equal(lw.logits, cw.logits)
    assert lw.new_tokens == cw.new_tokens


# training: no kernel launches; the same step on the card and on the CPU
TRAIN_ARCHS = ["qwen3-0.6b", "smollm-135m", "gemma-2b", "qwen3-14b",
               "whisper-large-v3", "mamba2-2.7b", "qwen3-moe-30b-a3b",
               "llama4-maverick-400b-a17b", "zamba2-1.2b", "internvl2-26b",
               "llama3-1-8b"]


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_card_equals_cpu(arch):
    """One fp32 smoke train step (remat, AdamW with eps 1e-3 so that a
    gradient near eps cannot turn a last-bit difference into a step of 2
    lr): loss within 1e-5 relative, gradients and parameters within 1e-4
    of each leaf's largest value, and no kernel launch."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, SyntheticLM, adamw_init,
                                      make_train_step)
    from repro_torch.training.train_step import value_and_grad
    from repro_torch.training.tree import tree_leaves, tree_map

    cfg = get_smoke_config(arch)
    b = SyntheticLM(cfg.vocab_size, 16, 2, seed=0).batch_at(0)
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        b = {k: v[:, :8] for k, v in b.items()}
        b["embeds"] = rng.standard_normal((2, 12, cfg.d_model), np.float32)
    elif cfg.family == "vlm":
        b["embeds"] = rng.standard_normal((2, cfg.num_patches, cfg.d_model),
                                          np.float32)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=0, eps=1e-3)
    out = {}
    launches.reset()
    for device in ("cpu", "cuda"):
        model = build_model(cfg, device=device)
        p = model.init_params(torch.Generator().manual_seed(0)) \
            if device == "cpu" else tree_map(lambda t: t.cuda(), out["cpu"][0])
        batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
        _, g = value_and_grad(model, p, batch, remat=True)
        new, _, m = make_train_step(model, ocfg, remat=True)(
            p, adamw_init(p, ocfg), batch)
        out[device] = (p, g, new, m["loss"].item())
    assert not any(launches.snapshot().values())
    np.testing.assert_allclose(out["cuda"][3], out["cpu"][3], rtol=1e-5)
    for i in (1, 2):
        for a, c in zip(tree_leaves(out["cuda"][i]),
                        tree_leaves(out["cpu"][i])):
            scale = max(float(c.abs().max()), 1e-30)
            assert float((a.cpu() - c).abs().max()) <= 1e-4 * scale


def test_launch_train_on_the_card(tmp_path, capsys):
    from repro_torch.launch import train
    train.main(["--arch", "smollm-135m", "--smoke", "--steps", "5",
                "--ckpt-dir", str(tmp_path)])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("done: steps=5 ")
