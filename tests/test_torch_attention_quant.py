"""The port's fused dequant-attention ops (K6 `decode_attention_quant`, K7
`flash_attention_quant`) and the packed-cache dequant, against the
reference: the plain PyTorch versions on the reference's own Pallas kernels
run in interpret mode, on synthetic and on real wire bytes; the device
dispatch of ``kernels.ops``; the wrappers' argument checks; and the kernel
build's cache key.  The CUDA kernels run only on the card
(``tests/test_torch_cuda.py``).

Tolerances: fp32 ``out`` and ``m`` within 1e-5 absolute; ``l`` within 1e-5
relative, because it is a sum of up to Sk terms of size <= 1 and an absolute
1e-5 is below fp32's resolution at l ~ 100 (the reference sums it block by
block, the plain version in one reduction).  A bf16 ``out`` within one bf16
rounding step beyond the fp32 bound: both versions round their fp32 result
once.  The dequant is exact.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.codec import get_codec as ref_get_codec  # noqa: E402
from repro.core import KVSpec as RefKVSpec, layer_range  # noqa: E402
from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention_quant as ref_decode,
    quant_block_s as ref_quant_block_s)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention_quant as ref_flash)
from repro.serving import kv_chunks as ref_kv  # noqa: E402
from repro_torch.core import KVSpec  # noqa: E402
from repro_torch.kernels import build, launches, ops  # noqa: E402
from repro_torch.kernels import decode_attention as D  # noqa: E402
from repro_torch.kernels import flash_attention as F  # noqa: E402
from repro_torch.kernels.kv_dequant import dequant_cache_ref  # noqa: E402
from repro_torch.serving import kv_chunks  # noqa: E402

QMAX = {8: 127, 4: 7}


def _packed(rng, B, S, KV, dh, NC, bits, group):
    """A packed cache and scale rows in the wire layout, with scales of the
    codecs' magnitude (the reference tests' `_rand_packed`)."""
    if bits == 4:
        q = rng.integers(0, 256, size=(B, S, KV, dh // 2), dtype=np.uint8)
    else:
        q = rng.integers(-127, 128, size=(B, S, KV, dh), dtype=np.int8)
    s = ((0.5 + rng.random((B, NC, KV * dh // group))) / QMAX[bits])
    return q, s.astype(np.float16)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _check(got, want, name):
    """got: the port's (out, m, l) tensors; want: the reference's arrays."""
    (o, m, l), (ow, mw, lw) = [tuple(_np(a) for a in t) for t in (got, want)]
    assert got[0].dtype == (torch.bfloat16 if want[0].dtype == jnp.bfloat16
                            else torch.float32)
    assert o.shape == ow.shape and m.shape == mw.shape == l.shape
    if got[0].dtype == torch.float32:
        tol = 1e-5
    else:
        big = np.maximum(np.abs(o), np.abs(ow)).clip(2.0 ** -126)
        tol = np.exp2(np.floor(np.log2(big)) - 7) + 1e-5
    d_out = np.abs(o - ow)
    assert (d_out <= tol).all(), d_out.max()
    assert np.array_equal(np.isinf(m), np.isinf(mw))
    fin = np.isfinite(mw)
    d_m = np.abs(m[fin] - mw[fin])
    assert (d_m <= 1e-5).all(), d_m.max()
    d_l = np.abs(l - lw)
    assert (d_l <= 1e-5 * np.abs(lw)).all(), (d_l / np.abs(lw)).max()
    print(f"largest |diff| {name}: out {d_out.max():.3g}, m "
          f"{d_m.max(initial=0.0):.3g}, l (relative) "
          f"{(d_l / np.maximum(np.abs(lw), 1e-30)).max():.3g}")


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _qdt(dtype):
    return (torch.float32, jnp.float32) if dtype == "float32" else (
        torch.bfloat16, jnp.bfloat16)


# the reference's (bits, group) cases at fp32, and its int8 case with a bf16
# query (the output is rounded to q's dtype)
PACKINGS = [(8, 1, "float32"), (8, 32, "float32"), (4, 32, "float32"),
            (8, 1, "bfloat16")]


class TestPlainAgainstPallas:
    """The reference's own cases (`tests/test_quant_attention.py`), plus a
    bf16 query, through the reference's Pallas kernels in interpret mode
    and the port's plain versions."""

    @pytest.mark.parametrize("bits,group,dtype", PACKINGS)
    @pytest.mark.parametrize("B,H,KV,S,dh,G,bs", [
        (2, 8, 4, 256, 32, 32, 256),   # GQA, block spans chunks
        (1, 4, 4, 128, 64, 32, 16),    # MHA, block inside a chunk
        (2, 4, 2, 192, 32, 64, 64),    # ragged lengths
    ])
    def test_decode(self, B, H, KV, S, dh, G, bs, bits, group, dtype):
        rng = np.random.default_rng(hash((bits, group, S, bs)) % 2**31)
        t_dt, j_dt = _qdt(dtype)
        q = rng.standard_normal((B, H, dh)).astype(np.float32)
        kq, ks = _packed(rng, B, S, KV, dh, S // G, bits, group)
        vq, vs = _packed(rng, B, S, KV, dh, S // G, bits, group)
        lengths = np.asarray([S] + [S - G // 2] * (B - 1), np.int32)
        args = dict(bits=bits, group=group, chunk_tokens=G)
        want = ref_decode(jnp.asarray(q, j_dt), *_j(kq, vq, ks, vs, lengths),
                          block_s=bs, return_residuals=True, interpret=True,
                          **args)
        tq, tk, tv, tks, tvs, tl = _t(q, kq, vq, ks, vs, lengths)
        got = D.decode_attention_quant_ref(tq.to(t_dt), tk, tv, tks, tvs, tl,
                                           **args)
        _check(got, want, f"decode {dtype}")

    @pytest.mark.parametrize("bits,group,dtype", PACKINGS)
    @pytest.mark.parametrize("causal,q_offset", [(False, 0), (True, 64)])
    def test_flash(self, bits, group, causal, q_offset, dtype):
        rng = np.random.default_rng(hash((bits, group, causal)) % 2**31)
        t_dt, j_dt = _qdt(dtype)
        B, Sq, H, KV, Sk, dh, G = 2, 16, 8, 4, 128, 32, 32
        q = rng.standard_normal((B, Sq, H, dh)).astype(np.float32)
        kq, ks = _packed(rng, B, Sk, KV, dh, Sk // G, bits, group)
        vq, vs = _packed(rng, B, Sk, KV, dh, Sk // G, bits, group)
        args = dict(bits=bits, group=group, chunk_tokens=G, causal=causal,
                    q_offset=q_offset)
        want = ref_flash(jnp.asarray(q, j_dt), *_j(kq, vq, ks, vs),
                         block_q=8, block_k=64, return_residuals=True,
                         interpret=True, **args)
        tq, tk, tv, tks, tvs = _t(q, kq, vq, ks, vs)
        got = F.flash_attention_quant_ref(tq.to(t_dt), tk, tv, tks, tvs,
                                          **args)
        _check(got, want, f"flash {dtype}")

    def test_empty_row_and_first_causal_row(self):
        """A row of length 0 gives out 0, m -inf, l 0; the first causal row
        at q_offset 0 sees key 0 alone (l = 1)."""
        rng = np.random.default_rng(3)
        kq, ks = _packed(rng, 1, 16, 2, 8, 2, 8, 1)
        tk, tks = _t(kq, ks)
        q = torch.from_numpy(rng.standard_normal((1, 4, 8)).astype(
            np.float32))
        out, m, l = D.decode_attention_quant_ref(
            q, tk, tk, tks, tks, torch.tensor([0], dtype=torch.int32),
            bits=8, group=1, chunk_tokens=8)
        assert bool((out == 0).all()) and bool((l == 0).all())
        assert bool(torch.isinf(m).all())
        out, m, l = F.flash_attention_quant_ref(
            q[:, None], tk, tk, tks, tks, bits=8, group=1, chunk_tokens=8,
            causal=True, q_offset=0)
        assert bool(torch.isfinite(m).all()) and bool((l == 1).all())

    def test_quant_block_s_is_the_reference_copy(self):
        for S, G, bs in [(256, 32, 64), (256, 32, 16), (256, 32, 48),
                         (128, 32, 512), (3840, 256, 512), (40, 8, 12)]:
            assert D.quant_block_s(S, G, bs) == ref_quant_block_s(S, G, bs)


class TestDequantCache:
    @pytest.mark.parametrize("bits", [8, 4])
    @pytest.mark.parametrize("group", [1, 2, 8, 32])
    def test_exact(self, bits, group):
        rng = np.random.default_rng(bits * 100 + group)
        q, s = _packed(rng, 2, 24, 2, 16, 3, bits, group)
        s = rng.standard_normal(s.shape).astype(np.float16)  # any sign/size
        want = ref_kernels.ref_dequant_cache(*_j(q, s), bits=bits,
                                             group=group, chunk_tokens=8)
        got = dequant_cache_ref(*_t(q, s), bits=bits, group=group,
                                chunk_tokens=8)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class TestWirePayload:
    """Fused attention over *real* wire bytes (the reference's
    `TestWirePayloadEquality`): every quantized codec family, payloads from
    `encode_chunk`, parsed by both packages into the same packed tensors."""

    CODECS = ["int8", "gw8/g32", "gw4/g32", "mixed/88844444/g32"]

    @pytest.mark.parametrize("codec_name", CODECS)
    def test_decode_and_prefill_shapes(self, codec_name):
        codec = ref_get_codec(codec_name)
        L = 8 if codec_name.startswith("mixed") else 2
        KV, dh, G, N, H = 2, 32, 8, 4, 4
        geo = dict(num_layers=L, chunk_tokens=G, num_kv_heads=KV,
                   head_dim=dh, dtype_bytes=2, codec=codec_name)
        ref_spec, spec = RefKVSpec(**geo), KVSpec(**geo)
        rng = np.random.default_rng(11)
        bufs = [codec.encode_chunk(
            rng.standard_normal((L, G, ref_spec.width)).astype(np.float32),
            rng.standard_normal((L, G, ref_spec.width)).astype(np.float32),
            ref_spec) for _ in range(N)]
        S = N * G
        qd = rng.standard_normal((1, H, dh)).astype(np.float32)
        qp = rng.standard_normal((1, G, H, dh)).astype(np.float32)
        lengths = np.asarray([S], np.int32)
        for layer in range(L):
            lo, hi = layer_range(layer, ref_spec)
            payload = b"".join(b[lo:hi] for b in bufs)
            rk = ref_kv.layer_payload_to_packed_kv(payload, N, ref_spec,
                                                   layer=layer)
            pk = kv_chunks.layer_payload_to_packed_kv(payload, N, spec,
                                                      layer=layer,
                                                      device="cpu")
            assert (pk.bits, pk.group, pk.chunk_tokens) == \
                (rk.bits, rk.group, rk.chunk_tokens)
            assert pk.resident_bytes == rk.resident_bytes
            for a, b in zip(pk.as_tuple(), rk.as_tuple()):
                assert a.device.type == "cpu"
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            args = dict(bits=pk.bits, group=pk.group, chunk_tokens=G)
            want = ref_decode(jnp.asarray(qd), *rk.as_tuple(),
                              jnp.asarray(lengths), block_s=16,
                              return_residuals=True, interpret=True, **args)
            got = ops.decode_attention_quant_op(
                *_t(qd), *pk.as_tuple(), *_t(lengths),
                return_residuals=True, **args)
            _check(got, want, "wire decode")
            want = ref_flash(jnp.asarray(qp), *rk.as_tuple(), causal=True,
                             q_offset=S, block_q=G, block_k=16,
                             return_residuals=True, interpret=True, **args)
            got = ops.flash_attention_quant_op(
                *_t(qp), *pk.as_tuple(), causal=True, q_offset=S,
                return_residuals=True, **args)
            _check(got, want, "wire flash")
            # packed -> model width, against the reference's expansion
            for dtype, jdt in ((torch.float32, jnp.float32),
                               (torch.bfloat16, jnp.bfloat16)):
                wk, wv = ref_kv.packed_layer_to_fp(rk, jdt)
                gk, gv = kv_chunks.packed_layer_to_fp(pk, dtype)
                assert gk.dtype == dtype and tuple(gk.shape) == wk.shape
                np.testing.assert_array_equal(_np(gk), _np(wk))
                np.testing.assert_array_equal(_np(gv), _np(wv))


class TestDispatch:
    def _case(self, bits=8):
        rng = np.random.default_rng(5)
        kq, ks = _packed(rng, 1, 16, 2, 32, 2, bits, 8)
        q = rng.standard_normal((1, 4, 32)).astype(np.float32)
        qp = rng.standard_normal((1, 3, 4, 32)).astype(np.float32)
        return _t(q, qp, kq, ks, np.asarray([16], np.int32))

    @pytest.mark.parametrize("bits", [8, 4])
    def test_cpu_tensors_take_the_plain_versions(self, bits):
        launches.reset()
        q, qp, kq, ks, ln = self._case(bits)
        args = dict(bits=bits, group=8, chunk_tokens=8)
        got = ops.decode_attention_quant_op(q, kq, kq, ks, ks, ln, block_s=4,
                                            return_residuals=True, **args)
        want = D.decode_attention_quant_ref(q, kq, kq, ks, ks, ln, **args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        out = ops.decode_attention_quant_op(q, kq, kq, ks, ks, ln, **args)
        assert torch.equal(out, want[0])  # residuals only on request
        got = ops.flash_attention_quant_op(qp, kq, kq, ks, ks, causal=True,
                                           q_offset=16, block_q=2, block_k=4,
                                           return_residuals=True, **args)
        want = F.flash_attention_quant_ref(qp, kq, kq, ks, ks, causal=True,
                                           q_offset=16, **args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert all(n == 0 for n in launches.LAUNCHES.values())

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        q, qp, kq, ks, ln = self._case()
        args = dict(bits=8, group=8, chunk_tokens=8)
        with pytest.raises(ValueError, match="CUDA"):
            D.decode_attention_quant(q, kq, kq, ks, ks, ln, **args)
        with pytest.raises(ValueError, match="CUDA"):
            F.flash_attention_quant(qp, kq, kq, ks, ks, **args)
        assert launches.LAUNCHES["decode_attention_quant"] == 0
        assert launches.LAUNCHES["flash_attention_quant"] == 0

    @pytest.mark.parametrize("fn", [ops.decode_attention_quant_op,
                                    D.decode_attention_quant])
    def test_decode_rejects_bad_inputs(self, fn):
        q, _, kq, ks, ln = self._case()
        args = dict(bits=8, group=8, chunk_tokens=8)
        with pytest.raises(TypeError, match="k_q must be"):
            fn(q, kq.view(torch.uint8), kq, ks, ks, ln, **args)
        with pytest.raises(TypeError, match="k_q must be"):
            fn(q, kq, kq, ks, ks, ln, **dict(args, bits=4))
        with pytest.raises(TypeError, match="float16"):
            fn(q, kq, kq, ks.float(), ks, ln, **args)
        with pytest.raises(TypeError, match="q must be"):
            fn(q.half(), kq, kq, ks, ks, ln, **args)
        with pytest.raises(ValueError, match="bits"):
            fn(q, kq, kq, ks, ks, ln, **dict(args, bits=2))
        with pytest.raises(ValueError, match="chunk_tokens"):
            fn(q, kq, kq, ks, ks, ln, **dict(args, chunk_tokens=5))
        with pytest.raises(ValueError, match="k_scales shape"):
            fn(q, kq, kq, ks, ks, ln, **dict(args, group=4))
        with pytest.raises(ValueError, match="q shape"):
            fn(q[..., :16], kq, kq, ks, ks, ln, **args)
        with pytest.raises(ValueError, match="query heads"):
            fn(q[:, :3], kq, kq, ks, ks, ln, **args)
        with pytest.raises(ValueError, match="lengths"):
            fn(q, kq, kq, ks, ks, ln.long(), **args)

    @pytest.mark.parametrize("fn", [ops.flash_attention_quant_op,
                                    F.flash_attention_quant])
    def test_flash_rejects_bad_inputs(self, fn):
        _, qp, kq, ks, _ = self._case()
        args = dict(bits=8, group=8, chunk_tokens=8)
        with pytest.raises(ValueError, match="want q"):
            fn(qp[0], kq, kq, ks, ks, **args)
        with pytest.raises(ValueError, match="q shape"):
            fn(qp[:, :, :, :16], kq, kq, ks, ks, **args)
        with pytest.raises(ValueError, match="want k_q and v_q"):
            fn(qp, kq, kq[:, :8], ks, ks, **args)
        with pytest.raises(ValueError, match="q_offset"):
            fn(qp, kq, kq, ks, ks, q_offset=-1, **args)


class TestBuildKey:
    """The library's name hashes every shared header, so editing K3's
    header rebuilds K6 and K7 (no nvcc needed to check the key)."""

    def test_header_bytes_change_the_library_path(self, tmp_path,
                                                  monkeypatch):
        csrc = tmp_path / "csrc"
        csrc.mkdir()
        for f in build.CSRC.iterdir():
            (csrc / f.name).write_bytes(f.read_bytes())
        monkeypatch.setattr(build, "CSRC", csrc)
        names = build.sources()
        assert {"decode_attention_quant", "flash_attention_quant",
                "kv_dequant"} <= set(names)
        before = {n: build.library_path(n) for n in names}
        assert before == {n: build.library_path(n) for n in names}
        header = csrc / "dequant_tile.cuh"
        header.write_bytes(header.read_bytes() + b"\n// edited\n")
        after = {n: build.library_path(n) for n in names}
        assert all(after[n] != before[n] for n in names)
        src = csrc / "kv_dequant.cu"
        src.write_bytes(src.read_bytes() + b"\n")
        assert build.library_path("kv_dequant") != after["kv_dequant"]
        assert build.library_path("flash_attention_quant") \
            == after["flash_attention_quant"]



def _finite_fp16_scales() -> np.ndarray:
    """Every finite fp16 value, as float32 (subnormals and negatives
    included)."""
    h = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    return h[np.isfinite(h)].astype(np.float32)


CODES = {8: np.arange(-128, 128, dtype=np.float32),
         4: np.arange(-8, 8, dtype=np.float32)}


def _trunc_bf16(x: np.ndarray) -> np.ndarray:
    """x truncated to bf16 (its top 16 bits), as float32."""
    return (x.view(np.uint32) & np.uint32(0xFFFF0000)).view(np.float32)


def _rn_bf16(x: np.ndarray) -> np.ndarray:
    """x rounded to the nearest bf16 (ties to even), as float32."""
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


class TestBf16Pieces:
    """The arithmetic K7's tensor-core loader rests on, for every int8 code
    and every int4 value against every finite fp16 scale: the value
    code * scale is exact in fp32; three bf16 pieces by truncation (K) sum
    to it exactly; two pieces by rounding to nearest (V) are within 2^-16
    of it, relative.  Properties of the arithmetic, checked here where they
    can be enumerated; the card runs the same steps."""

    @pytest.mark.parametrize("bits", [8, 4])
    def test_k_pieces_are_exact(self, bits):
        scales = _finite_fp16_scales()
        for part in np.array_split(CODES[bits], 8):
            x = part[:, None] * scales[None, :]  # fp32 products
            assert np.array_equal(x.astype(np.float64),
                                  part[:, None].astype(np.float64)
                                  * scales[None, :].astype(np.float64))
            hi = _trunc_bf16(x)
            r1 = x - hi
            mid = _trunc_bf16(r1)
            r2 = r1 - mid
            lo = _trunc_bf16(r2)
            assert np.array_equal(lo, r2)  # the rest fits the third piece
            total = (hi.astype(np.float64) + mid.astype(np.float64)
                     + lo.astype(np.float64))
            assert np.array_equal(total, x.astype(np.float64))

    @pytest.mark.parametrize("bits", [8, 4])
    def test_v_pieces_within_2_to_minus_16(self, bits):
        scales = _finite_fp16_scales()
        worst = 0.0
        for part in np.array_split(CODES[bits], 8):
            x = part[:, None] * scales[None, :]
            hi = _rn_bf16(x)
            lo = _rn_bf16(x - hi)
            err = np.abs(x.astype(np.float64) - hi.astype(np.float64)
                         - lo.astype(np.float64))
            assert bool((err <= 2.0 ** -16 * np.abs(x)).all())
            nz = x != 0
            worst = max(worst, float((err[nz] / np.abs(x[nz])).max()))
        # int4 values (at most 15 significant bits) are exact in two
        # pieces; int8 values (up to 19) are not
        assert (worst > 0) == (bits == 8)

    @pytest.mark.parametrize("bits", [8, 4])
    def test_codes_from_the_mantissa_of_2_to_23(self, bits):
        """K3's `code_from`: the byte u placed in the mantissa of 2^23, less
        2^23 + 128 (int8, u = code + 128) or 2^23 + 8 (a nibble), is the
        code exactly."""
        u = np.arange(256 if bits == 8 else 16, dtype=np.uint32)
        f = (np.uint32(0x4B000000) | u).view(np.float32)
        bias = np.float32(8388736.0 if bits == 8 else 8388616.0)
        want = (u.astype(np.uint8) ^ 0x80).view(np.int8).astype(np.float32) \
            if bits == 8 else u.astype(np.float32) - 8
        assert np.array_equal(f - bias, want)


class TestFlashQuantPlan:
    """K7's grid and row packing, and the split plans of K6/K7, plain
    Python: the CTAs cover every (query position, head) once, a CTA's rows
    share one KV head, and the splits fill the card without emptying a
    CTA's key range."""

    SHAPES = [(1, 256, 32, 8, 3840), (1, 64, 32, 8, 3840),
              (1, 128, 32, 8, 3840), (2, 37, 8, 2, 96), (1, 20, 8, 1, 64),
              (1, 9, 4, 4, 32), (1, 300, 32, 8, 3840), (3, 50, 40, 8, 1000)]
    # the query-head groups of the configs (H/KV = 2, 3, 5, 6 and 1) at the
    # card's cases (Sq = 37 over 2048 keys) and at a longer suffix
    GQA_SHAPES = [(B, Sq, H, KV, 2048) for H, KV in
                  ((16, 8), (9, 3), (40, 8), (48, 8), (8, 8))
                  for B, Sq in ((1, 37), (2, 300))]

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                             ids=["bf16", "fp32"])
    @pytest.mark.parametrize("B,Sq,H,KV,Sk", SHAPES)
    def test_rows_cover_every_query_once(self, B, Sq, H, KV, Sk, dtype):
        grid = F.flash_quant_grid(B, Sq, H, KV, dtype)
        rows = F.QUANT_ROWS[dtype]
        blocks, kv_dim = (grid[1], grid[0]) if dtype == torch.bfloat16 \
            else (grid[0], grid[1])
        assert kv_dim == KV and grid[2] == B
        seen = set()
        for kh in range(KV):
            for blk in range(blocks):
                for v in range(blk * rows, (blk + 1) * rows):
                    if v >= Sq * (H // KV):
                        continue
                    pos, head = F.flash_quant_row(kh, v, H, KV)
                    assert head // (H // KV) == kh
                    seen.add((pos, head))
        assert seen == {(p, h) for p in range(Sq) for h in range(H)}

    @pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                             ids=["bf16", "fp32"])
    @pytest.mark.parametrize("B,Sq,H,KV,Sk", GQA_SHAPES)
    def test_rows_map_back_once_at_every_group(self, B, Sq, H, KV, Sk,
                                               dtype):
        """Every (position, head) is exactly one row of one row block, its
        head within the block's KV head, and a block's rows run over
        consecutive positions (the causal mask is per row: a row's position
        is v // (H/KV), whether or not the block cuts a position's heads)."""
        grid = F.flash_quant_grid(B, Sq, H, KV, dtype)
        rows = F.QUANT_ROWS[dtype]
        blocks = grid[1] if dtype == torch.bfloat16 else grid[0]
        gs = H // KV
        seen = {}
        for kh in range(KV):
            for blk in range(blocks):
                vs = range(blk * rows, min((blk + 1) * rows, Sq * gs))
                positions = [F.flash_quant_row(kh, v, H, KV)[0] for v in vs]
                assert positions == sorted(positions)
                assert positions[-1] - positions[0] <= -(-rows // gs)
                for v in vs:
                    pos, head = F.flash_quant_row(kh, v, H, KV)
                    assert head // gs == kh and pos == v // gs
                    seen[pos, head] = seen.get((pos, head), 0) + 1
        assert seen == {(p, h): 1 for p in range(Sq) for h in range(H)}

    @pytest.mark.parametrize("B,Sq,H,KV,Sk", SHAPES + GQA_SHAPES)
    def test_splits_fill_the_card(self, B, Sq, H, KV, Sk):
        n = F.flash_quant_splits(B, Sq, H, KV, Sk, torch.bfloat16)
        grid = F.flash_quant_grid(B, Sq, H, KV, torch.bfloat16)
        ctas = grid[0] * grid[1] * grid[2]
        assert 1 <= n <= F.MAX_SPLITS
        assert ctas * n <= max(ctas, D.H100_SMS)
        if n > 1:
            assert Sk // n >= F.MIN_SPLIT_KEYS
        assert F.flash_quant_splits(B, Sq, H, KV, Sk, torch.float32) == 1

    def test_serving_shape(self):
        """The packed warm request's K7 (256 suffix rows over 3840 prefix
        keys, 32 heads on 8): 8 row blocks of 32 positions x 4 heads per KV
        head, 64 CTAs, each row block's keys cut in two: 128 CTAs.  Its K6
        (one token over 3840): 30 splits of 128 tokens, 240 CTAs."""
        assert F.flash_quant_grid(1, 256, 32, 8, torch.bfloat16) == (8, 8, 1)
        assert F.flash_quant_row(3, 5, 32, 8) == (1, 13)
        assert F.flash_quant_splits(1, 256, 32, 8, 3840,
                                    torch.bfloat16) == 2
        assert D.decode_plan(3840, 1, 32, 8) == (128, 30, 1)
