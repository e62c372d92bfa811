"""The port's attention ops over fp32 or bf16 K/V, K4 (`flash_attention`)
and K5 (`decode_attention`), against the reference: the plain PyTorch
versions on the reference's own Pallas kernels run in interpret mode and on
its jnp oracles (`kernels/ref.py`), with inputs made by numpy from a seed;
the device dispatch of ``kernels.ops``; and the wrappers' argument checks.
The CUDA kernels run only on the card (``tests/test_torch_cuda.py``).

Tolerances: fp32 ``out`` within 1e-5 absolute (the sums run in another
order); a bf16 ``out`` within one bf16 rounding step beyond that, because
both versions compute in fp32 and round their result once.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as ref_decode)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as ref_flash)
from repro_torch.kernels import launches, ops  # noqa: E402
from repro_torch.kernels import decode_attention as D  # noqa: E402
from repro_torch.kernels import flash_attention as F  # noqa: E402

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_out_close(got: torch.Tensor, want, name: str = ""):
    """got: the port's out; want: the reference's array, in one dtype."""
    want_dt = torch.bfloat16 if want.dtype == jnp.bfloat16 else torch.float32
    assert got.dtype == want_dt
    o, ow = _np(got), _np(want)
    assert o.shape == ow.shape
    if got.dtype == torch.float32:
        tol = 1e-5
    else:
        big = np.maximum(np.abs(o), np.abs(ow)).clip(2.0 ** -126)
        tol = np.exp2(np.floor(np.log2(big)) - 7) + 1e-5
    d = np.abs(o - ow)
    assert (d <= tol).all(), d.max()
    print(f"largest |diff| {name}: {d.max():.3g}")


def _normal(rng, shape, dtype="float32"):
    """The same values for both packages: (torch tensor, jnp array)."""
    x = rng.standard_normal(shape).astype(np.float32)
    t_dt, j_dt = DTYPES[dtype]
    return torch.from_numpy(x).to(t_dt), jnp.asarray(x, j_dt)


class TestFlashAgainstPallas:
    """K4: the reference's cases (`tests/test_kernels.py:42-93`) and more,
    through its Pallas kernel in interpret mode and the port's plain
    version and op."""

    @pytest.mark.parametrize("B,H,KV,S,dh,bq,bk", [
        (1, 4, 4, 128, 64, 64, 64),     # MHA
        (2, 4, 2, 128, 32, 32, 64),     # GQA, rectangular blocks
        (1, 8, 1, 256, 64, 128, 128),   # MQA
        (2, 6, 2, 64, 16, 16, 16),      # odd-ish head count
    ])
    @pytest.mark.parametrize("causal", [True, False])
    def test_reference_shapes(self, B, H, KV, S, dh, bq, bk, causal):
        rng = np.random.default_rng(B * 1000 + H * 10 + S + dh)
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (B, H, S, dh)), _normal(rng, (B, KV, S, dh)),
            _normal(rng, (B, KV, S, dh)))
        want = ref_flash(jq, jk, jv, causal=causal, block_q=bq, block_k=bk,
                         interpret=True)
        _assert_out_close(F.flash_attention_ref(tq, tk, tv, causal=causal),
                          want, "flash")
        _assert_out_close(ops.flash_attention_op(tq, tk, tv, causal=causal,
                                                 block_q=bq, block_k=bk),
                          want, "flash op")

    @pytest.mark.parametrize("Sq,Sk", [(64, 128), (128, 64), (32, 96)])
    def test_causal_mask_is_top_left(self, Sq, Sk):
        """Row i sees key j iff i >= j, whatever Sk - Sq is: the reference
        kernel's mask, not its oracle's bottom-right one (which agrees only
        when Sq == Sk)."""
        rng = np.random.default_rng(Sq * 7 + Sk)
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (1, 4, Sq, 32)), _normal(rng, (1, 2, Sk, 32)),
            _normal(rng, (1, 2, Sk, 32)))
        want = ref_flash(jq, jk, jv, causal=True, block_q=32, block_k=32,
                         interpret=True)
        got = F.flash_attention_ref(tq, tk, tv, causal=True)
        _assert_out_close(got, want, f"top-left Sq={Sq} Sk={Sk}")
        bottom_right = ref_kernels.ref_flash_attention(jq, jk, jv,
                                                       causal=True)
        assert not np.allclose(_np(got), _np(bottom_right), atol=1e-2)

    def test_square_causal_matches_the_oracle(self):
        rng = np.random.default_rng(4)
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (2, 6, 48, 16)), _normal(rng, (2, 2, 48, 16)),
            _normal(rng, (2, 2, 48, 16)))
        _assert_out_close(F.flash_attention_ref(tq, tk, tv, causal=True),
                          ref_kernels.ref_flash_attention(jq, jk, jv,
                                                          causal=True),
                          "oracle")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("causal", [True, False])
    def test_dtypes(self, dtype, causal):
        rng = np.random.default_rng(11)
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (1, 2, 64, 32), dtype) for _ in range(3))
        want = ref_flash(jq, jk, jv, causal=causal, block_q=32, block_k=32,
                         interpret=True)
        got = F.flash_attention_ref(tq, tk, tv, causal=causal)
        _assert_out_close(got, want, f"flash {dtype}")

    @pytest.mark.parametrize("group", [1, 2, 3, 8])
    def test_groups(self, group):
        """GQA groups of any size, powers of two or not (Qwen3-14B and
        Llama-4 share 5 query heads per KV head)."""
        rng = np.random.default_rng(group)
        KV = 2
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (1, KV * group, 64, 16)),
            _normal(rng, (1, KV, 64, 16)), _normal(rng, (1, KV, 64, 16)))
        want = ref_flash(jq, jk, jv, causal=True, block_q=32, block_k=32,
                         interpret=True)
        _assert_out_close(F.flash_attention_ref(tq, tk, tv), want,
                          f"group {group}")


class TestDecodeAgainstPallas:
    """K5: the reference's cases (`tests/test_kernels.py:96-136`) and more,
    through its Pallas kernel in interpret mode and the port's plain
    version and op."""

    @pytest.mark.parametrize("B,H,KV,S,dh,bs", [
        (2, 4, 4, 256, 64, 64),
        (2, 8, 2, 256, 32, 128),
        (1, 4, 1, 512, 64, 256),
    ])
    def test_reference_shapes(self, B, H, KV, S, dh, bs):
        rng = np.random.default_rng(B * 100 + S + dh)
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (B, H, dh)), _normal(rng, (B, S, KV, dh)),
            _normal(rng, (B, S, KV, dh)))
        lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
        tl, jl = torch.from_numpy(lengths), jnp.asarray(lengths)
        want = ref_decode(jq, jk, jv, jl, block_s=bs, interpret=True)
        _assert_out_close(D.decode_attention_ref(tq, tk, tv, tl), want,
                          "decode")
        _assert_out_close(ops.decode_attention_op(tq, tk, tv, tl,
                                                  block_s=bs), want,
                          "decode op")
        _assert_out_close(D.decode_attention_ref(tq, tk, tv, tl),
                          ref_kernels.ref_decode_attention(jq, jk, jv, jl),
                          "decode oracle")

    def test_ragged_trailing_block_and_empty_row(self):
        """S = 200 over blocks of 64 (a ragged last block, padded with NaN
        in interpret mode) and a row of length 0, which the reference's
        kernel gives as 0 (its jnp oracle gives NaN there)."""
        rng = np.random.default_rng(6)
        B, H, KV, S, dh = 3, 6, 2, 200, 32
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (B, H, dh)), _normal(rng, (B, S, KV, dh)),
            _normal(rng, (B, S, KV, dh)))
        lengths = np.asarray([200, 0, 130], np.int32)
        tl, jl = torch.from_numpy(lengths), jnp.asarray(lengths)
        want = ref_decode(jq, jk, jv, jl, block_s=64, interpret=True)
        got = D.decode_attention_ref(tq, tk, tv, tl)
        _assert_out_close(got, want, "ragged")
        assert bool((got[1] == 0).all())
        assert (_np(want)[1] == 0).all()
        assert np.isnan(_np(ref_kernels.ref_decode_attention(
            jq, jk, jv, jl))[1]).all()

    def test_tail_values_do_not_matter(self):
        """Cache rows past the length, set to +999 (K) and -999 (V) or to
        NaN, change nothing (the reference's `test_short_lengths_ignore_tail`
        and its rule that padded rows are selected away, not multiplied by
        a zero weight)."""
        rng = np.random.default_rng(7)
        B, H, KV, S, dh = 1, 2, 2, 128, 16
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (B, H, dh)), _normal(rng, (B, S, KV, dh)),
            _normal(rng, (B, S, KV, dh)))
        tl = torch.tensor([40], dtype=torch.int32)
        base = D.decode_attention_ref(tq, tk, tv, tl)
        for kfill, vfill in ((999.0, -999.0), (float("nan"), float("nan"))):
            tk2, tv2 = tk.clone(), tv.clone()
            tk2[:, 40:], tv2[:, 40:] = kfill, vfill
            assert torch.equal(D.decode_attention_ref(tq, tk2, tv2, tl), base)
        jk2 = jk.at[:, 40:].set(999.0)
        jv2 = jv.at[:, 40:].set(-999.0)
        want = ref_decode(jq, jk2, jv2, jnp.asarray([40], jnp.int32),
                          block_s=32, interpret=True)
        _assert_out_close(base, want, "tail")

    def test_lengths_above_s_read_s_rows(self):
        rng = np.random.default_rng(8)
        (tq, _), (tk, _), (tv, _) = (
            _normal(rng, (1, 4, 16)), _normal(rng, (1, 24, 2, 16)),
            _normal(rng, (1, 24, 2, 16)))
        over = D.decode_attention_ref(tq, tk, tv,
                                      torch.tensor([99], dtype=torch.int32))
        full = D.decode_attention_ref(tq, tk, tv,
                                      torch.tensor([24], dtype=torch.int32))
        assert torch.equal(over, full)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dtypes(self, dtype):
        rng = np.random.default_rng(9)
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (2, 4, 32), dtype), _normal(rng, (2, 128, 2, 32),
                                                     dtype),
            _normal(rng, (2, 128, 2, 32), dtype))
        lengths = np.asarray([100, 128], np.int32)
        want = ref_decode(jq, jk, jv, jnp.asarray(lengths), block_s=64,
                          interpret=True)
        got = D.decode_attention_ref(tq, tk, tv, torch.from_numpy(lengths))
        _assert_out_close(got, want, f"decode {dtype}")


class TestDispatch:
    def _case(self):
        rng = np.random.default_rng(5)
        q = torch.from_numpy(rng.standard_normal((1, 4, 16, 32)).astype(
            np.float32))
        k = torch.from_numpy(rng.standard_normal((1, 2, 24, 32)).astype(
            np.float32))
        qd = q[:, :, 0].contiguous()
        kc = k.transpose(1, 2).contiguous()  # [1, 24, 2, 32]
        return q, k, qd, kc, torch.tensor([20], dtype=torch.int32)

    def test_cpu_tensors_take_the_plain_versions(self):
        launches.reset()
        q, k, qd, kc, ln = self._case()
        want = F.flash_attention_ref(q, k, k, causal=True)
        for bq, bk in ((128, 128), (4, 8), (16, 1)):
            assert torch.equal(ops.flash_attention_op(
                q, k, k, causal=True, block_q=bq, block_k=bk), want)
        assert torch.equal(ops.flash_attention_op(q, k, k, causal=False),
                           F.flash_attention_ref(q, k, k, causal=False))
        want = D.decode_attention_ref(qd, kc, kc, ln)
        for bs in (512, 8, 3):
            assert torch.equal(ops.decode_attention_op(qd, kc, kc, ln,
                                                       block_s=bs), want)
        assert all(n == 0 for n in launches.LAUNCHES.values())

    def test_kernel_wrappers_refuse_cpu_tensors(self):
        launches.reset()
        q, k, qd, kc, ln = self._case()
        with pytest.raises(ValueError, match="CUDA"):
            F.flash_attention(q, k, k)
        with pytest.raises(ValueError, match="CUDA"):
            D.decode_attention(qd, kc, kc, ln)
        assert all(n == 0 for n in launches.LAUNCHES.values())

    @pytest.mark.parametrize("fn", [ops.flash_attention_op,
                                    F.flash_attention_ref,
                                    F.flash_attention])
    def test_flash_rejects_bad_inputs(self, fn):
        q, k, _, _, _ = self._case()
        with pytest.raises(TypeError, match="one dtype"):
            fn(q, k.to(torch.bfloat16), k.to(torch.bfloat16))
        with pytest.raises(TypeError, match="one dtype"):
            fn(q.half(), k.half(), k.half())
        with pytest.raises(ValueError, match="want q"):
            fn(q[..., :16], k, k)  # head width of q != k's
        with pytest.raises(ValueError, match="want q"):
            fn(q[0], k, k)
        with pytest.raises(ValueError, match="want k and v"):
            fn(q, k, k[:, :, :8])
        with pytest.raises(ValueError, match="query heads"):
            fn(q[:, :3], k, k)

    @pytest.mark.parametrize("fn", [ops.decode_attention_op,
                                    D.decode_attention_ref,
                                    D.decode_attention])
    def test_decode_rejects_bad_inputs(self, fn):
        _, _, qd, kc, ln = self._case()
        with pytest.raises(TypeError, match="one dtype"):
            fn(qd.to(torch.bfloat16), kc, kc, ln)
        with pytest.raises(ValueError, match="q shape"):
            fn(qd[..., :16], kc, kc, ln)  # head width of q != the cache's
        with pytest.raises(ValueError, match="want k_cache and v_cache"):
            fn(qd, kc, kc[:, :8], ln)
        with pytest.raises(ValueError, match="query heads"):
            fn(qd[:, :3], kc, kc, ln)
        with pytest.raises(ValueError, match="lengths"):
            fn(qd, kc, kc, ln.long())
        with pytest.raises(ValueError, match="lengths"):
            fn(qd, kc, kc, ln.repeat(2))


class TestDecodeSplitPlan:
    """K5's split planner (`decode_split_tokens`), plain Python: the splits
    cover S, each holds at least MIN_SPLIT_TOKENS, and the grid fills
    DECODE_WAVES waves of the card's SMs wherever S has the tokens for it."""

    SHAPES = [(4104, 1, 8), (32768, 1, 8), (8192, 4, 8), (1000, 8, 8),
              (200, 2, 2), (96, 3, 1), (1, 1, 1), (128, 1, 8),
              (1_000_000, 1, 1), (4096, 64, 8), (5000, 1, 40)]

    @pytest.mark.parametrize("S,B,KV", SHAPES)
    def test_splits_cover_s(self, S, B, KV):
        split = D.decode_split_tokens(S, B, KV)
        nsplit = -(-S // split)
        assert split >= D.MIN_SPLIT_TOKENS
        assert (nsplit - 1) * split < S <= nsplit * split
        # no more splits than the two waves ask for: the merge stays short
        assert nsplit <= D.DECODE_WAVES * D.H100_SMS

    @pytest.mark.parametrize("S,B,KV", SHAPES)
    def test_grid_fills_two_waves_where_s_allows(self, S, B, KV):
        split = D.decode_split_tokens(S, B, KV)
        ctas = B * KV * -(-S // split)
        waves = D.DECODE_WAVES * D.H100_SMS
        if B * KV * -(-S // D.MIN_SPLIT_TOKENS) >= waves:
            assert ctas >= waves
        else:  # too few tokens for two waves: every split at the minimum
            assert split == D.MIN_SPLIT_TOKENS

    def test_llama_decode_shape(self):
        """B=1, S=4104, KV=8: 33 splits of 128 tokens, 264 CTAs."""
        assert D.decode_split_tokens(4104, 1, 8) == 128
        assert 8 * -(-4104 // 128) == 264

    @pytest.mark.parametrize("S,B,KV", SHAPES)
    def test_lengths_zero_and_s(self, S, B, KV):
        """The merge reads the splits below a row's length,
        ceil(length / split): none for length 0, every split for S."""
        split = D.decode_split_tokens(S, B, KV)
        nsplit = -(-S // split)
        assert -(-0 // split) == 0
        assert -(-S // split) == nsplit
        if S > 1:
            assert -(-(S - 1) // split) in (nsplit - 1, nsplit)

    @pytest.mark.parametrize("lengths", [[0, 5], [24, 1], [24, 24]])
    def test_plain_version_at_lengths_zero_and_s(self, lengths):
        rng = np.random.default_rng(12)
        (tq, jq), (tk, jk), (tv, jv) = (
            _normal(rng, (2, 4, 16)), _normal(rng, (2, 24, 2, 16)),
            _normal(rng, (2, 24, 2, 16)))
        ln = np.asarray(lengths, np.int32)
        got = D.decode_attention_ref(tq, tk, tv, torch.from_numpy(ln))
        want = ref_decode(jq, jk, jv, jnp.asarray(ln), block_s=8,
                          interpret=True)
        _assert_out_close(got, want, f"lengths {lengths}")
        for b, n in enumerate(lengths):
            if n == 0:
                assert bool((got[b] == 0).all())
