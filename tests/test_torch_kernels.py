"""The port's KV dequant kernels: plain PyTorch versions against the
reference Pallas kernels (interpret mode), the device dispatch of
``kernels.ops``, and the wrappers' argument checks.  The CUDA kernels
themselves run only on the card (``tests/test_torch_cuda.py``)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.kv_dequant import (  # noqa: E402
    kv_dequant as ref_kv_dequant, kv_dequant_packed4 as ref_kv_dequant_p4)
from repro_torch.kernels import kv_dequant as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

OUT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(seed, N, R, W, group, packed):
    rng = np.random.default_rng(seed)
    if packed:
        q = rng.integers(0, 256, size=(N, R, W // 2), dtype=np.uint8)
    else:
        q = rng.integers(-128, 128, size=(N, R, W), dtype=np.int8)
    s = rng.standard_normal((N, W // group)).astype(np.float16)
    return q, s


def _as_f32(x):
    """A torch or jax array of fp32/bf16 -> numpy fp32 (exact widening)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ((N, R, W), group): groups 1, 2, 16 and 128; the ragged cases have odd N
# and R and widths that are not multiples of 16
CASES = [((2, 8, 256), 1), ((2, 8, 256), 2), ((2, 8, 256), 16),
         ((2, 8, 256), 128), ((3, 5, 24), 8), ((1, 7, 40), 2)]


class TestPlainAgainstPallas:
    """Tolerance 0: both compute one fp32 multiply and one rounding."""

    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("shape,group", CASES)
    @pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
    def test_exact(self, packed, shape, group, out):
        N, R, W = shape
        q, s = _inputs(N * 1000 + R * 10 + group, N, R, W, group, packed)
        t_out, j_out = OUT[out]
        if packed:
            want = ref_kv_dequant_p4(jnp.asarray(q), jnp.asarray(s),
                                     group=group, out_dtype=j_out,
                                     interpret=True)
            got = K.kv_dequant_packed4_ref(torch.from_numpy(q),
                                           torch.from_numpy(s), group=group,
                                           out_dtype=t_out)
        else:
            want = ref_kv_dequant(jnp.asarray(q), jnp.asarray(s), group=group,
                                  out_dtype=j_out, interpret=True)
            got = K.kv_dequant_ref(torch.from_numpy(q), torch.from_numpy(s),
                                   group=group, out_dtype=t_out)
        assert got.dtype == t_out and tuple(got.shape) == (N, R, W)
        np.testing.assert_array_equal(_as_f32(got), _as_f32(want))


class TestDispatch:
    @pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
    def test_cpu_tensor_takes_plain_version(self, packed):
        K.reset_launch_counts()
        q, s = _inputs(0, 2, 4, 32, 8, packed)
        q, s = torch.from_numpy(q), torch.from_numpy(s)
        op = ops.kv_dequant_packed4_op if packed else ops.kv_dequant_op
        plain = K.kv_dequant_packed4_ref if packed else K.kv_dequant_ref
        got = op(q, s, group=8, out_dtype=torch.bfloat16)
        assert torch.equal(got, plain(q, s, group=8,
                                      out_dtype=torch.bfloat16))
        assert K.LAUNCHES == {"kv_dequant": 0, "kv_dequant_packed4": 0}

    @pytest.mark.parametrize("kernel", [K.kv_dequant, K.kv_dequant_packed4])
    def test_kernel_wrapper_refuses_cpu_tensors(self, kernel):
        packed = kernel is K.kv_dequant_packed4
        q, s = _inputs(1, 1, 2, 32, 1, packed)
        with pytest.raises(ValueError, match="CUDA"):
            kernel(torch.from_numpy(q), torch.from_numpy(s))
        assert K.LAUNCHES[kernel.__name__] == 0


class TestArgumentChecks:
    def _ok(self, packed=False):
        q, s = _inputs(2, 2, 4, 32, 8, packed)
        return torch.from_numpy(q), torch.from_numpy(s)

    @pytest.mark.parametrize("fn", [ops.kv_dequant_op, K.kv_dequant])
    def test_int8_rejects_wrong_dtypes(self, fn):
        q, s = self._ok()
        with pytest.raises(TypeError, match="q must be"):
            fn(q.to(torch.int16), s, group=8)
        with pytest.raises(TypeError, match="q must be"):
            fn(q.to(torch.uint8), s, group=8)
        with pytest.raises(TypeError, match="scales must be float16"):
            fn(q, s.float(), group=8)
        with pytest.raises(TypeError, match="out_dtype"):
            fn(q, s, group=8, out_dtype=torch.float16)

    @pytest.mark.parametrize("fn", [ops.kv_dequant_packed4_op,
                                    K.kv_dequant_packed4])
    def test_int4_rejects_signed_words(self, fn):
        q, s = self._ok(packed=True)
        with pytest.raises(TypeError, match="q must be"):
            fn(q.to(torch.int8), s, group=8)

    @pytest.mark.parametrize("fn", [ops.kv_dequant_op, K.kv_dequant])
    def test_rejects_wrong_shapes(self, fn):
        q, s = self._ok()
        with pytest.raises(ValueError, match="scales shape"):
            fn(q, s, group=4)  # scales hold 32/8 groups, not 32/4
        with pytest.raises(ValueError, match="group"):
            fn(q, s, group=3)  # does not divide 32
        with pytest.raises(ValueError, match="want q"):
            fn(q[0], s, group=8)
        with pytest.raises(ValueError, match="scales shape"):
            fn(q[:1], s, group=8)  # scale rows for 2 chunks, q has 1

    def test_packed_width_counts_nibbles(self):
        q, s = self._ok(packed=True)  # q [2, 4, 16] bytes = 32 channels
        assert tuple(ops.kv_dequant_packed4_op(q, s, group=8).shape) \
            == (2, 4, 32)
        with pytest.raises(ValueError, match="scales shape"):
            ops.kv_dequant_packed4_op(q, s[:, :2], group=8)
