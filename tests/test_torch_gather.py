"""The port's chunk-tile gather K8 (`kv_gather`) against the reference's
Pallas kernel in interpret mode and its jnp oracle, bit for bit (the gather
moves bytes and does no arithmetic), with inputs made by numpy from a seed;
the op's device dispatch and the wrappers' argument checks; and the port's
copy of the residency byte model (`kernels/residency.py`), which must give
the reference's numbers on a grid of shapes.  The CUDA kernel runs only on
the card (``tests/test_torch_cuda.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ref as ref_kernels  # noqa: E402
from repro.kernels import residency as ref_residency  # noqa: E402
from repro.kernels.kv_gather import kv_gather as ref_gather  # noqa: E402
from repro_torch.kernels import launches, ops, residency  # noqa: E402
from repro_torch.kernels import kv_gather as K8  # noqa: E402

def _pool(rng, P, G, W, dtype):
    """The same pool for both packages: (torch tensor, jnp array).  bf16
    travels as its fp32 values, which bf16 holds exactly."""
    if dtype == "int8":
        x = rng.integers(-128, 128, size=(P, G, W), dtype=np.int8)
        return torch.from_numpy(x), jnp.asarray(x)
    x = rng.standard_normal((P, G, W)).astype(np.float32)
    if dtype == "bfloat16":
        t = torch.from_numpy(x).to(torch.bfloat16)
        return t, jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return torch.from_numpy(x), jnp.asarray(x)


def _bits(x) -> np.ndarray:
    """The bytes of a tensor or array, for a bit-for-bit comparison."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


class TestGatherAgainstPallas:
    @pytest.mark.parametrize("P,G,W,N", [(16, 8, 32, 5), (64, 16, 128, 64),
                                         (8, 4, 8, 1)])
    def test_reference_shapes(self, P, G, W, N):
        rng = np.random.default_rng(P + N)
        tp, jp = _pool(rng, P, G, W, "float32")
        idx = rng.integers(0, P, size=N).astype(np.int32)
        want = ref_gather(jp, jnp.asarray(idx), interpret=True)
        got = K8.kv_gather_ref(tp, torch.from_numpy(idx))
        np.testing.assert_array_equal(_bits(got), _bits(want))
        np.testing.assert_array_equal(
            _bits(ops.kv_gather_op(tp, torch.from_numpy(idx))),
            _bits(ref_kernels.ref_kv_gather(jp, jnp.asarray(idx))))

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("index_dtype", [np.int32, np.int64],
                             ids=["int32", "int64"])
    def test_dtypes_and_repeats(self, dtype, index_dtype):
        """The reference's repeated indices [3, 3, 0, 15]; int64 indices
        (torch's default) give what the reference's int32 ones give."""
        rng = np.random.default_rng(3)
        tp, jp = _pool(rng, 16, 8, 16, dtype)
        idx = np.asarray([3, 3, 0, 15])
        want = ref_gather(jp, jnp.asarray(idx, jnp.int32), interpret=True)
        got = K8.kv_gather_ref(tp, torch.from_numpy(idx.astype(index_dtype)))
        assert got.dtype == tp.dtype and tuple(got.shape) == (4, 8, 16)
        np.testing.assert_array_equal(_bits(got), _bits(want))

    @pytest.mark.parametrize("seed", range(6))
    def test_any_index_pattern(self, seed):
        rng = np.random.default_rng(100 + seed)
        tp, jp = _pool(rng, 10, 4, 8, "float32")
        idx = rng.integers(0, 10, size=int(rng.integers(1, 13))).astype(
            np.int32)
        want = ref_gather(jp, jnp.asarray(idx), interpret=True)
        np.testing.assert_array_equal(
            _bits(K8.kv_gather_ref(tp, torch.from_numpy(idx))), _bits(want))

    def test_indices_past_the_end_clamp_to_the_last_tile(self):
        """Outside the contract 0 <= idx < P the port clamps: an index past
        the end reads tile P-1, as the reference's jnp oracle does."""
        rng = np.random.default_rng(4)
        tp, jp = _pool(rng, 6, 2, 4, "float32")
        idx = np.asarray([9, 5, 6], np.int32)
        np.testing.assert_array_equal(
            _bits(K8.kv_gather_ref(tp, torch.from_numpy(idx))),
            _bits(ref_kernels.ref_kv_gather(jp, jnp.asarray(idx))))
        got = K8.kv_gather_ref(tp, torch.tensor([-2], dtype=torch.int32))
        assert torch.equal(got, tp[:1])  # clamped to 0, never out of bounds


class TestGatherDispatch:
    def test_cpu_tensors_take_the_plain_version(self):
        launches.reset()
        pool = torch.arange(5 * 2 * 3, dtype=torch.float32).reshape(5, 2, 3)
        idx = torch.tensor([4, 1, 1])
        assert torch.equal(ops.kv_gather_op(pool, idx),
                           K8.kv_gather_ref(pool, idx))
        assert all(n == 0 for n in launches.LAUNCHES.values())

    def test_kernel_wrapper_refuses_cpu_tensors(self):
        launches.reset()
        pool = torch.zeros((4, 2, 3))
        with pytest.raises(ValueError, match="CUDA"):
            K8.kv_gather(pool, torch.tensor([0], dtype=torch.int32))
        assert launches.LAUNCHES["kv_gather"] == 0

    @pytest.mark.parametrize("fn", [ops.kv_gather_op, K8.kv_gather_ref,
                                    K8.kv_gather])
    def test_rejects_bad_inputs(self, fn):
        pool = torch.zeros((4, 2, 3))
        idx = torch.tensor([0, 1], dtype=torch.int32)
        with pytest.raises(ValueError, match="want pool"):
            fn(pool[0], idx)
        with pytest.raises(ValueError, match="no tile"):
            fn(pool[:0], idx)
        with pytest.raises(TypeError, match="int32 or int64"):
            fn(pool, idx.float())
        with pytest.raises(TypeError, match="int32 or int64"):
            fn(pool, idx[None])


class TestResidencyCopy:
    """`kernels/residency.py` is the reference's byte model, copied: every
    function gives the reference's numbers."""

    @pytest.mark.parametrize("tokens,KV,dh,G", [
        (3840, 8, 128, 256), (4096, 8, 128, 256), (256, 1, 64, 16),
        (512, 2, 256, 32), (96, 4, 64, 32)])
    @pytest.mark.parametrize("bits,group", [(8, 1), (8, 32), (4, 1), (4, 64),
                                            (16, 1)])
    def test_equals_the_reference(self, tokens, KV, dh, G, bits, group):
        kw = dict(bits=bits, group=group, chunk_tokens=G)
        for layers in (1, 32):
            got = residency.cache_bytes(tokens, KV, dh, num_layers=layers,
                                        **kw)
            want = ref_residency.cache_bytes(tokens, KV, dh,
                                             num_layers=layers, **kw)
            assert (got.packed_cache, got.scale_bytes, got.fp_cache) == \
                (want.packed_cache, want.scale_bytes, want.fp_cache)
            assert (got.wire_resident, got.composed_peak) == \
                (want.wire_resident, want.composed_peak)
            for peak in (True, False):
                assert residency.residency_ratio(got, peak=peak) == \
                    ref_residency.residency_ratio(want, peak=peak)
            for block_s in (16, 64, 512, 1000):
                assert residency.fused_decode_hbm_reads(
                    got, tokens, chunk_tokens=G, block_s=block_s) == \
                    ref_residency.fused_decode_hbm_reads(
                        want, tokens, chunk_tokens=G, block_s=block_s)
            assert residency.composed_decode_hbm_traffic(got) == \
                ref_residency.composed_decode_hbm_traffic(want)

    def test_rejects_what_the_reference_rejects(self):
        with pytest.raises(AssertionError):
            residency.cache_bytes(100, 8, 128, bits=8, group=1,
                                  chunk_tokens=256)
        with pytest.raises(AssertionError):
            residency.cache_bytes(256, 8, 128, bits=8, group=3,
                                  chunk_tokens=256)
