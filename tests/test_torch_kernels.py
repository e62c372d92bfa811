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
from repro_torch.kernels import launches, ops  # noqa: E402

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
# the widths W = KV * dh of the repo's configs (smollm 192, gemma-2b 256,
# llama3-1-8b / qwen3 / internvl2 1024, whisper 1280, zamba2 2048) and
# ragged ones (20, 24, 40, 1030), each with the groups of GROUPS that divide
# it
CONFIG_WIDTHS = (192, 256, 1024, 1280, 2048)
RAGGED_WIDTHS = (20, 24, 40, 1030)
GROUPS = (1, 2, 3, 8, 64, 128)
WIDTH_CASES = [(W, g) for W in CONFIG_WIDTHS + RAGGED_WIDTHS for g in GROUPS
               if W % g == 0]


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


    @pytest.mark.parametrize("out", ["float32", "bfloat16"])
    @pytest.mark.parametrize("W,group", WIDTH_CASES)
    @pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
    def test_exact_at_config_widths(self, packed, W, group, out):
        self.test_exact(packed, (2, 3, W), group, out)


class TestDequantPlan:
    """K1/K2's launch geometry (`dequant_plan`), plain Python: the threads
    of the grid write every (n, r, c) exactly once, on the vector path
    exactly where the unit of 8 channels is whole and the plan's ``vec``
    holds."""

    @staticmethod
    def _written(plan, R, W):
        """How often each (r, c) of one chunk is written, and by which
        path: counts [R, W] and vector [R, W] (every chunk n is blockIdx.x,
        so each has the same map)."""
        count = np.zeros((R, W), dtype=np.int64)
        vector = np.zeros((R, W), dtype=bool)
        for slab in range(plan.slabs):
            for ty in range(plan.threads_y):
                rows = plan.rows_of(slab, ty, R)
                assert len(rows) <= plan.rows
                for sb in range(plan.strip_blocks):
                    for tx in range(plan.threads_x):
                        units = plan.channels(sb, tx, W)
                        assert sum(len(c) for c, _ in units) <= plan.strip
                        for chans, vec in units:
                            for r in rows:
                                count[r, chans.start:chans.stop] += 1
                                vector[r, chans.start:chans.stop] = vec
        return count, vector

    @pytest.mark.parametrize("W", CONFIG_WIDTHS + RAGGED_WIDTHS)
    @pytest.mark.parametrize("N,R", [(15, 256), (3, 5), (1, 1), (2, 1000)])
    def test_every_output_written_once(self, N, R, W):
        plan = K.dequant_plan(N, R, W, 0, 256, 4096)
        assert plan.grid(N)[0] == N
        assert plan.threads_x * plan.threads_y <= K.DEQUANT_THREADS
        assert max(plan.slabs, plan.strip_blocks) <= K.MAX_GRID_YZ
        assert plan.strip == K.DEQUANT_STRIP
        count, vector = self._written(plan, R, W)
        assert (count == 1).all()
        assert plan.vec == (W % K.DEQUANT_UNIT == 0)
        assert (vector == plan.vec).all()

    @pytest.mark.parametrize("W", CONFIG_WIDTHS)
    def test_misaligned_pointer_takes_the_per_element_path(self, W):
        for ptrs in ((1, 0, 0), (0, 2, 0), (0, 0, 8)):
            plan = K.dequant_plan(2, 4, W, *ptrs)
            assert not plan.vec
            count, vector = self._written(plan, 4, W)
            assert (count == 1).all() and not vector.any()

    @pytest.mark.parametrize("W", CONFIG_WIDTHS)
    def test_serving_widths_fit_one_wave(self, W):
        """At the served path's 15 chunks of 256 tokens every CTA is
        resident at once, each thread walking at least MIN_ROWS rows."""
        plan = K.dequant_plan(15, 256, W, 0, 0, 0)
        ctas = 15 * plan.slabs * plan.strip_blocks
        assert ctas <= K.H100_SMS * K.DEQUANT_CTAS_PER_SM
        assert K.MIN_ROWS <= plan.rows <= K.MAX_ROWS

    def test_serving_shape(self):
        """llama3-1-8b's layer payload (15 chunks, 256 tokens, W 1024): K1
        and K2 alike, 64 x 4 threads a CTA, 2 rows each, 480 CTAs."""
        p = K.dequant_plan(15, 256, 1024, 0, 0, 0)
        assert (p.threads_x, p.threads_y, p.rows, p.grid(15)) \
            == (64, 4, 2, (15, 32, 1))
        assert p.vec

    def test_many_rows_take_several_waves(self):
        """Past MAX_ROWS a thread, the grid grows instead; past a grid
        dimension's slabs, the rows grow."""
        plan = K.dequant_plan(64, 4096, 1024, 0, 0, 0)
        assert plan.rows == K.MAX_ROWS
        tall = K.dequant_plan(1, 1 << 29, 16, 0, 0, 0)
        assert tall.slabs <= K.MAX_GRID_YZ
        assert tall.rows > K.MAX_ROWS
        assert tall.slabs * tall.threads_y * tall.rows >= 1 << 29


class TestDispatch:
    @pytest.mark.parametrize("packed", [False, True], ids=["int8", "int4"])
    def test_cpu_tensor_takes_plain_version(self, packed):
        launches.reset()
        q, s = _inputs(0, 2, 4, 32, 8, packed)
        q, s = torch.from_numpy(q), torch.from_numpy(s)
        op = ops.kv_dequant_packed4_op if packed else ops.kv_dequant_op
        plain = K.kv_dequant_packed4_ref if packed else K.kv_dequant_ref
        got = op(q, s, group=8, out_dtype=torch.bfloat16)
        assert torch.equal(got, plain(q, s, group=8,
                                      out_dtype=torch.bfloat16))
        assert set(launches.LAUNCHES) >= {"kv_dequant", "kv_dequant_packed4"}
        assert all(n == 0 for n in launches.LAUNCHES.values())

    @pytest.mark.parametrize("kernel", [K.kv_dequant, K.kv_dequant_packed4])
    def test_kernel_wrapper_refuses_cpu_tensors(self, kernel):
        packed = kernel is K.kv_dequant_packed4
        q, s = _inputs(1, 1, 2, 32, 1, packed)
        with pytest.raises(ValueError, match="CUDA"):
            kernel(torch.from_numpy(q), torch.from_numpy(s))
        assert launches.LAUNCHES[kernel.__name__] == 0


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
