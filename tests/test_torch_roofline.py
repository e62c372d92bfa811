"""The port's roofline machinery: collective bytes from the functional
collectives DTensor issues (the counterpart of ``tests/test_roofline.py``'s
HLO parsing, on hand-made DTensor programs over a fake process group, with
known byte counts), `CostMode`'s FLOP and byte counts, the term arithmetic
(``TestTerms`` verbatim), and `model_flops` equal to the reference's for
every arch and shape."""
import contextlib

import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import list_archs as ref_list_archs  # noqa: E402
from repro.roofline.analysis import model_flops as ref_model_flops  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.roofline.analysis import (HW, CostMode,  # noqa: E402
                                           collective_bytes_from_log,
                                           floor_terms, model_flops,
                                           roofline_terms)


@contextlib.contextmanager
def fake_mesh(shape, device_type="cpu"):
    """A 1-D or 2-D DeviceMesh over a fake group of its size (rank 0)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        names = ("data", "model")[-len(shape):]
        yield init_device_mesh(device_type, shape, mesh_dim_names=names)
    finally:
        dist.destroy_process_group()


def _dt(mesh, shape, placements, dtype=torch.float32):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, placements, src_data_rank=None)


def _partial(mesh, shape, dtype=torch.float32):
    """A DTensor of ``shape`` whose value is a pending sum over the mesh."""
    from torch.distributed.tensor import DTensor, Partial
    return DTensor.from_local(torch.empty(shape, dtype=dtype, device="meta"),
                              mesh, [Partial()], run_check=False)


class TestCollectiveParsing:
    def test_counts_all_reduce_result_bytes(self):
        from torch.distributed.tensor import Replicate
        with fake_mesh((16,)) as mesh:
            x = _partial(mesh, (128, 16))
            with CostMode() as m:
                x.redistribute(mesh, [Replicate()])
        assert [c[0] for c in m.collectives] == ["all-reduce"]
        assert m.collective_bytes() == 128 * 16 * 4

    def test_all_gather_counts_the_gathered_result(self):
        from torch.distributed.tensor import Replicate, Shard
        with fake_mesh((16,)) as mesh:
            x = _dt(mesh, (128, 64), [Shard(0)], torch.bfloat16)
            with CostMode() as m:
                x.redistribute(mesh, [Replicate()])
        assert [c[0] for c in m.collectives] == ["all-gather"]
        assert m.collective_bytes() == 128 * 64 * 2

    def test_reduce_scatter_scaled_by_group(self):
        from torch.distributed.tensor import Shard
        with fake_mesh((8,)) as mesh:
            x = _partial(mesh, (64, 16))
            with CostMode() as m:
                y = x.redistribute(mesh, [Shard(0)])
        assert tuple(y.to_local().shape) == (8, 16)
        assert [c[0] for c in m.collectives] == ["reduce-scatter"]
        assert m.collective_bytes() == 8 * 16 * 4 * 8

    def test_all_to_all_counts_its_input(self):
        from torch.distributed.tensor import Shard
        with fake_mesh((4,), device_type="cuda") as mesh:
            x = _dt(mesh, (64, 32), [Shard(0)])
            with CostMode() as m:
                x.redistribute(mesh, [Shard(1)])
        assert [c[0] for c in m.collectives] == ["all-to-all"]
        assert m.collective_bytes() == 16 * 32 * 4

    def test_two_axis_mesh_collectives_use_their_group(self):
        """An all-gather over the 4-way 'model' axis of a 2x4 mesh gathers
        4 pieces, not 8."""
        from torch.distributed.tensor import Replicate, Shard
        with fake_mesh((2, 4)) as mesh:
            x = _dt(mesh, (32, 8), [Replicate(), Shard(0)])
            with CostMode() as m:
                x.redistribute(mesh, [Replicate(), Replicate()])
        assert m.collectives == [("all-gather", 8 * 8 * 4, 32 * 8 * 4, 4)]

    def test_local_program_has_no_collectives(self):
        """The counterpart of a one-device module: plain tensors move no
        bytes between devices."""
        with CostMode() as m:
            (torch.ones(8, 8) @ torch.ones(8, 8)).sum()
        assert m.collectives == [] and m.collective_bytes() == 0.0

    def test_log_rule(self):
        log = [("all-reduce", 64, 64, 8), ("all-gather", 16, 128, 8),
               ("reduce-scatter", 128, 16, 8), ("all-to-all", 96, 96, 4),
               ("broadcast", 40, 40, 2)]
        assert collective_bytes_from_log(log) == 64 + 128 + 16 * 8 + 96 + 40
        assert collective_bytes_from_log([]) == 0.0


class TestCostMode:
    def test_matmul_flops_and_bytes(self):
        a, b = torch.ones(32, 64), torch.ones(64, 16)
        with CostMode() as m:
            a @ b
        assert m.flops == 2 * 32 * 64 * 16
        assert m.bytes_accessed == (32 * 64 + 64 * 16 + 32 * 16) * 4

    def test_views_move_no_bytes_and_peak_tracks_live_storage(self):
        x = torch.ones(1024)
        with CostMode() as m:
            y = x.view(32, 32).t()
            z = y + 1  # 4 KiB read, 4 KiB written, held
            w = z * 2  # held too: peak 8 KiB
            del z, w
            v = x + 1  # z and w freed: live 4 KiB again
        assert m.bytes_accessed == 3 * (4096 + 4096)  # the view: none
        assert m.peak_bytes == 8192 and m.live_bytes == 4096
        del v, y

    def test_sharded_matmul_counts_the_local_product(self):
        """The mode sees the local op DTensor runs on rank 0, at the
        shard's shape."""
        from torch.distributed.tensor import Replicate, Shard
        with fake_mesh((4,)) as mesh:
            x = _dt(mesh, (64, 32), [Shard(0)])
            w = _dt(mesh, (32, 16), [Replicate()])
            with CostMode() as m:
                y = x @ w
            assert tuple(y.to_local().shape) == (16, 16)
        assert m.flops == 2 * 16 * 32 * 16
        assert m.collectives == []


class TestTerms:
    def test_bottleneck_selection(self):
        cfg = get_config("qwen3-14b")
        shape = SHAPES["train_4k"]
        r = roofline_terms(cfg, shape, flops_per_dev=1e15, bytes_per_dev=1e9,
                           collective_bytes_per_dev=1e9, n_dev=256)
        assert r["bottleneck"] == "compute"
        r2 = roofline_terms(cfg, shape, flops_per_dev=1e12, bytes_per_dev=1e13,
                            collective_bytes_per_dev=1e9, n_dev=256)
        assert r2["bottleneck"] == "memory"

    def test_model_flops_train_vs_prefill(self):
        cfg = get_config("qwen3-0.6b")
        t = model_flops(cfg, SHAPES["train_4k"])
        p = model_flops(cfg, SHAPES["prefill_32k"])
        # same token count (4096*256 == 32768*32); train is 3x forward
        assert t == pytest.approx(3 * p)

    def test_moe_uses_active_params(self):
        cfg = get_config("qwen3-moe-30b-a3b")
        f = model_flops(cfg, SHAPES["train_4k"])
        n_active = cfg.active_param_count()
        assert f == pytest.approx(6 * n_active * 4096 * 256)
        assert n_active < 0.25 * cfg.param_count()

    def test_perf_fraction_bounded_by_useful_ratio(self):
        cfg = get_config("qwen3-14b")
        shape = SHAPES["train_4k"]
        mf = model_flops(cfg, shape)
        # if counted flops == model flops and compute-bound, fraction == 1
        r = roofline_terms(cfg, shape, flops_per_dev=mf / 256,
                           bytes_per_dev=1.0, collective_bytes_per_dev=1.0,
                           n_dev=256)
        assert r["perf_fraction"] == pytest.approx(1.0)
        assert r["useful_flops_ratio"] == pytest.approx(1.0)

    def test_h100_constants(self):
        assert (HW.peak_flops, HW.hbm_bw, HW.link_bw) == (989e12, 3.35e12,
                                                          50e9)
        r = roofline_terms(get_config("llama3-1-8b"), SHAPES["decode_32k"],
                           989e12, 3.35e12, 50e9, 1)
        assert (r["compute_s"], r["memory_s"], r["collective_s"]) == \
            (1.0, 1.0, 1.0)

    def test_floor_is_moved_bytes_and_useful_flops(self):
        """The floor: the bytes the step must move over HBM bandwidth and
        the useful FLOPs per device over peak, the larger."""
        cfg = get_config("llama3-1-8b")
        dec, pre = SHAPES["decode_32k"], SHAPES["prefill_32k"]
        f = floor_terms(cfg, dec, 3.35e12, 1)
        assert f["floor_memory_s"] == 1.0
        assert f["floor_compute_s"] == model_flops(cfg, dec) / 989e12
        assert (f["step_time_floor_s"], f["floor_bound_by"]) == (1.0, "bytes")
        f = floor_terms(cfg, pre, 1.0, 256)
        assert f["step_time_floor_s"] == f["floor_compute_s"] == \
            model_flops(cfg, pre) / 256 / 989e12
        assert f["floor_bound_by"] == "operations"


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ref_list_archs(include_extra=True))
def test_model_flops_equal_reference(arch, shape):
    assert model_flops(get_config(arch), SHAPES[shape]) == \
        ref_model_flops(ref_get_config(arch), REF_SHAPES[shape])
