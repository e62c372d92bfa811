"""The port's sharding rules against the reference's.

For every arch of ``list_archs()`` at its FULL config, on the debug (2x4),
pod (16x16) and multipod (2x16x16) meshes, every parameter leaf's spec and
every decode-cache leaf's spec (decode_32k's B=128 and long_500k's B=1)
equal the reference's ``PartitionSpec``, as tuples.  The port's meshes are
``DeviceMesh``es over a fake process group of as many ranks (torch's
``FakeStore``, nothing is sent), the reference's ``AbstractMesh``es of the
same shape.  Then: the fallback cases, specs -> placements, and the local
shard shapes `distribute` gives.
"""
import contextlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_sh  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config, input_specs, list_archs  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

MESHES = {"debug": ((2, 4), ("data", "model")),
          "pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_mesh(kind):
    """A DeviceMesh of ``kind`` over a fake group of as many ranks (rank 0),
    torn down on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, _ = MESHES[kind]
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(np.prod(shape)))
    try:
        if kind == "debug":
            yield make_debug_mesh(2, 4, device_type="cpu")
        else:
            yield make_production_mesh(multi_pod=kind == "multipod",
                                       device_type="cpu")
    finally:
        dist.destroy_process_group()


def _ref_mesh(kind):
    shape, names = MESHES[kind]
    return AbstractMesh(shape, names)


def _norm(spec):
    """A spec as a tuple, a one-name tuple entry as the name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else
                 (tuple(e) if isinstance(e, tuple) else e) for e in spec)


def _ref_specs(tree_of_shardings):
    return jax.tree_util.tree_flatten_with_path(
        tree_of_shardings, is_leaf=lambda x: hasattr(x, "spec"))[0]


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _port_leaves(tree[k], path + (k,))
        return out
    return [(path, tree)]


def _assert_same(port_tree, ref_pairs):
    port = dict(_port_leaves(port_tree))
    ref = {tuple(getattr(k, "key", str(k)) for k in path): s.spec
           for path, s in ref_pairs}
    assert set(port) == set(ref)
    bad = {p: (_norm(port[p]), _norm(ref[p])) for p in ref
           if _norm(port[p]) != _norm(ref[p])}
    assert not bad, bad


@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_param_specs_match_reference(arch, kind):
    ref_model = ref_build_model(ref_get_config(arch))
    ref_params = jax.eval_shape(
        lambda: ref_model.init_params(jax.random.PRNGKey(0)))
    want = _ref_specs(ref_sh.param_shardings(ref_params, _ref_mesh(kind)))
    params = build_model(get_config(arch), "meta").param_spec()
    with fake_mesh(kind) as mesh:
        _assert_same(sh.param_pspecs(params, mesh), want)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("kind", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_reference(arch, kind, shape_name):
    from repro.configs import input_specs as ref_input_specs
    ref_cache = ref_input_specs(ref_get_config(arch), shape_name)["cache"]
    want = _ref_specs(ref_sh.cache_shardings(ref_cache, _ref_mesh(kind)))
    cache = input_specs(get_config(arch), shape_name)["cache"]
    with fake_mesh(kind) as mesh:
        _assert_same(sh.cache_pspecs(cache, mesh), want)


class TestFallback:
    @pytest.mark.parametrize("kind", ["pod", "multipod"])
    def test_batch_one_decode_puts_sequence_on_all_axes(self, kind):
        shape = (32, 2, 1, 524288, 8, 128)
        want = ref_sh._cache_rule(("cache",), shape, _ref_mesh(kind))
        with fake_mesh(kind) as mesh:
            got = sh._cache_rule(("cache",), shape, mesh)
            assert _norm(got) == _norm(want)
            seq = got[3] if isinstance(got[3], tuple) else (got[3],)
            assert seq == sh.data_axes(mesh) + ("model",)

    @pytest.mark.parametrize("shape,logical", [
        ((9 * 64, 576), ("model", "data")),     # 9 heads x 64 rows
        ((40, 4096), ("model", "data")),        # 40 heads
        ((2, 4096, 24), (None, "data", "model")),
        ((128, 2048, 768), ("model", "data", None)),
        ((3, 1152), (None, "model")),
    ])
    def test_non_divisible_dims_stay_replicated(self, shape, logical):
        want = ref_sh.logical_pspec(shape, logical, _ref_mesh("pod"))
        with fake_mesh("pod") as mesh:
            got = sh.logical_pspec(shape, logical, mesh)
        assert _norm(got) == _norm(want)

    def test_batch_spec(self):
        for kind in MESHES:
            for shape in [(256, 4096), (1, 8), (32, 16, 8)]:
                want = ref_sh.batch_pspec(shape, _ref_mesh(kind))
                with fake_mesh(kind) as mesh:
                    assert _norm(sh.batch_pspec(shape, mesh)) == _norm(want)


class TestPlacements:
    def test_multi_axis_dim_is_sharded_in_mesh_order(self):
        from torch.distributed.tensor import Replicate, Shard
        with fake_mesh("multipod") as mesh:
            pl = sh.spec_placements((None, ("pod", "data"), "model"), mesh)
            assert pl == (Shard(1), Shard(1), Shard(2))
            assert sh.spec_placements((), mesh) == (Replicate(),) * 3
            with pytest.raises(ValueError):
                sh.spec_placements((("model", "data"),), mesh)

    def test_distribute_keeps_local_shards(self):
        params = build_model(get_config("llama3-1-8b"), "meta").param_spec()
        with fake_mesh("pod") as mesh:
            shardings = sh.param_shardings(params, mesh)
            placed = sh.distribute(params, shardings)
            wq = placed["layers"]["attn"]["wq"]["w"]
            assert tuple(wq.shape) == (32, 4096, 4096)
            assert tuple(wq.to_local().shape) == (32, 256, 256)
            table = placed["embed"]["table"]
            assert tuple(table.to_local().shape) == (128256 // 16, 4096 // 16)
            scale = placed["final_norm"]["scale"]
            assert tuple(scale.to_local().shape) == (4096,)
