"""The port stands alone: importing ``repro_torch`` and every submodule
loads neither JAX nor the reference package, and no file of the port (or
``chip_smoke.py``) imports them."""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "src", "repro_torch")

_IMPORTS_ALL = r"""
import pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    __import__(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), "modules;", "loaded:", bad)
sys.exit(1 if bad else 0)
"""


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_import_loads_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORTS_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 105, out.stdout  # every subpackage was walked


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s))", re.MULTILINE)


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_reference(path):
    with open(path, encoding="utf-8") as f:
        hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(f.read())]
    assert not hits, hits


# A serving process: the serving stack imported, an engine built, the
# parameter tree's spec taken (as a benchmark's set-up checks it), a cold
# request and a warm layerwise hit over its prefix; then the modules that
# only training, a mesh or a compiler need must not be loaded.
_SERVES_LIGHT = r"""
import sys
import numpy as np
import torch
import repro_torch.serving
import repro_torch.models.api
from repro_torch import core
from repro_torch.configs import get_smoke_config
from repro_torch.core import Delivery
from repro_torch.models import build_model
from repro_torch.serving import Orchestrator, ServingEngine

arch, device = sys.argv[1], sys.argv[2]
G = 16
model = build_model(get_smoke_config(arch), device=device)
spec_tree = model.param_spec()
params = model.init_params(torch.Generator(model.device).manual_seed(0))
spec = model.cfg.kv_spec(G, dtype_bytes=4, codec="identity")
orch = Orchestrator(core.RadixIndex(G), core.Gateway(core.InMemoryStore()),
                    spec, theta_bytes=0)
engine = ServingEngine(model, params, orch)
rng = np.random.default_rng(0)
vocab = model.cfg.vocab_size
shared = rng.integers(0, vocab, size=3 * G)
cold = engine.submit(np.concatenate([shared, rng.integers(0, vocab, 5)]),
                     "cold")
warm = engine.submit(np.concatenate([shared, rng.integers(0, vocab, 9)]),
                     "warm")
assert not cold.hit, cold
assert warm.delivery is Delivery.LAYERWISE, warm.delivery
assert warm.matched_tokens == 3 * G, warm.matched_tokens
heavy = ("torch._dynamo", "torch.distributed.tensor", "sympy")
print("loaded:", sorted(m for m in heavy if m in sys.modules))
"""

_SERVED_ARCHS = ["qwen3-14b", "qwen3-moe-30b-a3b", "deepseek-v2-lite"]


def _serves_light(arch, device):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _SERVES_LIGHT, arch, device],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.split("\n")[-2] == "loaded: []", out.stdout


@pytest.mark.parametrize("arch", _SERVED_ARCHS)
def test_serving_loads_no_compiler_mesh_or_sympy(arch):
    """The dense, MoE and latent-attention families serve on the CPU
    without ``torch._dynamo``, ``torch.distributed.tensor`` or ``sympy``."""
    _serves_light(arch, "cpu")


@pytest.mark.cuda
def test_serving_loads_no_compiler_mesh_or_sympy_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for arch in _SERVED_ARCHS:
        _serves_light(arch, "cuda")


# A DTensor's names in `layers` and `moe`, with torch.distributed.tensor
# imported before the model modules or after them (then the model modules'
# import must not have loaded it).
_BINDS_DTENSOR = r"""
import sys
order = sys.argv[1]
if order == "before":
    import torch.distributed.tensor  # noqa: F401
from repro_torch.models import layers, moe
assert order == "before" or "torch.distributed.tensor" not in sys.modules
import torch
import torch.distributed as dist
import torch.distributed.tensor as dt
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
mesh = dist.device_mesh.init_device_mesh("cpu", (2,),
                                         mesh_dim_names=("data",))
w = dt.distribute_tensor(torch.ones(4, 2), mesh, [dt.Shard(0)])
plain = torch.ones(4, 2)
assert isinstance(w, layers.DTensor) and not isinstance(plain, layers.DTensor)
assert (layers.DTensor, layers.Partial, layers.Replicate, layers.Shard) == (
    dt.DTensor, dt.Partial, dt.Replicate, dt.Shard)
assert layers.gather_fsdp(w).placements == (dt.Replicate(),)
assert layers.gather_fsdp(plain) is plain
# moe's checks read layers' names: a DTensor takes its comparison branch
topi = torch.tensor([[0, 1], [1, 2]])
from torch.distributed.tensor.experimental import implicit_replication
with implicit_replication():  # as the sharded steps run the model
    counts = moe._expert_counts(
        dt.distribute_tensor(topi, mesh, [dt.Replicate()]), 3)
assert isinstance(counts, dt.DTensor), type(counts)
assert counts.to_local().tolist() == [1, 2, 1]
assert moe._expert_counts(topi, 3).tolist() == [1, 2, 1]
dist.destroy_process_group()
"""


@pytest.mark.parametrize("order", ["before", "after"])
def test_dtensor_checks_once_its_module_is_imported(order):
    """Once ``torch.distributed.tensor`` is imported, whether before the
    model modules or after, their DTensor checks hold for a DTensor and
    not for a plain tensor, and their placements are its own."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _BINDS_DTENSOR, order],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
