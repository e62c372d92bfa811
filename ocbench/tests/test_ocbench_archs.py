"""The architecture of a configuration is found by name: the one module
under ``archs/`` whose ``ARCHITECTURES`` lists the class the configuration
names first.  A new architecture is taken by new files alone; a class no
module lists, a class two modules list, and a configuration that names none
are each refused with the classes that are known."""
import json
import shutil
from pathlib import Path

import pytest

from ocbench import archs, counts, harness, weights
from ocbench.reference import qwen3 as qwen3_reference

HERE = Path(__file__).resolve().parent.parent
TOY = '''
ARCHITECTURES = ("ToyForCausalLM",)
REFERENCE = "qwen3"


def program_config(cfg):
    return ("toy", cfg["hidden_size"])


def weight_shapes(cfg):
    import torch
    d = cfg["hidden_size"]
    return {"a": ((3, d), torch.float32, 0.0, 1.0),
            "b": {"c": ((d,), torch.float32, 1.0, 0.1)}}


def active_nonembed_params(cfg):
    return 7 * cfg["hidden_size"]


def prefill_flops(cfg, prefix_len, computed):
    return 2.0 * active_nonembed_params(cfg) * computed + prefix_len


def kv_tensors(cfg):
    return 5, [cfg["hidden_size"] + 4]
'''
TOY_CFG = {"name": "toy", "architectures": ["ToyForCausalLM"],
           "hidden_size": 8, "chunk_tokens": 4, "codec": "identity"}


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


@pytest.fixture
def arch_dir(tmp_path, monkeypatch):
    """A search path holding a copy of the Qwen3 module."""
    shutil.copy(HERE / "archs" / "qwen3.py", tmp_path)
    monkeypatch.setattr(archs, "DIR", tmp_path)
    return tmp_path


@pytest.mark.parametrize("path", sorted((HERE / "configs").glob("*.json")),
                         ids=lambda p: p.stem)
def test_each_configuration_has_one_architecture(path):
    cfg = json.loads(path.read_text())
    assert cfg["architectures"][0] in archs.of(cfg).ARCHITECTURES


def test_a_new_architecture_is_taken_by_new_files_alone(arch_dir):
    (arch_dir / "toy.py").write_text(TOY)
    cfg = dict(TOY_CFG)
    assert harness.model_config(cfg) == ("toy", 8)
    assert list(weights.shapes(cfg)) == ["a", "b"]
    w = weights.make(cfg, 3, "cpu")
    assert w["a"].shape == (3, 8) and w["b"]["c"].shape == (8,)
    assert counts.active_nonembed_params(cfg) == 56
    assert counts.prefill_flops(cfg, 10, 2) == 234.0
    # the codec's arithmetic over the one 12-wide tensor of each of 5 layers
    assert counts.wire_chunk_bytes(cfg) == 5 * 4 * 12 * 2
    assert counts.wire_chunk_bytes(dict(cfg, codec="int8")) == \
        5 * (12 * 2 + 4 * 12)
    assert archs.reference(cfg) is qwen3_reference
    # the architectures already there are still found
    assert counts.wire_chunk_bytes(config("qwen3-14b.packed-int8")) == \
        21135360


def test_an_unknown_class_names_the_known_ones(arch_dir):
    with pytest.raises(ValueError, match="ToyForCausalLM.*none") as e:
        archs.of(TOY_CFG)
    assert "'Qwen3ForCausalLM', 'Qwen3MoeForCausalLM'" in str(e.value)


def test_two_modules_claiming_one_class_fail(arch_dir):
    shutil.copy(arch_dir / "qwen3.py", arch_dir / "qwen3_again.py")
    with pytest.raises(ValueError, match="2 modules") as e:
        weights.shapes(config("qwen3-14b.packed-int8"))
    assert "qwen3.py, qwen3_again.py" in str(e.value)
    assert "Qwen3MoeForCausalLM" in str(e.value)


def test_a_configuration_naming_no_architecture_fails(arch_dir):
    cfg = config("qwen3-14b.packed-int8")
    del cfg["architectures"]
    with pytest.raises(ValueError, match="no 'architectures'") as e:
        counts.prefill_flops(cfg, 0, 1)
    assert "'Qwen3ForCausalLM', 'Qwen3MoeForCausalLM'" in str(e.value)
