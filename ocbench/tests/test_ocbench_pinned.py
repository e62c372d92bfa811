"""What the yardstick reads of each configuration, pinned as literals from
the readings of the harness before its architecture code moved into
``archs/``: the two files under ``configs/`` and the two smoke
configurations.  The weight tree in draw order with each leaf's shape,
dtype, mean and std; every field of the program's ``ModelConfig``; the
parameters, FLOPs and wire bytes; and, at the smoke sizes, the weights that
one seed draws on the CPU, by a digest of each leaf's bytes."""
import dataclasses
import hashlib
import json
from pathlib import Path

import pytest
import torch

from ocbench import counts, harness, weights
from ocbench.tests.smoke import DENSE, MOE

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
SEED = 2**31 + 5


def config(name):
    if name == "dense-smoke":
        return dict(DENSE)
    if name == "moe-smoke":
        return dict(MOE)
    return json.loads((CONFIGS / f"{name}.json").read_text())


def flat(node, path=()):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from flat(v, path + (k,))
    else:
        yield "/".join(path), node


SHAPES = {
    "qwen3-14b.packed-int8": [
        ("embed/table", (152064, 5120), "bfloat16", 0.0, 0.02),
        ("embed/unembed", (152064, 5120), "bfloat16", 0.0, 0.02),
        ("layers/ln1/scale", (40, 5120), "bfloat16", 1.0, 0.1),
        ("layers/attn/wq/w", (40, 5120, 5120), "bfloat16", 0.0,
         0.013975424859373685),
        ("layers/attn/wk/w", (40, 5120, 1024), "bfloat16", 0.0,
         0.013975424859373685),
        ("layers/attn/wv/w", (40, 5120, 1024), "bfloat16", 0.0,
         0.013975424859373685),
        ("layers/attn/wo/w", (40, 5120, 5120), "bfloat16", 0.0,
         0.013975424859373685),
        ("layers/attn/q_norm/scale", (40, 128), "bfloat16", 1.0, 0.1),
        ("layers/attn/k_norm/scale", (40, 128), "bfloat16", 1.0, 0.1),
        ("layers/ln2/scale", (40, 5120), "bfloat16", 1.0, 0.1),
        ("layers/mlp/wi_gate/w", (40, 5120, 17408), "bfloat16", 0.0,
         0.013975424859373685),
        ("layers/mlp/wi_up/w", (40, 5120, 17408), "bfloat16", 0.0,
         0.013975424859373685),
        ("layers/mlp/wo/w", (40, 17408, 5120), "bfloat16", 0.0,
         0.007579238282385405),
        ("final_norm/scale", (5120,), "bfloat16", 1.0, 0.1),
    ],
    "qwen3-30b-a3b.identity": [
        ("embed/table", (152064, 2048), "bfloat16", 0.0, 0.02),
        ("embed/unembed", (152064, 2048), "bfloat16", 0.0, 0.02),
        ("layers/ln1/scale", (48, 2048), "bfloat16", 1.0, 0.1),
        ("layers/attn/wq/w", (48, 2048, 4096), "bfloat16", 0.0,
         0.02209708691207961),
        ("layers/attn/wk/w", (48, 2048, 512), "bfloat16", 0.0,
         0.02209708691207961),
        ("layers/attn/wv/w", (48, 2048, 512), "bfloat16", 0.0,
         0.02209708691207961),
        ("layers/attn/wo/w", (48, 4096, 2048), "bfloat16", 0.0, 0.015625),
        ("layers/attn/q_norm/scale", (48, 128), "bfloat16", 1.0, 0.1),
        ("layers/attn/k_norm/scale", (48, 128), "bfloat16", 1.0, 0.1),
        ("layers/ln2/scale", (48, 2048), "bfloat16", 1.0, 0.1),
        ("layers/moe/router", (48, 2048, 128), "float32", 0.0,
         0.02209708691207961),
        ("layers/moe/wi_gate", (48, 128, 2048, 768), "bfloat16", 0.0,
         0.02209708691207961),
        ("layers/moe/wi_up", (48, 128, 2048, 768), "bfloat16", 0.0,
         0.02209708691207961),
        ("layers/moe/wo", (48, 128, 768, 2048), "bfloat16", 0.0,
         0.03608439182435161),
        ("final_norm/scale", (2048,), "bfloat16", 1.0, 0.1),
    ],
    "dense-smoke": [
        ("embed/table", (256, 96), "float32", 0.0, 0.02),
        ("embed/unembed", (256, 96), "float32", 0.0, 0.02),
        ("layers/ln1/scale", (3, 96), "float32", 1.0, 0.1),
        ("layers/attn/wq/w", (3, 96, 96), "float32", 0.0, 0.10206207261596575),
        ("layers/attn/wk/w", (3, 96, 32), "float32", 0.0, 0.10206207261596575),
        ("layers/attn/wv/w", (3, 96, 32), "float32", 0.0, 0.10206207261596575),
        ("layers/attn/wo/w", (3, 96, 96), "float32", 0.0, 0.10206207261596575),
        ("layers/attn/q_norm/scale", (3, 16), "float32", 1.0, 0.1),
        ("layers/attn/k_norm/scale", (3, 16), "float32", 1.0, 0.1),
        ("layers/ln2/scale", (3, 96), "float32", 1.0, 0.1),
        ("layers/mlp/wi_gate/w", (3, 96, 192), "float32", 0.0,
         0.10206207261596575),
        ("layers/mlp/wi_up/w", (3, 96, 192), "float32", 0.0,
         0.10206207261596575),
        ("layers/mlp/wo/w", (3, 192, 96), "float32", 0.0, 0.07216878364870322),
        ("final_norm/scale", (96,), "float32", 1.0, 0.1),
    ],
    "moe-smoke": [
        ("embed/table", (256, 64), "float32", 0.0, 0.02),
        ("embed/unembed", (256, 64), "float32", 0.0, 0.02),
        ("layers/ln1/scale", (2, 64), "float32", 1.0, 0.1),
        ("layers/attn/wq/w", (2, 64, 64), "float32", 0.0, 0.125),
        ("layers/attn/wk/w", (2, 64, 32), "float32", 0.0, 0.125),
        ("layers/attn/wv/w", (2, 64, 32), "float32", 0.0, 0.125),
        ("layers/attn/wo/w", (2, 64, 64), "float32", 0.0, 0.125),
        ("layers/attn/q_norm/scale", (2, 16), "float32", 1.0, 0.1),
        ("layers/attn/k_norm/scale", (2, 16), "float32", 1.0, 0.1),
        ("layers/ln2/scale", (2, 64), "float32", 1.0, 0.1),
        ("layers/moe/router", (2, 64, 8), "float32", 0.0, 0.125),
        ("layers/moe/wi_gate", (2, 8, 64, 32), "float32", 0.0, 0.125),
        ("layers/moe/wi_up", (2, 8, 64, 32), "float32", 0.0, 0.125),
        ("layers/moe/wo", (2, 8, 32, 64), "float32", 0.0, 0.1767766952966369),
        ("final_norm/scale", (64,), "float32", 1.0, 0.1),
    ],
}
COMMON = {
    "qk_norm": True,
    "mlp_kind": "swiglu",
    "rope_theta": 1000000.0,
    "embed_scale": False,
    "tie_embeddings": False,
    "logit_softcap": 0.0,
    "moe_every": 1,
    "shared_expert_d_ff": 0,
    "capacity_factor": 1.25,
    "ssm_state": 0,
    "ssm_headdim": 64,
    "ssm_conv": 4,
    "ssm_expand": 2,
    "ssm_chunk": 128,
    "shared_attn_every": 0,
    "encoder_layers": 0,
    "decoder_train_len": 256,
    "cross_kv_len": 1500,
    "num_patches": 0,
    "attn_impl": "naive",
    "attn_block_k": 512,
    "attn_seq_shard": False,
    "decode_impl": "naive",
    "decode_blocks": 16,
    "subquadratic": False,
}
OWN = {
    "qwen3-14b.packed-int8": {
        "name": "qwen3-14b",
        "family": "dense",
        "num_layers": 40,
        "d_model": 5120,
        "num_heads": 40,
        "num_kv_heads": 8,
        "head_dim": 128,
        "d_ff": 17408,
        "vocab_size": 151936,
        "num_experts": 0,
        "experts_per_token": 0,
        "moe_d_ff": 0,
        "param_dtype": "bfloat16",
        "compute_dtype": "bfloat16",
    },
    "qwen3-30b-a3b.identity": {
        "name": "qwen3-moe-30b-a3b",
        "family": "moe",
        "num_layers": 48,
        "d_model": 2048,
        "num_heads": 32,
        "num_kv_heads": 4,
        "head_dim": 128,
        "d_ff": 0,
        "vocab_size": 151936,
        "num_experts": 128,
        "experts_per_token": 8,
        "moe_d_ff": 768,
        "param_dtype": "bfloat16",
        "compute_dtype": "bfloat16",
    },
    "dense-smoke": {
        "name": "qwen3-14b",
        "family": "dense",
        "num_layers": 3,
        "d_model": 96,
        "num_heads": 6,
        "num_kv_heads": 2,
        "head_dim": 16,
        "d_ff": 192,
        "vocab_size": 256,
        "num_experts": 0,
        "experts_per_token": 0,
        "moe_d_ff": 0,
        "param_dtype": "float32",
        "compute_dtype": "float32",
    },
    "moe-smoke": {
        "name": "qwen3-moe-30b-a3b",
        "family": "moe",
        "num_layers": 2,
        "d_model": 64,
        "num_heads": 4,
        "num_kv_heads": 2,
        "head_dim": 16,
        "d_ff": 0,
        "vocab_size": 256,
        "num_experts": 8,
        "experts_per_token": 2,
        "moe_d_ff": 32,
        "param_dtype": "float32",
        "compute_dtype": "float32",
    },
}
PARAMS = {
    "qwen3-14b.packed-int8": 13212057600,
    "qwen3-30b-a3b.identity": 2730491904,
    "dense-smoke": 239616,
    "moe-smoke": 50176,
}
FLOPS = {
    "qwen3-14b.packed-int8": {
        (0, 1): 27980759040.0,
        (0, 2): 54406512640.0,
        (0, 256): 6793077719040.0,
        (0, 2048): 55836969533440.0,
        (256, 1): 28190474240.0,
        (256, 256): 6846764810240.0,
        (1024, 512): 14067783434240.0,
        (3840, 256): 7598384087040.0,
        (7936, 256): 8457377546240.0,
    },
    "qwen3-30b-a3b.identity": {
        (0, 1): 6084100096.0,
        (0, 2): 11546656768.0,
        (0, 256): 1424504651776.0,
        (0, 2048): 12834789916672.0,
        (256, 1): 6285426688.0,
        (256, 256): 1476044259328.0,
        (1024, 512): 3312243441664.0,
        (3840, 256): 2197598765056.0,
        (7936, 256): 3022232485888.0,
    },
    "dense-smoke": {
        (0, 1): 529536.0,
        (0, 2): 1011072.0,
        (0, 256): 160628736.0,
        (0, 2048): 3398615040.0,
        (256, 1): 824448.0,
        (256, 256): 236126208.0,
        (1024, 512): 1000685568.0,
        (3840, 256): 1293090816.0,
        (7936, 256): 2501050368.0,
    },
    "moe-smoke": {
        (0, 1): 133632.0,
        (0, 2): 235008.0,
        (0, 256): 42565632.0,
        (0, 2048): 1279819776.0,
        (256, 1): 264704.0,
        (256, 256): 76120064.0,
        (1024, 512): 387088384.0,
        (3840, 256): 545882112.0,
        (7936, 256): 1082753024.0,
    },
}
WIRE = {
    "qwen3-14b.packed-int8": 21135360,
    "qwen3-30b-a3b.identity": 25165824,
    "dense-smoke": 3456,
    "moe-smoke": 4096,
}
DIGESTS = {
    "dense-smoke": [
        ("embed/table", "77d353c3784bce11"),
        ("embed/unembed", "4a1faddb105537e7"),
        ("layers/ln1/scale", "443d79e7d02b9581"),
        ("layers/attn/wq/w", "c74c5b85bf29b721"),
        ("layers/attn/wk/w", "9c165134634c71d9"),
        ("layers/attn/wv/w", "4bd589260a15b2ef"),
        ("layers/attn/wo/w", "b727ad112f0da7fd"),
        ("layers/attn/q_norm/scale", "e67f35fd48717955"),
        ("layers/attn/k_norm/scale", "65db8cb333a1fff2"),
        ("layers/ln2/scale", "4aa8a0fea0e30641"),
        ("layers/mlp/wi_gate/w", "5468c8a230587120"),
        ("layers/mlp/wi_up/w", "3ac098b9683b8b0c"),
        ("layers/mlp/wo/w", "7c3071b2db143a25"),
        ("final_norm/scale", "03fc1089726336be"),
    ],
    "moe-smoke": [
        ("embed/table", "0d667623d23e20a1"),
        ("embed/unembed", "62d1879e08724376"),
        ("layers/ln1/scale", "647bf66b993931b4"),
        ("layers/attn/wq/w", "b3a99d81f3a99786"),
        ("layers/attn/wk/w", "7a33277fe110c7a4"),
        ("layers/attn/wv/w", "9941f193e80c0cb5"),
        ("layers/attn/wo/w", "7a1b71e0dc2e6409"),
        ("layers/attn/q_norm/scale", "c5e0e5dd18abefda"),
        ("layers/attn/k_norm/scale", "1283959ebafe5f06"),
        ("layers/ln2/scale", "8be5e7b0aa78b5fe"),
        ("layers/moe/router", "dc8e903fa7c89f47"),
        ("layers/moe/wi_gate", "4f0a6e2d48685c14"),
        ("layers/moe/wi_up", "3a38ae4587472348"),
        ("layers/moe/wo", "7bf61669ce94c0f2"),
        ("final_norm/scale", "91bdccf9b78aec63"),
    ],
}


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_the_weight_tree_in_draw_order(name):
    got = [(p, tuple(s), str(dt).removeprefix("torch."), mean, std)
           for p, (s, dt, mean, std) in flat(weights.shapes(config(name)))]
    assert got == SHAPES[name]


@pytest.mark.parametrize("name", sorted(OWN))
def test_every_field_of_the_program_config(name):
    got = dataclasses.asdict(harness.model_config(config(name)))
    assert got == dict(COMMON, **OWN[name])


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_parameters_and_prefill_flops(name):
    cfg = config(name)
    assert counts.active_nonembed_params(cfg) == PARAMS[name]
    assert {g: counts.prefill_flops(cfg, *g) for g in FLOPS[name]} == \
        FLOPS[name]


@pytest.mark.parametrize("name", sorted(WIRE))
def test_wire_chunk_bytes(name):
    assert counts.wire_chunk_bytes(config(name)) == WIRE[name]


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_smoke_weights_drawn_from_one_seed(name):
    got = [(p, hashlib.sha256(t.contiguous().view(torch.uint8).numpy()
                              .tobytes()).hexdigest()[:16])
           for p, t in flat(weights.make(config(name), SEED, "cpu"))]
    assert got == DIGESTS[name]
