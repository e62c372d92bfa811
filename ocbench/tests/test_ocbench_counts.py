"""The yardstick's FLOP and byte counts against sums worked by hand."""
import json
from pathlib import Path

import pytest

from ocbench import counts

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_qwen3_14b_parameters():
    cfg = config("qwen3-14b.packed-int8")
    # q and o: 5120 x 5120 each; k and v: 5120 x 1024 each; MLP 3 x 5120 x
    # 17408; 40 layers
    per_layer = 2 * 5120 * 5120 + 2 * 5120 * 1024 + 3 * 5120 * 17408
    assert counts.active_nonembed_params(cfg) == 40 * per_layer
    assert abs(40 * per_layer - 13.21e9) < 0.01e9


def test_qwen3_30b_a3b_active_parameters():
    cfg = config("qwen3-30b-a3b.identity")
    # q and o: 2048 x 4096 each; k and v: 2048 x 512 each; router 2048 x
    # 128; eight experts of 3 x 2048 x 768; 48 layers
    per_layer = 2 * 2048 * 4096 + 2 * 2048 * 512 + 2048 * 128 \
        + 8 * 3 * 2048 * 768
    assert counts.active_nonembed_params(cfg) == 48 * per_layer


def test_prefill_flops_by_hand():
    cfg = config("qwen3-14b.packed-int8")
    N = counts.active_nonembed_params(cfg)
    # 3 tokens after a prefix of 2: they see 3, 4 and 5 keys
    want = 2 * N * 3 + 4 * 40 * 128 * 40 * (3 + 4 + 5) + 2 * 5120 * 151936
    assert counts.prefill_flops(cfg, 2, 3) == want
    # a cold prompt of 4: 1 + 2 + 3 + 4 keys
    assert counts.prefill_flops(cfg, 0, 4) == \
        2 * N * 4 + 4 * 40 * 128 * 40 * 10 + 2 * 5120 * 151936


def test_wire_chunk_bytes():
    # int8: per layer fp16 scales of K and V (2 x 1024 x 2) and the codes
    # (2 x 256 x 1024)
    assert counts.wire_chunk_bytes(config("qwen3-14b.packed-int8")) == \
        40 * (2 * 1024 * 2 + 2 * 256 * 1024)
    # identity: bf16 K and V, 4 KV heads of 128
    assert counts.wire_chunk_bytes(config("qwen3-30b-a3b.identity")) == \
        48 * 2 * 256 * 512 * 2
    with pytest.raises(ValueError):
        counts.wire_chunk_bytes(dict(config("qwen3-14b.packed-int8"),
                                     codec="int4"))

