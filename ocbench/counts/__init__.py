"""The yardstick's arithmetic: FLOPs from shapes, wire sizes, and the frozen
bf16 peak of one NVIDIA H100 SXM (data sheet, dense, 700 W).

Every function reads a configuration file's dict (``configs/<name>.json``,
Hugging Face keys), never the program's objects.  What depends on the
architecture (its parameters, its FLOPs, the tensors a layer stores) comes
from its module under ``archs/``; the codec's arithmetic is here.
"""
from __future__ import annotations

from ocbench import archs

H100_BF16_FLOPS = 989e12


def active_nonembed_params(cfg: dict) -> int:
    """Matrix parameters one token multiplies by, embedding and unembedding
    left out (``archs/<module>.py``)."""
    return archs.of(cfg).active_nonembed_params(cfg)


def prefill_flops(cfg: dict, prefix_len: int, computed: int) -> float:
    """Useful FLOPs of a prefill that computes ``computed`` tokens after a
    reused prefix of ``prefix_len`` (``archs/<module>.py``)."""
    return archs.of(cfg).prefill_flops(cfg, prefix_len, computed)


def wire_chunk_bytes(cfg: dict) -> int:
    """Bytes of one stored chunk object (all layers) under the config's
    codec, over each tensor a layer stores (``kv_tensors`` of the
    architecture): bf16 for identity; int8 codes plus one fp16 scale per
    channel for int8."""
    G = cfg["chunk_tokens"]
    size = {"identity": lambda W: G * W * 2,  # bf16 values
            "int8": lambda W: W * 2 + G * W}  # fp16 scales, int8 codes
    if cfg["codec"] not in size:
        raise ValueError(f"no wire size for codec {cfg['codec']!r}")
    layers, widths = archs.of(cfg).kv_tensors(cfg)
    return layers * sum(map(size[cfg["codec"]], widths))
