"""Assigned input shapes and per-(arch x shape) input specs.

    train_4k     seq_len=4096   global_batch=256   (training)
    prefill_32k  seq_len=32768  global_batch=32    (inference-prefill)
    decode_32k   seq_len=32768  global_batch=128   (inference-decode)
    long_500k    seq_len=524288 global_batch=1     (long-context-decode)

``decode_*`` / ``long_*`` run ``serve_step`` (one new token against a KV
cache of seq_len), NOT ``train_step``.  ``long_500k`` requires sub-quadratic
context handling and is skipped for pure full-attention archs (recorded in
the dry-run output).

For ``[audio]``/``[vlm]`` archs the modality frontend is a stub:
``input_specs`` provides precomputed frame/patch embeddings.

Port of the reference's ``configs/shapes.py``: the specs are tensors on the
``meta`` device (shape and dtype, no storage) where the reference returns
``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dt


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, Shape] = {
    "train_4k": Shape("train_4k", 4096, 256, "train"),
    "prefill_32k": Shape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": Shape("decode_32k", 32768, 128, "decode"),
    "long_500k": Shape("long_500k", 524288, 1, "decode"),
}


def shape_kind(shape_name: str) -> str:
    return SHAPES[shape_name].kind


def is_applicable(cfg: ModelConfig, shape_name: str) -> tuple[bool, str]:
    """long_500k only for sub-quadratic archs (SSM / hybrid)."""
    if shape_name == "long_500k" and not cfg.subquadratic:
        return False, ("full-attention arch: 524288-token attention context is "
                       "out of scope per the brief (sub-quadratic archs only)")
    return True, ""


def _tok(shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape_name: str,
                batch_override: int | None = None,
                seq_override: int | None = None) -> dict[str, Any]:
    """Meta-tensor stand-ins for every model input of this cell.

    For ``train``/``prefill`` this is the batch dict; for ``decode`` it is
    {token, pos, cache} where cache is the model's cache spec.
    """
    shape = SHAPES[shape_name]
    B = batch_override or shape.global_batch
    S = seq_override or shape.seq_len
    act = dt(cfg)

    if shape.kind == "train":
        if cfg.family == "encdec":
            # seq_len = audio frames (stub embeddings); fixed text length.
            T = cfg.decoder_train_len
            return {"embeds": _tok((B, S, cfg.d_model), act),
                    "tokens": _tok((B, T)), "labels": _tok((B, T))}
        if cfg.family == "vlm":
            return {"embeds": _tok((B, cfg.num_patches, cfg.d_model), act),
                    "tokens": _tok((B, S)), "labels": _tok((B, S))}
        return {"tokens": _tok((B, S)), "labels": _tok((B, S))}

    if shape.kind == "prefill":
        if cfg.family == "encdec":
            T = cfg.decoder_train_len
            return {"embeds": _tok((B, S, cfg.d_model), act),
                    "tokens": _tok((B, T))}
        if cfg.family == "vlm":
            return {"embeds": _tok((B, cfg.num_patches, cfg.d_model), act),
                    "tokens": _tok((B, S))}
        return {"tokens": _tok((B, S))}

    # decode: one new token against a seq_len cache
    cache = build_model(cfg, "meta").cache_spec(B, S)
    return {"token": _tok((B, 1)), "pos": _tok((B,)),
            "cache": cache}
