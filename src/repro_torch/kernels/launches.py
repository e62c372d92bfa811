"""Launch counts of every CUDA kernel of the port, in one place.

Each kernel wrapper adds one to its entry where it launches its kernel, and
nowhere else, so a run can show that the serving path went through the
kernels: `reset` before the path, `snapshot` after it.  Every op is one
device launch per call.
"""
from __future__ import annotations

LAUNCHES = {"kv_dequant": 0, "kv_dequant_packed4": 0,
            "decode_attention_quant": 0, "flash_attention_quant": 0,
            "flash_attention": 0, "decode_attention": 0, "kv_gather": 0}


def count(name: str) -> None:
    LAUNCHES[name] += 1


def reset() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def snapshot() -> dict[str, int]:
    return dict(LAUNCHES)
