"""Architecture registry: ``--arch <id>`` resolution for every launcher."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (gemma_2b, internvl2_26b, llama3_1_8b,
               llama4_maverick_400b_a17b, mamba2_2_7b, qwen3_0_6b, qwen3_14b,
               qwen3_moe_30b_a3b, smollm_135m, whisper_large_v3, zamba2_1_2b)

_MODULES = [qwen3_0_6b, smollm_135m, gemma_2b, qwen3_14b, whisper_large_v3,
            mamba2_2_7b, qwen3_moe_30b_a3b, llama4_maverick_400b_a17b,
            zamba2_1_2b, internvl2_26b, llama3_1_8b]

_CONFIGS: dict[str, ModelConfig] = {m.ARCH_ID: m.CONFIG for m in _MODULES}
_SMOKES: dict[str, ModelConfig] = {m.ARCH_ID: m.SMOKE for m in _MODULES}

# The ten ASSIGNED architectures (llama3-1-8b is the paper's own model,
# used by examples/benchmarks but not part of the 40-cell grid).
ARCH_IDS = [m.ARCH_ID for m in _MODULES[:10]]


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _CONFIGS[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_CONFIGS)}")


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _SMOKES[arch_id]


def list_archs(include_extra: bool = False) -> list[str]:
    return list(_CONFIGS) if include_extra else list(ARCH_IDS)
