"""Model configuration covering every assigned architecture family."""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.types import KVSpec

VOCAB_PAD_MULTIPLE = 256  # embedding tables padded for clean TP sharding


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # attention flavour
    qk_norm: bool = False
    mlp_kind: str = "swiglu"  # swiglu | geglu
    rope_theta: float = 1_000_000.0
    embed_scale: bool = False  # gemma multiplies embeddings by sqrt(d)
    tie_embeddings: bool = True
    logit_softcap: float = 0.0

    # mixture-of-experts
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_every: int = 1  # every k-th layer is MoE (llama4: 2 — alternating)
    shared_expert_d_ff: int = 0  # llama4 shared expert
    capacity_factor: float = 1.25

    # state-space (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_chunk: int = 128  # SSD chunk length (MXU-aligned)

    # hybrid (Zamba2): one weight-shared attention+MLP block applied every k
    # Mamba layers
    shared_attn_every: int = 0

    # encoder-decoder (Whisper)
    encoder_layers: int = 0
    decoder_train_len: int = 256  # text tokens per example in training shapes
    cross_kv_len: int = 1500  # encoder output frames available at decode

    # vision-language (InternVL): patch embeddings prepended to text
    num_patches: int = 0

    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # performance variants (§Perf hillclimbs; defaults = baseline)
    attn_impl: str = "naive"  # naive | blocked (flash-style lax.scan, O1)
    attn_block_k: int = 512
    attn_seq_shard: bool = False  # shard Sq over 'model' in attention (O2)
    decode_impl: str = "naive"  # naive | blocked (sharded flash-decode, O3)
    decode_blocks: int = 16

    # sub-quadratic? (full attention archs skip long_500k)
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        m = VOCAB_PAD_MULTIPLE
        return (self.vocab_size + m - 1) // m * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def attn_layers(self) -> int:
        """Number of attention KV caches the model maintains."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return max(1, (self.num_layers - 2) // max(self.shared_attn_every, 1))
        if self.family == "encdec":
            return self.num_layers  # decoder self-attention layers
        return self.num_layers

    def kv_spec(self, chunk_tokens: int, dtype_bytes: int = 2,
                codec: str = "identity") -> KVSpec:
        """ObjectCache chunk geometry for this deployment (Eq. 1); ``codec``
        selects the KV wire codec (DESIGN.md §Codec)."""
        return KVSpec(num_layers=self.attn_layers, chunk_tokens=chunk_tokens,
                      num_kv_heads=self.num_kv_heads, head_dim=self.head_dim,
                      dtype_bytes=dtype_bytes, codec=codec)

    # -- parameter counting (for roofline MODEL_FLOPS = 6·N·D) -------------
    def param_count(self) -> int:
        d, dh = self.d_model, self.head_dim
        attn = d * (self.num_heads * dh) + 2 * d * (self.num_kv_heads * dh) \
            + (self.num_heads * dh) * d
        embed = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        n = embed
        if self.family in ("dense", "vlm"):
            mlp = 3 * d * self.d_ff if self.mlp_kind in ("swiglu", "geglu") else 2 * d * self.d_ff
            n += self.num_layers * (attn + mlp)
        elif self.family == "moe":
            n_moe = self.num_layers // self.moe_every
            n_dense = self.num_layers - n_moe
            moe_mlp = self.num_experts * 3 * d * self.moe_d_ff \
                + d * self.num_experts  # router
            if self.shared_expert_d_ff:
                moe_mlp += 3 * d * self.shared_expert_d_ff
            n += self.num_layers * attn + n_moe * moe_mlp \
                + n_dense * 3 * d * self.d_ff
        elif self.family == "ssm":
            n += self.num_layers * self._ssm_layer_params()
        elif self.family == "hybrid":
            shared = attn + 3 * self.d_model * self.d_ff
            n += self.num_layers * self._ssm_layer_params() + shared
        elif self.family == "encdec":
            mlp = 2 * d * self.d_ff  # whisper uses plain GELU MLP
            enc = self.encoder_layers * (attn + mlp)
            dec = self.num_layers * (2 * attn + mlp)  # self + cross
            n += enc + dec
        return n

    def _ssm_layer_params(self) -> int:
        d, di, ds, nh = self.d_model, self.d_inner, self.ssm_state, self.ssm_heads
        in_proj = d * (2 * di + 2 * ds + nh)  # z, x, B, C, dt
        conv = (di + 2 * ds) * self.ssm_conv
        out_proj = di * d
        return in_proj + conv + out_proj + 3 * nh + di

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed experts count)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        full = self.param_count()
        n_moe = self.num_layers // self.moe_every
        all_experts = n_moe * self.num_experts * 3 * d * self.moe_d_ff
        active_experts = n_moe * self.experts_per_token * 3 * d * self.moe_d_ff
        return full - all_experts + active_experts
