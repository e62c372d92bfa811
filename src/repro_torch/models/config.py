"""Model configuration covering every assigned architecture family."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.types import KVSpec, LatentKVSpec

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


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature factor (DeepSeek's ``yarn_get_mscale``)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class MLAConfig(ModelConfig):
    """A DeepSeek-V2 decoder: multi-head latent attention with YaRN
    rotary embeddings, and an MoE stack (``family`` "moe") after
    ``first_dense_layers`` dense layers, whose router may leave its top-k
    weights as they are (``norm_topk_prob``) and scale their sum.

    ``num_heads`` query heads of ``qk_nope_head_dim + qk_rope_head_dim``
    (``head_dim`` holds that sum); keys and values come from one latent a
    token, ``kv_lora_rank + qk_rope_head_dim`` wide, which is what a layer
    caches (`kv_spec`: a `LatentKVSpec`); values are ``v_head_dim`` wide.
    ``d_ff`` is the dense layers' width, ``moe_d_ff`` an expert's,
    ``shared_expert_d_ff`` the shared experts' together."""

    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    first_dense_layers: int = 0
    norm_topk_prob: bool = True
    routed_scaling_factor: float = 1.0
    # YaRN (rope_theta is the base)
    rope_factor: float = 1.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0

    @property
    def latent_dim(self) -> int:
        """Values a layer caches a token: c_kv and the shared k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def softmax_scale(self) -> float:
        """(qk_nope + qk_rope)^-0.5 times YaRN's mscale(all dims) squared."""
        m = yarn_mscale(self.rope_factor, self.rope_mscale_all_dim)
        return (self.qk_nope_head_dim + self.qk_rope_head_dim) ** -0.5 * m * m

    def kv_spec(self, chunk_tokens: int, dtype_bytes: int = 2,
                codec: str = "identity") -> KVSpec:
        """One latent a layer (Eq. 1 with one tensor)."""
        return LatentKVSpec(num_layers=self.num_layers,
                            chunk_tokens=chunk_tokens, num_kv_heads=1,
                            head_dim=self.latent_dim, dtype_bytes=dtype_bytes,
                            codec=codec)

    def _attn_params(self) -> int:
        d, H = self.d_model, self.num_heads
        qk = self.qk_nope_head_dim + self.qk_rope_head_dim
        return d * H * qk + d * self.latent_dim \
            + self.kv_lora_rank * H * (self.qk_nope_head_dim
                                       + self.v_head_dim) \
            + H * self.v_head_dim * d

    def _layer_mlp_params(self, active: bool) -> int:
        """The MLP matrices of all layers, or those one token multiplies
        by."""
        d = self.d_model
        experts = self.experts_per_token if active else self.num_experts
        moe = d * self.num_experts + experts * 3 * d * self.moe_d_ff \
            + 3 * d * self.shared_expert_d_ff
        return self.first_dense_layers * 3 * d * self.d_ff + \
            (self.num_layers - self.first_dense_layers) * moe

    def param_count(self) -> int:
        """Matrices and embeddings (norm scales aside)."""
        embed = self.padded_vocab * self.d_model * \
            (1 if self.tie_embeddings else 2)
        return embed + self.num_layers * self._attn_params() \
            + self._layer_mlp_params(active=False)

    def active_param_count(self) -> int:
        return self.param_count() - self._layer_mlp_params(False) \
            + self._layer_mlp_params(True)
