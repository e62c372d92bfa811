"""deepseek-v2-lite [moe] — 27L d_model=2048 16H MLA (kv_lora_rank=512,
qk 128 nope + 64 rope, v 128, YaRN x40 over 4096), layer 0 dense
d_ff=10944, then 64 experts of 1408 top-6 (softmax, not renormalised) +
2 shared, vocab=102400.  [hf:deepseek-ai/DeepSeek-V2-Lite; hf]"""
from repro_torch.models.config import MLAConfig

ARCH_ID = "deepseek-v2-lite"

CONFIG = MLAConfig(
    name=ARCH_ID, family="moe", num_layers=27, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=192, d_ff=10944,
    vocab_size=102400, mlp_kind="swiglu", rope_theta=10_000.0,
    tie_embeddings=False, num_experts=64, experts_per_token=6,
    moe_d_ff=1408, shared_expert_d_ff=2 * 1408, kv_lora_rank=512,
    qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128,
    first_dense_layers=1, norm_topk_prob=False, routed_scaling_factor=1.0,
    rope_factor=40.0, rope_original_max=4096, rope_beta_fast=32.0,
    rope_beta_slow=1.0, rope_mscale=0.707, rope_mscale_all_dim=0.707)

SMOKE = MLAConfig(
    name=ARCH_ID + "-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=48, d_ff=128, vocab_size=512,
    rope_theta=10_000.0, tie_embeddings=False, num_experts=8,
    experts_per_token=3, moe_d_ff=32, shared_expert_d_ff=32,
    kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
    v_head_dim=32, first_dense_layers=1, norm_topk_prob=False,
    rope_factor=40.0, rope_original_max=4096, rope_beta_fast=32.0,
    rope_beta_slow=1.0, rope_mscale=0.707, rope_mscale_all_dim=0.707,
    param_dtype="float32", compute_dtype="float32")
