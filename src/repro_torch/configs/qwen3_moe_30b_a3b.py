"""qwen3-moe-30b-a3b [moe] — 48L d_model=2048 32H (GQA kv=4) expert
d_ff=768 vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B; hf]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-moe-30b-a3b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="moe", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=4, head_dim=128, d_ff=0,
    vocab_size=151936, qk_norm=True, mlp_kind="swiglu",
    rope_theta=1_000_000.0, tie_embeddings=False,
    num_experts=128, experts_per_token=8, moe_d_ff=768, moe_every=1,
    capacity_factor=1.25)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="moe", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=0, vocab_size=256,
    qk_norm=True, num_experts=8, experts_per_token=2, moe_d_ff=32,
    capacity_factor=2.0, tie_embeddings=False,
    param_dtype="float32", compute_dtype="float32")
