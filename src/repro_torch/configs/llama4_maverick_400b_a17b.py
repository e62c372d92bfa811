"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8),
MoE 128 experts top-1 (expert d_ff=8192) + shared expert, alternating
dense(ff 16384)/MoE layers -> ~400B total / ~17B active params; early
fusion handled by the token-embedding path.
[hf:meta-llama/Llama-4 family; unverified]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llama4-maverick-400b-a17b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="moe", num_layers=48, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=16384,
    vocab_size=202048, mlp_kind="swiglu", rope_theta=500_000.0,
    tie_embeddings=False,
    num_experts=128, experts_per_token=1, moe_d_ff=8192, moe_every=2,
    shared_expert_d_ff=8192, capacity_factor=1.25)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="moe", num_layers=4, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    num_experts=8, experts_per_token=1, moe_d_ff=32, moe_every=2,
    shared_expert_d_ff=32, capacity_factor=2.0, tie_embeddings=False,
    param_dtype="float32", compute_dtype="float32")
