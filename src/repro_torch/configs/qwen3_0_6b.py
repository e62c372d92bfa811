"""qwen3-0.6b [dense] — 28L d_model=1024 16H (GQA kv=8) d_ff=3072
vocab=151936; qk_norm, GQA, head_dim 128 (decoupled from d_model/H, faithful
to Qwen3).  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-0.6b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", num_layers=28, d_model=1024,
    num_heads=16, num_kv_heads=8, head_dim=128, d_ff=3072,
    vocab_size=151936, qk_norm=True, mlp_kind="swiglu",
    rope_theta=1_000_000.0, tie_embeddings=True)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    qk_norm=True, mlp_kind="swiglu", param_dtype="float32",
    compute_dtype="float32")
