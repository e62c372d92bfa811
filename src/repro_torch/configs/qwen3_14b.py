"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936; qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen3-14b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", num_layers=40, d_model=5120,
    num_heads=40, num_kv_heads=8, head_dim=128, d_ff=17408,
    vocab_size=151936, qk_norm=True, mlp_kind="swiglu",
    rope_theta=1_000_000.0, tie_embeddings=False)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="dense", num_layers=3, d_model=96,
    num_heads=6, num_kv_heads=2, head_dim=16, d_ff=192, vocab_size=256,
    qk_norm=True, tie_embeddings=False, param_dtype="float32",
    compute_dtype="float32")
