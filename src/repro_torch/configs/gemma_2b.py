"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000; GeGLU, head_dim=256, embeddings scaled by sqrt(d).
[arXiv:2403.08295; hf]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "gemma-2b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", num_layers=18, d_model=2048,
    num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
    vocab_size=256000, mlp_kind="geglu", rope_theta=10_000.0,
    embed_scale=True, tie_embeddings=True)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=1, head_dim=32, d_ff=256, vocab_size=512,
    mlp_kind="geglu", embed_scale=True, param_dtype="float32",
    compute_dtype="float32")
