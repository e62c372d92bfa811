"""smollm-135m [dense] — 30L d_model=576 9H (GQA kv=3) d_ff=1536
vocab=49152; llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "smollm-135m"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", num_layers=30, d_model=576,
    num_heads=9, num_kv_heads=3, head_dim=64, d_ff=1536,
    vocab_size=49152, mlp_kind="swiglu", rope_theta=10_000.0,
    tie_embeddings=True)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="dense", num_layers=2, d_model=48,
    num_heads=3, num_kv_heads=1, head_dim=16, d_ff=96, vocab_size=256,
    mlp_kind="swiglu", param_dtype="float32", compute_dtype="float32")
