"""llama3-1-8b [dense] — the PAPER's evaluation model (Llama 3.1 8B):
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.  Used by the
serving examples and paper-reproduction benchmarks; not part of the
assigned 40-cell grid.  [hf:meta-llama/Llama-3.1-8B]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "llama3-1-8b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="dense", num_layers=32, d_model=4096,
    num_heads=32, num_kv_heads=8, head_dim=128, d_ff=14336,
    vocab_size=128256, mlp_kind="swiglu", rope_theta=500_000.0,
    tie_embeddings=False)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="dense", num_layers=4, d_model=128,
    num_heads=8, num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=512,
    tie_embeddings=False, param_dtype="float32", compute_dtype="float32")
