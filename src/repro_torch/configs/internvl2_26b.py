"""internvl2-26b [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553; InternViT frontend STUBBED — input_specs() provides 256
precomputed patch embeddings prepended to the text sequence; the LM backbone
(InternLM2-20B-like) is fully implemented.  [arXiv:2404.16821; hf]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "internvl2-26b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="vlm", num_layers=48, d_model=6144,
    num_heads=48, num_kv_heads=8, head_dim=128, d_ff=16384,
    vocab_size=92553, mlp_kind="swiglu", rope_theta=1_000_000.0,
    tie_embeddings=False, num_patches=256)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="vlm", num_layers=2, d_model=64,
    num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=256,
    tie_embeddings=False, num_patches=4,
    param_dtype="float32", compute_dtype="float32")
