"""zamba2-1.2b [hybrid] — 38L d_model=2048, Mamba2 backbone (ssm_state=64,
d_inner 4096, headdim 64) + ONE weight-shared attention+MLP block
(32H MHA kv=32, dh 64, d_ff=8192) applied every 6 Mamba layers.
[arXiv:2411.15242; hf]

Sub-quadratic backbone: runs the long_500k shape (attention KV exists only
at the 6 shared-block applications)."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "zamba2-1.2b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="hybrid", num_layers=38, d_model=2048,
    num_heads=32, num_kv_heads=32, head_dim=64, d_ff=8192,
    vocab_size=32000, mlp_kind="swiglu", rope_theta=10_000.0,
    ssm_state=64, ssm_headdim=64, ssm_conv=4, ssm_expand=2, ssm_chunk=128,
    shared_attn_every=6, tie_embeddings=True, subquadratic=True)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="hybrid", num_layers=8, d_model=64,
    num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
    ssm_state=16, ssm_headdim=16, ssm_conv=4, ssm_chunk=8,
    shared_attn_every=3, subquadratic=True,
    param_dtype="float32", compute_dtype="float32")
