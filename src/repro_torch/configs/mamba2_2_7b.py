"""mamba2-2.7b [ssm] — 64L d_model=2560 (attention-free) vocab=50280,
ssm_state=128; SSD (state-space duality), d_inner=5120 (expand 2),
headdim 64 -> 80 heads.  [arXiv:2405.21060; unverified]

Sub-quadratic: runs the long_500k shape (constant-size recurrent state)."""
from repro_torch.models.config import ModelConfig

ARCH_ID = "mamba2-2.7b"

CONFIG = ModelConfig(
    name=ARCH_ID, family="ssm", num_layers=64, d_model=2560,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_headdim=64, ssm_conv=4, ssm_expand=2, ssm_chunk=128,
    tie_embeddings=True, subquadratic=True)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="ssm", num_layers=2, d_model=64,
    num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=256,
    ssm_state=16, ssm_headdim=16, ssm_conv=4, ssm_expand=2, ssm_chunk=8,
    subquadratic=True, param_dtype="float32", compute_dtype="float32")
