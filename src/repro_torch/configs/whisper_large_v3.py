"""whisper-large-v3 [audio] — enc-dec, 32L each side, d_model=1280 20H
(MHA kv=20) d_ff=5120 vocab=51866; conv frontend STUBBED — input_specs()
provides precomputed frame embeddings.  [arXiv:2212.04356; unverified]"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "whisper-large-v3"

CONFIG = ModelConfig(
    name=ARCH_ID, family="encdec", num_layers=32, encoder_layers=32,
    d_model=1280, num_heads=20, num_kv_heads=20, head_dim=64, d_ff=5120,
    vocab_size=51866, mlp_kind="gelu", tie_embeddings=True,
    decoder_train_len=256, cross_kv_len=1500)

SMOKE = ModelConfig(
    name=ARCH_ID + "-smoke", family="encdec", num_layers=2, encoder_layers=2,
    d_model=64, num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    vocab_size=256, mlp_kind="gelu", decoder_train_len=8, cross_kv_len=12,
    param_dtype="float32", compute_dtype="float32")
