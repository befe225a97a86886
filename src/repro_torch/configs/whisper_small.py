"""whisper-small — enc-dec, conv frontend stubbed
[arXiv:2212.04356; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    head_dim=64, d_ff=3072, vocab=51865,
    mlp_type="gelu", use_bias=True, norm_type="layernorm",
    tie_embeddings=True, n_audio_frames=1500,
)
