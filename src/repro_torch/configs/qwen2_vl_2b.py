"""qwen2-vl-2b — M-RoPE, dynamic-resolution vision (frontend stubbed)
[arXiv:2409.12191; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), n_vision_patches=256,
)
