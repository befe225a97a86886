"""rwkv6-1.6b — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=7168, vocab=65536, norm_type="layernorm",
    rwkv_head_dim=64, rwkv_lora_dim=64,
)
