"""zamba2-1.2b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_conv=4, ssm_chunk=64,
    shared_attn_every=6,
)
