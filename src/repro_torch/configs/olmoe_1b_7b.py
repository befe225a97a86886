"""olmoe-1b-7b — MoE 64 experts top-8 [arXiv:2409.02060; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304, rope_theta=10000.0,
    n_experts=64, top_k=8, expert_d_ff=1024, n_shared_experts=0,
)
