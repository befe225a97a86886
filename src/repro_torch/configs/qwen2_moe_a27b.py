"""qwen2-moe-a2.7b — 4 shared + 60 routed top-4
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=151936, rope_theta=1_000_000.0,
    n_experts=60, top_k=4, expert_d_ff=1408, n_shared_experts=4,
)
