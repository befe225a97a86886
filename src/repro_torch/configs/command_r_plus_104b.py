"""command-r-plus-104b — dense GQA, no-bias, parallel block
[hf:CohereForAI/c4ai-command-r-plus; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000, rope_theta=75_000_000.0,
    parallel_block=True, norm_type="layernorm",
)
