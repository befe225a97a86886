"""command-r-35b — dense GQA, no-bias, parallel block
[hf:CohereForAI/c4ai-command-r-v01; unverified]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    arch_id="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22528, vocab=256000, rope_theta=8_000_000.0,
    parallel_block=True, norm_type="layernorm",
)
