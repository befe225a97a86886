"""Model configuration for the assigned architecture families: a copy of
``repro.models.config`` whose dtype properties return torch dtypes."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """One config describes any member of the supported families.

    family:
      'dense'  — decoder-only GQA transformer (llama3 / command-r)
      'moe'    — decoder-only with MoE FFN (olmoe / qwen2-moe)
      'hybrid' — Mamba2 backbone + periodic shared attention (zamba2)
      'ssm'    — RWKV6 (attention-free)
      'encdec' — whisper encoder-decoder (conv frontend stubbed)
      'vlm'    — decoder-only with M-RoPE + vision-embed stub (qwen2-vl)
    """

    arch_id: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None          # default d_model // n_heads
    rope_theta: float = 500000.0
    mlp_type: str = "swiglu"                # 'swiglu' | 'gelu'
    use_bias: bool = False                  # whisper: True
    tie_embeddings: bool = False
    norm_type: str = "rmsnorm"              # 'rmsnorm' | 'layernorm'
    norm_eps: float = 1e-5
    parallel_block: bool = False            # command-r: attn+mlp in parallel

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    n_shared_experts: int = 0
    router_aux_coef: float = 0.01
    moe_fused_combine: int = 1              # fold gate-combine into the
                                            # expert contraction: the TP
                                            # partial-sum all-reduce shrinks
                                            # from (B,S,E,D) to (B,S,D)
                                            # (64x for qwen2-moe; §Perf C1).
                                            # 0 reproduces the naive baseline.

    # SSM / Mamba2
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64                     # SSD chunk length

    # hybrid (zamba2)
    shared_attn_every: int = 6

    # RWKV6
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64
    rwkv_impl: str = "chunked"              # 'scan' | 'chunked' (see
                                            # models/rwkv6.py — chunked is
                                            # the MXU-friendly TPU form)
    rwkv_chunk: int = 16

    # encoder-decoder (whisper)
    n_enc_layers: int = 0
    n_audio_frames: int = 1500              # stubbed conv frontend output

    # VLM (qwen2-vl)
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    n_vision_patches: int = 256             # stubbed patch embeds

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # attention execution
    attn_block: int = 0                     # >0: flash-style blocked causal
                                            # attention with this tile size
                                            # (no S x S materialization)
    attn_repeat_kv: int = 0                 # 1: repeat KV heads to Hq and
                                            # run flat per-head attention —
                                            # keeps scores shardable when
                                            # Hkv < model axis (§Perf A2)
    norm_f32: int = 1                       # 0: norms/RoPE in compute dtype
                                            # — cuts the unfused f32-upcast
                                            # elementwise traffic (§Perf A7;
                                            # numerics tradeoff, off by
                                            # default)
    bf16_params_compute: int = 0            # 1: cast params to compute dtype
                                            # before the forward pass, so
                                            # FSDP all-gathers move bf16
                                            # instead of f32 (§Perf lever)
    # execution
    sp_serve: int = 0                       # 1: sequence-parallel serving
                                            # rules (seq->model, weights
                                            # replicated) — §Perf lever
    dp_serve: int = 0                       # 1: decode batch over model
                                            # axis too (pure DP decode)
    # execution
    remat: str = "none"                     # 'none'|'full'|'dots'
    scan_layers: bool = True
    scan_unroll: int = 1                    # lax.scan unroll for layer scans
                                            # (dry-run sets full unroll so
                                            # cost_analysis counts every
                                            # layer — XLA counts while
                                            # bodies once)
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        assert self.family in ("dense", "moe", "hybrid", "ssm", "encdec",
                               "vlm"), self.family
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_head_dim(self) -> int:
        return self.d_inner // self.n_heads

    @property
    def rwkv_n_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def subquadratic(self) -> bool:
        """Supports the long_500k cell (no full quadratic attention over
        the whole context)."""
        return self.family in ("ssm", "hybrid")


def reduced_for_smoke(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 5),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        head_dim=32,
        d_ff=256,
        vocab=512,
        n_experts=min(cfg.n_experts, 8) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        expert_d_ff=64 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_chunk=8,
        shared_attn_every=2,
        rwkv_head_dim=32,
        rwkv_lora_dim=16,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        n_audio_frames=16 if cfg.family == "encdec" else cfg.n_audio_frames,
        n_vision_patches=8 if cfg.family == "vlm" else cfg.n_vision_patches,
        mrope_sections=(4, 6, 6) if cfg.family == "vlm" else cfg.mrope_sections,
        compute_dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
