"""Shared neural layers: norms, RoPE/M-RoPE, GQA attention, MLP — the
port of ``repro.models.layers`` in plain torch.

Pure-function style: params are nested dicts of tensors; every function
takes (params, config, inputs).  Parameter *schemas* (shape + logical
axes + init) are declared once via :class:`PSpec`; init, counts and the
carry-across of the reference's parameters derive from the same schema
(models/api.py).

The reference's ``shard`` annotations are the identity outside a mesh
and are left out until the port has one.  As in the reference, the
model's attention is plain tensor code (``gqa_scores_and_mix``, or
``blocked_causal_gqa`` when ``cfg.attn_block`` is set); it does not call
the flash kernel.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig

MASK_VALUE = -1e30


# ----------------------------------------------------------------- schema --

@dataclasses.dataclass(frozen=True)
class PSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"        # 'normal'|'zeros'|'ones'|'out_proj'
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"shape {self.shape} and logical axes "
                             f"{self.logical} differ in rank")


def is_pspec(x) -> bool:
    return isinstance(x, PSpec)


# ------------------------------------------------------------------ norms --

def rmsnorm(x, gamma, eps):
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * gamma.float()).to(x.dtype)


def layernorm(x, gamma, beta, eps):
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * gamma.float() + beta.float()
    return out.to(x.dtype)


def norm_schema(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    if cfg.norm_type == "rmsnorm":
        return {"gamma": PSpec((d,), ("embed",), init="ones")}
    return {"gamma": PSpec((d,), ("embed",), init="ones"),
            "beta": PSpec((d,), ("embed",), init="zeros")}


def _rmsnorm_lowp(x, gamma, eps):
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * gamma.to(x.dtype)


def _layernorm_lowp(x, gamma, beta, eps):
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps) * gamma.to(x.dtype)
            + beta.to(x.dtype))


def apply_norm(p, cfg: ModelConfig, x):
    if not cfg.norm_f32:
        if cfg.norm_type == "rmsnorm":
            return _rmsnorm_lowp(x, p["gamma"], cfg.norm_eps)
        return _layernorm_lowp(x, p["gamma"], p["beta"], cfg.norm_eps)
    if cfg.norm_type == "rmsnorm":
        return rmsnorm(x, p["gamma"], cfg.norm_eps)
    return layernorm(x, p["gamma"], p["beta"], cfg.norm_eps)


# ------------------------------------------------------------------- rope --

def _inv_freqs(start: int, stop: int, half: int, theta: float, device):
    return 1.0 / (theta ** (torch.arange(start, stop, dtype=torch.float32,
                                         device=device) / half))


def _rope_angles(positions, dim_half: int, theta: float):
    """positions (..., S) -> angles (..., S, dim_half)."""
    freqs = _inv_freqs(0, dim_half, dim_half, theta, positions.device)
    return positions.float()[..., None] * freqs


def apply_rope(q, k, positions, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None,
               lowp: bool = False):
    """Rotary embedding.  q/k: (B, S, H, hd).

    positions: (B, S) — standard RoPE; or (3, B, S) — M-RoPE with
    ``mrope_sections`` splitting hd/2 into (t, h, w) frequency bands
    (qwen2-vl).  Text-only tokens pass identical ids in all 3 streams,
    which reduces exactly to standard RoPE.
    """
    hd = q.shape[-1]
    half = hd // 2
    if mrope_sections is None:
        ang = _rope_angles(positions, half, theta)        # (B,S,half)
    else:
        if sum(mrope_sections) != half:
            raise ValueError(f"M-RoPE sections {mrope_sections} do not "
                             f"sum to hd/2 = {half}")
        parts = []
        for i, sec in enumerate(mrope_sections):
            start = sum(mrope_sections[:i])
            freqs = _inv_freqs(start, start + sec, half, theta,
                               positions.device)
            parts.append(positions[i].float()[..., None] * freqs)
        ang = torch.cat(parts, dim=-1)                     # (B,S,half)
    cos = torch.cos(ang)[..., None, :]                     # (B,S,1,half)
    sin = torch.sin(ang)[..., None, :]
    if lowp:       # keep the rotation in the activation dtype
        cos, sin = cos.to(q.dtype), sin.to(q.dtype)

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
        return out.to(x.dtype)

    return rot(q), rot(k)


def sinusoidal_positions(n_pos: int, d: int, device=None) -> torch.Tensor:
    """Whisper-style sinusoidal table (n_pos, d)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    return _sinusoid(pos, d)


def sinusoidal_position_at(pos, d: int, device=None) -> torch.Tensor:
    """Single-position sinusoid; pos scalar -> (1, d)."""
    p = torch.as_tensor(pos, dtype=torch.float32, device=device).reshape(1, 1)
    return _sinusoid(p, d)


def _sinusoid(pos, d: int) -> torch.Tensor:
    dim = torch.arange(d // 2, dtype=torch.float32, device=pos.device)[None]
    inv = torch.exp(-math.log(10000.0) * dim / max(d // 2 - 1, 1))
    ang = pos * inv
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# -------------------------------------------------------------- attention --

def attn_schema(cfg: ModelConfig, d: Optional[int] = None):
    d = d or cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": PSpec((d, hq * hd), ("embed", "q_heads")),
        "wk": PSpec((d, hkv * hd), ("embed", "kv_heads")),
        "wv": PSpec((d, hkv * hd), ("embed", "kv_heads")),
        "wo": PSpec((hq * hd, d), ("q_heads", "embed"), init="out_proj"),
    }
    if cfg.use_bias:
        s.update({
            "bq": PSpec((hq * hd,), ("q_heads",), init="zeros"),
            "bk": PSpec((hkv * hd,), ("kv_heads",), init="zeros"),
            "bv": PSpec((hkv * hd,), ("kv_heads",), init="zeros"),
            "bo": PSpec((d,), ("embed",), init="zeros"),
        })
    return s


def _proj(x, w, b=None):
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _split_heads(x, n, hd):
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def _softcap(x, softcap: float):
    return torch.tanh(x / softcap) * softcap


def gqa_scores_and_mix(q, k, v, mask, softcap: float = 0.0):
    """Grouped-query attention core.

    q: (B,S,Hq,hd); k/v: (B,T,Hkv,hd); mask broadcastable (B,1,1,S,T)
    or None.  Returns (B,S,Hq,hd).  Hq split into Hkv groups to avoid
    materializing repeated KV.
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, hq // hkv, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg, k) / math.sqrt(hd)
    scores = scores.float()
    if softcap:
        scores = _softcap(scores, softcap)
    if mask is not None:
        scores = torch.where(mask, scores, MASK_VALUE)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", w, v)
    return out.reshape(b, s, hq, hd)


def blocked_causal_gqa(q, k, v, block: int, softcap: float = 0.0):
    """Flash-style blocked causal GQA in plain torch.

    Streams over (q-block, k-block) tiles with an online softmax
    (running max + denominator), so no (S, S) score tensor is ever
    materialized.  q: (B,S,Hq,hd); k/v: (B,S,Hkv,hd).
    """
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    bq = bk = min(block, s)
    if s % bq:
        raise ValueError(f"sequence {s} is not a multiple of the block {bq}")
    nq = s // bq
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(b, s, hkv, g, hd)
    dev = q.device
    tri = (torch.arange(bk, device=dev)[None, :]
           <= torch.arange(bq, device=dev)[:, None])

    out_blocks = []
    for qi in range(nq):
        qblk = qg[:, qi * bq:(qi + 1) * bq].float()
        m = torch.full((b, hkv, g, bq), MASK_VALUE, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, bq, hd), dtype=torch.float32,
                          device=dev)
        for kj in range(qi + 1):
            kblk = k[:, kj * bk:(kj + 1) * bk].float()
            vblk = v[:, kj * bk:(kj + 1) * bk].float()
            sc = torch.einsum("bskgh,btkh->bkgst", qblk, kblk) * scale
            if softcap:
                sc = _softcap(sc, softcap)
            if kj == qi:                       # diagonal tile: causal mask
                sc = torch.where(tri, sc, MASK_VALUE)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(sc - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgst,btkh->bkgsh", p, vblk)
            m = m_new
        out = acc / l[..., None]
        out_blocks.append(
            out.permute(0, 3, 1, 2, 4).reshape(b, bq, hq, hd))
    return torch.cat(out_blocks, dim=1).to(q.dtype)


def causal_mask(s: int, t: int, offset, device=None) -> torch.Tensor:
    """mask[..., i, j] = j <= i + offset (offset = cache position)."""
    rows = torch.arange(s, device=device)[:, None]
    cols = torch.arange(t, device=device)[None, :]
    return (cols <= rows + offset)[None, None, None]


def attention(p, cfg: ModelConfig, x, *, positions=None,
              mode: str = "causal", cache=None, cache_pos=None,
              kv_x=None):
    """GQA attention for all modes.

    mode:
      'causal'  — self-attention over x (train / prefill)
      'bidir'   — encoder self-attention
      'cross'   — decoder cross-attention over kv_x (no rope, no mask)
      'decode'  — single-step with KV cache: x is (B,1,D); cache is
                  {'k': (B,T,Hkv,hd), 'v': ...}; cache_pos an int.
    Returns (out, new_cache) — new_cache is None unless mode='decode'
    or cache-building prefill (pass cache with preallocated buffers).
    Unlike the reference, which returns updated copies, the cache
    tensors are written in place and returned.  A decode step at
    ``cache_pos`` past the cache raises (the reference's update would
    clamp it to the last slot).
    """
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = _split_heads(_proj(x, p["wq"], p.get("bq")), hq, hd)
    src = kv_x if mode == "cross" else x
    if mode == "cross" and cache is not None and "ck" in cache:
        k, v = cache["ck"], cache["cv"]     # precomputed at prefill
    else:
        k = _split_heads(_proj(src, p["wk"], p.get("bk")), hkv, hd)
        v = _split_heads(_proj(src, p["wv"], p.get("bv")), hkv, hd)

    sections = cfg.mrope_sections if cfg.family == "vlm" else None
    new_cache = None
    if mode in ("causal", "bidir") and positions is not None \
            and cfg.family != "encdec":
        q, k = apply_rope(q, k, positions, cfg.rope_theta,
                          mrope_sections=sections,
                          lowp=not cfg.norm_f32)
    if mode == "decode":
        pos_i = int(cache_pos)
        t = cache["k"].shape[1]
        if not 0 <= pos_i < t:
            raise ValueError(f"decode position {pos_i} is outside the "
                             f"cache of {t} positions")
        if cfg.family != "encdec":
            pos = torch.full((1, 1), pos_i, dtype=torch.int32,
                             device=x.device)
            if sections is not None:
                pos = pos[None].expand(3, 1, 1)
            q, k = apply_rope(q, k, pos, cfg.rope_theta,
                              mrope_sections=sections,
                              lowp=not cfg.norm_f32)
        ck, cv = cache["k"], cache["v"]
        ck[:, pos_i:pos_i + 1] = k.to(ck.dtype)
        cv[:, pos_i:pos_i + 1] = v.to(cv.dtype)
        new_cache = {"k": ck, "v": cv}
        mask = (torch.arange(t, device=x.device) <= pos_i)[
            None, None, None, None, :]
        out = gqa_scores_and_mix(q, ck.to(q.dtype), cv.to(q.dtype), mask,
                                 cfg.logits_softcap)
    else:
        s, t = q.shape[1], k.shape[1]
        if cfg.attn_repeat_kv and hq != hkv:
            # repeat KV to Hq so scores carry a model-shardable head dim
            k = torch.repeat_interleave(k, hq // hkv, dim=2)
            v = torch.repeat_interleave(v, hq // hkv, dim=2)
        if (mode == "causal" and cfg.attn_block and s == t
                and s % min(cfg.attn_block, s) == 0):
            out = blocked_causal_gqa(q, k, v, cfg.attn_block,
                                     cfg.logits_softcap)
        else:
            mask = (causal_mask(s, t, 0, device=x.device)
                    if mode == "causal" else None)
            out = gqa_scores_and_mix(q, k, v, mask, cfg.logits_softcap)
        if cache is not None and mode == "causal":
            # prefill: write k/v into the preallocated cache buffers
            ck, cv = cache["k"], cache["v"]
            ck[:, :s] = k.to(ck.dtype)
            cv[:, :s] = v.to(cv.dtype)
            new_cache = {"k": ck, "v": cv}

    out = out.reshape(x.shape[0], x.shape[1], hq * hd)
    out = _proj(out, p["wo"], p.get("bo"))
    return out, new_cache


# ------------------------------------------------------------------- mlp ---

def mlp_schema(cfg: ModelConfig, d_ff: Optional[int] = None,
               d: Optional[int] = None):
    d = d or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    if cfg.mlp_type == "swiglu":
        s = {
            "wg": PSpec((d, d_ff), ("embed", "mlp")),
            "wu": PSpec((d, d_ff), ("embed", "mlp")),
            "wd": PSpec((d_ff, d), ("mlp", "embed"), init="out_proj"),
        }
    else:
        s = {
            "wu": PSpec((d, d_ff), ("embed", "mlp")),
            "wd": PSpec((d_ff, d), ("mlp", "embed"), init="out_proj"),
        }
    if cfg.use_bias:
        s["bu"] = PSpec((d_ff,), ("mlp",), init="zeros")
        s["bd"] = PSpec((d,), ("embed",), init="zeros")
    return s


def apply_mlp(p, cfg: ModelConfig, x):
    if cfg.mlp_type == "swiglu":
        h = F.silu(x @ p["wg"].to(x.dtype)) * (x @ p["wu"].to(x.dtype))
    else:
        h = x @ p["wu"].to(x.dtype)
        if "bu" in p:
            h = h + p["bu"].to(x.dtype)
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    out = h @ p["wd"].to(x.dtype)
    if "bd" in p:
        out = out + p["bd"].to(x.dtype)
    return out


# ------------------------------------------------------------- embedding ---

def embed_schema(cfg: ModelConfig):
    s = {"tok": PSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                      scale=1.0 / math.sqrt(cfg.d_model))}
    if not cfg.tie_embeddings:
        s["head"] = PSpec((cfg.vocab, cfg.d_model), ("vocab", "embed"))
    return s


def embed_tokens(p, cfg: ModelConfig, tokens):
    return p["tok"][tokens.long()].to(cfg.cdtype)


def lm_logits(p, cfg: ModelConfig, x):
    w = p.get("head", p["tok"])
    logits = x @ w.to(x.dtype).T
    if cfg.logits_softcap:
        logits = _softcap(logits, cfg.logits_softcap)
    return logits
