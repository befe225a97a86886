"""Model API: schema → (init | counts | carry-across) params + forward fns
— the port of ``repro.models.api``.

    schema(cfg)                               -> tree of PSpec (every family)
    param_count(cfg)                          -> int (every family)
    init_params(cfg, seed, device=None)       -> tree of tensors
    params_from_numpy(cfg, tree, device=None) -> tree of tensors
    forward_train(cfg, params, batch)          -> (logits, aux)
    forward_prefill(cfg, params, batch, max_seq) -> (logits, cache)
    forward_decode(cfg, params, tokens, cache) -> (logits, cache)
    init_cache(cfg, batch_size, max_seq, device=None) -> cache (zeros)

The forward passes, the initialisation and the caches cover the
``dense`` family (llama3, command-r); every other family raises
``NotImplementedError`` until it is ported (ROADMAP queue 1 item 11).

Layers are stacked along a leading axis, as in the reference, and
applied by a loop over the layer index, which stands in for the
reference's ``lax.scan``.  ``scan_layers``, ``scan_unroll`` and
``remat`` are accepted and have no effect: they shape the reference's
compiled graph and its backward pass, and these are eager forward
passes.  Entry points run on ``cuda:0`` unless the caller passes a
device, and raise without a card.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import layers as L
from .config import ModelConfig
from .layers import PSpec

#: families the forward passes run
PORTED_FAMILIES = ("dense",)

# ===========================================================================
# schemas
# ===========================================================================


def _attn_mlp_block_schema(cfg: ModelConfig, mlp: bool = True,
                           cross: bool = False):
    s = {"ln1": L.norm_schema(cfg), "attn": L.attn_schema(cfg)}
    if cross:
        s["ln_cross"] = L.norm_schema(cfg)
        s["cross"] = L.attn_schema(cfg)
    if mlp:
        if not cfg.parallel_block:
            s["ln2"] = L.norm_schema(cfg)
        s["mlp"] = L.mlp_schema(cfg)
    return s


# The parameter schemas of the families still to port: copies of the
# reference's moe_schema, mamba2_schema, rwkv_att_schema and
# rwkv_ffn_schema, so that schema() and param_count() cover every config.

def _moe_schema(cfg: ModelConfig):
    e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_d_ff
    s = {
        "router": PSpec((d, e), ("embed", None)),
        "wg": PSpec((e, d, f), ("experts", "embed", "mlp")),
        "wu": PSpec((e, d, f), ("experts", "embed", "mlp")),
        "wd": PSpec((e, f, d), ("experts", "mlp", "embed"),
                    init="out_proj"),
    }
    if cfg.n_shared_experts:
        s["shared"] = L.mlp_schema(
            cfg, d_ff=cfg.n_shared_experts * cfg.expert_d_ff)
    return s


def _mamba2_schema(cfg: ModelConfig):
    d, di, ds, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_heads
    conv_dim = di + 2 * ds
    return {
        # in_proj -> [z (di), x (di), B (ds), C (ds), dt (h)]
        "in_proj": PSpec((d, 2 * di + 2 * ds + h), ("embed", "mlp")),
        "conv_w": PSpec((cfg.ssm_conv, conv_dim), (None, "mlp")),
        "conv_b": PSpec((conv_dim,), ("mlp",), init="zeros"),
        "A_log": PSpec((h,), (None,), init="ones"),
        "D": PSpec((h,), (None,), init="ones"),
        "dt_bias": PSpec((h,), (None,), init="zeros"),
        "norm": PSpec((di,), ("mlp",), init="ones"),
        "out_proj": PSpec((di, d), ("mlp", "embed"), init="out_proj"),
    }


def _rwkv_att_schema(cfg: ModelConfig):
    d, lr = cfg.d_model, cfg.rwkv_lora_dim
    H, hd = cfg.rwkv_n_heads, cfg.rwkv_head_dim
    s = {f"mu_{c}": PSpec((d,), ("embed",), init="zeros")
         for c in ("r", "k", "v", "g", "w")}
    s.update({
        "w0": PSpec((d,), ("embed",), init="zeros"),
        "w1": PSpec((d, lr), ("embed", None)),
        "w2": PSpec((lr, d), (None, "embed")),
        "u": PSpec((H, hd), ("q_heads", None)),
        "wr": PSpec((d, d), ("embed", "q_heads")),
        "wk": PSpec((d, d), ("embed", "q_heads")),
        "wv": PSpec((d, d), ("embed", "q_heads")),
        "wg": PSpec((d, d), ("embed", "q_heads")),
        "ln_x": PSpec((d,), ("embed",), init="ones"),
        "wo": PSpec((d, d), ("q_heads", "embed"), init="out_proj"),
    })
    return s


def _rwkv_ffn_schema(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": PSpec((d,), ("embed",), init="zeros"),
        "mu_r": PSpec((d,), ("embed",), init="zeros"),
        "wk": PSpec((d, f), ("embed", "mlp")),
        "wv": PSpec((f, d), ("mlp", "embed"), init="out_proj"),
        "wr": PSpec((d, d), ("embed", "q_heads")),
    }


def _tree_map(fn: Callable, tree):
    """``fn`` on every leaf of a tree of dicts (a PSpec or a tensor)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree, prefix: Tuple[str, ...] = ()):
    """``(path, leaf)`` pairs in sorted key order (the reference's
    ``jax.tree`` flattening order)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _stack(schema_tree, n: int):
    """Prepend a stacked 'layers' axis to every PSpec in the tree."""
    return _tree_map(
        lambda ps: PSpec((n,) + ps.shape, ("layers",) + ps.logical,
                         init=ps.init, scale=ps.scale), schema_tree)


def schema(cfg: ModelConfig):
    s: Dict[str, Any] = {"embed": L.embed_schema(cfg),
                         "final_norm": L.norm_schema(cfg)}
    if cfg.family in ("dense", "vlm"):
        s["blocks"] = _stack(_attn_mlp_block_schema(cfg), cfg.n_layers)
    elif cfg.family == "moe":
        s["blocks"] = _stack({"ln1": L.norm_schema(cfg),
                              "attn": L.attn_schema(cfg),
                              "ln2": L.norm_schema(cfg),
                              "moe": _moe_schema(cfg)}, cfg.n_layers)
    elif cfg.family == "hybrid":
        s["blocks"] = _stack({"ln1": L.norm_schema(cfg),
                              "mamba": _mamba2_schema(cfg)}, cfg.n_layers)
        s["shared"] = _attn_mlp_block_schema(cfg)      # one shared block
    elif cfg.family == "ssm":
        s["blocks"] = _stack({"ln1": L.norm_schema(cfg),
                              "att": _rwkv_att_schema(cfg),
                              "ln2": L.norm_schema(cfg),
                              "ffn": _rwkv_ffn_schema(cfg)}, cfg.n_layers)
    elif cfg.family == "encdec":
        s["enc_blocks"] = _stack(_attn_mlp_block_schema(cfg),
                                 cfg.n_enc_layers)
        s["enc_final_norm"] = L.norm_schema(cfg)
        s["blocks"] = _stack(
            _attn_mlp_block_schema(cfg, cross=True), cfg.n_layers)
    else:
        raise ValueError(cfg.family)
    return s


def param_count(cfg: ModelConfig) -> int:
    return sum(int(np.prod(ps.shape)) for _, ps in tree_leaves(schema(cfg)))


# ===========================================================================
# schema -> params
# ===========================================================================


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.arch_id}) is not ported yet: "
            "ROADMAP queue 1 item 11 (models); the port runs "
            f"{PORTED_FAMILIES}")


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda:0``; a CUDA device without a card raises."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the model on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _from_schema(cfg: ModelConfig, make: Callable):
    """A parameter tree shaped like ``schema(cfg)``, leaf ``path`` being
    ``make(path, pspec)``."""
    out: Dict[str, Any] = {}
    for path, ps in tree_leaves(schema(cfg)):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = make(path, ps)
    return out


def _init_leaf(ps: PSpec, gen: torch.Generator, dtype, device):
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=device)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=device)
    scale = ps.scale
    if ps.init == "out_proj":        # scaled-down residual projections
        scale = ps.scale / np.sqrt(2.0)
    x = torch.randn(ps.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return x.mul_(scale).to(dtype)


def init_params(cfg: ModelConfig, seed: int, device=None):
    """Seeded random parameters (normal, scaled as the reference's
    schema says) on ``device`` (``cuda:0`` by default).  The numbers
    come from a ``torch.Generator`` and differ from ``jax.random``'s;
    :func:`params_from_numpy` carries the reference's own across."""
    _require_ported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return _from_schema(
        cfg, lambda _, ps: _init_leaf(ps, gen, cfg.pdtype, dev))


def _from_numpy(a, dtype: torch.dtype, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: carry the bits
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))       # the port's own copy
    return t.to(device=device, dtype=dtype)


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes; ``blocks`` stacked along the layer axis) as
    tensors of ``cfg.pdtype`` on ``device``, checked against the
    schema."""
    _require_ported(cfg)
    dev = resolve_device(device)

    def take(path, ps):
        node = tree
        for k in path:
            node = node[k]
        if tuple(np.shape(node)) != ps.shape:
            raise ValueError(f"parameter {'/'.join(path)} has shape "
                             f"{tuple(np.shape(node))}, the schema says "
                             f"{ps.shape}")
        return _from_numpy(node, cfg.pdtype, dev)

    return _from_schema(cfg, take)


# ===========================================================================
# blocks and forward passes (dense family)
# ===========================================================================


def _apply_attn_mlp_block(p, cfg: ModelConfig, x, *, mode, positions,
                          cache=None, cache_pos=None):
    h = L.apply_norm(p["ln1"], cfg, x)
    a, new_cache = L.attention(p["attn"], cfg, h, positions=positions,
                               mode=mode, cache=cache, cache_pos=cache_pos)
    if cfg.parallel_block and "mlp" in p:
        m = L.apply_mlp(p["mlp"], cfg, h)
        return x + a + m, new_cache
    x = x + a
    if "mlp" in p:
        h2 = L.apply_norm(p["ln2"], cfg, x)
        x = x + L.apply_mlp(p["mlp"], cfg, h2)
    return x, new_cache


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    return _tree_map(lambda a: a[i], tree)


def _n_layers(blocks) -> int:
    return next(tree_leaves(blocks))[1].shape[0]


def _positions(b: int, s: int, device, start: int = 0):
    pos = torch.arange(start, start + s, dtype=torch.int32, device=device)
    return pos[None, :].expand(b, s)


def _device_of(params) -> torch.device:
    return params["embed"]["tok"].device


def forward_train(cfg: ModelConfig, params, batch
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = L.embed_tokens(params["embed"], cfg, tokens)
    positions = _positions(b, s, x.device)
    blocks = params["blocks"]
    for i in range(_n_layers(blocks)):
        x, _ = _apply_attn_mlp_block(_layer(blocks, i), cfg, x,
                                     mode="causal", positions=positions)
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["embed"], cfg, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux * cfg.router_aux_coef


def init_cache(cfg: ModelConfig, b: int, max_seq: int, device=None):
    """Preallocated decode cache: ``pos`` (an int) and zero ``k`` / ``v``
    of shape ``(L, B, max_seq, Hkv, hd)`` in the compute dtype."""
    _require_ported(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, b, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return {"pos": 0,
            "k": torch.zeros(shape, dtype=cfg.cdtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.cdtype, device=dev)}


def forward_decode(cfg: ModelConfig, params, tokens, cache,
                   batch: Optional[dict] = None):
    """One decode step.  tokens: (B,1) -> (logits (B,1,V), new cache).

    The new cache holds the same ``k`` / ``v`` tensors as ``cache``,
    updated in place at position ``cache['pos']`` (the reference returns
    updated copies), and ``pos + 1``."""
    _require_ported(cfg)
    pos = int(cache["pos"])
    x = L.embed_tokens(params["embed"], cfg, tokens)
    blocks = params["blocks"]
    for i in range(_n_layers(blocks)):
        x, _ = _apply_attn_mlp_block(
            _layer(blocks, i), cfg, x, mode="decode", positions=None,
            cache={"k": cache["k"][i], "v": cache["v"][i]}, cache_pos=pos)
    x = L.apply_norm(params["final_norm"], cfg, x)
    logits = L.lm_logits(params["embed"], cfg, x)
    return logits, dict(cache, pos=pos + 1)


def forward_prefill(cfg: ModelConfig, params, batch, max_seq: int):
    """Prefill: run the full prompt, build the decode cache.

    Returns (last-position logits (B,1,V), cache at pos=S)."""
    _require_ported(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = init_cache(cfg, b, max_seq, device=_device_of(params))
    x = L.embed_tokens(params["embed"], cfg, tokens)
    positions = _positions(b, s, x.device)
    blocks = params["blocks"]
    for i in range(_n_layers(blocks)):
        x, _ = _apply_attn_mlp_block(
            _layer(blocks, i), cfg, x, mode="causal", positions=positions,
            cache={"k": cache["k"][i], "v": cache["v"][i]})
    cache["pos"] = s
    x = L.apply_norm(params["final_norm"], cfg, x[:, -1:, :])
    logits = L.lm_logits(params["embed"], cfg, x)
    return logits, cache
