"""The dense model family of the torch port against the JAX reference.

Same parameters in both packages (the reference's ``init_params``,
carried across with ``params_from_numpy``), same numpy-seeded inputs,
``reduced_for_smoke`` of the four dense configs.  Tolerances, each from
the reference test that holds the same quantity:

* layer functions in float32: 2e-5, as ``test_blocked_attention.py:32``
  holds blocked against dense attention; in bfloat16: 2e-2, as
  ``test_flash_attention_kernel.py:56`` holds bfloat16 attention;
* ``forward_train`` / ``forward_prefill`` logits and the cache after
  prefill: 2e-4 (``test_arch_smoke.py:80``); ``forward_decode`` logits
  and the cache after it: 2e-3 (``test_arch_smoke.py:95``); the
  blocked-attention model: 5e-4 (``test_blocked_attention.py:56``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from _hypothesis_compat import given, settings, st

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as R_ARCH_IDS
from repro.configs import SHAPES as R_SHAPES
from repro.configs import all_cells as r_all_cells
from repro.configs import get_config as r_get_config
from repro.models import api as RA
from repro.models import layers as RL
from repro.models.config import reduced_for_smoke as r_reduced

from repro_torch import configs as TC
from repro_torch.models import api as TA
from repro_torch.models import layers as TL
from repro_torch.models.config import reduced_for_smoke as t_reduced

DENSE = ("llama3-8b", "llama3-405b", "command-r-35b", "command-r-plus-104b")
B, S = 2, 16
F32_TOL = 2e-5
BF16_TOL = 2e-2


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _pair(x, dtype="float32"):
    """The same numpy array as a JAX array and a CPU tensor."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _cfgs(arch, **over):
    return (r_reduced(r_get_config(arch), **over),
            t_reduced(TC.get_config(arch), **over))


def _schema_params(tree, seed, scale=0.05):
    """numpy parameters for a schema subtree of PSpecs: seeded normals for
    every leaf (biases and gains too, so they are exercised)."""
    out = {}
    for i, (k, ps) in enumerate(sorted(tree.items())):
        out[k] = _rand(ps.shape, seed + i, scale) + (
            1.0 if ps.init == "ones" else 0.0)
    return out


def _both_params(tree, seed):
    p = _schema_params(tree, seed)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


# ------------------------------------------------------- configs ---

def test_config_registry_matches_reference():
    assert TC.ARCH_IDS == R_ARCH_IDS
    assert ({k: dataclasses.asdict(v) for k, v in TC.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in R_SHAPES.items()})
    assert TC.all_cells() == r_all_cells()
    for arch in R_ARCH_IDS:
        r, t = r_get_config(arch), TC.get_config(arch)
        assert dataclasses.asdict(r) == dataclasses.asdict(t)
        assert t.pdtype == torch.float32 and t.cdtype == torch.bfloat16
        assert (dataclasses.asdict(r_reduced(r))
                == dataclasses.asdict(t_reduced(t)))


def test_param_count_matches_reference_for_all_configs():
    for arch in R_ARCH_IDS:
        assert TA.param_count(TC.get_config(arch)) == RA.param_count(
            r_get_config(arch)), arch
    assert TA.param_count(TC.get_config("llama3-8b")) == 8_030_261_248


# ------------------------------------------------------- layers ---

@pytest.mark.parametrize("norm_type", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("norm_f32", [1, 0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_reference(norm_type, norm_f32, dtype):
    rc, tc = _cfgs("llama3-8b", norm_type=norm_type, norm_f32=norm_f32)
    rp, tp = _both_params(TL.norm_schema(tc), 1)
    rx, tx = _pair(_rand((B, S, tc.d_model), 2, 3.0) + 0.5, dtype)
    got = TL.apply_norm(tp, tc, tx)
    assert got.dtype == tx.dtype
    _close(got, RL.apply_norm(rp, rc, rx),
           F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("mrope", [False, True])
@pytest.mark.parametrize("lowp", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_and_mrope_match_reference(mrope, lowp, dtype):
    hd, h = 32, 4
    rq, tq = _pair(_rand((B, S, h, hd), 3), dtype)
    rk, tk = _pair(_rand((B, S, 2, hd), 4), dtype)
    pos = np.random.RandomState(5).randint(0, 4096, (B, S)).astype(np.int32)
    sections = None
    if mrope:
        pos = np.stack([pos, pos // 7, pos % 13])
        sections = (4, 6, 6)
    ro = RL.apply_rope(rq, rk, jnp.asarray(pos), 500000.0,
                       mrope_sections=sections, lowp=lowp)
    to = TL.apply_rope(tq, tk, torch.from_numpy(pos), 500000.0,
                       mrope_sections=sections, lowp=lowp)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for got, want in zip(to, ro):
        assert got.dtype == tq.dtype
        _close(got, want, tol)


def test_sinusoids_match_reference():
    _close(TL.sinusoidal_positions(40, 64), RL.sinusoidal_positions(40, 64),
           F32_TOL)
    _close(TL.sinusoidal_position_at(17, 64),
           RL.sinusoidal_position_at(17, 64), F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("masked", [True, False])
def test_gqa_scores_and_mix_matches_reference(dtype, softcap, masked):
    s, t = 16, 24
    rq, tq = _pair(_rand((B, s, 8, 16), 6), dtype)
    rk, tk = _pair(_rand((B, t, 2, 16), 7), dtype)
    rv, tv = _pair(_rand((B, t, 2, 16), 8), dtype)
    rm = RL.causal_mask(s, t, 3) if masked else None
    tm = TL.causal_mask(s, t, 3) if masked else None
    if masked:
        np.testing.assert_array_equal(np.asarray(rm), tm.numpy())
    got = TL.gqa_scores_and_mix(tq, tk, tv, tm, softcap)
    assert got.dtype == tq.dtype
    _close(got, RL.gqa_scores_and_mix(rq, rk, rv, rm, softcap),
           F32_TOL if dtype == "float32" else BF16_TOL)


@settings(deadline=None, max_examples=15)
@given(s=st.sampled_from([8, 16, 24, 32]), block=st.sampled_from([4, 8, 16]),
       hq_hkv=st.sampled_from([(4, 4), (8, 2), (4, 1)]),
       softcap=st.sampled_from([0.0, 30.0]), seed=st.integers(0, 2 ** 16))
def test_blocked_causal_gqa_matches_reference(s, block, hq_hkv, softcap,
                                              seed):
    if s % min(block, s):
        return
    hq, hkv = hq_hkv
    rq, tq = _pair(_rand((1, s, hq, 8), seed))
    rk, tk = _pair(_rand((1, s, hkv, 8), seed + 1))
    rv, tv = _pair(_rand((1, s, hkv, 8), seed + 2))
    got = TL.blocked_causal_gqa(tq, tk, tv, block, softcap)
    _close(got, RL.blocked_causal_gqa(rq, rk, rv, block, softcap), F32_TOL)
    _close(got, TL.gqa_scores_and_mix(tq, tk, tv, TL.causal_mask(s, s, 0),
                                      softcap), F32_TOL)


def _attn_setup(arch, seed, **over):
    rc, tc = _cfgs(arch, **over)
    rp, tp = _both_params(TL.attn_schema(tc), seed)
    return rc, tc, rp, tp


@pytest.mark.parametrize("arch,over", [
    ("llama3-8b", {}), ("llama3-8b", {"attn_block": 8}),
    ("llama3-8b", {"attn_repeat_kv": 1}), ("llama3-8b", {"norm_f32": 0}),
    ("command-r-35b", {"logits_softcap": 30.0}), ("whisper-small", {}),
    ("qwen2-vl-2b", {})])
@pytest.mark.parametrize("mode", ["causal", "bidir"])
def test_attention_self_modes_match_reference(arch, over, mode):
    rc, tc, rp, tp = _attn_setup(arch, 10, **over)
    rx, tx = _pair(_rand((B, S, tc.d_model), 11))
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    if tc.family == "vlm":
        pos = np.stack([pos, pos // 2, pos // 3])
    pos = np.ascontiguousarray(pos)
    ro, _ = RL.attention(rp, rc, rx, positions=jnp.asarray(pos), mode=mode)
    to, tcache = TL.attention(tp, tc, tx, positions=torch.from_numpy(pos),
                              mode=mode)
    assert tcache is None
    _close(to, ro, F32_TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-small"])
def test_attention_cross_mode_matches_reference(arch):
    rc, tc, rp, tp = _attn_setup(arch, 20)
    rx, tx = _pair(_rand((B, S, tc.d_model), 21))
    rkv, tkv = _pair(_rand((B, 24, tc.d_model), 22))
    ro, _ = RL.attention(rp, rc, rx, mode="cross", kv_x=rkv)
    to, _ = TL.attention(tp, tc, tx, mode="cross", kv_x=tkv)
    _close(to, ro, F32_TOL)
    ck = _rand((B, 24, tc.n_kv_heads, tc.head_dim), 23)
    cv = _rand((B, 24, tc.n_kv_heads, tc.head_dim), 24)
    ro, _ = RL.attention(rp, rc, rx, mode="cross", kv_x=rkv,
                         cache={"ck": jnp.asarray(ck), "cv": jnp.asarray(cv)})
    to, _ = TL.attention(tp, tc, tx, mode="cross", kv_x=tkv,
                         cache={"ck": torch.from_numpy(ck),
                                "cv": torch.from_numpy(cv)})
    _close(to, ro, F32_TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "command-r-35b",
                                  "whisper-small", "qwen2-vl-2b"])
@pytest.mark.parametrize("cache_pos", [0, 5, 11])
def test_attention_decode_mode_matches_reference(arch, cache_pos):
    rc, tc, rp, tp = _attn_setup(arch, 30)
    rx, tx = _pair(_rand((B, 1, tc.d_model), 31))
    shape = (B, 12, tc.n_kv_heads, tc.head_dim)
    k0, v0 = _rand(shape, 32), _rand(shape, 33)
    ro, rc_new = RL.attention(rp, rc, rx, mode="decode",
                              cache={"k": jnp.asarray(k0),
                                     "v": jnp.asarray(v0)},
                              cache_pos=jnp.int32(cache_pos))
    tcache = {"k": torch.from_numpy(k0.copy()),
              "v": torch.from_numpy(v0.copy())}
    to, tc_new = TL.attention(tp, tc, tx, mode="decode", cache=tcache,
                              cache_pos=cache_pos)
    _close(to, ro, F32_TOL)
    assert tc_new["k"] is tcache["k"]            # written in place
    for name in ("k", "v"):
        _close(tc_new[name], rc_new[name], F32_TOL)
    with pytest.raises(ValueError, match="outside the cache"):
        TL.attention(tp, tc, tx, mode="decode", cache=tcache, cache_pos=12)


@pytest.mark.parametrize("arch", ["llama3-8b", "whisper-small"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(arch, dtype):
    rc, tc = _cfgs(arch)
    rp, tp = _both_params(TL.mlp_schema(tc), 40)
    rx, tx = _pair(_rand((B, S, tc.d_model), 41), dtype)
    got = TL.apply_mlp(tp, tc, tx)
    assert got.dtype == tx.dtype
    _close(got, RL.apply_mlp(rp, rc, rx),
           F32_TOL if dtype == "float32" else BF16_TOL)


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("tie", [False, True])
def test_embedding_and_lm_logits_match_reference(softcap, tie):
    rc, tc = _cfgs("llama3-8b", logits_softcap=softcap, tie_embeddings=tie)
    rp, tp = _both_params(TL.embed_schema(tc), 50)
    tok = np.random.RandomState(51).randint(0, tc.vocab, (B, S))
    got = TL.embed_tokens(tp, tc, torch.from_numpy(tok))
    _close(got, RL.embed_tokens(rp, rc, jnp.asarray(tok)), 0.0)
    rx, tx = _pair(_rand((B, S, tc.d_model), 52))
    _close(TL.lm_logits(tp, tc, tx), RL.lm_logits(rp, rc, rx), F32_TOL)


# ------------------------------------------------------- the model ---

@pytest.fixture(scope="module")
def models():
    """Per dense arch: configs, the reference's params in both packages,
    the prompt, and the reference's train/prefill/decode results."""
    out = {}
    for i, arch in enumerate(DENSE):
        rc, tc = _cfgs(arch)
        rp = RA.init_params(rc, jax.random.PRNGKey(i))
        tp = TA.params_from_numpy(tc, jax.tree.map(np.asarray, rp),
                                  device="cpu")
        tok = np.random.RandomState(60 + i).randint(
            0, tc.vocab, (B, S)).astype(np.int32)
        logits, _ = RA.forward_train(rc, rp, {"tokens": jnp.asarray(tok)})
        pre, cache = RA.forward_prefill(rc, rp, {"tokens": jnp.asarray(tok)},
                                        S + 4)
        nxt = np.asarray(jnp.argmax(pre[:, 0], -1)).astype(np.int32)[:, None]
        dec, cache2 = RA.forward_decode(rc, rp, jnp.asarray(nxt), cache)
        out[arch] = dict(rc=rc, tc=tc, rp=rp, tp=tp, tok=tok, nxt=nxt,
                         logits=logits, pre=pre, cache=cache, dec=dec,
                         cache2=cache2)
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_forward_train_matches_reference(models, arch):
    m = models[arch]
    logits, aux = TA.forward_train(m["tc"], m["tp"],
                                   {"tokens": torch.from_numpy(m["tok"])})
    assert logits.shape == (B, S, m["tc"].vocab) and float(aux) == 0.0
    _close(logits, m["logits"], 2e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_forward_prefill_and_decode_match_reference(models, arch):
    m = models[arch]
    pre, cache = TA.forward_prefill(m["tc"], m["tp"],
                                    {"tokens": torch.from_numpy(m["tok"])},
                                    S + 4)
    _close(pre, m["pre"], 2e-4)
    assert cache["pos"] == int(m["cache"]["pos"]) == S
    for name in ("k", "v"):
        assert cache[name].shape == m["cache"][name].shape
        _close(cache[name], m["cache"][name], 2e-4)
    k_buf = cache["k"]
    dec, cache2 = TA.forward_decode(m["tc"], m["tp"],
                                    torch.from_numpy(m["nxt"]), cache)
    _close(dec, m["dec"], 2e-3)
    assert cache2["pos"] == int(m["cache2"]["pos"]) == S + 1
    assert cache2["k"] is k_buf                      # updated in place
    for name in ("k", "v"):
        _close(cache2[name], m["cache2"][name], 2e-3)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_consistency(models, arch):
    """The reference's check on the port alone: decode(prefill(prompt))
    logits == train-forward logits (test_arch_smoke.py:66-95)."""
    m = models[arch]
    tc, tp = m["tc"], m["tp"]
    tok = torch.from_numpy(m["tok"])
    logits, _ = TA.forward_train(tc, tp, {"tokens": tok})
    pre, cache = TA.forward_prefill(tc, tp, {"tokens": tok}, S + 4)
    _close(pre[:, 0], logits[:, -1], 2e-4)
    nxt = pre[:, 0].argmax(-1).to(torch.int32)[:, None]
    dec, _ = TA.forward_decode(tc, tp, nxt, cache)
    ext, _ = TA.forward_train(tc, tp, {"tokens": torch.cat([tok, nxt], 1)})
    _close(dec[:, 0], ext[:, -1], 2e-3)


def test_blocked_attention_model_matches_reference(models):
    m = models["llama3-8b"]
    rc = dataclasses.replace(m["rc"], attn_block=8)
    tc = dataclasses.replace(m["tc"], attn_block=8)
    want, _ = RA.forward_train(rc, m["rp"], {"tokens": jnp.asarray(m["tok"])})
    got, _ = TA.forward_train(tc, m["tp"], {"tokens": torch.from_numpy(
        m["tok"])})
    _close(got, want, 5e-4)
    _close(got, m["logits"], 5e-4)


# ------------------------------------------- init, carry-across, errors ---

def test_init_params_seeded_on_cpu():
    tc = t_reduced(TC.get_config("command-r-35b"))
    a = TA.init_params(tc, 7, device="cpu")
    b = TA.init_params(tc, 7, device="cpu")
    c = TA.init_params(tc, 8, device="cpu")
    sch = TA.schema(tc)
    for (path, ps), (_, x) in zip(TA.tree_leaves(sch), TA.tree_leaves(a)):
        assert tuple(x.shape) == ps.shape and x.dtype == torch.float32
        y, z = b, c
        for k in path:
            y, z = y[k], z[k]
        assert torch.equal(x, y)
        if ps.init == "ones":
            assert torch.equal(x, torch.ones_like(x))
        elif ps.init == "zeros":
            assert not x.any()
        else:
            assert not torch.equal(x, z)
            want = ps.scale / (np.sqrt(2.0) if ps.init == "out_proj" else 1)
            assert abs(float(x.std()) - want) < 0.2 * want
    logits, _ = TA.forward_train(tc, a, {"tokens": torch.zeros(
        (1, 8), dtype=torch.int64)})
    assert torch.isfinite(logits).all()


def test_params_from_numpy_checks_shapes():
    tc = t_reduced(TC.get_config("llama3-8b"))
    tree = jax.tree.map(np.asarray, RA.init_params(
        r_reduced(r_get_config("llama3-8b")), jax.random.PRNGKey(0)))
    tree["final_norm"]["gamma"] = np.ones(7, np.float32)
    with pytest.raises(ValueError, match="final_norm/gamma"):
        TA.params_from_numpy(tc, tree, device="cpu")


def test_params_from_numpy_carries_bfloat16():
    tc = t_reduced(TC.get_config("llama3-8b"), param_dtype="bfloat16")
    rc = r_reduced(r_get_config("llama3-8b"), param_dtype="bfloat16")
    tree = jax.tree.map(np.asarray, RA.init_params(rc, jax.random.PRNGKey(0)))
    tp = TA.params_from_numpy(tc, tree, device="cpu")
    w = tp["blocks"]["attn"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(w.float().numpy(),
                                  tree["blocks"]["attn"]["wq"].astype(
                                      np.float32))


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "zamba2-1.2b", "rwkv6-1.6b",
                                  "whisper-small", "qwen2-vl-2b"])
def test_other_families_not_ported_yet(arch):
    tc = t_reduced(TC.get_config(arch))
    for call in (lambda: TA.init_params(tc, 0, device="cpu"),
                 lambda: TA.init_cache(tc, 1, 8, device="cpu"),
                 lambda: TA.forward_train(tc, {}, {"tokens": None}),
                 lambda: TA.forward_prefill(tc, {}, {"tokens": None}, 8),
                 lambda: TA.forward_decode(tc, {}, None, {})):
        with pytest.raises(NotImplementedError, match="queue 1 item 11"):
            call()


def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = t_reduced(TC.get_config("llama3-8b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.init_params(tc, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.init_cache(tc, 1, 8)
