"""Flash attention of the torch port against the JAX reference.

The CPU tests feed the same numpy-seeded inputs to the reference's
Pallas kernel (interpret mode, as ``tests/test_flash_attention_kernel.py``
runs it) and to the port's plain path, at that test's tolerances:
2e-5 for float32, 2e-2 for bfloat16.  The reference is imported inside
the tests, so that the ``gpu``-marked ones, which hold the CUDA kernel
against its plain version, also run on a machine without JAX:

    python -m pytest -m gpu tests/test_torch_flash_attention.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.models import layers as TL

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _jax(x, dtype="float32"):
    import jax.numpy as jnp
    return jnp.asarray(x, getattr(jnp, dtype))


def _torch(x, dtype="float32", device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _dense_oracle(q, k, v, causal):
    """numpy float64 attention with the top-left causal mask."""
    sc = q.astype(np.float64) @ k.astype(np.float64).T / np.sqrt(q.shape[1])
    if causal:
        sc = np.where(np.tril(np.ones(sc.shape, bool)), sc, -1e30)
    w = np.exp(sc - sc.max(-1, keepdims=True))
    return (w / w.sum(-1, keepdims=True)) @ v.astype(np.float64)


# ------------------------------------------------ the reference's grid ---

@pytest.mark.parametrize("s,blk", [(128, 128), (256, 128), (512, 256)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_single_matches_reference(s, blk, hd, causal):
    from repro.kernels.flash_attention import flash_attention_single
    q, k, v = (_rand((s, hd), i) for i in range(3))
    ref = flash_attention_single(_jax(q), _jax(k), _jax(v), causal=causal,
                                 block_q=blk, block_k=blk)
    out = tfa.flash_attention_single(_torch(q), _torch(k), _torch(v),
                                     causal=causal, block_q=blk, block_k=blk)
    assert out.shape == (s, hd) and out.dtype == torch.float32
    np.testing.assert_allclose(_f32(out), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_matches_reference_and_model_attention(dtype):
    from repro.kernels.flash_attention import flash_attention
    b, s, hq, hkv, hd = 2, 256, 4, 2, 64
    q, k, v = (_rand(shp, i) for i, shp in
               ((3, (b, s, hq, hd)), (4, (b, s, hkv, hd)),
                (5, (b, s, hkv, hd))))
    ref = flash_attention(_jax(q, dtype), _jax(k, dtype), _jax(v, dtype),
                          causal=True, block_q=128, block_k=128)
    tq, tk, tv = (_torch(x, dtype) for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=True, block_q=128,
                              block_k=128)
    assert out.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=tol, atol=tol)
    model = TL.gqa_scores_and_mix(tq, tk, tv, TL.causal_mask(s, s, 0))
    np.testing.assert_allclose(_f32(out), _f32(model), rtol=tol, atol=tol)


@pytest.mark.parametrize("s,t,causal", [(128, 384, False), (128, 384, True),
                                        (256, 128, True)])
def test_rectangular_matches_reference(s, t, causal):
    """T != S: cross-attention shapes, and the top-left causal mask
    (query i sees keys j <= i) in both directions."""
    from repro.kernels.flash_attention import flash_attention_single
    hd = 64
    q, k, v = _rand((s, hd), 6), _rand((t, hd), 7), _rand((t, hd), 8)
    ref = flash_attention_single(_jax(q), _jax(k), _jax(v), causal=causal,
                                 block_q=128, block_k=128)
    out = tfa.flash_attention_single(_torch(q), _torch(k), _torch(v),
                                     causal=causal, block_q=128, block_k=128)
    np.testing.assert_allclose(_f32(out), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(_f32(out), _dense_oracle(q, k, v, causal),
                               rtol=F32_TOL, atol=F32_TOL)


# ------------------------------------------------------------- errors ---

@pytest.mark.parametrize("s,t,bq,bk", [(192, 128, 128, 128),
                                       (128, 200, 128, 128),
                                       (256, 256, 96, 128)])
def test_tile_divisibility_raises_like_reference(s, t, bq, bk):
    from repro.kernels.flash_attention import flash_attention_single
    q, k, v = _rand((s, 64), 0), _rand((t, 64), 1), _rand((t, 64), 2)
    with pytest.raises(AssertionError):
        flash_attention_single(_jax(q), _jax(k), _jax(v), block_q=bq,
                               block_k=bk)
    with pytest.raises(ValueError, match="multiples of the tiles"):
        tfa.flash_attention_single(_torch(q), _torch(k), _torch(v),
                                   block_q=bq, block_k=bk)


@pytest.mark.parametrize("dtypes", [("int32",) * 3, ("float64",) * 3,
                                    ("float32", "bfloat16", "float32")])
def test_dtype_errors(dtypes):
    q, k, v = (_torch(_rand((1, 128, 2, 64), i), dt)
               for i, dt in enumerate(dtypes))
    with pytest.raises(ValueError, match="must share one of"):
        tfa.flash_attention(q, k, v)


def test_shape_and_impl_errors():
    q = _torch(_rand((1, 128, 3, 64), 0))
    kv = _torch(_rand((1, 128, 2, 64), 1))
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        tfa.flash_attention(q, kv, kv)
    q = _torch(_rand((1, 128, 4, 64), 0))
    with pytest.raises(ValueError, match="batch and head dim"):
        tfa.flash_attention(q, kv[..., :32].contiguous(),
                            kv[..., :32].contiguous())
    with pytest.raises(ValueError, match="unknown impl"):
        tfa.flash_attention(q, kv, kv, impl="pallas")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tfa.flash_attention(q, kv, kv, impl="cuda")
    small = _torch(_rand((1, 128, 2, 32), 2))
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention_cuda(small, small, small)


def test_cpu_tensors_take_the_plain_version_uncounted():
    tfa.reset_launch_counts()
    x = _torch(_rand((128, 64), 0))
    auto = tfa.flash_attention_single(x, x, x)
    plain = tfa.flash_attention_single(x, x, x, impl="ref")
    assert torch.equal(auto, plain)
    assert tfa.launch_counts == {"flash": 0, "ref_on_cuda": 0}


# ------------------------------------------------ the kernel on a card ---

@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


GPU_SHAPES = [  # (B, S, T, Hq, Hkv, block_q, block_k)
    (2, 256, 256, 8, 2, 128, 128),
    (1, 128, 384, 4, 4, 128, 128),
    (1, 384, 128, 4, 1, 128, 128),
    (2, 100, 200, 4, 2, 256, 256),        # ragged: S, T not multiples of 64
]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", GPU_SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, dtype, hd, causal, shape):
    b, s, t, hq, hkv, bq, bk = shape
    q = _torch(_rand((b, s, hq, hd), 11), dtype, cuda_device)
    k = _torch(_rand((b, t, hkv, hd), 12), dtype, cuda_device)
    v = _torch(_rand((b, t, hkv, hd), 13), dtype, cuda_device)
    before = tfa.launch_counts["flash"]
    out = tfa.flash_attention(q, k, v, causal=causal, block_q=bq,
                              block_k=bk)
    plain = tfa.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tfa.launch_counts["flash"] == before + 1
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(_f32(out.cpu()), _f32(plain.cpu()), rtol=tol,
                               atol=tol)


@pytest.mark.gpu
def test_cuda_counts_and_rejects(cuda_device):
    x = _torch(_rand((1, 128, 2, 64), 0), "float32", cuda_device)
    tfa.reset_launch_counts()
    tfa.flash_attention(x, x, x)
    tfa.flash_attention(x, x, x, impl="ref")
    assert tfa.launch_counts == {"flash": 1, "ref_on_cuda": 1}
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(x.transpose(1, 2).contiguous().transpose(1, 2),
                            x, x)
    with pytest.raises(ValueError, match="head dims"):
        y = x[..., :32].contiguous()
        tfa.flash_attention(y, y, y)
    with pytest.raises(ValueError, match="one CUDA device"):
        tfa.flash_attention_cuda(x, x.cpu(), x)
    assert tfa.launch_counts["flash"] == 1
