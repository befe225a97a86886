"""Flash attention: the port of ``repro.kernels.flash_attention``.

Blocked attention with an online softmax: the scores never reach
device memory.  The public functions keep the reference's names,
layouts and arguments:

* :func:`flash_attention_single` — one problem, q ``(S, hd)``, k/v
  ``(T, hd)``;
* :func:`flash_attention` — grouped-query attention, q ``(B, S, Hq,
  hd)``, k/v ``(B, T, Hkv, hd)``; query head ``h`` reads kv head
  ``h // (Hq // Hkv)``.

Both compute in float32 whatever the input type, mask with ``-1e30``,
align the causal mask top-left (key ``j`` is seen by query ``i`` iff
``j <= i``, also when ``T != S``) and return the input type.  Both
raise, as the reference asserts, unless ``S % min(block_q, S) == 0`` and
``T % min(block_k, T) == 0``; the tile sizes are otherwise the
reference's (the CUDA kernel tiles by 64 on its own).

Two implementations, chosen by ``impl`` as in
:mod:`repro_torch.kernels.segmented_copy`:

* ``'cuda'`` — the hand-written Hopper kernel of
  ``csrc/flash_attention.cu`` (:func:`flash_attention_cuda`), for CUDA
  tensors: float32, bfloat16 or float16, head dim 64 or 128;
* ``'ref'`` — :func:`flash_attention_ref`, the plain torch version: the
  same function as one dense float32 softmax.

``'auto'`` takes the kernel for CUDA tensors and the plain version for
CPU tensors; ``'cuda'`` on CPU tensors raises.  There is no fallback: a
CUDA tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict

import torch

IMPLS = ("auto", "cuda", "ref")
#: input types, in the order of their codes in ``csrc/flash_attention.cu``
DTYPES = (torch.float32, torch.bfloat16, torch.float16)
#: head dims the kernel is built for
HEAD_DIMS = (64, 128)
#: the kernel's grid runs batch x q heads on its y axis
MAX_BATCH_HEADS = 65535
MASK_VALUE = -1e30

#: launches of the kernel, counted by its wrapper where it launches (and
#: nowhere else); ``ref_on_cuda`` counts plain-version calls on CUDA
#: tensors, which ``impl='auto'`` never makes.
launch_counts: Dict[str, int] = {"flash": 0, "ref_on_cuda": 0}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in launch_counts:
            launch_counts[k] = 0


def _bump(name: str) -> None:
    with _COUNT_LOCK:
        launch_counts[name] += 1


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  block_q: int, block_k: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q must be (B,S,Hq,hd) and k, v (B,T,Hkv,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"batch and head dim of q {tuple(q.shape)} and "
                         f"k/v {tuple(k.shape)} differ")
    hkv = k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"q heads {hq} are not a multiple of kv heads {hkv}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise ValueError(f"q, k, v must share one of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    t = k.shape[1]
    bq, bk = min(block_q, s), min(block_k, t)
    if bq <= 0 or bk <= 0 or s % bq or t % bk:
        raise ValueError(f"S={s} and T={t} must be multiples of the tiles "
                         f"min(block_q, S)={bq} and min(block_k, T)={bk}")


def resolve_impl(impl: str, q: torch.Tensor) -> str:
    """``'auto'`` → ``'cuda'`` for a CUDA tensor, ``'ref'`` for a CPU
    one; ``'cuda'`` for a CPU tensor raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    if impl == "auto":
        return "cuda" if q.is_cuda else "ref"
    if impl == "cuda" and not q.is_cuda:
        raise ValueError(f"impl='cuda' needs CUDA tensors, got {q.device}")
    return impl


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """The plain version: q ``(B,S,Hq,hd)``, k/v ``(B,T,Hkv,hd)`` →
    ``(B,S,Hq,hd)`` in q's type, computed as one float32 softmax over
    scores masked with ``-1e30`` (top-left causal)."""
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, hkv, hq // hkv, hd)
    sc = torch.einsum("bskgh,btkh->bkgst", qg, k.float()) * (
        1.0 / math.sqrt(hd))
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(t, device=q.device)[None, :]
        sc = torch.where(cols <= rows, sc, MASK_VALUE)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bkgst,btkh->bskgh", w, v.float())
    return out.reshape(b, s, hq, hd).to(q.dtype)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """The hand-written kernel on q's current stream: a new
    ``(B,S,Hq,hd)`` tensor in q's type.  Takes contiguous CUDA tensors of
    one device, float32 / bfloat16 / float16, head dim 64 or 128, and at
    most :data:`MAX_BATCH_HEADS` batch x q heads; raises on anything
    else."""
    from . import _build

    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash kernel takes head dims {HEAD_DIMS}, "
                         f"got {hd}")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"the flash kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if b * hq > MAX_BATCH_HEADS:
        raise ValueError(f"batch x q heads {b * hq} exceeds "
                         f"{MAX_BATCH_HEADS}")
    out = torch.empty_like(q)
    lib = _build.load("flash_attention")
    strides = [x.stride(i) for x in (q, k, v, out) for i in range(3)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.dart_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, t,
            hq, hkv, hd, *strides, DTYPES.index(q.dtype), int(causal),
            ctypes.c_float(1.0 / math.sqrt(hd)), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"flash attention launch failed: "
                           f"{_build.error_string(err, 'flash_attention')}")
    _bump("flash")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128, impl: str = "auto") -> torch.Tensor:
    """GQA flash attention.  q: ``(B,S,Hq,hd)``; k/v: ``(B,T,Hkv,hd)``."""
    _check_inputs(q, k, v, block_q, block_k)
    if resolve_impl(impl, q) == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal)
    if q.is_cuda:
        _bump("ref_on_cuda")
    return flash_attention_ref(q, k, v, causal=causal)


def flash_attention_single(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           block_q: int = 128, block_k: int = 128,
                           impl: str = "auto") -> torch.Tensor:
    """One ``(seq, head_dim)`` attention problem.  q: ``(S,hd)``, k/v:
    ``(T,hd)``."""
    if q.dim() != 2 or k.dim() != 2:
        raise ValueError(f"q must be (S,hd) and k, v (T,hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    out = flash_attention(q[None, :, None], k[None, :, None],
                          v[None, :, None], causal=causal, block_q=block_q,
                          block_k=block_k, impl=impl)
    return out[0, :, 0]
