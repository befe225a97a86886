"""Shape-stable segmented copy: the dispatch substrate of
``CommEngine.flush``, on torch.

One coalesced run of puts (or gets) becomes ONE dispatch over a packed
``(kb, 6)`` int32 descriptor table and, for puts, ONE flat uint8
payload buffer.  Descriptor ``i`` names a strided run: ``count``
segments of ``len`` bytes, ``stride`` bytes apart, starting at byte
``off`` of arena row ``row``; its payload lies densely at ``start`` in
the flat buffer.  Lane ``lane < len*count`` of descriptor ``i`` is arena
byte

    row*P + off + (lane // len)*stride + lane % len

(``P`` = pool bytes).  Run length buckets to a power of two (floor 4),
the segment to a power of two (floor 16) and the flat buffer to
``kb*seg + seg`` bytes, padded with all-zero descriptors that move
nothing, so a small family of plans serves every epoch.

The host layer — :func:`bucket_pow2`, :func:`pack_descriptors`,
:func:`pack_acc_descriptors`, :func:`check_flat_addressable`,
:func:`strided_buckets`, :data:`REDUCE_OPS` and the column constants —
is the JAX reference's numpy code, verbatim, so both packages stage
byte-identical tables; :func:`op_identity` / :func:`identity_bytes`
build the same identities with torch (bfloat16 included).

The reduction plane (``dart_accumulate`` / ``dart_get_accumulate``)
rides the same substrate: an accumulate descriptor adds an op column
(``(kb, 7)``), and each valid lane's element becomes ``old op payload``
(:func:`combine`: sum, prod, min, max with XLA's semantics).

Two implementations sit behind :func:`scatter_plan`,
:func:`gather_plan` and :func:`accumulate_plan`:

* ``'cuda'`` — the hand-written Hopper kernels of
  ``csrc/segmented_copy.cu`` (ports of the reference's
  ``_pallas_scatter_kernel``, ``_pallas_gather_kernel`` and
  ``_pallas_acc_kernel``), launched by :func:`scatter_cuda` /
  :func:`gather_cuda` / :func:`accumulate_cuda` on the arena's device;
* ``'ref'`` — plain torch versions of the reference's XLA kernels
  (``_ref_scatter_vec``, ``_ref_scatter_ordered``, ``_ref_gather``,
  ``_ref_accumulate_vec``, ``_ref_accumulate_ordered``) with the same
  flat-index formula and masking.  They serve CPU arenas and the
  tests.

``'auto'`` picks the kernel for a CUDA arena and the plain version for a
CPU arena (:func:`resolve_impl`).  The kernels address every lane
exactly, so — unlike the reference's Pallas kernels, which read padded
windows and need pool headroom — they have no precondition and no
per-dispatch fallback: on a CUDA arena every dispatch is a kernel
launch.  Arenas are updated in place.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

# descriptor columns: desc[i] = (row, off, len, start, stride, count[, op])
ROW, OFF, LEN, START, STRIDE, COUNT, OPCODE = 0, 1, 2, 3, 4, 5, 6
DESC_COLS = 6           # put/get descriptor width
ACC_DESC_COLS = 7       # accumulate descriptor width (adds OPCODE)

#: element-wise reduction ops of the reduction plane (dart_accumulate /
#: dart_allreduce): name → descriptor op code.
REDUCE_OPS = {"sum": 0, "prod": 1, "min": 2, "max": 3}

#: element types the accumulate kernels take, in the order of their type
#: codes in ``csrc/segmented_copy.cu`` (64-bit values are narrowed to
#: 32 bits at initiation; bool and complex are refused there).
ACC_DTYPES = ("int8", "uint8", "int16", "uint16", "int32", "uint32",
              "float16", "bfloat16", "float32")

#: smallest segment bucket — tiny ops (1..16 B) share one plan
SEG_FLOOR = 16
#: smallest run-length bucket — runs of 1..4 ops share one plan
K_FLOOR = 4
#: smallest flat-payload staging bucket
FLAT_FLOOR = 64


def bucket_pow2(n: int, floor: int = 1) -> int:
    """Next power of two >= max(n, floor) — the shape-stability rule."""
    n = max(int(n), floor, 1)
    return 1 << (n - 1).bit_length()


def pack_descriptors(rows: Sequence[int], offs: Sequence[int],
                     lens: Sequence[int],
                     payloads: Optional[Sequence[np.ndarray]] = None,
                     strides: Optional[Sequence[int]] = None,
                     counts: Optional[Sequence[int]] = None
                     ) -> Tuple[np.ndarray, Optional[np.ndarray], int]:
    """Host-side staging: k ops → one bucketed ``(k', 6)`` int32
    descriptor table (k' = pow2 bucket of k, padded with all-zero
    no-ops) and, for puts, one bucketed flat uint8 payload buffer.

    ``lens`` are **per-segment** bytes; op *i* moves
    ``lens[i] * counts[i]`` bytes in total (``counts`` defaults to all
    ones, ``strides`` to all zeros — the contiguous case).  The
    segment-size bucket covers the *total* bytes of the largest op.
    ``starts`` index into the flat buffer, where payloads pack densely
    (segment j of op i at ``start + j*len``); the buffer carries a
    trailing ``seg`` bytes of zero margin.  Returns ``(desc, flat,
    seg)`` with ``flat is None`` for gathers.
    """
    k = len(rows)
    kb = bucket_pow2(k, K_FLOOR)
    lens = np.asarray(lens, np.int64)
    counts = (np.ones(k, np.int64) if counts is None
              else np.asarray(counts, np.int64))
    strides = (np.zeros(k, np.int64) if strides is None
               else np.asarray(strides, np.int64))
    totals = lens * counts
    seg = bucket_pow2(int(totals.max()) if k else 1, SEG_FLOOR)
    desc = np.zeros((kb, DESC_COLS), np.int32)
    desc[:k, ROW] = rows
    desc[:k, OFF] = offs
    desc[:k, LEN] = lens
    desc[:k, STRIDE] = strides
    desc[:k, COUNT] = counts
    starts = np.zeros(k, np.int64)
    np.cumsum(totals[:-1], out=starts[1:])
    desc[:k, START] = starts
    flat = None
    if payloads is not None:
        # sized by the BUCKETS, not the actual payload total, so the
        # flat staging shape is a pure function of (kb, seg) and warm
        # epochs with any payload mix inside the bucket reuse the plan
        flat = np.zeros(max(kb * seg + seg, FLAT_FLOOR), np.uint8)
        for s, p in zip(starts, payloads):
            flat[int(s):int(s) + p.size] = p
    return desc, flat, seg


def acc_dtype(dtype) -> torch.dtype:
    """The torch dtype of an accumulate element type (a torch or numpy
    dtype, or a name); raises ``ValueError`` outside :data:`ACC_DTYPES`."""
    from repro_torch.core.globmem import torch_dtype
    try:
        dt = torch_dtype(dtype)
    except TypeError:
        dt = None
    if dt is None or str(dt).split(".")[-1] not in ACC_DTYPES:
        raise ValueError(f"accumulate of {dtype} is not supported "
                         f"(element types: {', '.join(ACC_DTYPES)})")
    return dt


def op_identity(op: str, dtype) -> torch.Tensor:
    """The identity element of ``op`` over ``dtype`` (``x op identity ==
    x``), as a 0-d CPU tensor: 0 / 1 for sum / prod, ``+inf`` / ``-inf``
    (floating) or the type's max / min (integral) for min / max."""
    if op not in REDUCE_OPS:
        raise ValueError(f"unknown reduction op {op!r} "
                         f"(supported: {sorted(REDUCE_OPS)})")
    from repro_torch.core.globmem import torch_dtype
    dt = torch_dtype(dtype)
    if dt.is_floating_point:
        v = {"sum": 0.0, "prod": 1.0, "min": math.inf, "max": -math.inf}[op]
    elif dt.is_complex or dt == torch.bool:
        raise ValueError(f"no {op} identity over {dt}")
    else:
        info = torch.iinfo(dt)
        v = {"sum": 0, "prod": 1, "min": info.max, "max": info.min}[op]
    return torch.tensor(v, dtype=dt)


def identity_bytes(op: str, dtype) -> np.ndarray:
    """``op``'s identity element as its little-endian byte pattern
    (``itemsize`` uint8 values)."""
    return op_identity(op, dtype).reshape(1).view(torch.uint8).numpy().copy()


def pack_acc_descriptors(rows: Sequence[int], offs: Sequence[int],
                         lens: Sequence[int],
                         payloads: Sequence[np.ndarray],
                         op: str, dtype,
                         strides: Optional[Sequence[int]] = None,
                         counts: Optional[Sequence[int]] = None
                         ) -> Tuple[np.ndarray, np.ndarray, int]:
    """The reference's accumulate staging: one bucketed ``(k', 7)``
    int32 table (``row, off, len, start, stride, count, op``) and one
    ``k'*seg`` flat buffer in which op ``i`` owns the slot at ``start =
    i*seg``, pre-filled with the op's identity.  The engine stages
    payloads densely instead (:func:`pack_acc_table`); this layout is
    kept for the tests, which hold both against the reference."""
    k = len(rows)
    kb = bucket_pow2(k, K_FLOOR)
    lens = np.asarray(lens, np.int64)
    counts = (np.ones(k, np.int64) if counts is None
              else np.asarray(counts, np.int64))
    strides = (np.zeros(k, np.int64) if strides is None
               else np.asarray(strides, np.int64))
    totals = lens * counts
    seg = bucket_pow2(int(totals.max()) if k else 1, SEG_FLOOR)
    desc = np.zeros((kb, ACC_DESC_COLS), np.int32)
    desc[:k, ROW] = rows
    desc[:k, OFF] = offs
    desc[:k, LEN] = lens
    desc[:k, STRIDE] = strides
    desc[:k, COUNT] = counts
    desc[:k, START] = np.arange(k, dtype=np.int64) * seg
    desc[k:, START] = np.arange(k, kb, dtype=np.int64) * seg
    desc[:, OPCODE] = REDUCE_OPS[op]
    ident = identity_bytes(op, dtype)
    flat = np.tile(ident, kb * seg // ident.size)
    for i, p in enumerate(payloads):
        flat[i * seg:i * seg + p.size] = p
    return desc, flat, seg


def pack_acc_table(rows: Sequence[int], offs: Sequence[int],
                   lens: Sequence[int], op: str,
                   strides: Optional[Sequence[int]] = None,
                   counts: Optional[Sequence[int]] = None
                   ) -> Tuple[np.ndarray, int]:
    """``(desc, seg)``: the ``(k', 7)`` accumulate table with the
    payloads' starts dense in run order, as :func:`pack_descriptors`
    lays out puts, for callers that stage the payloads themselves.  The
    kernels and plain versions touch valid lanes only, so no identity
    fill is needed; the plan key keeps the reference's ``k'*seg``."""
    d6, _, seg = pack_descriptors(rows, offs, lens, strides=strides,
                                  counts=counts)
    desc = np.zeros((d6.shape[0], ACC_DESC_COLS), np.int32)
    desc[:, :DESC_COLS] = d6
    desc[:, OPCODE] = REDUCE_OPS[op]
    return desc, seg


def flat_bucket(kb: int, seg: int) -> int:
    """Length of the flat buffer :func:`pack_descriptors` builds for
    ``kb`` descriptors of segment bucket ``seg`` — the ``flat_len`` of
    the scatter plan key, for callers that stage the payloads
    themselves."""
    return max(kb * seg + seg, FLAT_FLOOR)


def check_flat_addressable(arena_shape: Tuple[int, int]) -> None:
    """The reference's kernels address the arena as a flat int32 byte
    index (``row * pool_bytes + off + lane``), so arenas at or beyond
    2**30 total bytes are refused.  The CUDA kernels index in 64 bits,
    but keep the reference's cap so both packages accept the same
    heaps."""
    n_cells = int(arena_shape[0]) * int(arena_shape[1])
    if n_cells >= 1 << 30:
        raise NotImplementedError(
            f"arena of {n_cells} bytes exceeds the flat int32 "
            "addressing range of the segmented-copy kernels (see "
            "ROADMAP: int64-lane variant for >1 GiB heaps)")


def strided_buckets(desc: np.ndarray, seg: int) -> Tuple[int, int]:
    """``(sseg, cb)`` buckets: the per-segment window bytes (pow2 of the
    largest ``LEN``) and the segment-count extent (pow2 of the largest
    ``COUNT``).  For an all-contiguous run this is exactly ``(seg,
    1)``."""
    lens = desc[:, LEN]
    counts = desc[:, COUNT]
    sseg = bucket_pow2(int(lens.max()) if lens.size else 1, SEG_FLOOR)
    cb = bucket_pow2(int(counts.max()) if counts.size else 1, 1)
    return min(sseg, seg), cb


# --------------------------------------------------------------------------
# Plain torch versions ('ref') — the reference's XLA kernels, on tensors
# --------------------------------------------------------------------------


def _lane_mask(desc: torch.Tensor, seg: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(k, seg) lane grid + validity mask (``lane < len*count``).  Lane
    space is *dense*: lane ``j*len + r`` is byte ``r`` of segment
    ``j``."""
    lane = torch.arange(seg, dtype=torch.int64, device=desc.device)[None, :]
    valid = lane < (desc[:, LEN] * desc[:, COUNT])[:, None]
    return valid, lane


def _strided_dst(desc: torch.Tensor, lane: torch.Tensor, P: int
                 ) -> torch.Tensor:
    """Flat arena byte index per dense lane:
    ``row*P + off + (lane // len)*stride + lane % len``; ``len`` is
    clamped to 1 so padding rows divide safely (their lanes are masked
    off by the callers)."""
    safe_len = desc[:, LEN].clamp(min=1)[:, None]
    return (desc[:, ROW][:, None] * P + desc[:, OFF][:, None]
            + (lane // safe_len) * desc[:, STRIDE][:, None]
            + lane % safe_len)


def _ref_scatter_vec(arena: torch.Tensor, desc: torch.Tensor,
                     flat: torch.Tensor, *, seg: int) -> torch.Tensor:
    """Disjoint segmented put as ONE vectorized update: every valid lane
    lands at its unique arena byte; masked lanes are dropped."""
    P = arena.shape[1]
    d = desc.to(torch.int64)
    valid, lane = _lane_mask(d, seg)
    dst = _strided_dst(d, lane, P)[valid]
    src = (d[:, START][:, None] + lane)[valid]
    arena.view(-1)[dst] = flat[src]
    return arena


def _ref_scatter_ordered(arena: torch.Tensor, desc: torch.Tensor,
                         flat: torch.Tensor, *, seg: int) -> torch.Tensor:
    """Overlap-tolerant segmented put: descriptors apply strictly in
    queue order, preserving last-writer-wins."""
    P = arena.shape[1]
    d = desc.to(torch.int64)
    lane = torch.arange(seg, dtype=torch.int64, device=arena.device)
    out = arena.view(-1)
    for i in range(d.shape[0]):
        row, off, ln, st, stride, cnt = (int(v) for v in d[i].tolist())
        valid = lane < ln * cnt
        if not bool(valid.any()):
            continue
        safe_len = max(ln, 1)
        lv = lane[valid]
        dst = row * P + off + (lv // safe_len) * stride + lv % safe_len
        out[dst] = flat[st + lv]
    return arena


def _ref_gather(arena: torch.Tensor, desc: torch.Tensor, *, seg: int
                ) -> torch.Tensor:
    """Segmented get: (k, seg) pad-to-bucket byte windows; masked lanes
    read as zero."""
    P = arena.shape[1]
    d = desc.to(torch.int64)
    valid, lane = _lane_mask(d, seg)
    out = torch.zeros((d.shape[0], seg), dtype=torch.uint8,
                      device=arena.device)
    out[valid] = arena.view(-1)[_strided_dst(d, lane, P)[valid]]
    return out


def scatter_ref(arena: torch.Tensor, desc: torch.Tensor,
                flat: torch.Tensor, *, seg: int, ordered: bool
                ) -> torch.Tensor:
    """The plain version of :func:`scatter_cuda`, on any device."""
    fn = _ref_scatter_ordered if ordered else _ref_scatter_vec
    return fn(arena, desc, flat, seg=seg)


def gather_ref(arena: torch.Tensor, desc: torch.Tensor, *, seg: int
               ) -> torch.Tensor:
    """The plain version of :func:`gather_cuda`, on any device."""
    return _ref_gather(arena, desc, seg=seg)


_SIGNED_OF = {1: torch.int8, 2: torch.int16, 4: torch.int32}


def combine(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """``a op b`` element-wise on typed tensors, with the reference's
    (XLA's) semantics written out: float16/bfloat16 computed in float32
    and rounded to nearest even; min/max NaN-propagating (a NaN operand
    gives ``a + b``, the hardware's NaN) and ordering ``-0 < +0``, so
    ``min(±0, ∓0) = -0`` and ``max(±0, ∓0) = +0`` (``torch.minimum``
    returns its first operand on a tie); integer sum/prod wrap in two's
    complement."""
    dt = a.dtype
    if dt.is_floating_point:
        x, y = a.float(), b.float()
        if op == "sum":
            r = x + y
        elif op == "prod":
            r = x * y
        else:
            xi, yi = x.view(torch.int32), y.view(torch.int32)
            if op == "min":
                tie = (xi | yi).view(torch.float32)
                r = torch.where(x < y, x, torch.where(y < x, y, tie))
            else:
                tie = (xi & yi).view(torch.float32)
                r = torch.where(x > y, x, torch.where(y > x, y, tie))
            r = torch.where(torch.isnan(x) | torch.isnan(y), x + y, r)
        return r.to(dt)
    isz = dt.itemsize
    sv = _SIGNED_OF[isz]
    # the signed view's values in int64: sums and products are exact
    # (|x|, |y| <= 2**31) and their low bytes are the wrapped result
    x, y = a.view(sv).to(torch.int64), b.view(sv).to(torch.int64)
    if op == "sum":
        r = x + y
    elif op == "prod":
        r = x * y
    else:
        if not dt.is_signed:
            mask = (1 << (8 * isz)) - 1
            x, y = x & mask, y & mask
        r = torch.minimum(x, y) if op == "min" else torch.maximum(x, y)
    low = r.reshape(-1, 1).view(torch.uint8)[:, :isz].reshape(-1)
    return low.view(dt).reshape(a.shape)


def _ref_accumulate_vec(arena: torch.Tensor, desc: torch.Tensor,
                        flat: torch.Tensor, *, seg: int, op: str,
                        dtype: torch.dtype, fetch: bool):
    """Disjoint segmented read-modify-write in one vectorized pass: read
    every valid lane's arena bytes, combine them with the payload at
    ``START + lane`` as elements of ``dtype``, write them back.  Masked
    lanes are never touched, so this works on the reference's
    identity-padded layout and on a dense one alike.  With ``fetch`` the
    ``(kb, seg)`` pre-update windows come back too, zero past each
    op's bytes."""
    P = arena.shape[1]
    d = desc.to(torch.int64)
    valid, lane = _lane_mask(d, seg)
    dst = _strided_dst(d, lane, P)[valid]
    src = (d[:, START][:, None] + lane)[valid]
    cells = arena.view(-1)
    old = cells[dst]
    cells[dst] = combine(old.view(dtype), flat[src].view(dtype),
                         op).view(torch.uint8)
    if not fetch:
        return arena
    out = torch.zeros((d.shape[0], seg), dtype=torch.uint8,
                      device=arena.device)
    out[valid] = old
    return arena, out


def _ref_accumulate_ordered(arena: torch.Tensor, desc: torch.Tensor,
                            flat: torch.Tensor, *, seg: int, op: str,
                            dtype: torch.dtype) -> torch.Tensor:
    """Overlap-tolerant accumulate: descriptors read-modify-write
    strictly in table order, bitwise the blocking order."""
    for i in range(desc.shape[0]):
        _ref_accumulate_vec(arena, desc[i:i + 1], flat, seg=seg, op=op,
                            dtype=dtype, fetch=False)
    return arena


def accumulate_ref(arena: torch.Tensor, desc: torch.Tensor,
                   flat: torch.Tensor, *, seg: int, op: str, dtype,
                   fetch: bool, ordered: bool):
    """The plain version of :func:`accumulate_cuda`, on any device."""
    if fetch and ordered:
        raise ValueError("a fetch run is disjoint: it never takes the "
                         "ordered accumulate")
    dt = acc_dtype(dtype)
    if ordered:
        return _ref_accumulate_ordered(arena, desc, flat, seg=seg, op=op,
                                       dtype=dt)
    return _ref_accumulate_vec(arena, desc, flat, seg=seg, op=op, dtype=dt,
                               fetch=fetch)


# --------------------------------------------------------------------------
# Hand-written Hopper kernels ('cuda') — csrc/segmented_copy.cu
# --------------------------------------------------------------------------

#: launches of each CUDA kernel, counted by its wrapper where it launches
#: (and nowhere else); ``ref_on_cuda`` counts plain-version calls on CUDA
#: arenas, which the engine never makes under ``impl='auto'``.
launch_counts: Dict[str, int] = {"scatter": 0, "scatter_ordered": 0,
                                 "gather": 0, "accumulate": 0,
                                 "accumulate_ordered": 0,
                                 "get_accumulate": 0, "ref_on_cuda": 0}
_COUNT_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in launch_counts:
            launch_counts[k] = 0


def _bump(name: str) -> None:
    with _COUNT_LOCK:
        launch_counts[name] += 1


def _check_common(arena: torch.Tensor, desc: torch.Tensor, seg: int,
                  cols: int = DESC_COLS) -> None:
    if not arena.is_cuda:
        raise ValueError("the CUDA segmented-copy kernels need a CUDA "
                         f"arena, got one on {arena.device}")
    if arena.dtype != torch.uint8 or arena.dim() != 2:
        raise ValueError(f"arena must be 2-D uint8, got {arena.dtype} "
                         f"{tuple(arena.shape)}")
    if (desc.device != arena.device or desc.dtype != torch.int32
            or desc.dim() != 2 or desc.shape[1] != cols):
        raise ValueError(f"desc must be int32 (kb, {cols}) on "
                         f"{arena.device}, got {desc.dtype} "
                         f"{tuple(desc.shape)} on {desc.device}")
    if not (arena.is_contiguous() and desc.is_contiguous()):
        raise ValueError("arena and desc must be contiguous")
    if seg < SEG_FLOOR or seg & (seg - 1):
        raise ValueError(f"seg must be a power of two >= {SEG_FLOOR}, "
                         f"got {seg}")
    check_flat_addressable(tuple(arena.shape))


def _check_flat(arena: torch.Tensor, flat: torch.Tensor) -> None:
    if (flat.device != arena.device or flat.dtype != torch.uint8
            or flat.dim() != 1 or not flat.is_contiguous()):
        raise ValueError(f"flat must be a contiguous 1-D uint8 tensor on "
                         f"{arena.device}")


def scatter_cuda(arena: torch.Tensor, desc: torch.Tensor,
                 flat: torch.Tensor, *, seg: int, ordered: bool
                 ) -> torch.Tensor:
    """Segmented put into ``arena`` in place, on its current stream.
    ``ordered`` applies the descriptors strictly in table order (one
    CTA, barrier between descriptors) for overlapping runs; otherwise
    one parallel grid covers every (descriptor, lane chunk).  The
    descriptors must lie inside the arena and the flat buffer — the
    engine checks every op's geometry at enqueue."""
    from . import _build

    _check_common(arena, desc, seg)
    _check_flat(arena, flat)
    lib = _build.load()
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        err = lib.dart_segmented_scatter(
            arena.data_ptr(), arena.shape[0], arena.shape[1],
            desc.data_ptr(), desc.shape[0], flat.data_ptr(),
            flat.shape[0], seg, int(ordered), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"segmented scatter launch failed: "
                           f"{_build.error_string(err)}")
    _bump("scatter_ordered" if ordered else "scatter")
    return arena


def gather_cuda(arena: torch.Tensor, desc: torch.Tensor, *, seg: int
                ) -> torch.Tensor:
    """Segmented get: a new ``(kb, seg)`` uint8 tensor whose row ``i``
    holds descriptor ``i``'s bytes densely from column 0, zeros after —
    byte-identical to :func:`_ref_gather`."""
    from . import _build

    _check_common(arena, desc, seg)
    out = torch.empty((desc.shape[0], seg), dtype=torch.uint8,
                      device=arena.device)
    lib = _build.load()
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        err = lib.dart_segmented_gather(
            arena.data_ptr(), arena.shape[0], arena.shape[1],
            desc.data_ptr(), desc.shape[0], out.data_ptr(), seg,
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"segmented gather launch failed: "
                           f"{_build.error_string(err)}")
    _bump("gather")
    return out


def accumulate_cuda(arena: torch.Tensor, desc: torch.Tensor,
                    flat: torch.Tensor, *, seg: int, op: str, dtype,
                    fetch: bool, ordered: bool):
    """Segmented read-modify-write of ``arena`` in place, on its current
    stream: each valid lane's element becomes ``old op payload`` (the
    payload at ``START + lane`` of ``flat``), as elements of ``dtype``.
    ``ordered`` applies the descriptors strictly in table order (one
    CTA, a barrier between descriptors) for overlapping runs; otherwise
    one parallel grid covers every (descriptor, lane chunk).  ``fetch``
    (disjoint runs only) also returns the ``(kb, seg)`` pre-update
    windows, zero past each op's bytes — byte-identical to
    :func:`accumulate_ref`.  The descriptors must be element-aligned and
    lie inside the arena and ``flat``: the engine checks each op at
    enqueue."""
    from . import _build

    _check_common(arena, desc, seg, ACC_DESC_COLS)
    _check_flat(arena, flat)
    if op not in REDUCE_OPS:
        raise ValueError(f"unknown reduction op {op!r}")
    if fetch and ordered:
        raise ValueError("a fetch run is disjoint: it never takes the "
                         "ordered accumulate")
    dt = acc_dtype(dtype)
    if arena.shape[1] % dt.itemsize:
        raise ValueError(f"pool bytes {arena.shape[1]} are not a multiple "
                         f"of the {dt} element size")
    out = (torch.empty((desc.shape[0], seg), dtype=torch.uint8,
                       device=arena.device) if fetch else None)
    lib = _build.load()
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        err = lib.dart_segmented_accumulate(
            arena.data_ptr(), arena.shape[0], arena.shape[1],
            desc.data_ptr(), desc.shape[0], flat.data_ptr(), flat.shape[0],
            seg, REDUCE_OPS[op], ACC_DTYPES.index(str(dt).split(".")[-1]),
            int(ordered), None if out is None else out.data_ptr(),
            ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"segmented accumulate launch failed: "
                           f"{_build.error_string(err)}")
    _bump("get_accumulate" if fetch else
          "accumulate_ordered" if ordered else "accumulate")
    return (arena, out) if fetch else arena


def _ref_on(fn: Callable) -> Callable:
    """Wrap a plain version so a call on a CUDA arena is counted."""
    @functools.wraps(fn)
    def run(arena, *args, **kw):
        if arena.is_cuda:
            _bump("ref_on_cuda")
        return fn(arena, *args, **kw)
    return run


# --------------------------------------------------------------------------
# The plan cache
# --------------------------------------------------------------------------

_PLAN_CACHE: Dict[Tuple, Callable] = {}
_BUILD_COUNT = [0]      # process-total plan builds
_PLAN_LOCK = threading.Lock()

IMPLS = ("auto", "cuda", "ref")


def resolve_impl(impl: str, arena: torch.Tensor) -> str:
    """``'auto'`` → ``'cuda'`` on a CUDA arena, ``'ref'`` on a CPU one;
    ``'cuda'`` on a CPU arena raises."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (expected one of {IMPLS})")
    if impl == "auto":
        return "cuda" if arena.is_cuda else "ref"
    if impl == "cuda" and not arena.is_cuda:
        raise ValueError("impl='cuda' needs a CUDA arena, got one on "
                         f"{arena.device}")
    return impl


def cached_plan(key: Tuple, build: Callable[[], Callable]
                ) -> Tuple[Callable, bool]:
    """Process-wide plan cache (the DispatchPlan layer): returns
    ``(fn, hit)``.  A miss runs ``build()`` and records it; hits are
    the steady state.  The keys and the hit/miss pattern are the JAX
    reference's, so engine counters agree between the packages."""
    with _PLAN_LOCK:
        fn = _PLAN_CACHE.get(key)
        if fn is not None:
            return fn, True
        fn = build()
        _PLAN_CACHE[key] = fn
        _BUILD_COUNT[0] += 1
        return fn, False


def clear_plan_cache() -> None:
    """Drop every cached plan."""
    with _PLAN_LOCK:
        _PLAN_CACHE.clear()


def plan_cache_stats() -> Dict[str, int]:
    with _PLAN_LOCK:
        return {"size": len(_PLAN_CACHE), "builds": _BUILD_COUNT[0]}


def scatter_plan(arena_shape: Tuple[int, int], kb: int, seg: int,
                 flat_len: int, *, ordered: bool, impl: str = "ref"
                 ) -> Tuple[Callable, bool]:
    """fn(arena, desc, flat) -> arena, updated in place.  ``ordered``
    applies descriptors in queue order (overlapping runs); otherwise
    the vectorized scatter runs.  ``impl`` is ``'cuda'`` or ``'ref'``
    (see :func:`resolve_impl`)."""
    check_flat_addressable(arena_shape)
    key = ("scatter", impl, tuple(arena_shape), kb, seg, flat_len, ordered)

    def build():
        fn = scatter_cuda if impl == "cuda" else _ref_on(scatter_ref)
        return functools.partial(fn, seg=seg, ordered=ordered)

    return cached_plan(key, build)


def accumulate_plan(arena_shape: Tuple[int, int], kb: int, seg: int,
                    flat_len: int, *, op: str, dtype, fetch: bool,
                    ordered: bool = False, impl: str = "ref"
                    ) -> Tuple[Callable, bool]:
    """fn(arena, desc, flat) -> arena, updated in place (or ``(arena,
    old_windows)`` with ``fetch``, the ``MPI_Get_accumulate`` form).
    ``ordered`` applies descriptors in queue order (overlapping
    same-op runs); a fetch run is byte-disjoint by the run rule and
    always takes the parallel pass.  The key fields are the reference's;
    the reference forces ``impl='ref'`` into fetch keys because its
    Pallas kernel has no fetch form, while here the CUDA kernel fuses
    the fetch, so the key keeps the impl that runs (on a CPU arena,
    ``'ref'``: the reference's keys)."""
    check_flat_addressable(arena_shape)
    if op not in REDUCE_OPS:
        raise ValueError(f"unknown reduction op {op!r}")
    dt = acc_dtype(dtype)
    if seg % dt.itemsize or arena_shape[1] % dt.itemsize:
        raise ValueError(
            f"accumulate of {dt} needs element-aligned segment/pool "
            f"bytes (seg={seg}, pool_bytes={arena_shape[1]})")
    key = ("accumulate", impl, tuple(arena_shape), kb, seg, flat_len, op,
           str(dt), fetch, ordered)

    def build():
        fn = accumulate_cuda if impl == "cuda" else _ref_on(accumulate_ref)
        return functools.partial(fn, seg=seg, op=op, dtype=dt, fetch=fetch,
                                 ordered=ordered and not fetch)

    return cached_plan(key, build)


def gather_plan(arena_shape: Tuple[int, int], kb: int, seg: int, *,
                impl: str = "ref") -> Tuple[Callable, bool]:
    """fn(arena, desc) -> (kb, seg) uint8 pad-to-bucket windows; each
    op's bytes pack densely from column 0 of its row."""
    check_flat_addressable(arena_shape)
    key = ("gather", impl, tuple(arena_shape), kb, seg)

    def build():
        fn = gather_cuda if impl == "cuda" else _ref_on(gather_ref)
        return functools.partial(fn, seg=seg)

    return cached_plan(key, build)
