"""DART collective communication, host plane (paper §III, §IV.B.5), on
torch.

The paper builds DART collectives on the MPI-3 collectives after the
team → communicator translation.  On one controller the host-plane
collectives are row motions and reductions over a pool's arena: every
member's row holds its portion of a symmetric allocation at the same
offset.  As in the reference, each collective

* flushes the pool's queued one-sided ops first (queued puts are
  ordered before it) and counts one dispatch on the engine;
* looks up a plan in the process-wide cache under the reference's key
  (segment bytes or element counts bucketed to a power of two), so
  ``compile_count`` and ``plan_cache_hits`` agree with the reference;
* reduces (``dart_allreduce`` / ``dart_reduce``) over element vectors
  padded to the bucket with the op's identity
  (:func:`~repro_torch.kernels.segmented_copy.op_identity`) and trims
  the result on the host.

The reference computes these with XLA ops, not Pallas kernels, so here
they are plain torch ops.  Element-wise combines are
:func:`~repro_torch.kernels.segmented_copy.combine`, the accumulate's,
folded over the rows in order from the identity: exact for integers,
and for floats an order that may differ from XLA's (the tests hold
integer-valued floats exactly and random float32 to ``rtol=1e-6``).

**Engine-gated in-place update.**  With an engine the pool's arena is
the engine holder's and is updated in place.  With ``engine=None`` the
caller's state must not change (the reference's donation bug fixed in
its PR 4): the arena is cloned and the new state returned.

The SPMD ``team_*`` collectives belong to the device plane (a later
slice of the port).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import segmented_copy as _sc

from .globmem import HeapState, SymmetricHeap, torch_dtype
from .gptr import GlobalPtr
from .onesided import _CANONICAL, _CANONICAL_TORCH, Handle, deref


def _pre_collective(state: HeapState, poolid: int, engine) -> HeapState:
    """Flush queued one-sided ops on the pool and count the collective's
    dispatch.  With an engine the collective works on the holder's
    freshly flushed state."""
    if engine is not None:
        state = engine.flush(poolid)
        engine.dispatch_count += 1
    return state


def _note_plan(engine, hit: bool) -> None:
    if engine is not None:
        engine._note_plan(hit)


def _plan(key):
    """A cached plan entry; the collectives' work is plain torch, so the
    entry only carries the key's hit/miss pattern."""
    return _sc.cached_plan(key, lambda: key)


def _target(state: HeapState, poolid: int, engine
            ) -> "tuple[HeapState, torch.Tensor]":
    """The arena a collective may write: the holder's own (in place) with
    an engine, a clone in a new state dict without one."""
    if engine is not None:
        return state, state[poolid]
    new_state = dict(state)
    new_state[poolid] = state[poolid].clone()
    return new_state, new_state[poolid]


def _done(arena: torch.Tensor) -> Handle:
    """A handle born issued; on a CUDA arena it completes with the
    collective's work on the stream."""
    if not arena.is_cuda:
        return Handle()
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(arena.device))
    return Handle((ev,))


def dart_bcast(state: HeapState, heap: SymmetricHeap, teams_by_slot,
               root_gptr: GlobalPtr, nbytes: int, engine=None):
    """Broadcast ``nbytes`` at the root's allocation to every row of the
    segment (team members all see the root's bytes at the same offset)."""
    poolid, row, off = deref(heap, teams_by_slot, root_gptr)
    state = _pre_collective(state, poolid, engine)
    seg = _sc.bucket_pow2(nbytes, _sc.SEG_FLOOR)
    _, hit = _plan(("coll_bcast", tuple(state[poolid].shape), seg,
                    engine is not None))
    _note_plan(engine, hit)
    state, arena = _target(state, poolid, engine)
    arena[:, off:off + nbytes] = arena[row, off:off + nbytes].clone()
    return state, _done(arena)


def dart_gather(state: HeapState, heap: SymmetricHeap, teams_by_slot,
                gptr: GlobalPtr, per_unit_nbytes: int, engine=None):
    """Gather each row's ``per_unit_nbytes`` at gptr.addr → a CPU uint8
    tensor of shape ``(n_rows, per_unit_nbytes)``."""
    poolid, _, off = deref(heap, teams_by_slot, gptr)
    state = _pre_collective(state, poolid, engine)
    seg = _sc.bucket_pow2(per_unit_nbytes, _sc.SEG_FLOOR)
    _, hit = _plan(("coll_gather", tuple(state[poolid].shape), seg))
    _note_plan(engine, hit)
    out = state[poolid][:, off:off + per_unit_nbytes]
    return out.to("cpu", copy=True), Handle()


def dart_scatter(state: HeapState, heap: SymmetricHeap, teams_by_slot,
                 gptr: GlobalPtr, values, engine=None):
    """Scatter row i of ``values`` (uint8 ``(n_rows, nbytes)``) to
    unit i."""
    poolid, _, off = deref(heap, teams_by_slot, gptr)
    state = _pre_collective(state, poolid, engine)
    vals = (values.to(torch.uint8) if isinstance(values, torch.Tensor)
            else torch.from_numpy(np.asarray(values, np.uint8)))
    nbytes = vals.shape[1]
    seg = _sc.bucket_pow2(nbytes, _sc.SEG_FLOOR)
    _, hit = _plan(("coll_scatter", tuple(state[poolid].shape), seg,
                    engine is not None))
    _note_plan(engine, hit)
    state, arena = _target(state, poolid, engine)
    arena[:, off:off + nbytes] = vals.to(arena.device)
    return state, _done(arena)


def dart_gather_typed(state: HeapState, heap: SymmetricHeap, teams_by_slot,
                      gptr: GlobalPtr, shape, dtype, engine=None):
    """Typed gather: each row's value at ``gptr.addr`` decoded to its
    dtype → a CPU tensor of shape ``(n_rows, *shape)``."""
    dt = torch_dtype(dtype)
    shape = tuple(shape)
    n_elems = max(int(np.prod(shape, dtype=np.int64)), 1) if shape else 1
    poolid, _, off = deref(heap, teams_by_slot, gptr)
    state = _pre_collective(state, poolid, engine)
    eb = _sc.bucket_pow2(n_elems, 4)
    _, hit = _plan(("coll_gather_typed", tuple(state[poolid].shape),
                    str(dt), eb))
    _note_plan(engine, hit)
    raw = state[poolid][:, off:off + n_elems * dt.itemsize]
    vals = raw.to("cpu", copy=True).contiguous().view(dt)
    return vals.reshape(raw.shape[:1] + shape), Handle()


def _typed_rows(values) -> torch.Tensor:
    """``(n_rows, ...)`` values → a CPU ``(n_rows, n)`` tensor, with the
    reference's canonicalization (64-bit types narrowed)."""
    if isinstance(values, torch.Tensor):
        t = values.detach().cpu()
        t = t.to(_CANONICAL_TORCH.get(t.dtype, t.dtype))
    else:
        arr = np.asarray(values)
        arr = arr.astype(_CANONICAL.get(arr.dtype, arr.dtype))
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.view(np.uint16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.reshape(t.shape[0], -1).contiguous()


def dart_scatter_typed(state: HeapState, heap: SymmetricHeap, teams_by_slot,
                       gptr: GlobalPtr, values, engine=None):
    """Typed scatter: row i of ``values`` (``(n_rows, *shape)``, any
    dtype) lands at ``gptr.addr`` on unit i."""
    vals = _typed_rows(values)
    n_elems = vals.shape[1]
    poolid, _, off = deref(heap, teams_by_slot, gptr)
    state = _pre_collective(state, poolid, engine)
    eb = _sc.bucket_pow2(n_elems, 4)
    _, hit = _plan(("coll_scatter_typed", tuple(state[poolid].shape),
                    str(vals.dtype), eb, engine is not None))
    _note_plan(engine, hit)
    state, arena = _target(state, poolid, engine)
    raw = vals.view(torch.uint8) if vals.dtype != torch.uint8 else vals
    arena[:, off:off + raw.shape[1]] = raw.to(arena.device)
    return state, _done(arena)


def _run_reduce(state, heap, teams_by_slot, gptr, shape, dtype, op,
                engine, root_unit):
    dt = torch_dtype(dtype)
    if op not in _sc.REDUCE_OPS:
        raise ValueError(f"unknown reduction op {op!r}")
    shape = tuple(shape)
    n_elems = int(np.prod(shape, dtype=np.int64)) if shape else 1
    if root_unit is None:
        poolid, _, off = deref(heap, teams_by_slot, gptr)
        root_row = 0
    else:
        poolid, root_row, off = deref(heap, teams_by_slot,
                                      gptr.setunit(root_unit))
    state = _pre_collective(state, poolid, engine)
    eb = _sc.bucket_pow2(max(n_elems, 1), 4)
    _, hit = _plan(("coll_reduce", tuple(state[poolid].shape), eb, str(dt),
                    op, root_unit is not None, engine is not None))
    _note_plan(engine, hit)
    state, arena = _target(state, poolid, engine)
    n = n_elems * dt.itemsize
    vals = arena[:, off:off + n].contiguous().view(dt)     # (R, n_elems)
    ident = _sc.op_identity(op, dt).to(arena.device)
    padded = ident.expand(vals.shape[0], eb).clone()
    padded[:, :n_elems] = vals
    red = ident.expand(eb).clone()
    for r in range(padded.shape[0]):
        red = _sc.combine(red, padded[r], op)
    out_b = red[:n_elems].contiguous().view(torch.uint8)
    if root_unit is None:
        arena[:, off:off + n] = out_b
    else:
        arena[root_row, off:off + n] = out_b
    return state, red[:n_elems].cpu().reshape(shape)


def dart_allreduce(state: HeapState, heap: SymmetricHeap, teams_by_slot,
                   gptr: GlobalPtr, shape, dtype, op: str = "sum",
                   engine=None):
    """All-reduce the typed value at gptr.addr across rows; the result
    replaces every row's copy.  Returns ``(new_state, reduced_value)``,
    the value a CPU tensor."""
    return _run_reduce(state, heap, teams_by_slot, gptr, shape, dtype, op,
                       engine, root_unit=None)


def dart_reduce(state: HeapState, heap: SymmetricHeap, teams_by_slot,
                gptr: GlobalPtr, shape, dtype, op: str = "sum",
                root: int = 0, engine=None):
    """Root-taking reduce: like :func:`dart_allreduce`, but the reduced
    value replaces only ``root``'s row (absolute unit id); every other
    row keeps its own copy."""
    return _run_reduce(state, heap, teams_by_slot, gptr, shape, dtype, op,
                       engine, root_unit=root)


def dart_barrier(state: Optional[HeapState] = None) -> None:
    """Host-plane barrier: fence the device queue of every CUDA arena's
    device (a CPU heap has nothing in flight)."""
    for dev in {a.device for a in (state or {}).values() if a.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
