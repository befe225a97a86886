"""DART one-sided communication (paper §III, §IV.B.5): the non-blocking
engine, on torch.

``dart_put`` / ``dart_get_nb`` dereference the global pointer and
bounds-check the op at initiation, then *enqueue* it on
:class:`CommEngine`; no device work runs yet and the returned
:class:`Handle` is ``queued``.  ``CommEngine.flush`` closes the epoch:
maximal runs of same-pool ops coalesce into ONE dispatch each — same
size always, mixed sizes while their byte ranges stay disjoint — and
runs dispatch in program order, so overlapping writes resolve as the
equivalent blocking sequence would (last writer wins).  A per-target
flush (``flush(poolid, row)``, the ``MPI_Win_flush_local(rank, win)``
analogue) dispatches one ``(pool, row)`` lane and leaves the others
queued.

Each dispatch packs the run into one ``(kb, 6)`` int32 descriptor table
and, for puts, one flat uint8 payload
(:mod:`repro_torch.kernels.segmented_copy`), sends them host→device as
two copies through a reused pinned staging buffer, and launches one
kernel on the arena's device: the segmented scatter (disjoint runs), the
ordered scatter (overlapping runs) or the segmented gather.  Accumulate
runs (``accumulate`` / ``get_accumulate``, the reduction plane) carry an
op column and launch the segmented read-modify-write kernel: parallel
for disjoint runs, fused with the fetch for ``get_accumulate``, ordered
for overlapping same-op runs.  Arenas are updated in place.  On a CPU
arena the plain torch versions run instead.

Completion ladder (paper §III): ``queued`` → (flush) → ``issued`` →
``complete``.  A handle's dispatch records a CUDA event; ``test()`` and
``state`` query it, ``wait()`` flushes the handle's lane and
synchronizes on it.  On a CPU arena an op is complete once issued.  A
get run's ``(kb, seg)`` windows come to the host in ONE device→host
copy, made lazily and shared by the run (:class:`_GatherBatch`); the
per-op typed decode is host work and ``value()`` returns a CPU tensor.

Payloads are staged to host bytes at initiation, with the JAX
reference's canonicalization (x64 off): numpy arrays and Python values
of 64-bit type become 32-bit before the bitcast (:data:`_CANONICAL`).
torch tensors — bf16 and CUDA tensors included — keep their dtype.  As
with MPI, a payload buffer must not change before its op completes.

**Thread safety**: ``CommEngine.lock`` (reentrant) serializes enqueue,
flush, the counters and the staging buffer.

The fault plane (retry, deadlines, unit death), the shm plane and the
progress daemon are later slices of the port; until then every dispatch
takes the reference's fault-free path.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import segmented_copy as _sc

from .faults import DartError
from .globmem import (HeapState, SymmetricHeap, WindowDestroyedError,
                      nbytes_of, torch_dtype)
from .gptr import GlobalPtr

#: JAX's dtype canonicalization with x64 off, written out: host values of
#: these types are narrowed before their bytes are staged, as
#: ``jnp.asarray`` narrows them in the reference.
_CANONICAL = {
    np.dtype(np.float64): np.dtype(np.float32),
    np.dtype(np.int64): np.dtype(np.int32),
    np.dtype(np.uint64): np.dtype(np.uint32),
    np.dtype(np.complex128): np.dtype(np.complex64),
}


def _to_host_bytes(value) -> np.ndarray:
    """Typed value → host-staged 1-D uint8 bytes (little-endian
    bitcast).  torch tensors are staged as they are; anything else goes
    through ``np.asarray`` and :data:`_CANONICAL`."""
    if isinstance(value, torch.Tensor):
        t = value.detach().contiguous().reshape(-1)
        if t.dtype != torch.uint8:
            t = t.view(torch.uint8)
        return t.cpu().numpy()
    arr = np.asarray(value)
    canon = _CANONICAL.get(arr.dtype)
    if canon is not None:
        arr = arr.astype(canon)
    arr = np.ascontiguousarray(arr).reshape(-1)
    if arr.dtype != np.uint8:
        arr = arr.view(np.uint8)
    return arr


_CANONICAL_TORCH = {torch.float64: torch.float32, torch.int64: torch.int32,
                    torch.complex128: torch.complex64}


def _acc_value(value) -> Tuple[Tuple[int, ...], torch.dtype, np.ndarray]:
    """An accumulate payload → ``(shape, dtype, host bytes)``, with the
    reference's canonicalization (64-bit types narrowed to 32 bits).
    Element types outside :data:`~repro_torch.kernels.segmented_copy.
    ACC_DTYPES` — bool and complex among them — raise ``ValueError``
    here, at initiation: the reference accepts them and fails at
    dispatch, where the failed op then stays queued."""
    if isinstance(value, torch.Tensor):
        v = value.detach()
        v = v.to(_CANONICAL_TORCH.get(v.dtype, v.dtype))
        dt = v.dtype
    else:
        v = np.asarray(value)
        dt = _CANONICAL.get(v.dtype, v.dtype)
    return tuple(v.shape), _sc.acc_dtype(dt), _to_host_bytes(v)


def _host_decode(raw: np.ndarray, shape: Tuple[int, ...], dtype
                 ) -> torch.Tensor:
    """Inverse of :func:`_to_host_bytes` on a host byte window: a CPU
    tensor of ``shape``/``dtype``."""
    dt = torch_dtype(dtype)
    n = nbytes_of(shape, dt)
    return torch.from_numpy(raw[:n].copy()).view(dt).reshape(shape)


# --------------------------------------------------------------------------
# Request handles (paper: MPI_Rput/Rget handles + dart_wait/test[all])
# --------------------------------------------------------------------------


class Handle:
    """A DART communication handle.

    Lifecycle (paper §III): ``queued`` (enqueued on a
    :class:`CommEngine`) → ``issued`` (dispatched; its CUDA events not
    yet reached) → ``complete``.  A handle built without an engine is
    born issued.  ``failed`` is terminal: ``wait()``/``test()`` re-raise
    the typed :class:`~repro_torch.core.faults.DartError`.
    """

    def __init__(self, events: Tuple[torch.cuda.Event, ...] = (),
                 engine: "Optional[CommEngine]" = None):
        self.events = tuple(events)
        self._engine = engine
        self._issued = engine is None
        self._error: Optional[BaseException] = None

    @property
    def state(self) -> str:
        if self._error is not None:
            return "failed"
        if not self._issued:
            return "queued"
        if all(e.query() for e in self.events):
            return "complete"
        return "issued"

    def _resolve(self, events: Tuple[torch.cuda.Event, ...]) -> None:
        self.events = tuple(events)
        self._issued = True

    def _fail(self, error: DartError) -> None:
        """Mark the op terminally **failed** (for example, its window was
        destroyed before dispatch)."""
        self._error = error

    def _check_failed(self) -> None:
        if self._error is not None:
            raise self._error

    def _dropped_error(self) -> DartError:
        err = DartError(
            f"queued op ({self._lane_repr()}) was dropped before "
            "dispatch (engine cleared by dart_exit?)")
        err.poolid = getattr(self, "poolid", None)
        err.row = getattr(self, "row", None)
        return err

    def _lane_repr(self) -> str:
        return (f"pool {getattr(self, 'poolid', '?')}, "
                f"row {getattr(self, 'row', '?')}")

    def wait(self) -> None:
        self._check_failed()
        if not self._issued and self._engine is not None:
            # close only this handle's (pool, row) lane — the
            # MPI_Win_flush_local(rank, win) analogue
            self._engine.flush(getattr(self, "poolid", None),
                               getattr(self, "row", None))
            self._check_failed()
            if not self._issued:
                raise self._dropped_error()
        for e in self.events:
            e.synchronize()

    def test(self) -> bool:
        self._check_failed()
        if not self._issued:
            return False
        return all(e.query() for e in self.events)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Handle(state={self.state}, n_events={len(self.events)})"


class _GatherBatch:
    """One coalesced get dispatch: the ``(kb, seg)`` byte windows every
    handle of the run shares.  The device→host copy is made ONCE,
    lazily, on the first ``value()``."""

    __slots__ = ("raws", "_host")

    def __init__(self, raws: torch.Tensor):
        self.raws = raws
        self._host: Optional[np.ndarray] = None

    def host(self) -> np.ndarray:
        if self._host is None:
            self._host = self.raws.cpu().numpy()
        return self._host


class GetHandle(Handle):
    """Handle of a queued get; ``value()`` flushes and returns the typed
    result as a CPU tensor."""

    def __init__(self, shape: Tuple[int, ...], dtype,
                 engine: "CommEngine"):
        super().__init__((), engine)
        self.shape = tuple(shape)
        self.dtype = dtype
        self._value: Optional[torch.Tensor] = None
        self._batch: Optional[_GatherBatch] = None
        self._batch_idx = 0

    def _resolve_gather(self, batch: _GatherBatch, idx: int,
                        events: Tuple[torch.cuda.Event, ...]) -> None:
        self._batch = batch
        self._batch_idx = idx
        self._resolve(events)

    def value(self) -> torch.Tensor:
        self.wait()
        if self._value is None and self._batch is not None:
            self._value = _host_decode(
                self._batch.host()[self._batch_idx], self.shape,
                self.dtype)
        if self._value is None:
            raise self._dropped_error()
        return self._value


def dart_wait(handle: Handle) -> None:
    handle.wait()


def dart_test(handle: Handle) -> bool:
    return handle.test()


def dart_waitall(handles: Sequence[Handle]) -> None:
    # group queued handles by (engine, pool) and flush each pool's UNION
    # of target lanes once, so the batch coalesces into the fewest
    # dispatches while untargeted lanes keep accumulating
    lanes: Dict = {}
    for h in handles:
        h._check_failed()
        if not h._issued and h._engine is not None:
            key = (h._engine, getattr(h, "poolid", None))
            row = getattr(h, "row", None)
            if key not in lanes:
                lanes[key] = None if row is None else {row}
            elif lanes[key] is not None:
                if row is None:
                    lanes[key] = None        # unknown lane: whole pool
                else:
                    lanes[key].add(row)
    for (engine, poolid), rows in lanes.items():
        engine.flush(poolid, rows)
    for h in handles:
        # wait() re-flushes only a handle that a concurrent flusher left
        # queued, and raises the lane-named "dropped" error if it is gone
        h.wait()


def dart_testall(handles: Sequence[Handle]) -> bool:
    return all(h.test() for h in handles)


# --------------------------------------------------------------------------
# Global-pointer dereference (paper §IV.B.4)
# --------------------------------------------------------------------------


def deref(heap: SymmetricHeap, teams_by_slot, gptr: GlobalPtr
          ) -> Tuple[int, int, int]:
    """gptr → (poolid, row, offset).

    Collective pointers: segid is the owning team's teamlist slot; the
    absolute unitid is translated to the team-relative id, which indexes
    the team pool's rows, and the pool is resolved through the heap's
    :class:`~repro_torch.core.globmem.WindowRegistry` (teamid → live
    PoolMeta), never through slot arithmetic (slots are reused after
    ``dart_team_destroy``, pool ids are not).  Non-collective pointers
    address the WORLD pool directly by absolute unitid (§IV.B.4).
    """
    if gptr.is_collective:
        team = teams_by_slot[gptr.segid]
        rel = team.myid(gptr.unitid)
        if rel < 0:
            raise KeyError(
                f"unit {gptr.unitid} is not a member of team {team.teamid}")
        meta = heap.windows.lookup(team.teamid)
        return meta.poolid, rel, gptr.addr
    return WORLD_POOLID, gptr.unitid, gptr.addr


#: poolid of the pre-reserved non-collective WORLD pool (reserved first
#: at dart_init, so it is always 0).
WORLD_POOLID = 0


# --------------------------------------------------------------------------
# The non-blocking engine: epoch-scoped pending-op queue + coalesced flush
# --------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class _PendingPut:
    poolid: int
    row: int
    off: int
    payload: np.ndarray         # 1-D uint8, host-staged at initiation
    handle: Handle
    ts: float = 0.0             # monotonic enqueue time (lane_stats)
    stride: int = 0             # byte distance between strided segments
    count: int = 1              # segments (1 = contiguous)
    unit: int = -1              # absolute target unitid


@dataclasses.dataclass(eq=False)
class _PendingGet:
    poolid: int
    row: int
    off: int
    nbytes: int
    handle: GetHandle
    ts: float = 0.0
    stride: int = 0
    count: int = 1
    unit: int = -1


@dataclasses.dataclass(eq=False)
class _PendingAcc:
    """A queued element-wise accumulate (``MPI_Accumulate`` /
    ``MPI_Get_accumulate``): read-modify-write at the target inside
    the same epoch/flush discipline as puts.  ``fetch`` marks the
    get-accumulate form, whose handle yields the pre-update value."""
    poolid: int
    row: int
    off: int
    payload: np.ndarray
    op: str
    dtype: str
    fetch: bool
    handle: Handle
    ts: float = 0.0
    stride: int = 0
    count: int = 1
    unit: int = -1


def _check_strided(off: int, total: int, stride: int, count: int,
                   pool_bytes: int, what: str) -> Tuple[int, int, int]:
    """Validate a (possibly strided) op's geometry at initiation and
    return ``(seg_len, stride, count)`` normalized so contiguous ops
    are always ``(total, 0, 1)``.

    ``total`` bytes split into ``count`` equal segments placed
    ``stride`` bytes apart.  ``stride >= seg_len`` is required for
    ``count > 1``: segments of one op may never self-overlap, which is
    what licenses the vectorized unique-index scatter to treat every
    lane of a descriptor as a distinct arena byte."""
    count = int(count)
    stride = int(stride)
    if count < 1:
        raise ValueError(f"{what}: count must be >= 1, got {count}")
    if total % count:
        raise ValueError(
            f"{what}: {total} payload bytes do not split into {count} "
            "equal segments")
    seg_len = total // count
    if count == 1:
        stride = 0          # canonical contiguous form
    else:
        if stride < seg_len:
            raise ValueError(
                f"{what}: stride ({stride} B) must be >= the segment "
                f"length ({seg_len} B) — overlapping segments of one "
                "op are not addressable")
    span = off + (count - 1) * stride + seg_len if total else off
    if span > pool_bytes:
        raise ValueError(f"{what} overruns the target allocation's pool")
    return seg_len, stride, count


class _PinnedStaging:
    """A reused pinned host buffer for a dispatch's two host→device
    copies (descriptor table, flat payload).  The copies are
    asynchronous, so the buffer is guarded by the event of the dispatch
    that last used it (:meth:`guard`, recorded after the kernel and so
    after the copies): the next dispatch waits on it before writing the
    buffer again."""

    def __init__(self):
        self._buf: Optional[torch.Tensor] = None
        self._in_use: Optional[torch.cuda.Event] = None

    def to_device(self, device: torch.device, desc: np.ndarray,
                  payloads: Optional[Sequence[np.ndarray]]
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Copy ``desc`` and the payloads over.  Each payload is written
        straight into the pinned buffer at its ``START`` (payloads pack
        densely in run order, as :func:`pack_descriptors` lays them
        out), so the flat payload is exactly the bytes the kernel reads:
        no bucket-sized zero tail is built or copied."""
        nd = desc.nbytes
        fo = (nd + 255) // 256 * 256            # flat starts aligned
        used = 0 if payloads is None else sum(int(p.size) for p in payloads)
        if self._in_use is not None:
            self._in_use.synchronize()
        if self._buf is None or self._buf.numel() < fo + used:
            self._buf = torch.empty(_sc.bucket_pow2(fo + used),
                                    dtype=torch.uint8, pin_memory=True)
        host = self._buf.numpy()
        host[:nd] = desc.reshape(-1).view(np.uint8)
        d = (self._buf[:nd].to(device, non_blocking=True)
             .view(torch.int32).reshape(desc.shape))
        f = None
        if payloads is not None:
            at = fo
            for p in payloads:
                host[at:at + p.size] = p
                at += p.size
            f = self._buf[fo:fo + used].to(device, non_blocking=True)
        return d, f

    def guard(self, event: torch.cuda.Event) -> None:
        self._in_use = event


class CommEngine:
    """Epoch-scoped pending-op queue over a heap-state holder.

    ``holder`` is any object with a ``state: HeapState`` attribute
    (normally the :class:`repro_torch.core.runtime.DartContext`).  Ops
    enqueue with pointer translation + bounds checks done eagerly
    (initiation, paper DTIT); ``flush`` closes the epoch by dispatching
    coalesced runs and bumping ``epoch``.

    Instrumentation, as in the reference: ``dispatch_count`` (kernel
    launches — what coalescing minimizes), ``ops_enqueued``,
    ``ops_coalesced`` (ops that shared a dispatch with a neighbour),
    ``compile_count`` / ``plan_cache_hits`` (plan-cache misses and
    hits).

    ``impl`` selects the segmented-copy implementation:
    ``'auto'`` (the CUDA kernels on a CUDA arena, the plain torch
    versions on a CPU arena), ``'cuda'`` (a CPU arena raises at
    dispatch), or ``'ref'`` (the plain versions everywhere).
    """

    def __init__(self, holder=None, impl: str = "auto"):
        if impl not in _sc.IMPLS:
            raise ValueError(f"unknown impl {impl!r} "
                             f"(expected one of {_sc.IMPLS})")
        self._holder = holder
        self._pending: List = []        # program order across pools
        #: serializes queue mutation, counters and the staging buffer
        self.lock = threading.RLock()
        self.epoch = 0
        self.dispatch_count = 0
        self.ops_enqueued = 0
        self.ops_coalesced = 0
        self.compile_count = 0
        self.plan_cache_hits = 0
        self.impl = impl
        self._staging = _PinnedStaging()

    def _note_plan(self, hit: bool) -> None:
        if hit:
            self.plan_cache_hits += 1
        else:
            self.compile_count += 1

    # -- enqueue (initiation) -------------------------------------------
    def put(self, heap: SymmetricHeap, teams_by_slot, gptr: GlobalPtr,
            value, *, stride: int = 0, count: int = 1) -> Handle:
        """Queue a put of the value's bytes at the target.  With
        ``count > 1`` the payload splits into ``count`` equal segments
        landing ``stride`` bytes apart (ONE strided descriptor)."""
        poolid, row, off = deref(heap, teams_by_slot, gptr)
        payload = _to_host_bytes(value)
        stride, count = self._check_geom(
            "put", heap, poolid, off, int(payload.size), stride, count)
        h = Handle((), engine=self)
        h.poolid = poolid
        h.row = row
        with self.lock:
            self._pending.append(_PendingPut(poolid, row, off, payload,
                                             h, time.monotonic(),
                                             stride=stride, count=count,
                                             unit=gptr.unitid))
            self.ops_enqueued += 1
        return h

    def get(self, heap: SymmetricHeap, teams_by_slot, gptr: GlobalPtr,
            shape: Tuple[int, ...], dtype, *, stride: int = 0,
            count: int = 1) -> GetHandle:
        """Queue a get of ``shape``/``dtype`` from the target; with
        ``count > 1`` the bytes come from ``count`` equal segments
        ``stride`` bytes apart, densely packed in the result."""
        poolid, row, off = deref(heap, teams_by_slot, gptr)
        n = nbytes_of(shape, dtype)
        stride, count = self._check_geom(
            "get", heap, poolid, off, n, stride, count)
        h = GetHandle(shape, dtype, engine=self)
        h.poolid = poolid
        h.row = row
        with self.lock:
            self._pending.append(_PendingGet(poolid, row, off, n, h,
                                             time.monotonic(),
                                             stride=stride, count=count,
                                             unit=gptr.unitid))
            self.ops_enqueued += 1
        return h

    def _check_geom(self, what: str, heap: SymmetricHeap, poolid: int,
                    off: int, total: int, stride: int, count: int
                    ) -> Tuple[int, int]:
        _, stride, count = _check_strided(
            off, total, stride, count, heap.pools[poolid].pool_bytes,
            what)
        return stride, count

    def _stage_acc(self, heap: SymmetricHeap, teams_by_slot,
                   gptr: GlobalPtr, value, op: str, stride: int,
                   count: int):
        """Shared accumulate initiation: deref + canonicalize + the
        element-type, alignment and bounds checks the read-modify-write
        kernels rely on."""
        if op not in _sc.REDUCE_OPS:
            raise ValueError(f"unknown reduction op {op!r} "
                             f"(supported: {sorted(_sc.REDUCE_OPS)})")
        poolid, row, off = deref(heap, teams_by_slot, gptr)
        shape, dt, payload = _acc_value(value)
        isz = dt.itemsize
        pool_bytes = heap.pools[poolid].pool_bytes
        if off % isz or pool_bytes % isz:
            raise ValueError(
                f"accumulate of {dt} needs an element-aligned offset "
                f"and pool (off={off}, pool_bytes={pool_bytes})")
        seg_len, stride, count = _check_strided(
            off, int(payload.size), stride, count, pool_bytes,
            "accumulate")
        if seg_len % isz or stride % isz:
            raise ValueError(
                f"strided accumulate of {dt} needs element-aligned "
                f"segment length and stride (seg={seg_len}, "
                f"stride={stride})")
        return poolid, row, off, shape, payload, dt, stride, count

    def accumulate(self, heap: SymmetricHeap, teams_by_slot,
                   gptr: GlobalPtr, value, op: str = "sum", *,
                   stride: int = 0, count: int = 1) -> Handle:
        """Queued element-wise accumulate at the target
        (``MPI_Accumulate``): enqueues like ``put``; same-op runs
        coalesce into one segmented read-modify-write dispatch at flush
        — even overlapping ones (the ops commute), while mixed-op or
        accumulate-vs-put overlap splits the run in queue order."""
        poolid, row, off, _, payload, dt, stride, count = self._stage_acc(
            heap, teams_by_slot, gptr, value, op, stride, count)
        h = Handle((), engine=self)
        h.poolid = poolid
        h.row = row
        self._enqueue_acc(poolid, row, off, payload, op, dt, False, h,
                          stride, count, gptr.unitid)
        return h

    def get_accumulate(self, heap: SymmetricHeap, teams_by_slot,
                       gptr: GlobalPtr, value, op: str = "sum", *,
                       stride: int = 0, count: int = 1) -> GetHandle:
        """Queued fetch-and-accumulate (``MPI_Get_accumulate``):
        ``handle.value()`` flushes and yields the target's value from
        *before* this op applied.  Byte-disjoint same-op fetches share
        one fused dispatch; overlap splits the run so every fetched
        value matches the sequential order."""
        poolid, row, off, shape, payload, dt, stride, count = (
            self._stage_acc(heap, teams_by_slot, gptr, value, op, stride,
                            count))
        h = GetHandle(shape, dt, engine=self)
        h.poolid = poolid
        h.row = row
        self._enqueue_acc(poolid, row, off, payload, op, dt, True, h,
                          stride, count, gptr.unitid)
        return h

    def _enqueue_acc(self, poolid, row, off, payload, op, dt, fetch, h,
                     stride, count, unit) -> None:
        with self.lock:
            self._pending.append(_PendingAcc(
                poolid, row, off, payload, op, str(dt).split(".")[-1],
                fetch, h, time.monotonic(), stride=stride, count=count,
                unit=unit))
            self.ops_enqueued += 1

    def pending_ops(self, poolid: Optional[int] = None,
                    row: Optional[int] = None) -> int:
        with self.lock:
            if poolid is None:
                return len(self._pending)
            return sum(1 for op in self._pending if op.poolid == poolid
                       and (row is None or op.row == row))

    def lane_stats(self) -> Dict[Tuple[int, int], Tuple[int, int, float]]:
        """Snapshot of the pending queue grouped by ``(pool, row)``
        lane: ``{lane: (ops, bytes, oldest_enqueue_ts)}``."""
        with self.lock:
            stats: Dict[Tuple[int, int], List] = {}
            for op in self._pending:
                key = (op.poolid, op.row)
                n = _op_nbytes(op)
                s = stats.get(key)
                if s is None:
                    stats[key] = [1, n, op.ts]
                else:
                    s[0] += 1
                    s[1] += n
            return {k: (v[0], v[1], v[2]) for k, v in stats.items()}

    # -- flush (epoch close) --------------------------------------------
    def flush(self, poolid: Optional[int] = None,
              row=None) -> HeapState:
        """Dispatch pending ops in program order: all of them, one
        pool's, or one ``(pool, row)`` target lane (``row`` may be a
        collection of rows: their union flushes as one epoch).  Ops on
        distinct pools touch distinct arenas and ops on distinct rows
        touch disjoint partitions, so a partial flush cannot reorder
        visible effects.  Runs under the engine lock; if a dispatch
        raises, the runs already dispatched leave the queue and the rest
        stay queued."""
        with self.lock:
            if poolid is None:
                todo = self._pending
            else:
                rows = (None if row is None else
                        set(row) if isinstance(row, (set, frozenset,
                                                     list, tuple))
                        else {row})
                todo = [op for op in self._pending
                        if op.poolid == poolid
                        and (rows is None or op.row in rows)]
            state = self._holder.state
            if not todo:
                return state
            done: set = set()
            try:
                for run, disjoint in _coalesced_runs(todo):
                    arena = state[run[0].poolid]
                    if isinstance(run[0], _PendingPut):
                        self._dispatch_put_run(arena, run, disjoint)
                    elif isinstance(run[0], _PendingAcc):
                        self._dispatch_acc_run(arena, run, disjoint)
                    else:
                        self._dispatch_get_run(arena, run)
                    done.update(id(op) for op in run)
            finally:
                if done:
                    self._pending = [op for op in self._pending
                                     if id(op) not in done]
                    self.epoch += 1
            return state

    def drop_pool(self, poolid: int, reason: str = "",
                  teamid: Optional[int] = None) -> int:
        """Discard queued ops targeting ``poolid`` and fail their
        handles with a typed
        :class:`~repro_torch.core.globmem.WindowDestroyedError`
        carrying ``poolid`` (and ``teamid`` when the drop came from
        ``dart_team_destroy``).  Returns the number of ops dropped."""
        with self.lock:
            dropped = [op for op in self._pending if op.poolid == poolid]
            if not dropped:
                return 0
            self._pending = [op for op in self._pending
                             if op.poolid != poolid]
            err = WindowDestroyedError(
                f"window destroyed: pool {poolid} was dropped with "
                f"this op still queued"
                f"{' (' + reason + ')' if reason else ''}")
            err.poolid, err.teamid = poolid, teamid
            for op in dropped:
                op.handle._fail(err)
            return len(dropped)

    def _stage(self, arena: torch.Tensor, desc: np.ndarray,
               payloads: Optional[Sequence[np.ndarray]] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The run's descriptor table and its payloads packed densely in
        run order (the flat buffer's used bytes): two host→device copies
        on a CUDA arena, none on a CPU arena."""
        if arena.is_cuda:
            return self._staging.to_device(arena.device, desc, payloads)
        return (torch.from_numpy(desc), None if payloads is None
                else torch.from_numpy(np.concatenate(payloads)))

    def _completion(self, arena: torch.Tensor
                    ) -> Tuple[torch.cuda.Event, ...]:
        """Events a handle waits on: one recorded after the dispatch on
        a CUDA arena (it also guards the staging buffer), none on a CPU
        arena (complete when issued)."""
        if not arena.is_cuda:
            return ()
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(arena.device))
        self._staging.guard(ev)
        return (ev,)

    def _dispatch_put_run(self, arena: torch.Tensor,
                          run: Sequence[_PendingPut],
                          disjoint: bool = True) -> None:
        """One counted dispatch for the whole run: pack descriptors +
        flat payload on the host, copy them over, and run the cached
        plan — the parallel scatter when the run's byte ranges are
        provably disjoint, the ordered one otherwise (last writer
        wins)."""
        self.dispatch_count += 1
        if len(run) > 1:
            self.ops_coalesced += len(run)
        desc, _, seg = _sc.pack_descriptors(
            [op.row for op in run], [op.off for op in run],
            [int(op.payload.size) // op.count for op in run],
            strides=[op.stride for op in run],
            counts=[op.count for op in run])
        kb = desc.shape[0]
        impl = _sc.resolve_impl(self.impl, arena)
        fn, hit = _sc.scatter_plan(
            tuple(arena.shape), kb, seg, _sc.flat_bucket(kb, seg),
            ordered=not disjoint, impl=impl)
        self._note_plan(hit)
        d, f = self._stage(arena, desc, [op.payload for op in run])
        fn(arena, d, f)
        events = self._completion(arena)
        for op in run:
            op.handle._resolve(events)

    def _dispatch_acc_run(self, arena: torch.Tensor,
                          run: Sequence[_PendingAcc],
                          disjoint: bool = True) -> None:
        """One counted dispatch for a same-(op, dtype) accumulate run:
        the parallel read-modify-write when the run's byte ranges are
        provably disjoint, the ordered one otherwise (still one
        dispatch, bitwise the blocking order).  Payloads are staged
        densely, as for puts, with the table's ``START`` column at
        their dense offsets: the kernels touch valid lanes only, so the
        reference's ``kb*seg`` identity-filled buffer is never built
        (its length stays the plan key's ``flat_len``).  Strided runs
        take the kernels too.  A fetch run (byte-disjoint by the run
        rule) returns every op's pre-update window from the same
        dispatch."""
        self.dispatch_count += 1
        if len(run) > 1:
            self.ops_coalesced += len(run)
        first = run[0]
        desc, seg = _sc.pack_acc_table(
            [op.row for op in run], [op.off for op in run],
            [int(op.payload.size) // op.count for op in run], first.op,
            strides=[op.stride for op in run],
            counts=[op.count for op in run])
        kb = desc.shape[0]
        impl = _sc.resolve_impl(self.impl, arena)
        fn, hit = _sc.accumulate_plan(
            tuple(arena.shape), kb, seg, kb * seg, op=first.op,
            dtype=first.dtype, fetch=first.fetch, ordered=not disjoint,
            impl=impl)
        self._note_plan(hit)
        d, f = self._stage(arena, desc, [op.payload for op in run])
        res = fn(arena, d, f)
        events = self._completion(arena)
        if first.fetch:
            batch = _GatherBatch(res[1])
            for i, op in enumerate(run):
                op.handle._resolve_gather(batch, i, events)
        else:
            for op in run:
                op.handle._resolve(events)

    def _dispatch_get_run(self, arena: torch.Tensor,
                          run: Sequence[_PendingGet]) -> None:
        """One counted dispatch for the whole run (uniform AND mixed
        sizes): the segmented gather returns every op's pad-to-bucket
        byte window; the typed decode happens on the host from ONE
        device→host copy shared by the run."""
        self.dispatch_count += 1
        if len(run) > 1:
            self.ops_coalesced += len(run)
        desc, _, seg = _sc.pack_descriptors(
            [op.row for op in run], [op.off for op in run],
            [op.nbytes // op.count for op in run],
            strides=[op.stride for op in run],
            counts=[op.count for op in run])
        impl = _sc.resolve_impl(self.impl, arena)
        fn, hit = _sc.gather_plan(tuple(arena.shape), desc.shape[0], seg,
                                  impl=impl)
        self._note_plan(hit)
        d, _ = self._stage(arena, desc, None)
        batch = _GatherBatch(fn(arena, d))
        events = self._completion(arena)
        for i, op in enumerate(run):
            op.handle._resolve_gather(batch, i, events)

    @contextlib.contextmanager
    def epoch_scope(self, poolid: Optional[int] = None):
        """Explicit epoch as a ``with`` block: ops enqueued inside stay
        queued; leaving the block closes the epoch with one coalesced
        flush — of everything, or of one pool.  The flush runs even on
        error so no op is silently left queued."""
        try:
            yield self
        finally:
            self.flush(poolid)

    def clear(self) -> None:
        """Drop queued ops without dispatching (dart_exit teardown)."""
        with self.lock:
            self._pending = []


# --------------------------------------------------------------------------
# Run building — the reference's rules, verbatim
# --------------------------------------------------------------------------


def _kind_key(op) -> Tuple:
    if isinstance(op, _PendingPut):
        return ("put", op.poolid)
    if isinstance(op, _PendingAcc):
        # accumulates coalesce only with the SAME (op, dtype, fetch?):
        # a mixed-op (or mixed-dtype) overlap is not commutative, so it
        # splits the run and dispatches in queue order — exactly the
        # last-writer-wins rule puts follow
        kind = "gacc" if op.fetch else "acc"
        return (kind, op.poolid, op.op, op.dtype)
    return ("get", op.poolid)


def _op_nbytes(op) -> int:
    if isinstance(op, _PendingPut) or isinstance(op, _PendingAcc):
        return int(op.payload.size)
    return op.nbytes


def _op_span(op) -> int:
    """Bytes of the op's *covering interval* ``[off, off + span)`` —
    for a strided op this includes the gaps between segments
    (``(count-1)*stride + seg_len``), a deliberately conservative
    overlap proxy: two interleaved strided ops whose bytes never
    collide still read as overlapping, which only demotes the run to
    the ordered kernel (or splits it) — always correct, never unsafe.
    Contiguous ops: span == nbytes, the historical rule unchanged."""
    n = _op_nbytes(op)
    if op.count <= 1:
        return n
    return (op.count - 1) * op.stride + n // op.count


class _RunMeta:
    """Bookkeeping for the run currently being grown: payload sizes,
    per-row byte intervals, and whether every recorded write range is
    pairwise *disjoint* — the proof the dispatcher uses to issue the
    run as one vectorized segmented update (disjoint) instead of the
    sequential in-order loop (overlapping).

    Intervals are kept per row as a *merged* sorted disjoint set
    (parallel ``starts``/``ends`` lists), so the disjointness query is
    a bisect against at most two neighbours — O(log k) per candidate
    instead of a linear scan over every recorded op.  Only put runs
    track intervals: reads commute, so a get run never needs the
    disjointness rule (a write would split the run by kind anyway).

    The bucketed flat-index kernels never read or write outside an
    op's exact byte range (masked lanes are dropped/filled, not
    clamped), so there is no pool-headroom constraint: mixed-size runs
    coalesce anywhere in the pool, including hard against its end.
    """

    __slots__ = ("kind", "sizes", "max_n", "disjoint", "intervals")

    def __init__(self, op, n: int):
        self.kind = _kind_key(op)
        self.sizes = {n}
        self.max_n = n
        self.disjoint = True
        # row -> (starts, ends): merged, sorted, pairwise-disjoint.
        # Tracked for puts and plain accumulates (the vectorized-vs-
        # ordered dispatch proof — accumulates never *split* on
        # overlap, they just demote to the ordered RMW loop) and for
        # fetch-accumulates (whose run rule *requires* disjointness so
        # the fused read-all-then-apply-all equals sequential order).
        self.intervals: Dict[int, Tuple[List[int], List[int]]] = {}
        if self.kind[0] in ("put", "acc", "gacc"):
            self._note(op.row, op.off, op.off + _op_span(op))

    def _note(self, row: int, off: int, end: int) -> None:
        starts, ends = self.intervals.setdefault(row, ([], []))
        i = bisect.bisect_right(starts, off)
        # absorb a left neighbour that reaches (or touches) us
        if i > 0 and ends[i - 1] >= off:
            i -= 1
            off = starts[i]
            end = max(end, ends[i])
            del starts[i], ends[i]
        # absorb every following interval we now cover
        while i < len(starts) and starts[i] <= end:
            end = max(end, ends[i])
            del starts[i], ends[i]
        starts.insert(i, off)
        ends.insert(i, end)

    def _disjoint(self, op, n: int) -> bool:
        row_ivs = self.intervals.get(op.row)
        if row_ivs is None:
            return True
        starts, ends = row_ivs
        end = op.off + _op_span(op)
        i = bisect.bisect_right(starts, op.off)
        if i > 0 and ends[i - 1] > op.off:
            return False
        return not (i < len(starts) and starts[i] < end)

    def can_extend(self, op, n: int) -> bool:
        if _kind_key(op) != self.kind:
            return False
        if self.kind[0] == "acc":
            # same-(op, dtype) accumulates commute: any mix of sizes
            # and overlaps shares ONE dispatch — an overlapping
            # extension just demotes it to the ordered RMW kernel
            return True
        if self.kind[0] == "gacc":
            # fetch-accumulate: each fetched value must equal what a
            # sequential execution would read, and the fused kernel
            # reads every window before applying any op — valid only
            # while the run stays byte-disjoint; overlap splits it
            return self._disjoint(op, n)
        if self.sizes == {n}:
            # uniform run: unconditional, exactly the pre-registry rule —
            # an overlapping extension just demotes the dispatch to the
            # ordered kernel, so even overlapping ranges keep
            # last-writer-wins
            return True
        # mixed-size extension (bucketed segmented dispatch): puts
        # require byte-range disjointness — overlapping writes stay in
        # separate, sequentially dispatched runs so program order is
        # preserved; gets commute, so they coalesce unconditionally
        return self.kind[0] != "put" or self._disjoint(op, n)

    def extend(self, op, n: int) -> None:
        self.sizes.add(n)
        self.max_n = max(self.max_n, n)
        if self.kind[0] in ("put", "acc"):
            if self.disjoint and not self._disjoint(op, n):
                self.disjoint = False
            self._note(op.row, op.off, op.off + _op_span(op))
        elif self.kind[0] == "gacc":
            self._note(op.row, op.off, op.off + _op_span(op))


def _coalesced_runs(ops: Sequence) -> List[Tuple[List, bool]]:
    """Split into maximal ``(run, disjoint)`` pairs, each run sharing
    one batched dispatch.

    An op extends the current run when it has the same kind and pool
    and either (a) the same payload size as a so-far-uniform run — the
    original coalescing rule — or (b) for mixed sizes, a byte range
    *disjoint* from every write already in the run.  Overlapping
    ranges of different sizes split the run, so dispatching runs in
    queue order preserves put/put and put/get program order (last
    writer wins, reads see prior writes), exactly like the blocking
    sequence.  ``disjoint`` reports whether every write range in the
    run is pairwise disjoint — the dispatcher's license to use the
    vectorized segmented kernel instead of the ordered loop.
    """
    runs: List[List] = []
    metas: List[_RunMeta] = []
    for op in ops:
        n = _op_nbytes(op)
        if runs and metas[-1].can_extend(op, n):
            runs[-1].append(op)
            metas[-1].extend(op, n)
        else:
            runs.append([op])
            metas.append(_RunMeta(op, n))
    return [(run, meta.disjoint) for run, meta in zip(runs, metas)]
