"""DART global memory management (paper §III, §IV.B.3), on torch.

The global address space is a **symmetric heap**: one byte arena per
*segment pool*, each a ``torch.uint8[n_rows, pool_bytes]`` tensor whose
rows are the per-unit partitions.  Arenas live on one device — a CUDA
card by default, the CPU when the caller asks for it.  This is the
analogue of the paper's MPI *windows*:

* **Non-collective allocations** (``dart_memalloc``) are local ops.  The
  paper pre-reserves one block of memory on every unit and creates a
  single WORLD window over it at init time (§IV.B.3, Fig. 4); every
  non-collective allocation then carves from the calling unit's
  partition.  Pool id 0 is that WORLD pool, with one row per unit and a
  *per-unit* allocator; offsets in non-collective global pointers are
  displacements into the owner's row, dereferenced **without unit
  translation** (§IV.B.4).

* **Collective allocations** (``dart_team_memalloc_aligned``) carve from
  the owning team's pre-reserved pool (one row per *team member*,
  addressed by relative id → unit translation required).  A single
  shared allocator cursor guarantees the *aligned & symmetric* property:
  every member sees the identical offset (§III).  Each allocation is
  recorded in the team's **translation table** (§IV.B.3, Fig. 5).

The allocator is a first-fit free-list with coalescing; offsets match
the JAX reference package allocation for allocation (same
``ALIGNMENT``), so a heap can be carried across between the two
(:func:`heap_state_from_numpy`).

Arenas are updated **in place** by the one-sided engine (the JAX
reference donates and re-installs them instead), so a ``HeapState`` dict
holds the same tensor objects for the life of their pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .faults import DartError

#: allocation granularity (bytes).  Kept at 128 — the reference's value —
#: so offsets are shared with the JAX package.
ALIGNMENT = 128


def align_up(n: int, a: int = ALIGNMENT) -> int:
    return (n + a - 1) // a * a


class OutOfGlobalMemory(DartError):
    """Allocation failure in a symmetric-heap pool (typed: part of the
    :class:`~repro_torch.core.faults.DartError` ladder, still a
    ``RuntimeError``)."""


class WindowDestroyedError(DartError, KeyError):
    """A global pointer was dereferenced against a team whose window
    (collective pool) is no longer live — the pool was dropped by
    ``dart_team_destroy`` and the teamlist slot may since have been
    reused by an unrelated team (paper §IV.B.2).  Doubly parented:
    :class:`~repro_torch.core.faults.DartError` and ``KeyError``
    (registry lookup semantics).  Instances raised through the engine's
    drop path carry ``poolid`` and ``teamid``."""


class BlockAllocator:
    """First-fit free-list allocator with coalescing over [0, size)."""

    def __init__(self, size: int):
        self.size = size
        self._free: List[Tuple[int, int]] = [(0, size)]   # (offset, len)
        self._live: Dict[int, int] = {}                   # offset -> len

    def alloc(self, nbytes: int) -> int:
        nbytes = align_up(max(nbytes, 1))
        for i, (off, ln) in enumerate(self._free):
            if ln >= nbytes:
                if ln == nbytes:
                    self._free.pop(i)
                else:
                    self._free[i] = (off + nbytes, ln - nbytes)
                self._live[off] = nbytes
                return off
        raise OutOfGlobalMemory(
            f"pool exhausted: need {nbytes}B, largest free block "
            f"{self.largest_free()}B")

    def free(self, offset: int) -> None:
        ln = self._live.pop(offset)
        self._free.append((offset, ln))
        self._free.sort()
        merged: List[Tuple[int, int]] = []
        for off, l in self._free:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + l)
            else:
                merged.append((off, l))
        self._free = merged

    def bytes_live(self) -> int:
        return sum(self._live.values())

    def bytes_free(self) -> int:
        return sum(l for _, l in self._free)

    def largest_free(self) -> int:
        """Largest contiguous free block — the quantity coalescing on
        :meth:`free` exists to maximize."""
        return max((l for _, l in self._free), default=0)


@dataclasses.dataclass
class TranslationRecord:
    """One row of a team's translation table (paper Fig. 5)."""
    offset: int          # displacement in the team pool (== gptr.addr)
    nbytes: int          # per-unit extent of the allocation
    poolid: int          # which arena backs it ("window object")


class TranslationTable:
    """Per-team table mapping collective allocations → (pool, offset).

    The paper stores (window object, offset) per collective allocation;
    dereference walks the table to find the record *containing* a given
    address (§IV.B.3/4).
    """

    def __init__(self):
        self._records: List[TranslationRecord] = []

    def add(self, rec: TranslationRecord) -> None:
        self._records.append(rec)
        self._records.sort(key=lambda r: r.offset)

    def query(self, addr: int) -> TranslationRecord:
        for r in self._records:
            if r.offset <= addr < r.offset + r.nbytes:
                return r
        raise KeyError(f"address {addr} not inside any collective allocation")

    def remove(self, offset: int) -> TranslationRecord:
        for i, r in enumerate(self._records):
            if r.offset == offset:
                return self._records.pop(i)
        raise KeyError(f"no allocation at offset {offset}")

    def __len__(self) -> int:
        return len(self._records)


@dataclasses.dataclass
class PoolMeta:
    """Host-side metadata for one arena pool."""
    poolid: int
    n_rows: int
    pool_bytes: int
    collective: bool
    # collective pools: one shared cursor (aligned & symmetric);
    # non-collective pool: one allocator per unit row.
    shared_alloc: Optional[BlockAllocator] = None
    per_unit_alloc: Optional[List[BlockAllocator]] = None
    table: Optional[TranslationTable] = None


class WindowRegistry:
    """teamid → live :class:`PoolMeta` binding (the window-object table).

    DART-MPI binds every team to an MPI window object; dereference of a
    collective pointer goes team → window, never through slot
    arithmetic.  Teams register their pool at creation, drop it at
    destroy, and ``deref`` keys off this registry — so teamlist-slot
    reuse (paper §IV.B.2) can never route a new team's pointers at a
    dropped or foreign pool.  TeamIDs are never reused (§IV.B.2).
    """

    def __init__(self):
        self._by_team: Dict[int, PoolMeta] = {}

    def register(self, teamid: int, meta: PoolMeta) -> None:
        if teamid in self._by_team:
            raise ValueError(f"team {teamid} already has a live window")
        self._by_team[teamid] = meta

    def lookup(self, teamid: int) -> PoolMeta:
        try:
            return self._by_team[teamid]
        except KeyError:
            raise WindowDestroyedError(
                f"team {teamid} has no live window (pool dropped by "
                "dart_team_destroy?)") from None

    def drop(self, teamid: int) -> PoolMeta:
        try:
            return self._by_team.pop(teamid)
        except KeyError:
            raise WindowDestroyedError(
                f"team {teamid} has no live window to drop") from None

    def clear(self) -> None:
        self._by_team.clear()

    def __contains__(self, teamid: int) -> bool:
        return teamid in self._by_team

    def __len__(self) -> int:
        return len(self._by_team)

    def live_teams(self) -> Tuple[int, ...]:
        return tuple(self._by_team)


#: The heap state: ``{poolid: uint8[n_rows, pool_bytes]}`` tensors, all on
#: the heap's device and updated in place by the engine.
HeapState = Dict[int, torch.Tensor]


class SymmetricHeap:
    """Host-side layout manager + factory for the heap's arenas."""

    def __init__(self, n_units: int, device):
        self.n_units = n_units
        self.device = torch.device(device)
        self.pools: Dict[int, PoolMeta] = {}
        self.windows = WindowRegistry()
        self._next_poolid = 0

    # -- pool management -------------------------------------------------
    def reserve_pool(self, n_rows: int, pool_bytes: int,
                     collective: bool) -> PoolMeta:
        pool_bytes = align_up(pool_bytes)
        pid = self._next_poolid
        self._next_poolid += 1
        meta = PoolMeta(
            poolid=pid, n_rows=n_rows, pool_bytes=pool_bytes,
            collective=collective,
            shared_alloc=BlockAllocator(pool_bytes) if collective else None,
            per_unit_alloc=(None if collective else
                            [BlockAllocator(pool_bytes) for _ in range(n_rows)]),
            table=TranslationTable() if collective else None,
        )
        self.pools[pid] = meta
        return meta

    def drop_pool(self, poolid: int) -> None:
        del self.pools[poolid]

    def init_pool_state(self, meta: PoolMeta) -> torch.Tensor:
        """Zero-initialized arena for one pool, on the heap's device."""
        return torch.zeros((meta.n_rows, meta.pool_bytes),
                           dtype=torch.uint8, device=self.device)

    # -- allocation ------------------------------------------------------
    def memalloc_local(self, meta: PoolMeta, unit_row: int,
                       nbytes: int) -> int:
        """Non-collective allocation on one unit's partition (§IV.B.3)."""
        if meta.collective:
            raise ValueError("local alloc on a collective pool")
        return meta.per_unit_alloc[unit_row].alloc(nbytes)

    def memalloc_aligned(self, meta: PoolMeta, nbytes: int) -> int:
        """Collective aligned/symmetric allocation (§IV.B.3, Fig. 5)."""
        if not meta.collective:
            raise ValueError("aligned alloc on the non-collective pool")
        off = meta.shared_alloc.alloc(nbytes)
        meta.table.add(TranslationRecord(offset=off, nbytes=align_up(nbytes),
                                         poolid=meta.poolid))
        return off

    def memfree_local(self, meta: PoolMeta, unit_row: int,
                      offset: int) -> None:
        meta.per_unit_alloc[unit_row].free(offset)

    def memfree_aligned(self, meta: PoolMeta, offset: int) -> None:
        meta.shared_alloc.free(offset)
        meta.table.remove(offset)


# -- dtypes -------------------------------------------------------------------

_TORCH_BY_NAME = {
    "bool": torch.bool, "uint8": torch.uint8, "int8": torch.int8,
    "int16": torch.int16, "uint16": torch.uint16, "int32": torch.int32,
    "uint32": torch.uint32, "int64": torch.int64, "uint64": torch.uint64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def torch_dtype(dtype) -> torch.dtype:
    """Normalize a dtype given as a ``torch.dtype``, a numpy dtype (or
    scalar type), or a name — bfloat16 included, which numpy knows only
    through extension packages and is matched here by name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    try:
        return _TORCH_BY_NAME[name]
    except KeyError:
        raise TypeError(f"unsupported heap dtype {dtype!r}") from None


# -- byte <-> typed-value conversion -------------------------------------------

def to_bytes(value: torch.Tensor) -> torch.Tensor:
    """Flatten a typed tensor into a 1-D uint8 byte string (bitcast, on
    the tensor's device)."""
    flat = value.contiguous().reshape(-1)
    if flat.dtype == torch.uint8:
        return flat
    return flat.view(torch.uint8)


def from_bytes(raw: torch.Tensor, shape: Tuple[int, ...], dtype
               ) -> torch.Tensor:
    """Inverse of :func:`to_bytes`."""
    dt = torch_dtype(dtype)
    raw = raw.contiguous().reshape(-1)
    if dt == torch.uint8:
        return raw.reshape(shape)
    return raw.view(dt).reshape(shape)


def nbytes_of(shape: Tuple[int, ...], dtype) -> int:
    return int(np.prod(shape, dtype=np.int64)) * torch_dtype(dtype).itemsize


# -- carrying a heap across from the JAX reference ------------------------------

def heap_state_from_numpy(state: Dict[int, np.ndarray], device
                          ) -> HeapState:
    """``{poolid: uint8[n_rows, pool_bytes]}`` numpy arenas (for example
    the JAX package's heap, converted with ``np.asarray``) → this
    package's arenas on ``device``, byte for byte."""
    out: HeapState = {}
    for pid, arr in state.items():
        arr = np.asarray(arr)
        if arr.dtype != np.uint8 or arr.ndim != 2:
            raise ValueError(f"pool {pid}: expected a 2-D uint8 arena, got "
                             f"{arr.dtype} {arr.shape}")
        out[pid] = torch.from_numpy(np.array(arr, copy=True)).to(device)
    return out


def heap_state_to_numpy(state: HeapState) -> Dict[int, np.ndarray]:
    """Inverse of :func:`heap_state_from_numpy`: host numpy copies."""
    return {pid: t.detach().cpu().numpy().copy() for pid, t in state.items()}
