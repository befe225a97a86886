"""DART runtime context: init/exit, teams, global memory (paper §III/IV),
on torch.

One :class:`DartContext` owns

* the unit space (``n_units``),
* the teamlist + ``teams`` registry (slot-indexed, §IV.B.2),
* the symmetric heap layout + its arenas on one device (§IV.B.3),
* the lock service (§IV.B.6),
* the one-sided engine (:class:`~repro_torch.core.onesided.CommEngine`).

``dart_init`` reserves the non-collective WORLD pool and creates
DART_TEAM_ALL with its collective pool.  The heap lives on ``cuda:0``
unless the caller names another device; with no CUDA device and no
explicit ``device``, ``dart_init`` raises rather than run on the host.

Blocking put/get/accumulate and the host-plane collectives go through
the engine: the reference routes ``FLAG_SHM`` pointers on host-visible
arenas through its shm plane first, which a CUDA arena never is; the
port's shm plane is a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .atomics import ThreadedAtomics
from .globmem import HeapState, SymmetricHeap
from .gptr import FLAG_COLLECTIVE, NON_COLLECTIVE_SEG, GlobalPtr
from .group import DartGroup
from .lock import LockService
from .team import (DART_TEAM_ALL, FreeListTeamList, Team, TeamList,
                   TeamPartition)
from . import collectives as _coll
from . import onesided as _os


@dataclasses.dataclass
class DartConfig:
    non_collective_pool_bytes: int = 1 << 20   # per-unit WORLD partition
    team_pool_bytes: int = 1 << 20             # per-member team pool
    teamlist_capacity: int = 256
    teamlist_impl: str = "paper"               # 'paper' | 'freelist' (§VI)
    lock_tail_placement: str = "unit0"         # 'unit0' | 'round_robin' (§VI)


def _resolve_device(device) -> torch.device:
    """``None`` → ``cuda:0``; a CUDA device without a card raises."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "dart_init: no CUDA device is available; pass "
                "device='cpu' to keep the heap on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class DartContext:
    """The live runtime (the paper's process-global DART state)."""

    def __init__(self, n_units: int, config: DartConfig,
                 device: torch.device):
        self.n_units = n_units
        self.config = config
        self.heap = SymmetricHeap(n_units, device=device)
        tl_cls = TeamList if config.teamlist_impl == "paper" else FreeListTeamList
        self.teamlist = tl_cls(config.teamlist_capacity)
        self.teams: Dict[int, Team] = {}          # teamid -> Team
        self.teams_by_slot: Dict[int, Team] = {}  # slot   -> Team
        self._next_teamid = 0
        self.atomics = ThreadedAtomics(n_units)
        self.locks = LockService(self.atomics,
                                 tail_placement=config.lock_tail_placement)
        self.state: HeapState = {}
        # epoch-scoped pending-op queue: dart_put/dart_get_nb enqueue
        # here; dart_flush / handle.wait() dispatch coalesced runs
        # against self.state, in place
        self.engine = _os.CommEngine(holder=self)
        self._initialized = False

    @property
    def device(self) -> torch.device:
        return self.heap.device

    @property
    def windows(self):
        """The heap's teamid → live-PoolMeta window registry."""
        return self.heap.windows

    def _create_team(self, group: DartGroup, parent: Optional[int]) -> Team:
        teamid = self._next_teamid
        self._next_teamid += 1                  # teamIDs never reused (§IV.B.2)
        slot = self.teamlist.alloc(teamid)
        # reserve the team's collective pool and bind it (registry entry
        # + poolid on the Team): deref keys off this binding, never off
        # slot arithmetic, since slots are reused and pool ids are not
        meta = self.heap.reserve_pool(
            n_rows=group.size(), pool_bytes=self.config.team_pool_bytes,
            collective=True)
        team = Team(teamid=teamid, group=group, slot=slot, parent=parent,
                    poolid=meta.poolid)
        self.teams[teamid] = team
        self.teams_by_slot[slot] = team
        self.heap.windows.register(teamid, meta)
        self.state[meta.poolid] = self.heap.init_pool_state(meta)
        return team


def dart_init(n_units: Optional[int] = None,
              config: Optional[DartConfig] = None,
              device=None) -> DartContext:
    """Initialize the runtime (paper: ``dart_init``).  ``device=None``
    puts the heap on ``cuda:0`` and raises without a card; tests pass
    ``device='cpu'``.  ``n_units`` defaults to the number of CUDA
    devices for a CUDA heap and to 1 for a CPU heap."""
    config = config or DartConfig()
    dev = _resolve_device(device)
    if n_units is None:
        n_units = torch.cuda.device_count() if dev.type == "cuda" else 1
    ctx = DartContext(n_units, config, dev)
    # pre-reserved WORLD window for non-collective allocations (§IV.B.3)
    world_meta = ctx.heap.reserve_pool(
        n_rows=n_units, pool_bytes=config.non_collective_pool_bytes,
        collective=False)
    if world_meta.poolid != _os.WORLD_POOLID:
        raise RuntimeError("WORLD pool must be reserved first")
    ctx.state[world_meta.poolid] = ctx.heap.init_pool_state(world_meta)
    team_all = ctx._create_team(DartGroup(tuple(range(n_units))),
                                parent=None)
    if team_all.teamid != DART_TEAM_ALL:
        raise RuntimeError("DART_TEAM_ALL must be the first team")
    ctx._initialized = True
    return ctx


def dart_exit(ctx: DartContext) -> None:
    """Tear down (paper: ``dart_exit``): queued ops are dropped and the
    arenas released."""
    ctx.engine.clear()
    ctx.state.clear()
    ctx.teams.clear()
    ctx.teams_by_slot.clear()
    ctx.heap.windows.clear()
    ctx._initialized = False


# -- team management (paper §III) -------------------------------------------

def dart_team_create(ctx: DartContext, parent_teamid: int,
                     group: DartGroup) -> int:
    """Collective team creation from a group (paper: subset of parent)."""
    parent = ctx.teams[parent_teamid]
    for u in group.members:
        if not parent.contains(u):
            raise ValueError(f"unit {u} not in parent team {parent_teamid}")
    return ctx._create_team(group, parent=parent_teamid).teamid


def dart_team_destroy(ctx: DartContext, teamid: int) -> None:
    if teamid == DART_TEAM_ALL:
        raise ValueError("cannot destroy DART_TEAM_ALL")
    team = ctx.teams.pop(teamid)
    ctx.teams_by_slot.pop(team.slot)
    ctx.teamlist.free(teamid)            # slot becomes reusable (§IV.B.2)
    meta = ctx.heap.windows.drop(teamid)
    # queued ops against the dropped window can never dispatch: fail
    # their handles now with a typed WindowDestroyedError
    ctx.engine.drop_pool(meta.poolid, reason=f"team {teamid} destroyed",
                         teamid=teamid)
    ctx.state.pop(meta.poolid, None)
    ctx.heap.drop_pool(meta.poolid)


def dart_team_get_group(ctx: DartContext, teamid: int) -> DartGroup:
    return ctx.teams[teamid].group


def dart_team_myid(ctx: DartContext, teamid: int, absolute_unit: int) -> int:
    return ctx.teams[teamid].myid(absolute_unit)


def dart_team_size(ctx: DartContext, teamid: int) -> int:
    return ctx.teams[teamid].size()


def dart_team_split(ctx: DartContext, teamid: int, n: int) -> TeamPartition:
    """Split a team into n equal sub-teams."""
    from .group import dart_group_split
    subgroups = dart_group_split(ctx.teams[teamid].group, n)
    teams = tuple(ctx.teams[dart_team_create(ctx, teamid, g)]
                  for g in subgroups)
    return TeamPartition(teams)


# -- global memory (paper §III, §IV.B.3) -------------------------------------

def dart_memalloc(ctx: DartContext, nbytes: int, unit: int) -> GlobalPtr:
    """Non-collective allocation on ``unit``'s WORLD partition."""
    meta = ctx.heap.pools[_os.WORLD_POOLID]
    off = ctx.heap.memalloc_local(meta, unit, nbytes)
    return GlobalPtr(unitid=unit, segid=NON_COLLECTIVE_SEG, flags=0,
                     addr=off)


def dart_memfree(ctx: DartContext, gptr: GlobalPtr) -> None:
    if gptr.is_collective:
        raise ValueError("use dart_team_memfree for collective pointers")
    meta = ctx.heap.pools[_os.WORLD_POOLID]
    ctx.heap.memfree_local(meta, gptr.unitid, gptr.addr)


def dart_team_memalloc_aligned(ctx: DartContext, teamid: int,
                               nbytes_per_unit: int) -> GlobalPtr:
    """Collective aligned/symmetric allocation (paper Fig. 5): a
    collective pointer to the allocation's start, owned by the team's
    first member; ``setunit`` addresses any member's portion at the same
    offset."""
    team = ctx.teams[teamid]
    meta = ctx.heap.windows.lookup(teamid)
    off = ctx.heap.memalloc_aligned(meta, nbytes_per_unit)
    return GlobalPtr(unitid=team.unit_at(0), segid=team.slot,
                     flags=FLAG_COLLECTIVE, addr=off)


def dart_team_memfree(ctx: DartContext, teamid: int,
                      gptr: GlobalPtr) -> None:
    meta = ctx.heap.windows.lookup(teamid)
    ctx.heap.memfree_aligned(meta, gptr.addr)


# -- one-sided ops bound to a context ----------------------------------------
#
# Non-blocking ops ENQUEUE on ctx.engine (initiation = translation +
# bounds check only); dispatch happens at dart_flush / handle.wait() /
# a blocking op, coalescing queued ops into one kernel launch per run.

def dart_put(ctx: DartContext, gptr: GlobalPtr, value, *,
             stride: int = 0, count: int = 1):
    """Non-blocking put: enqueue on the engine, return a queued handle.
    ``count > 1`` splits the payload into ``count`` equal segments
    landing ``stride`` bytes apart (one strided descriptor)."""
    return ctx.engine.put(ctx.heap, ctx.teams_by_slot, gptr, value,
                          stride=stride, count=count)


def dart_put_blocking(ctx: DartContext, gptr: GlobalPtr, value, *,
                      stride: int = 0, count: int = 1) -> None:
    """Blocking put: enqueue, flush the target's lane, and wait for the
    dispatch to complete."""
    ctx.engine.put(ctx.heap, ctx.teams_by_slot, gptr, value,
                   stride=stride, count=count).wait()


def dart_accumulate(ctx: DartContext, gptr: GlobalPtr, value,
                    op: str = "sum", *, stride: int = 0, count: int = 1):
    """Non-blocking element-wise accumulate at the target (the
    ``MPI_Accumulate`` analogue): enqueue on the engine, return a
    queued handle.  Consecutive same-``op`` accumulates to one pool
    coalesce into ONE segmented read-modify-write dispatch at flush —
    overlapping ranges included, since the ops commute; mixed-op or
    accumulate-vs-put overlap splits the run in queue order."""
    return ctx.engine.accumulate(ctx.heap, ctx.teams_by_slot, gptr, value,
                                 op, stride=stride, count=count)


def dart_accumulate_blocking(ctx: DartContext, gptr: GlobalPtr, value,
                             op: str = "sum", *, stride: int = 0,
                             count: int = 1) -> None:
    """Blocking accumulate: enqueue, flush the target's lane, and wait
    for the dispatch to complete."""
    ctx.engine.accumulate(ctx.heap, ctx.teams_by_slot, gptr, value, op,
                          stride=stride, count=count).wait()


def dart_get_accumulate(ctx: DartContext, gptr: GlobalPtr, value,
                        op: str = "sum", *, stride: int = 0,
                        count: int = 1):
    """Fetch-and-accumulate (the ``MPI_Get_accumulate`` analogue):
    flushes the target's ``(pool, row)`` lane and returns ``(old_value,
    handle)`` — the target's typed value from *before* this op applied,
    as a CPU tensor.  For the queued form use
    ``ctx.engine.get_accumulate`` and ``handle.value()`` later."""
    h = ctx.engine.get_accumulate(ctx.heap, ctx.teams_by_slot, gptr, value,
                                  op, stride=stride, count=count)
    ctx.engine.flush(h.poolid, h.row)
    return h.value(), h


def dart_get_nb(ctx: DartContext, gptr: GlobalPtr, shape, dtype, *,
                stride: int = 0, count: int = 1):
    """Non-blocking get: enqueue; ``handle.value()`` flushes and yields
    the typed result.  ``count > 1`` gathers ``count`` equal segments
    ``stride`` bytes apart, densely packed in the result."""
    return ctx.engine.get(ctx.heap, ctx.teams_by_slot, gptr, shape,
                          dtype, stride=stride, count=count)


def dart_get(ctx: DartContext, gptr: GlobalPtr, shape, dtype, *,
             stride: int = 0, count: int = 1):
    """Issue-immediately get: returns ``(value, handle)``.  Flushes the
    target's ``(pool, row)`` lane (queued puts to that unit become
    visible; other targets keep accumulating), then dispatches the
    read; the value is a CPU tensor."""
    h = ctx.engine.get(ctx.heap, ctx.teams_by_slot, gptr, shape,
                       dtype, stride=stride, count=count)
    ctx.engine.flush(h.poolid, h.row)
    return h.value(), h


def dart_get_blocking(ctx: DartContext, gptr: GlobalPtr, shape, dtype):
    """Blocking get through the engine; returns a CPU tensor."""
    return ctx.engine.get(ctx.heap, ctx.teams_by_slot, gptr, shape,
                          dtype).value()


def dart_flush(ctx: DartContext, gptr: Optional[GlobalPtr] = None,
               target: Optional[int] = None) -> None:
    """Close the epoch: dispatch all pending ops, only those against
    ``gptr``'s pool (the ``MPI_Win_flush`` analogue), or — with
    ``target`` — only those against one unit's row of that pool (the
    ``MPI_Win_flush_local(rank, win)`` analogue)."""
    if gptr is None:
        if target is not None:
            raise ValueError("per-target flush needs a gptr to name the "
                             "window (dart_flush(ctx, gptr, target=unit))")
        ctx.engine.flush()
        return
    if target is not None:
        gptr = gptr.setunit(target)
    poolid, row, _ = _os.deref(ctx.heap, ctx.teams_by_slot, gptr)
    ctx.engine.flush(poolid, row if target is not None else None)


# -- host-plane collectives ---------------------------------------------------
#
# Each wrapper holds the engine lock for the whole flush-compute-update
# of ctx.state (the lock is reentrant, so the flush inside re-enters).
# The reference first offers bcast/gather/scatter to its shm plane,
# which serves FLAG_SHM pointers on host-visible pools by memcpy with no
# dispatch; the port has no shm plane yet, so they always go through the
# engine (see ROADMAP queue 3).

def dart_bcast(ctx: DartContext, root_gptr: GlobalPtr, nbytes: int):
    with ctx.engine.lock:
        ctx.state, h = _coll.dart_bcast(ctx.state, ctx.heap,
                                        ctx.teams_by_slot, root_gptr,
                                        nbytes, engine=ctx.engine)
    return h


def dart_gather(ctx: DartContext, gptr: GlobalPtr, per_unit_nbytes: int):
    """Every row's ``per_unit_nbytes`` at ``gptr.addr`` → ``(out,
    handle)``, ``out`` a CPU uint8 tensor ``(n_rows, per_unit_nbytes)``."""
    with ctx.engine.lock:
        return _coll.dart_gather(ctx.state, ctx.heap, ctx.teams_by_slot,
                                 gptr, per_unit_nbytes, engine=ctx.engine)


def dart_gather_typed(ctx: DartContext, gptr: GlobalPtr, shape, dtype):
    """Typed gather: every row's value at ``gptr.addr`` → a CPU tensor
    ``(n_rows, *shape)``."""
    with ctx.engine.lock:
        return _coll.dart_gather_typed(ctx.state, ctx.heap,
                                       ctx.teams_by_slot, gptr, shape,
                                       dtype, engine=ctx.engine)


def dart_scatter(ctx: DartContext, gptr: GlobalPtr, values):
    with ctx.engine.lock:
        ctx.state, h = _coll.dart_scatter(ctx.state, ctx.heap,
                                          ctx.teams_by_slot, gptr, values,
                                          engine=ctx.engine)
    return h


def dart_scatter_typed(ctx: DartContext, gptr: GlobalPtr, values):
    """Typed scatter: row i of ``values`` ((n_rows, *shape)) → unit i."""
    with ctx.engine.lock:
        ctx.state, h = _coll.dart_scatter_typed(ctx.state, ctx.heap,
                                                ctx.teams_by_slot, gptr,
                                                values, engine=ctx.engine)
    return h


def dart_allreduce(ctx: DartContext, gptr: GlobalPtr, shape, dtype,
                   op: str = "sum"):
    with ctx.engine.lock:
        ctx.state, red = _coll.dart_allreduce(ctx.state, ctx.heap,
                                              ctx.teams_by_slot, gptr,
                                              shape, dtype, op,
                                              engine=ctx.engine)
    return red


def dart_reduce(ctx: DartContext, gptr: GlobalPtr, shape, dtype,
                op: str = "sum", root: int = 0):
    """Root-taking reduce: the reduced value replaces only ``root``'s
    copy (other rows keep their own); returns the reduced value."""
    with ctx.engine.lock:
        ctx.state, red = _coll.dart_reduce(ctx.state, ctx.heap,
                                           ctx.teams_by_slot, gptr, shape,
                                           dtype, op, root,
                                           engine=ctx.engine)
    return red


def dart_barrier(ctx: DartContext) -> None:
    with ctx.engine.lock:
        ctx.engine.flush()
        _coll.dart_barrier(ctx.state)
