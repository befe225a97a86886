"""DART mutexes: the MCS list-based queuing lock (paper §IV.B.6).

Faithful implementation of the protocol in the paper (after
Mellor-Crummey & Scott [16]), Fig. 6:

* Lock creation is collective on a team; multiple locks per team.
* State: a ``tail`` cell — a non-collective global allocation on unit 0
  of the team (``dart_memalloc`` in the paper) — plus a distributed
  ``list`` (one "next waiter" cell per member, allocated via
  ``dart_team_memalloc_aligned``).  Both initialized to -1:
  lock free, queue empty.
* ``dart_lock_acquire`` (unit i): ``predecessor = fetch_and_store(tail, i)``.
  If ``predecessor == -1`` the lock was free and i holds it.  Otherwise
  i registers itself in ``list[predecessor]`` (a one-sided put) and
  blocks waiting for a zero-size notification from its predecessor
  (``MPI_Recv`` in the paper).
* ``dart_lock_release`` (unit i): ``compare_and_swap(tail, i, -1)``.
  If the CAS succeeds i was the only queued unit and the lock becomes
  free.  Otherwise a successor is (or is about to be) registered: spin
  until ``list[i] != -1``, then send the zero-size notification to the
  successor and reset ``list[i]``.

FIFO ordering and mutual exclusion follow from the atomicity of
fetch_and_store/CAS — both provided by :mod:`repro_torch.core.atomics`.

Beyond-paper (§VI future work): the paper always places ``tail`` on
unit 0, concentrating atomic traffic there when many locks exist per
team.  ``tail_placement='round_robin'`` spreads tails across members by
lock id; ``benchmarks/lock_bench.py`` measures the per-home congestion
counters for both placements.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional

from .atomics import AtomicsProvider, Cell
from .team import Team

FREE = -1


@dataclasses.dataclass
class DartLock:
    """Handle for one team lock (the paper's compound record)."""

    lock_id: int
    team: Team
    tail: Cell                       # non-collective gptr → atomic cell
    next_cells: Dict[int, Cell]      # absolute unit → its 'list' slot
    #: stats for benchmarks
    acquisitions: int = 0

    def is_free_hint(self, atomics: AtomicsProvider) -> bool:
        """Non-authoritative peek at the tail (debug/monitoring only)."""
        return atomics.load(self.tail) == FREE


class LockService:
    """Creates and operates DART team locks over an atomics provider."""

    def __init__(self, atomics: AtomicsProvider,
                 tail_placement: str = "unit0"):
        if tail_placement not in ("unit0", "round_robin"):
            raise ValueError(tail_placement)
        self.atomics = atomics
        self.tail_placement = tail_placement
        self._locks: Dict[int, DartLock] = {}
        self._next_lock_id = 0

    # -- dart_team_lock_init (collective on team) ------------------------
    def create_lock(self, team: Team) -> DartLock:
        lock_id = self._next_lock_id
        self._next_lock_id += 1
        members = team.group.members
        if self.tail_placement == "unit0":
            home = members[0]                      # paper: always unit 0
        else:
            home = members[lock_id % len(members)]  # beyond-paper balance
        tail = self.atomics.make_cell(("tail", lock_id), home, FREE)
        next_cells = {
            u: self.atomics.make_cell(("next", lock_id, u), u, FREE)
            for u in members
        }
        lock = DartLock(lock_id=lock_id, team=team, tail=tail,
                        next_cells=next_cells)
        self._locks[lock_id] = lock
        return lock

    def destroy_lock(self, lock: DartLock) -> None:
        """dart_team_lock_free: drop the registry entry AND return the
        tail/next cells to the provider (heap-backed providers reclaim
        the global-memory bytes; cells leaked here were unreclaimable
        until the provider grew ``free_cell``)."""
        self._locks.pop(lock.lock_id, None)
        self.atomics.free_cell(lock.tail)
        for cell in lock.next_cells.values():
            self.atomics.free_cell(cell)

    # -- dart_lock_acquire ------------------------------------------------
    def acquire(self, lock: DartLock, unit: int,
                timeout: Optional[float] = None) -> None:
        if unit not in lock.next_cells:
            raise KeyError(f"unit {unit} is not in team {lock.team.teamid}")
        predecessor = self.atomics.fetch_and_store(lock.tail, unit)
        if predecessor != FREE:
            # register with the predecessor (one-sided put into list[pred])
            self.atomics.store(lock.next_cells[predecessor], unit)
            # block until the predecessor's release notifies us
            self.atomics.wait_notify(unit, ("lock", lock.lock_id),
                                     timeout=timeout)
        lock.acquisitions += 1

    def try_acquire(self, lock: DartLock, unit: int) -> bool:
        """dart_lock_try_acquire: acquire only if currently free."""
        old = self.atomics.compare_and_swap(lock.tail, FREE, unit)
        if old == FREE:
            lock.acquisitions += 1
            return True
        return False

    @contextlib.contextmanager
    def held(self, lock: DartLock, unit: int,
             timeout: Optional[float] = None):
        """``with locks.held(lock, unit): ...`` — acquire on entry,
        release on exit **including on exception**, so a failing
        critical section can never wedge the queue (successors would
        otherwise block forever in ``wait_notify``)."""
        self.acquire(lock, unit, timeout=timeout)
        try:
            yield lock
        finally:
            self.release(lock, unit)

    # -- dart_lock_release ------------------------------------------------
    def release(self, lock: DartLock, unit: int,
                spin_sleep: float = 1e-6, max_spin_sleep: float = 1e-3,
                timeout: Optional[float] = None) -> None:
        """Release, handing off to the registered successor if any.

        The successor-registration wait uses bounded exponential
        backoff (``spin_sleep`` doubling up to ``max_spin_sleep``) —
        the old ``spin_sleep=0.0`` default was a GIL-held busy loop
        that starved the very successor thread it was waiting on under
        the threaded provider.  ``timeout`` mirrors ``acquire``: raise
        ``TimeoutError`` instead of spinning forever on a successor
        that swapped the tail but died before registering.
        """
        old = self.atomics.compare_and_swap(lock.tail, unit, FREE)
        if old == unit:
            return                                  # nobody queued behind us
        # A successor swapped the tail before our CAS: it is (or will be)
        # registered in our 'next' cell.  Back off until the
        # registration lands, then hand over.
        mine = lock.next_cells[unit]
        deadline = (time.monotonic() + timeout
                    if timeout is not None else None)
        sleep = max(spin_sleep, 1e-9)
        succ = self.atomics.load(mine)
        while succ == FREE:
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"lock {lock.lock_id}: successor swapped the tail "
                    f"but never registered in unit {unit}'s next cell "
                    f"within {timeout}s")
            time.sleep(sleep)
            sleep = min(sleep * 2, max_spin_sleep)
            succ = self.atomics.load(mine)
        self.atomics.store(mine, FREE)
        self.atomics.notify(succ, ("lock", lock.lock_id))
