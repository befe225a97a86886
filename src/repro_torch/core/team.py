"""DART teams and the teamlist slot allocator (paper §IV.B.2, §IV.B.4).

Teams are coherent, collective objects (unlike groups).  Each team maps
one-to-one onto an entry in the runtime's ``teams`` array — the analogue
of an MPI communicator.  Because DART teamIDs grow without bound (they
are never reused, paper §IV.B.2), the runtime keeps a bounded
``teamlist`` whose *slot index* — not the teamID itself — keys

* the ``teams`` communicator array,
* the team's collective global-memory pool, and
* the team's translation table.

The paper's allocator scans ``teamlist`` linearly for a ``-1`` slot on
team creation and resets the slot to ``-1`` on destruction.  Paper §VI
flags the linear scan as a scalability issue and suggests a linked list;
:class:`FreeListTeamList` is that beyond-paper O(1) variant (free-slot
stack + id→slot hash), benchmarked against the faithful one in
``benchmarks/teamlist_bench.py``.

Unit translation (paper §IV.B.4): collective global pointers carry
*absolute* unit ids which must be translated to *relative* ids (ranks)
within the owning team before the data plane can address the team's
memory pool.  :meth:`Team.myid` / :meth:`Team.unit_at` implement the two
directions; members are sorted so translation is a binary search.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .group import DartGroup

#: teamid of DART_TEAM_ALL.
DART_TEAM_ALL = 0

#: sentinel for an empty teamlist slot (paper uses -1).
EMPTY_SLOT = -1


class TeamListFullError(RuntimeError):
    pass


class TeamList:
    """Paper-faithful bounded slot allocator (linear scan, §IV.B.2)."""

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._slots: List[int] = [EMPTY_SLOT] * capacity

    def alloc(self, teamid: int) -> int:
        """Allocate the first empty slot for ``teamid`` (linear scan)."""
        for i in range(self.capacity):
            if self._slots[i] == EMPTY_SLOT:
                self._slots[i] = teamid
                return i
        raise TeamListFullError(
            f"teamlist exhausted ({self.capacity} live teams)")

    def lookup(self, teamid: int) -> int:
        """Find the slot index of ``teamid`` (linear scan, paper §IV.B.2)."""
        for i in range(self.capacity):
            if self._slots[i] == teamid:
                return i
        raise KeyError(f"team {teamid} not in teamlist")

    def free(self, teamid: int) -> int:
        i = self.lookup(teamid)
        self._slots[i] = EMPTY_SLOT
        return i

    def live(self) -> Tuple[int, ...]:
        return tuple(t for t in self._slots if t != EMPTY_SLOT)


class FreeListTeamList(TeamList):
    """Beyond-paper O(1) allocator (paper §VI future work).

    Keeps the identical interface and slot-reuse semantics, but replaces
    both linear scans with a free-slot stack (alloc/free) and an
    id→slot dict (lookup).  Free slots are handed out lowest-index-first
    to preserve the paper allocator's deterministic slot assignment.
    """

    def __init__(self, capacity: int = 256):
        super().__init__(capacity)
        self._free: List[int] = list(range(capacity - 1, -1, -1))  # stack, low idx on top
        self._index: Dict[int, int] = {}

    def alloc(self, teamid: int) -> int:
        if not self._free:
            raise TeamListFullError(
                f"teamlist exhausted ({self.capacity} live teams)")
        i = self._free.pop()
        self._slots[i] = teamid
        self._index[teamid] = i
        return i

    def lookup(self, teamid: int) -> int:
        try:
            return self._index[teamid]
        except KeyError:
            raise KeyError(f"team {teamid} not in teamlist") from None

    def free(self, teamid: int) -> int:
        i = self._index.pop(teamid)
        self._slots[i] = EMPTY_SLOT
        # push back keeping the stack sorted descending so that the lowest
        # free index is always allocated next (matches paper allocator).
        bisect.insort(self._free, i, key=lambda v: -v)
        return i


@dataclasses.dataclass(frozen=True)
class Team:
    """A DART team: an ordered set of units with collective identity."""

    teamid: int
    group: DartGroup
    slot: int                      # teamlist slot index (gptr.segid routing)
    parent: Optional[int] = None   # parent teamid
    #: poolid of this team's collective pool, bound at creation and
    #: mirrored in the heap's :class:`~repro_torch.core.globmem.WindowRegistry`
    #: (teamid → PoolMeta).  Slots are reused after destroy (§IV.B.2) but
    #: pool ids are not, so dereference keys off this binding — never off
    #: slot arithmetic.
    poolid: int = -1

    def size(self) -> int:
        return self.group.size()

    # -- unit translation (paper §IV.B.4) -------------------------------
    def myid(self, absolute_unit: int) -> int:
        """absolute unit id → relative id in this team (-1 if absent)."""
        m = self.group.members
        i = bisect.bisect_left(m, absolute_unit)
        if i < len(m) and m[i] == absolute_unit:
            return i
        return -1

    def unit_at(self, relative_id: int) -> int:
        """relative id in this team → absolute unit id."""
        return self.group.members[relative_id]

    def contains(self, absolute_unit: int) -> bool:
        return self.myid(absolute_unit) >= 0


@dataclasses.dataclass(frozen=True)
class TeamPartition:
    """A partition of DART_TEAM_ALL into equal-size teams.

    SPMD collectives on the data plane (one process group per team)
    require the groups to tile all devices with equal sizes.  This
    mirrors how sub-communicators are used on device meshes
    (rows/columns); arbitrary unequal teams remain fully usable on
    the host control plane and for one-sided ops (``ppermute`` accepts
    arbitrary pairs).
    """

    teams: Tuple[Team, ...]

    def __post_init__(self):
        sizes = {t.size() for t in self.teams}
        if len(sizes) != 1:
            raise ValueError("TeamPartition requires equal-size teams")
        seen = [u for t in self.teams for u in t.group.members]
        if sorted(seen) != list(range(len(seen))):
            raise ValueError("TeamPartition must tile units 0..N-1 exactly")

    @property
    def axis_index_groups(self) -> Sequence[Sequence[int]]:
        return [list(t.group.members) for t in self.teams]

    def team_of(self, absolute_unit: int) -> Team:
        for t in self.teams:
            if t.contains(absolute_unit):
                return t
        raise KeyError(absolute_unit)
