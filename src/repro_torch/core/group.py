"""DART groups (paper §III, §IV.B.1).

A DART group is an *ordered* set of absolute unit ids, maintained in
ascending order at all times.  This is the semantic gap the paper closes
against MPI: ``MPI_Group_incl`` orders by position in ``ranks`` and
``MPI_Group_union`` merely appends, so MPI groups are "arranged in a
random fashion" (paper Fig. 3).  DART therefore implements

* ``dart_group_union`` as an explicit **merge-sort** of the two sorted
  member lists, and
* ``dart_group_addmember(g, u)`` as ``incl(WORLD, 1, [u])`` followed by a
  union — exactly the construction of paper §IV.B.1.

Groups are *local* objects (no collective operations — paper §III), so
this module is pure host-side metadata, just as MPI groups are.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Tuple


@dataclasses.dataclass(frozen=True)
class DartGroup:
    """Ordered set of absolute unit ids (always sorted ascending)."""

    members: Tuple[int, ...] = ()

    def __post_init__(self):
        m = self.members
        if any(u < 0 for u in m):
            raise ValueError("unit ids must be non-negative")
        if any(m[i] >= m[i + 1] for i in range(len(m) - 1)):
            raise ValueError("DART group invariant violated: members must be "
                             "strictly ascending (sorted, no duplicates)")

    def size(self) -> int:
        return len(self.members)

    def ismember(self, unitid: int) -> bool:
        lo, hi = 0, len(self.members)
        while lo < hi:                      # binary search — members sorted
            mid = (lo + hi) // 2
            if self.members[mid] < unitid:
                lo = mid + 1
            else:
                hi = mid
        return lo < len(self.members) and self.members[lo] == unitid


def dart_group_init() -> DartGroup:
    """Create an empty group."""
    return DartGroup(())


def dart_group_union(g1: DartGroup, g2: DartGroup) -> DartGroup:
    """Merge-sort union of two groups (paper §IV.B.1).

    Implemented as an explicit two-finger merge (not ``sorted(set(..))``)
    to mirror the paper's mechanism; deduplicates on the fly.
    """
    a, b = g1.members, g2.members
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        if a[i] < b[j]:
            nxt = a[i]; i += 1
        elif b[j] < a[i]:
            nxt = b[j]; j += 1
        else:
            nxt = a[i]; i += 1; j += 1
        if not out or out[-1] != nxt:
            out.append(nxt)
    for rest, k in ((a, i), (b, j)):
        while k < len(rest):
            if not out or out[-1] != rest[k]:
                out.append(rest[k])
            k += 1
    return DartGroup(tuple(out))


def dart_group_addmember(g: DartGroup, unitid: int) -> DartGroup:
    """Add one absolute unit id (paper §IV.B.1).

    Faithful construction: build the singleton group (the analogue of
    ``MPI_Group_incl(MPI_COMM_WORLD, 1, [unitid])``) and merge-sort it
    into ``g`` via :func:`dart_group_union`, so the result stays ordered
    regardless of insertion order.
    """
    singleton = DartGroup((unitid,))
    return dart_group_union(g, singleton)


def dart_group_delmember(g: DartGroup, unitid: int) -> DartGroup:
    return DartGroup(tuple(u for u in g.members if u != unitid))


def dart_group_intersect(g1: DartGroup, g2: DartGroup) -> DartGroup:
    a, b = g1.members, g2.members
    i = j = 0
    out = []
    while i < len(a) and j < len(b):
        if a[i] < b[j]:
            i += 1
        elif b[j] < a[i]:
            j += 1
        else:
            out.append(a[i]); i += 1; j += 1
    return DartGroup(tuple(out))


def dart_group_split(g: DartGroup, n: int) -> Tuple[DartGroup, ...]:
    """Split into ``n`` contiguous, balanced sub-groups (DART spec)."""
    if n <= 0:
        raise ValueError("n must be positive")
    m = g.members
    base, extra = divmod(len(m), n)
    out, start = [], 0
    for k in range(n):
        take = base + (1 if k < extra else 0)
        out.append(DartGroup(m[start:start + take]))
        start += take
    return tuple(out)


def dart_group_copy(g: DartGroup) -> DartGroup:
    return DartGroup(g.members)


def group_from_units(units: Iterable[int]) -> DartGroup:
    """Convenience: build a group by repeated addmember (paper path)."""
    g = dart_group_init()
    for u in units:
        g = dart_group_addmember(g, u)
    return g
