"""DART global pointers (paper §III, §IV.B.4).

A DART global pointer is 128 bits wide:

    | unitid : 32 | segid : 16 | flags : 16 | addr : 64 |

* ``unitid`` — absolute unit id (position in DART_TEAM_ALL).
* ``segid``  — segment id.  For collective allocations this is the
  *teamlist slot index* of the owning team (paper §IV.B.2/3); for
  non-collective allocations it is ``NON_COLLECTIVE_SEG`` (0), i.e. the
  single pre-reserved WORLD window.
* ``flags``  — bit 0 marks a collective allocation; remaining bits are
  reserved (the paper reserves them too).
* ``addr``   — byte offset relative to the *base of the segment's memory
  pool* (paper: "relative to the base address of the memory region
  reserved for this team rather than the beginning of the sub-memory
  spanned by certain DART collective allocation").
"""

from __future__ import annotations

import dataclasses

import numpy as np

UNIT_BITS = 32
SEG_BITS = 16
FLAG_BITS = 16
ADDR_BITS = 64

UNIT_MAX = (1 << UNIT_BITS) - 1
SEG_MAX = (1 << SEG_BITS) - 1
FLAG_MAX = (1 << FLAG_BITS) - 1
ADDR_MAX = (1 << ADDR_BITS) - 1

#: segment id of the pre-reserved non-collective (WORLD) pool.
NON_COLLECTIVE_SEG = 0

#: flags bit 0: pointer refers to a collective (team-pool) allocation.
FLAG_COLLECTIVE = 1 << 0
#: flags bit 1: pointer was produced by the (beyond-paper) shared-memory
#: window path (§VI future work); informational only.
FLAG_SHM = 1 << 1


@dataclasses.dataclass(frozen=True, order=True)
class GlobalPtr:
    """An immutable 128-bit DART global pointer."""

    unitid: int
    segid: int
    flags: int
    addr: int

    def __post_init__(self):
        if not (0 <= self.unitid <= UNIT_MAX):
            raise ValueError(f"unitid {self.unitid} out of 32-bit range")
        if not (0 <= self.segid <= SEG_MAX):
            raise ValueError(f"segid {self.segid} out of 16-bit range")
        if not (0 <= self.flags <= FLAG_MAX):
            raise ValueError(f"flags {self.flags:#x} out of 16-bit range")
        if not (0 <= self.addr <= ADDR_MAX):
            raise ValueError(f"addr {self.addr} out of 64-bit range")

    # -- packing ---------------------------------------------------------
    def pack(self) -> int:
        """Pack into a single 128-bit integer."""
        return (
            (self.unitid << (SEG_BITS + FLAG_BITS + ADDR_BITS))
            | (self.segid << (FLAG_BITS + ADDR_BITS))
            | (self.flags << ADDR_BITS)
            | self.addr
        )

    @classmethod
    def unpack(cls, packed: int) -> "GlobalPtr":
        if not (0 <= packed < (1 << 128)):
            raise ValueError("packed global pointer out of 128-bit range")
        addr = packed & ADDR_MAX
        flags = (packed >> ADDR_BITS) & FLAG_MAX
        segid = (packed >> (FLAG_BITS + ADDR_BITS)) & SEG_MAX
        unitid = (packed >> (SEG_BITS + FLAG_BITS + ADDR_BITS)) & UNIT_MAX
        return cls(unitid=unitid, segid=segid, flags=flags, addr=addr)

    def to_words(self) -> np.ndarray:
        """Four little-endian uint32 words (device-transportable form)."""
        p = self.pack()
        return np.array(
            [(p >> (32 * i)) & 0xFFFFFFFF for i in range(4)], dtype=np.uint32
        )

    @classmethod
    def from_words(cls, words) -> "GlobalPtr":
        words = np.asarray(words, dtype=np.uint64)
        if words.shape != (4,):
            raise ValueError("expected 4 uint32 words")
        p = 0
        for i in range(4):
            p |= int(words[i]) << (32 * i)
        return cls.unpack(p)

    # -- queries ---------------------------------------------------------
    @property
    def is_collective(self) -> bool:
        return bool(self.flags & FLAG_COLLECTIVE)

    @property
    def is_shm(self) -> bool:
        """Minted by the shared-memory window path (§VI): eligible for
        the zero-copy locality fast path when the arena is host-visible."""
        return bool(self.flags & FLAG_SHM)

    @property
    def is_null(self) -> bool:
        return self == DART_GPTR_NULL

    # -- arithmetic ------------------------------------------------------
    def incaddr(self, nbytes: int) -> "GlobalPtr":
        """``dart_gptr_incaddr``: advance the offset by ``nbytes``.

        ``nbytes`` may be negative; the result must stay inside
        [0, ADDR_MAX] or a :class:`ValueError` is raised.
        """
        new = self.addr + nbytes
        if not (0 <= new <= ADDR_MAX):
            raise ValueError("global pointer arithmetic out of range "
                             f"(addr {self.addr} {nbytes:+d})")
        return dataclasses.replace(self, addr=new)

    def decaddr(self, nbytes: int) -> "GlobalPtr":
        """``dart_gptr_decaddr``: move the offset back by ``nbytes``
        (the negative-direction twin of :meth:`incaddr`)."""
        return self.incaddr(-nbytes)

    def addrdiff(self, other: "GlobalPtr") -> int:
        """Signed byte distance ``self.addr - other.addr``.

        Only meaningful for pointers into the same segment: both must
        share ``segid`` and collectivity, and non-collective pointers
        must also share ``unitid`` (their offsets are displacements into
        per-unit WORLD partitions, not a common pool).  Collective
        pointers may target different units — the allocation is aligned
        & symmetric, so offsets are unit-independent (paper §III).
        """
        if self.segid != other.segid:
            raise ValueError(
                f"pointer distance across segments ({self.segid} vs "
                f"{other.segid}) is undefined")
        if self.is_collective != other.is_collective:
            raise ValueError("pointer distance between collective and "
                             "non-collective pointers is undefined")
        if not self.is_collective and self.unitid != other.unitid:
            raise ValueError(
                "non-collective pointer distance requires the same unit "
                f"(got {self.unitid} vs {other.unitid})")
        return self.addr - other.addr

    def setunit(self, unitid: int) -> "GlobalPtr":
        """``dart_gptr_setunit``: retarget at another unit's portion.

        Valid for *aligned & symmetric* collective allocations — the same
        offset refers to the same datum on every member (paper §III).
        """
        return dataclasses.replace(self, unitid=unitid)

    def __add__(self, nbytes: int) -> "GlobalPtr":
        return self.incaddr(nbytes)

    def __sub__(self, other):
        """``gptr - int`` → :meth:`decaddr`; ``gptr - gptr`` →
        :meth:`addrdiff` (signed byte distance)."""
        if isinstance(other, GlobalPtr):
            return self.addrdiff(other)
        return self.decaddr(other)


#: the DART null pointer.
DART_GPTR_NULL = GlobalPtr(unitid=0, segid=0, flags=0, addr=0)
