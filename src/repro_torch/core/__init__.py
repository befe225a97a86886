"""DART core on torch: the paper's PGAS runtime (DART-MPI, §III/§IV)
with its one-sided put/get path on a CUDA card.

The port so far covers initialization, teams and groups, the symmetric
heap, the queued one-sided engine with its completion handles, the
reduction plane (``dart_accumulate`` / ``dart_get_accumulate``) and the
host-plane collectives; the engine's dispatches run the hand-written
Hopper segmented-copy and read-modify-write kernels of
:mod:`repro_torch.kernels`.
"""

from .faults import (DartError, FaultPlane, FaultSpec, FlushTimeoutError,
                     RetriesExhaustedError, ShmBoundsError,
                     TransientDispatchFault, UnitFailedError)
from .gptr import (ADDR_MAX, DART_GPTR_NULL, FLAG_COLLECTIVE, FLAG_SHM,
                   NON_COLLECTIVE_SEG, GlobalPtr)
from .group import (DartGroup, dart_group_addmember, dart_group_copy,
                    dart_group_delmember, dart_group_init,
                    dart_group_intersect, dart_group_split,
                    dart_group_union, group_from_units)
from .team import (DART_TEAM_ALL, EMPTY_SLOT, FreeListTeamList, Team,
                   TeamList, TeamListFullError, TeamPartition)
from .globmem import (ALIGNMENT, BlockAllocator, HeapState,
                      OutOfGlobalMemory, PoolMeta, SymmetricHeap,
                      TranslationRecord, TranslationTable,
                      WindowDestroyedError, WindowRegistry, align_up,
                      from_bytes, heap_state_from_numpy,
                      heap_state_to_numpy, nbytes_of, to_bytes)
from .onesided import (WORLD_POOLID, CommEngine, GetHandle, Handle,
                       dart_test, dart_testall, dart_wait, dart_waitall,
                       deref)
from .atomics import AtomicsProvider, Cell, ThreadedAtomics
from .lock import FREE, DartLock, LockService
from .runtime import (DartConfig, DartContext, dart_accumulate,
                      dart_accumulate_blocking, dart_allreduce,
                      dart_barrier, dart_bcast, dart_exit, dart_flush,
                      dart_gather, dart_gather_typed, dart_get,
                      dart_get_accumulate, dart_get_blocking, dart_get_nb,
                      dart_init, dart_memalloc, dart_memfree, dart_put,
                      dart_put_blocking, dart_reduce, dart_scatter,
                      dart_scatter_typed, dart_team_create,
                      dart_team_destroy, dart_team_get_group,
                      dart_team_memalloc_aligned, dart_team_memfree,
                      dart_team_myid, dart_team_size, dart_team_split)

__all__ = [
    # typed error ladder (+ the injector, attached in a later slice)
    "DartError", "FaultPlane", "FaultSpec", "FlushTimeoutError",
    "RetriesExhaustedError", "ShmBoundsError", "TransientDispatchFault",
    "UnitFailedError",
    # global pointers
    "ADDR_MAX", "DART_GPTR_NULL", "FLAG_COLLECTIVE", "FLAG_SHM",
    "NON_COLLECTIVE_SEG", "GlobalPtr",
    # groups
    "DartGroup", "dart_group_addmember", "dart_group_copy",
    "dart_group_delmember", "dart_group_init", "dart_group_intersect",
    "dart_group_split", "dart_group_union", "group_from_units",
    # teams
    "DART_TEAM_ALL", "EMPTY_SLOT", "FreeListTeamList", "Team", "TeamList",
    "TeamListFullError", "TeamPartition",
    # global memory
    "ALIGNMENT", "BlockAllocator", "HeapState", "OutOfGlobalMemory",
    "PoolMeta", "SymmetricHeap", "TranslationRecord", "TranslationTable",
    "WindowDestroyedError", "WindowRegistry", "align_up", "from_bytes",
    "heap_state_from_numpy", "heap_state_to_numpy", "nbytes_of",
    "to_bytes",
    # one-sided engine + handles
    "WORLD_POOLID", "CommEngine", "GetHandle", "Handle", "dart_test",
    "dart_testall", "dart_wait", "dart_waitall", "deref",
    # atomics + locks
    "AtomicsProvider", "Cell", "ThreadedAtomics", "FREE", "DartLock",
    "LockService",
    # runtime
    "DartConfig", "DartContext", "dart_accumulate",
    "dart_accumulate_blocking", "dart_allreduce", "dart_barrier",
    "dart_bcast", "dart_exit", "dart_flush", "dart_gather",
    "dart_gather_typed", "dart_get", "dart_get_accumulate",
    "dart_get_blocking", "dart_get_nb", "dart_init", "dart_memalloc",
    "dart_memfree", "dart_put", "dart_put_blocking", "dart_reduce",
    "dart_scatter", "dart_scatter_typed", "dart_team_create",
    "dart_team_destroy", "dart_team_get_group",
    "dart_team_memalloc_aligned", "dart_team_memfree", "dart_team_myid",
    "dart_team_size", "dart_team_split",
]
