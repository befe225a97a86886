"""Atomic one-sided memory operations (paper §IV.B.6).

The MCS lock requires ``fetch_and_op`` (here: fetch-and-store /
fetch-and-add) and ``compare_and_swap`` with MPI-3 RMA atomicity, plus a
zero-byte notification channel (the paper blocks in ``MPI_Recv`` and the
releaser sends a zero-size message).

Where this lives: the *data plane* inside a step is SPMD and
dataflow-ordered, so locks are unnecessary there by construction
(DESIGN.md §2, assumption change 1).  Real concurrency is on the
**host control plane**: checkpoint writer threads,
serving request handlers, and the elastic coordinator.  The providers
below give that plane MPI-3-equivalent atomics:

* :class:`ThreadedAtomics` — in-process provider; every cell op holds a
  per-provider mutex (the atomicity guarantee), and the notification
  channel is a per-unit ``queue.Queue`` (blocking ``recv`` ≙
  ``MPI_Recv`` of a zero-size message).

* The heap-backed provider (atomics on arena bytes) comes with the
  atomics slice of the port.

Cell placement is tracked so the (beyond-paper §VI) balanced-tail
placement can be measured: every cell knows its home unit and the
provider counts per-home accesses (the "communication congestion on
unit 0" the paper flags).
"""

from __future__ import annotations

import abc
import dataclasses
import queue
import threading
from collections import defaultdict
from typing import Callable, Dict, Hashable, Tuple


@dataclasses.dataclass(frozen=True)
class Cell:
    """A globally addressable atomic integer cell."""
    name: Hashable
    home_unit: int


class AtomicsProvider(abc.ABC):
    """MPI-3-RMA-equivalent atomic ops on integer cells."""

    @abc.abstractmethod
    def make_cell(self, name: Hashable, home_unit: int, init: int) -> Cell: ...

    @abc.abstractmethod
    def fetch_and_store(self, cell: Cell, value: int) -> int: ...

    @abc.abstractmethod
    def fetch_and_add(self, cell: Cell, value: int) -> int: ...

    @abc.abstractmethod
    def compare_and_swap(self, cell: Cell, expected: int,
                         desired: int) -> int:
        """Returns the *old* value (swap happened iff old == expected)."""

    @abc.abstractmethod
    def load(self, cell: Cell) -> int: ...

    @abc.abstractmethod
    def store(self, cell: Cell, value: int) -> None: ...

    def free_cell(self, cell: Cell) -> None:
        """Release a cell's backing storage (LockService.destroy_lock).
        Default no-op for providers without reclaimable cells."""

    # zero-byte notification channel (MPI_Send/Recv of size 0, §IV.B.6)
    @abc.abstractmethod
    def notify(self, unit: int, tag: Hashable) -> None: ...

    @abc.abstractmethod
    def wait_notify(self, unit: int, tag: Hashable,
                    timeout: float = None) -> None: ...


class ThreadedAtomics(AtomicsProvider):
    """In-process provider: units are threads (the test/control plane)."""

    def __init__(self, n_units: int):
        self.n_units = n_units
        self._mutex = threading.Lock()
        self._cells: Dict[Hashable, int] = {}
        self._inbox: Dict[Tuple[int, Hashable], queue.Queue] = defaultdict(
            queue.Queue)
        #: per-home-unit atomic-op counter (congestion accounting, §VI)
        self.home_traffic: Dict[int, int] = defaultdict(int)

    def make_cell(self, name, home_unit, init) -> Cell:
        with self._mutex:
            if name in self._cells:
                raise ValueError(f"cell {name!r} already exists")
            self._cells[name] = init
        return Cell(name=name, home_unit=home_unit)

    def free_cell(self, cell: Cell) -> None:
        with self._mutex:
            self._cells.pop(cell.name, None)

    def _rmw(self, cell: Cell, fn: Callable[[int], int]) -> int:
        with self._mutex:
            old = self._cells[cell.name]
            self._cells[cell.name] = fn(old)
            self.home_traffic[cell.home_unit] += 1
            return old

    def fetch_and_store(self, cell, value):
        return self._rmw(cell, lambda old: value)

    def fetch_and_add(self, cell, value):
        return self._rmw(cell, lambda old: old + value)

    def compare_and_swap(self, cell, expected, desired):
        with self._mutex:
            old = self._cells[cell.name]
            if old == expected:
                self._cells[cell.name] = desired
            self.home_traffic[cell.home_unit] += 1
            return old

    def load(self, cell):
        with self._mutex:
            self.home_traffic[cell.home_unit] += 1
            return self._cells[cell.name]

    def store(self, cell, value):
        with self._mutex:
            self._cells[cell.name] = value
            self.home_traffic[cell.home_unit] += 1

    def notify(self, unit, tag):
        self._inbox[(unit, tag)].put(None)

    def wait_notify(self, unit, tag, timeout=None):
        self._inbox[(unit, tag)].get(timeout=timeout)
