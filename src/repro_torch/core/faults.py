"""Fault plane: the typed DART error ladder + a seedable fault injector.

DART's completion ladder (paper §III) and team/window machinery (§IV)
define *where* a one-sided op can fail — translation, enqueue,
dispatch, drain — but say nothing about what the runtime should do
when one does.  Zhou & Gracia's asynchronous-progress design
(arXiv:1609.08574) makes the progress entity exactly the component
that must survive and report partner failure; DASH (arXiv:1610.01482)
gives containers typed error contracts.  This module supplies both
halves for the reproduction:

* **the error taxonomy** — every runtime failure is a
  :class:`DartError` (itself a ``RuntimeError``, so pre-existing
  ``except RuntimeError`` / ``pytest.raises(RuntimeError)`` call sites
  keep working).  Subtypes name the failure domain:
  :class:`UnitFailedError` (the target unit is dead),
  :class:`FlushTimeoutError` (the per-flush deadline expired while
  retrying), :class:`RetriesExhaustedError` (the retry budget ran
  out), and :class:`TransientDispatchFault` (an *injected* transient —
  the only fault kind the engine's retry loop is allowed to absorb).
  The pre-existing ``WindowDestroyedError`` / ``OutOfGlobalMemory``
  (``repro_torch.core.globmem``) are re-parented onto :class:`DartError`.
  Errors carry structured context (``poolid``/``row``/``unit``/
  ``teamid``) so handlers can route on the lane, not on message text.

* **the injector** — :class:`FaultPlane`, a seedable, deterministic
  schedule of :class:`FaultSpec` entries hooked at the CommEngine
  dispatch boundary (``dispatch_gate``), the enqueue path
  (``poll_enqueue``: lane poisoning, unit death at op N), and the
  progress plane's drain loop (``drain_gate``).  Determinism is the
  point: a chaos test replays the *same* fault schedule against the
  fault-free oracle and asserts surviving lanes are byte-identical.

This module is stdlib-only (no torch) so both ``globmem`` and
``onesided`` can import the ladder without cycles.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "DartError", "UnitFailedError", "FlushTimeoutError",
    "RetriesExhaustedError", "ShmBoundsError", "TransientDispatchFault",
    "FaultSpec", "FaultPlane",
]


# --------------------------------------------------------------------------
# Typed error ladder
# --------------------------------------------------------------------------


class DartError(RuntimeError):
    """Base of the typed DART failure ladder.

    A ``RuntimeError`` subclass on purpose: the runtime raised bare
    ``RuntimeError`` before the ladder existed, so every established
    ``except RuntimeError`` handler (and test) stays correct.
    Instances carry structured context on attributes — ``None`` when
    the domain does not apply.
    """

    poolid: Optional[int] = None
    row: Optional[int] = None
    unit: Optional[int] = None
    teamid: Optional[int] = None


class UnitFailedError(DartError):
    """The op's target unit has been declared dead (heartbeat sweep or
    injected death).  Raised at enqueue (fail-fast on a dead unit's
    lanes) and by handles whose queued ops were doomed by the death."""


class FlushTimeoutError(DartError):
    """The per-flush deadline expired while a run was still retrying
    transient dispatch faults; the run's handles fail with this."""


class RetriesExhaustedError(DartError):
    """A run kept faulting past the engine's retry budget."""


class ShmBoundsError(DartError, ValueError):
    """A shared-memory window access (``dart_shm_view`` / shm-plane
    read) whose byte span overruns the unit's pool partition.

    Previously the view sliced ``host[row, off:off+n]`` unchecked: the
    overrun silently truncated and surfaced as a bare numpy reshape
    ``ValueError``.  Also a ``ValueError`` so pre-existing handlers of
    that symptom keep catching the (now typed, lane-addressed) error.
    Carries ``poolid``/``row``/``off``/``nbytes``.
    """

    off: Optional[int] = None
    nbytes: Optional[int] = None


class TransientDispatchFault(DartError):
    """An injected transient failure of one dispatch attempt.

    ``issued`` reports whether the attempt's kernel ran before the
    fault struck (a *post*-dispatch fault): puts/gets are idempotent
    and retry either way, but accumulate runs may retry **only** when
    ``issued`` is False — the at-most-once rule (re-issuing an RMW
    whose first attempt may have applied would double-apply it).
    """

    def __init__(self, message: str, *, issued: bool = False):
        super().__init__(message)
        self.issued = issued


# --------------------------------------------------------------------------
# Fault specs + the injector
# --------------------------------------------------------------------------

#: spec kinds gated at the dispatch boundary
_DISPATCH_KINDS = ("fail", "drop", "delay")
#: spec kinds polled at enqueue
_ENQUEUE_KINDS = ("poison", "unit_dead")
#: spec kinds gated in the progress plane's drain loop
_DRAIN_KINDS = ("skip_drain",)


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault.

    ``kind``:

    * ``'fail'`` — raise :class:`TransientDispatchFault` at the
      dispatch gate; ``issued=True`` strikes *after* the kernel ran.
    * ``'drop'`` — alias of a never-issued ``'fail'`` (the dispatch is
      dropped before any kernel runs).
    * ``'delay'`` — sleep ``delay_s`` at the pre-dispatch gate.
    * ``'poison'`` — mark the matching ``(pool, row)`` lane failed at
      enqueue; subsequent enqueues fail fast until the lane is cleared.
    * ``'unit_dead'`` — declare the matching op's target unit dead at
      enqueue (the "unit dies at op N" schedule; ``after=N-1``).
    * ``'skip_drain'`` — suppress the progress plane's background
      drain of the matching lane (foreground flushes are unaffected).

    ``poolid``/``row``/``unit`` are match filters (``None`` = any);
    ``op_kind`` filters dispatch gates by run kind (``put``/``get``/
    ``acc``/``gacc``).  The spec skips its first ``after`` matching
    events, then fires ``times`` times (``times <= 0`` = unlimited).
    ``seen``/``fired`` are runtime counters.
    """

    kind: str
    poolid: Optional[int] = None
    row: Optional[int] = None
    unit: Optional[int] = None
    op_kind: Optional[str] = None
    after: int = 0
    times: int = 1
    delay_s: float = 0.0
    issued: bool = False
    seen: int = 0
    fired: int = 0

    def __post_init__(self):
        known = _DISPATCH_KINDS + _ENQUEUE_KINDS + _DRAIN_KINDS
        if self.kind not in known:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (one of {known})")

    def _matches(self, poolid: Optional[int], row: Optional[int],
                 unit: Optional[int] = None,
                 op_kind: Optional[str] = None) -> bool:
        return ((self.poolid is None or self.poolid == poolid)
                and (self.row is None or self.row == row)
                and (self.unit is None or unit is None
                     or self.unit == unit)
                and (self.op_kind is None or op_kind is None
                     or self.op_kind == op_kind))

    def _due(self) -> bool:
        """Bump ``seen`` for a matching event; True when this firing
        is inside the ``(after, after + times]`` window."""
        self.seen += 1
        if self.seen <= self.after:
            return False
        if self.times > 0 and self.fired >= self.times:
            return False
        self.fired += 1
        return True


class FaultPlane:
    """Seedable deterministic fault injector for one CommEngine.

    Two sources of faults compose:

    * **scheduled** — :meth:`schedule` registers :class:`FaultSpec`
      entries that fire at exact event counts (fully deterministic,
      the chaos harness's tool of choice);
    * **rates** — ``fail_rate``/``post_fail_rate``/``delay_rate``
      draw from a ``random.Random(seed)`` stream per pre/post gate,
      deterministic given the seed and the call sequence.

    Thread-safe: the engine's dispatch path, N enqueueing threads, and
    the progress-plane daemon may all hit the gates concurrently.  The
    plane never calls back into the engine, so its lock nests freely
    inside ``engine.lock``.
    """

    def __init__(self, seed: int = 0, *, fail_rate: float = 0.0,
                 post_fail_rate: float = 0.0, delay_rate: float = 0.0,
                 delay_s: float = 0.0):
        for name, rate in (("fail_rate", fail_rate),
                           ("post_fail_rate", post_fail_rate),
                           ("delay_rate", delay_rate)):
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {rate}")
        self.seed = int(seed)
        self.rng = random.Random(seed)
        self.fail_rate = float(fail_rate)
        self.post_fail_rate = float(post_fail_rate)
        self.delay_rate = float(delay_rate)
        self.delay_s = float(delay_s)
        self.specs: List[FaultSpec] = []
        self._lock = threading.Lock()
        self.counters: Dict[str, int] = {
            "gates_pre": 0, "gates_post": 0, "enqueue_polls": 0,
            "injected_fails": 0, "injected_drops": 0,
            "injected_delays": 0, "poisons": 0, "unit_deaths": 0,
            "drains_skipped": 0,
        }

    def schedule(self, spec: Optional[FaultSpec] = None, /,
                 **kw) -> FaultSpec:
        """Register a spec (or build one from keyword fields)."""
        if spec is None:
            spec = FaultSpec(**kw)
        elif kw:
            raise TypeError("pass a FaultSpec or fields, not both")
        with self._lock:
            self.specs.append(spec)
        return spec

    # -- engine dispatch boundary ---------------------------------------

    def dispatch_gate(self, op_kind: str, poolid: int, row: int,
                      phase: str) -> None:
        """Called by the engine around every dispatch attempt
        (``phase`` ``'pre'`` before the kernel, ``'post'`` after).
        Sleeps for delay faults; raises
        :class:`TransientDispatchFault` for fail/drop faults."""
        sleep_s = 0.0
        fault: Optional[str] = None
        with self._lock:
            self.counters["gates_pre" if phase == "pre"
                          else "gates_post"] += 1
            for spec in self.specs:
                if spec.kind not in _DISPATCH_KINDS:
                    continue
                fires_post = spec.kind == "fail" and spec.issued
                if (phase == "post") != fires_post:
                    continue
                if not spec._matches(poolid, row, op_kind=op_kind):
                    continue
                if not spec._due():
                    continue
                if spec.kind == "delay":
                    sleep_s = max(sleep_s, spec.delay_s)
                    self.counters["injected_delays"] += 1
                else:
                    self.counters["injected_drops" if spec.kind == "drop"
                                  else "injected_fails"] += 1
                    fault = spec.kind
                    break
            if fault is None:
                # rate-driven faults: one deterministic draw per gate
                r = self.rng.random()
                if phase == "pre":
                    if self.fail_rate and r < self.fail_rate:
                        self.counters["injected_fails"] += 1
                        fault = "fail"
                    elif self.delay_rate and r < (self.fail_rate
                                                  + self.delay_rate):
                        self.counters["injected_delays"] += 1
                        sleep_s = self.delay_s
                elif self.post_fail_rate and r < self.post_fail_rate:
                    self.counters["injected_fails"] += 1
                    fault = "fail"
        if sleep_s > 0.0:
            time.sleep(sleep_s)
        if fault is not None:
            raise TransientDispatchFault(
                f"injected {fault} of {op_kind} dispatch on lane "
                f"(pool {poolid}, row {row}) [{phase}]",
                issued=phase == "post")

    # -- engine enqueue boundary ----------------------------------------

    def poll_enqueue(self, poolid: int, row: int,
                     unit: int) -> List[FaultSpec]:
        """Called by the engine on every enqueue; returns the poison/
        unit-death specs that fire on this op (the engine applies
        them: lane marked failed, unit marked dead)."""
        with self._lock:
            self.counters["enqueue_polls"] += 1
            out = []
            for spec in self.specs:
                if spec.kind not in _ENQUEUE_KINDS:
                    continue
                if not spec._matches(poolid, row, unit=unit):
                    continue
                if not spec._due():
                    continue
                self.counters["poisons" if spec.kind == "poison"
                              else "unit_deaths"] += 1
                out.append(spec)
            return out

    # -- progress-plane drain boundary ----------------------------------

    def drain_gate(self, poolid: int, row: int) -> bool:
        """Called by the progress plane before draining a lane; False
        suppresses this background drain (foreground flushes never
        consult this gate)."""
        with self._lock:
            for spec in self.specs:
                if spec.kind not in _DRAIN_KINDS:
                    continue
                if not spec._matches(poolid, row):
                    continue
                if not spec._due():
                    continue
                self.counters["drains_skipped"] += 1
                return False
        return True

    # -- observability ---------------------------------------------------

    def stats(self) -> Dict[str, int]:
        with self._lock:
            s = dict(self.counters)
            s["seed"] = self.seed
            s["n_specs"] = len(self.specs)
            s["specs_fired"] = sum(sp.fired for sp in self.specs)
            return s

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"FaultPlane(seed={self.seed}, specs={len(self.specs)}, "
                f"fail_rate={self.fail_rate})")
