"""Fault-injection harness + failure taxonomy (docs/PERF.md §D9).

The self-healing layer needs failures it can rehearse: a
``FaultInjector`` carries a deterministic script of ``FaultSpec``s keyed
by the scheduler's tick counter, and the execution backends consult it
at their hook points (launch, rebind, drain). With no active spec every
hook is a cheap no-op — the fault-free hot path is untouched, which is
what keeps the §Perf guards honest.

Fault kinds:
  - KILL: the named engine tiles die at ``tick``. Every later launch or
    drain whose collective includes them raises ``EngineFault`` — the
    scheduler quarantines the engines (``FleetLayout.quarantine``) and
    recovers their requests onto surviving islands.
  - STALL: the named engines run ``factor``x slow for ``duration``
    ticks. The backend's reported step durations inflate; the
    scheduler's soft step deadline (roofline expectation x
    ``watchdog_slack``) trips after ``health_misses`` consecutive
    overruns and quarantines the island.
  - REBIND_FAIL: the next rebind inside the active window raises
    ``TransitionFault`` before any state moves — the transition
    watchdog rolls the scheduler back to the prior layout, un-pausing
    everything the attempt paused.
  - DRAIN_CORRUPT: the drain of an island overlapping the named engines
    loses its un-harvested tokens (real engine) / fails the rebind's
    safe-point drain (simulation: ``TransitionFault`` naming the
    engines, so the watchdog both rolls back and quarantines).
  - POOL_EXHAUST: seize ``blocks`` free KV blocks (-1 = all) from the
    named engines' pools for ``duration`` ticks — a scripted memory
    burst that must complete via the preempt-to-recompute backpressure
    path, never a crash.

The injector is shared: backends hold it (``SimBackend(injector=...)``,
``FlyingEngine(injector=...)``) and the scheduler adopts it from the
backend (like the adaptors), advances the tick, and applies the
POOL_EXHAUST seizures itself (they live in host allocator state).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional, Sequence, Tuple

KILL = "kill"
STALL = "stall"
REBIND_FAIL = "rebind_fail"
DRAIN_CORRUPT = "drain_corrupt"
POOL_EXHAUST = "pool_exhaust"

FAULT_KINDS = (KILL, STALL, REBIND_FAIL, DRAIN_CORRUPT, POOL_EXHAUST)


class EngineFault(RuntimeError):
    """A launch (or drain) lost engines: the step's output never
    materializes. Carries the dead engine tiles so the scheduler can
    quarantine exactly them."""

    def __init__(self, engines: Iterable[int], msg: str = ""):
        self.engines = frozenset(engines)
        super().__init__(
            msg or f"engines {sorted(self.engines)} failed mid-step")


class TransitionFault(RuntimeError):
    """A rebind failed before (or while) reaching the new layout. The
    transition watchdog rolls back to the prior layout; when the fault
    names engines (a corrupted safe-point drain), they are quarantined
    too."""

    def __init__(self, msg: str = "", engines: Iterable[int] = ()):
        self.engines = frozenset(engines)
        super().__init__(msg or "rebind failed")


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault. ``tick`` is the scheduler step index at which
    it arms; KILL is permanent from then on, the windowed kinds stay
    active for ``duration`` ticks, and the one-shot kinds (REBIND_FAIL,
    DRAIN_CORRUPT) fire at most once inside their window."""
    kind: str
    tick: int
    engines: Tuple[int, ...] = ()
    factor: float = 8.0      # STALL: duration multiplier
    blocks: int = -1         # POOL_EXHAUST: blocks to seize (-1 = all free)
    duration: int = 1        # STALL/POOL_EXHAUST/windowed one-shots

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")


class FaultInjector:
    """Deterministic scripted fault schedule, consulted by backend hooks.

    The scheduler owns the clock (``advance`` once per tick); every
    query is answered against that tick, so identical scripts produce
    identical failure runs — the chaos tests' token-identity assertions
    ride on this determinism. ``fired`` is the audit log of
    (tick, spec) pairs that actually took effect.
    """

    def __init__(self, specs: Sequence[FaultSpec] = ()):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.tick = -1
        self._spent: set = set()       # one-shot spec indices consumed
        self.fired: List[Tuple[int, FaultSpec]] = []

    def advance(self, tick: int) -> None:
        self.tick = tick

    # ------------------------------------------------------------------
    def _active(self, kind: str) -> Iterator[Tuple[int, FaultSpec]]:
        for i, s in enumerate(self.specs):
            if s.kind != kind or i in self._spent:
                continue
            if kind == KILL:
                if s.tick <= self.tick:
                    yield i, s
            elif s.tick <= self.tick < s.tick + s.duration:
                yield i, s

    def _note(self, i: int, s: FaultSpec, spend: bool = False) -> None:
        if spend:
            self._spent.add(i)
        self.fired.append((self.tick, s))

    # -- backend hooks --------------------------------------------------
    def dead_engines(self) -> frozenset:
        """Engines killed at or before the current tick (permanent)."""
        return frozenset(e for _, s in self._active(KILL) for e in s.engines)

    def stall_factor(self, engines: Iterable[int]) -> float:
        """Duration multiplier for a launch over ``engines`` (a stalled
        member slows its whole collective)."""
        f = 1.0
        es = set(engines)
        for i, s in self._active(STALL):
            if not s.engines or es & set(s.engines):
                f *= s.factor
                self._note(i, s)
        return f

    def check_launch(self, engines: Iterable[int]) -> float:
        """Called by backends at every step launch: raises
        ``EngineFault`` when a dead engine participates, else returns
        the stall factor to apply to the step duration."""
        es = set(engines)
        dead = self.dead_engines() & es
        if dead:
            for i, s in self._active(KILL):
                if set(s.engines) & es:
                    self._note(i, s)
            raise EngineFault(dead)
        return self.stall_factor(es)

    def take_rebind_fault(self) -> Optional[FaultSpec]:
        """One-shot: the next rebind inside an active REBIND_FAIL window
        fails."""
        for i, s in self._active(REBIND_FAIL):
            self._note(i, s, spend=True)
            return s
        return None

    def take_drain_corrupt(self,
                           engines: Iterable[int]) -> Optional[FaultSpec]:
        """One-shot: a drain touching ``engines`` inside an active
        DRAIN_CORRUPT window loses its un-harvested output."""
        es = set(engines)
        for i, s in self._active(DRAIN_CORRUPT):
            if not s.engines or es & set(s.engines):
                self._note(i, s, spend=True)
                return s
        return None

    def pool_faults(self) -> List[Tuple[int, FaultSpec]]:
        """Active POOL_EXHAUST windows (the scheduler applies/releases
        the block seizures — they live in host allocator state)."""
        return list(self._active(POOL_EXHAUST))

    def note_pool_fault(self, i: int, s: FaultSpec) -> None:
        self._note(i, s)
