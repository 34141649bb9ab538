"""Dynamic Scheduler (paper §5, Algorithm 1) over heterogeneous fleets.

One scheduling iteration = one step-aligned collective step across all
islands (vLLM-v1-style DP coordination — the paper's control plane
heartbeat becomes the step boundary in JAX's single-controller model).
The scheduler is execution-agnostic: a ``Backend`` either simulates step
durations from the roofline cost model (benchmarks) or runs the real
compiled executables (examples/tests).

The fleet runs a ``FleetLayout`` (modes.py): an ordered partition of the
engine tiles into islands, each with its own merge — the paper's Fig. 3
picture, where a TP island serves a priority request while the rest of
the fleet keeps serving DP traffic. A uniform mode is the single-island
degenerate case. Worklists, admission, and execution are per island:
every island with work gets its own (mixed/prefill/decode) launch each
tick, dispatched back-to-back so an async backend overlaps them; the
tick advances by the slowest island (step-aligned).

Mode switching strategies (paper §5.2, Fig. 7) are PARTIAL: a
transition's scope is ``layout.changed_engines`` — only requests whose
group assignment (lead engine, merge) the new layout reshapes are
incompatible; everything else keeps serving through the rebind.
  - SEQUENTIAL: drain the reshaped engines' requests before switching
    (stragglers idle only their island).
  - SOFT preempt: while draining, idle engines speculatively run the
    TP-designated request in DP mode; on switch its KV is dropped and
    re-prefilled under the TP layout (compute-bound, parallel), keeping
    the tokens generated meanwhile.
  - HARD preempt: switch at the next step boundary; incompatible running
    requests PAUSE — their blocks stay physically resident with their
    mode tag (KV Cache Adaptor §4.2) and resume without recomputation.
    Requests outside the reshaped islands never pause.
  - LIVE (docs/PERF.md §D8): the §4.2 claim made whole — requests whose
    KV is tag-readable under the new layout (merge-up into a group
    containing every segment's owner group, on a live-readable
    architecture) are NOT incompatible at all: they keep decoding
    straight through the rebind, their frozen segments read in place by
    per-segment partial attention + an LSE combine, their pending write
    slot retagged to the new mode. Merge-downs and non-readable
    architectures (MLA/MQA head layouts, recurrent states, sliding
    windows) degrade per request to the HARD behavior.

Invariants (paper §5.3): all engines in a TP group observe the same
request order (single worklist per island), and transitions happen only
at step boundaries (safe points) — deadlock-free by construction here,
since collectives exist only inside per-island compiled programs.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Protocol, Sequence, Tuple, Union

from repro_torch.core.faults import EngineFault, TransitionFault
from repro_torch.core.kv_adaptor import (KVCacheAdaptor, PoolGeometry,
                                   PrefixCache, bind_fleet)
from repro_torch.core.modes import FleetLayout, Island, ParallelPlan
from repro_torch.core.task_pool import (TERMINAL_STATES, Request, TaskPool,
                                  prompt_token_ids)

SEQUENTIAL = "sequential"
SOFT = "soft"
HARD = "hard"
LIVE = "live"


class Backend(Protocol):
    """Execution substrate: simulate or really execute one step.

    The contract is async-aware: ``prefill``/``decode`` may only LAUNCH
    a step and return immediately (the real engine runs a bounded
    in-flight window of compiled steps with sampling fused on device).
    Generated-token VALUES are observable only after ``drain`` — the
    scheduler's finish detection is count-based (``Request.generated``),
    so it never needs a mid-stream synchronization. ``island`` arguments
    are ``modes.Island`` handles from the live layout (backends may also
    accept a bare merge for the degenerate uniform case). Backends must
    drain the islands a ``rebind`` reshapes (the §5.3 step-boundary safe
    point) — and ONLY those; the scheduler additionally drains once at
    the end of a run.

    Backends MAY additionally expose
    ``mixed(prefills, decodes, island, chunk_tokens) -> float`` (gated
    by an optional ``supports_mixed()``): one launch covering an
    island's prefill chunks AND decode batch (§Perf D6). ``decodes``
    includes requests promoted out of this tick's final chunk; their
    ``prefilled`` field still holds the chunk's PRIOR length when the
    backend runs — the scheduler advances it only after the launch.

    Backends exposing ``adaptors`` (the real engine does) have them
    adopted by the scheduler at construction, so allocation state lives
    in exactly one place.
    """

    def prefill(self, reqs: Sequence[Request], island,
                chunk_tokens: int) -> float:
        """Run (or simulate) prefill of `chunk_tokens` for each req;
        returns step duration in seconds."""

    def decode(self, reqs: Sequence[Request], island) -> float:
        """One decode token for every req; returns duration (dispatch
        time for asynchronous backends)."""

    def rebind(self, layout: FleetLayout) -> float:
        """Partial layout transition (flying: executable lookup + island
        view re-assembly; static baselines: restart). Implies a drain of
        the RESHAPED islands' in-flight steps only."""

    def drain(self) -> None:
        """Synchronize any in-flight asynchronous work so generated
        tokens are host-visible. No-op for synchronous backends."""


@dataclass
class SchedulerConfig:
    strategy: str = HARD
    max_batch_per_group: int = 32
    prefill_chunk: int = 512  # Sarathi-style small chunks keep TPOT smooth
    # policy thresholds (use case 1)
    queue_high: int = 8          # per engine -> go DP
    queue_low: int = 1
    latency_merge: int = 0       # 0 -> max available merge at low load
    fixed_merge: Optional[int] = None  # static baselines pin the mode
    # fault tolerance (docs/PERF.md §D9): a step (or rebind) is a
    # deadline MISS when its duration exceeds the backend's clean
    # roofline expectation by watchdog_slack x; health_misses
    # consecutive misses quarantine the island's engines.
    watchdog_slack: float = 4.0
    health_misses: int = 3
    # cross-request prefix cache (docs/PERF.md §D10): content-addressed
    # block sharing across requests; admission discounts cache hits.
    prefix_cache: bool = False
    # overload backstop (§D11): cap on queued-but-unplaced requests.
    # Beyond it the scheduler SHEDS the lowest-priority newest arrivals
    # (terminal 'shed' state, KV-free by construction) instead of
    # letting the backlog wedge the pool. None disables the cap — the
    # front door normally owns admission control; this is the last line.
    max_waiting: Optional[int] = None


@dataclass
class StepLog:
    t: float
    merge: int                 # widest live island merge (uniform: THE merge)
    phase: str
    n_running: int
    n_queued: int
    switched: bool = False     # a layout transition applied this tick
    islands: Tuple[Tuple[int, int], ...] = ()   # live (n_engines, merge)s
    degraded: bool = False     # backpressure eviction fired this tick
    # prefix-cache counters (§D10), CUMULATIVE as of this tick
    prefix_hits: int = 0
    prefix_misses: int = 0
    prefix_evictions: int = 0


@dataclass
class SchedulerDiagnostic:
    """Structured snapshot of the scheduler's full state — raised with
    ``SchedulerWedged`` instead of a bare state string, and consumed by
    the quarantine/recovery path to pick its victims (both views of a
    stuck fleet come from the same accounting)."""
    t: float
    tick: int
    layout: str
    islands: Tuple[Dict, ...] = ()     # per island: span/shape/clock/work
    waiting: Tuple[str, ...] = ()
    running: Tuple[str, ...] = ()
    paused: Tuple[str, ...] = ()
    pool_free: Tuple[int, ...] = ()    # free blocks per engine tile
    preempt_stats: Dict = field(default_factory=dict)
    quarantined: Tuple[int, ...] = ()
    health: Dict = field(default_factory=dict)  # island span -> miss count
    # request lifecycle counters (§D11): aborted / expired / shed
    lifecycle: Dict = field(default_factory=dict)
    incidents: Tuple[Dict, ...] = ()   # audit log (snapshots elided)

    def to_dict(self) -> Dict:
        """JSON-safe snapshot. Nested incident snapshots are elided —
        the top-level diagnostic already IS one, and a quarantine
        incident's embedded ``SchedulerDiagnostic`` would otherwise
        recurse into the serializer."""
        return {
            "t": self.t, "tick": self.tick, "layout": self.layout,
            "islands": [dict(isl) for isl in self.islands],
            "waiting": list(self.waiting),
            "running": list(self.running),
            "paused": list(self.paused),
            "pool_free": list(self.pool_free),
            "preempt_stats": dict(self.preempt_stats),
            "quarantined": list(self.quarantined),
            "health": dict(self.health),
            "lifecycle": dict(self.lifecycle),
            "incidents": [
                {k: v for k, v in inc.items() if k != "snapshot"}
                for inc in self.incidents],
        }

    def to_json(self) -> str:
        """The structured artifact ``serve.py`` writes to
        ``diagnostic.json`` on shutdown and on ``SchedulerWedged``."""
        return json.dumps(self.to_dict(), indent=2, sort_keys=True,
                          default=str)

    def describe(self) -> str:
        lines = [f"  t={self.t:.3f} tick={self.tick} layout={self.layout}"]
        for isl in self.islands:
            lines.append(
                f"  island {isl['span']} {isl['shape']}: "
                f"clock={isl['clock']:.3f} decode={isl['decode']} "
                f"prefill={isl['prefill']}")
        lines.append(f"  waiting={list(self.waiting)}")
        lines.append(f"  running={list(self.running)}")
        lines.append(f"  paused={list(self.paused)}")
        lines.append(f"  pool_free={list(self.pool_free)}")
        lines.append(f"  quarantined={list(self.quarantined)} "
                     f"health={self.health}")
        lines.append(f"  preempt_stats={self.preempt_stats}")
        if self.lifecycle:
            lines.append(f"  lifecycle={self.lifecycle}")
        return "\n".join(lines)


class SchedulerWedged(RuntimeError):
    """The scheduler has work but can make no progress. Carries the
    full ``SchedulerDiagnostic`` (also appended to the message) so the
    operator sees per-island worklists, the paused set, and pool
    occupancy instead of a bare count string."""

    def __init__(self, msg: str, diagnostic: Optional[SchedulerDiagnostic]
                 = None):
        self.diagnostic = diagnostic
        if diagnostic is not None:
            msg = f"{msg}\n{diagnostic.describe()}"
        super().__init__(msg)


class DynamicScheduler:
    """Algorithm 1 event loop over the fleet's islands."""

    def __init__(self, plan: ParallelPlan, geom: PoolGeometry,
                 backend: Backend, cfg: SchedulerConfig,
                 policy=None):
        self.plan = plan
        self.geom = geom
        self.backend = backend
        self.cfg = cfg
        self.pool = TaskPool()
        self.layout = FleetLayout.uniform(plan, cfg.fixed_merge or 1)
        self.pending_layout: Optional[FleetLayout] = None
        self.now = 0.0
        # per-island completion clocks: islands run concurrently (the
        # real engine overlaps their launches via async dispatch), so a
        # slow TP island must not throttle its DP neighbors' token
        # cadence. An island launches its next step only once its
        # previous one has completed; the control-plane clock advances
        # to the earliest busy island. Uniform layouts degenerate to the
        # seed-era single step clock.
        self._clock: Dict[Island, float] = {
            isl: 0.0 for isl in self.layout.islands}
        self.waiting: List[Request] = []
        self.running: List[Request] = []   # decoding under current layout
        self.paused: List[Request] = []    # hard-preempted (other mode tag)
        # one adaptor per engine tile; adopt the backend's when it owns
        # them (the real engine) so allocation state is never split
        backend_ads = getattr(backend, "adaptors", None)
        if backend_ads is not None:
            self.adaptors = backend_ads
        else:
            self.adaptors = [KVCacheAdaptor(geom)
                             for _ in range(plan.dp_engines * plan.pods)]
            bind_fleet(self.adaptors, self.layout)
        # cross-request prefix cache (§D10): ONE content-addressed index
        # shared by every adaptor in the fleet — chains carry their
        # writer group, so cross-island hits are first-class.
        self.prefix_cache: Optional[PrefixCache] = None
        if cfg.prefix_cache:
            self.prefix_cache = PrefixCache()
            for a in self.adaptors:
                a.prefix_cache = self.prefix_cache
        # whether the backend's step programs can read cached chains
        # written under OTHER tags (the §D8 live-read capability gates
        # cross-layout attach; geometry per tag is checked at lookup)
        blr = getattr(backend, "live_readable", None)
        self._live_backend = bool(blr()) if callable(blr) else True
        # per-request prompt token ids (content hashing); dropped once
        # the prompt fully prefills or the request is recovered
        self._tok_cache: Dict[str, object] = {}
        self.policy = policy
        self.log: List[StepLog] = []
        self.switches = 0
        self._switched_tick = False
        self._busy_islands: set = set()
        # disruption accounting (§D8 acceptance): how many requests each
        # transition class touched. LIVE's whole point is that its
        # rebinds add nothing here. §D9 adds the self-healing counters:
        # recovered (requests re-admitted after a quarantine/eviction),
        # rollbacks (transitions undone by the watchdog), degraded_ticks
        # (ticks that needed a backpressure eviction).
        self.preempt_stats = {"paused": 0, "recomputed_tokens": 0,
                              "live_riders": 0, "recovered": 0,
                              "rollbacks": 0, "degraded_ticks": 0}
        # -- fault tolerance (docs/PERF.md §D9) -------------------------
        # the injector rides on the backend (like the adaptors) so one
        # scripted schedule drives both sides; the scheduler owns the
        # tick clock and the host-side POOL_EXHAUST seizures.
        self.injector = getattr(backend, "injector", None)
        self._tick = -1
        self.quarantined: set = set()      # permanently dead engine tiles
        self._health: Dict[Island, int] = {}   # consecutive deadline misses
        self._seized: Dict[int, List[int]] = {}  # engine -> seized block ids
        self._degraded_tick = False
        self._recovered_tick: set = set()  # req_ids recovered this pass
        self.incidents: List[Dict] = []    # audit log of faults handled
        # -- request lifecycle (docs/PERF.md §D11) ----------------------
        # terminal exits other than 'done': client aborts, deadline
        # expiries, load sheds. The front door drives these; the
        # counters live here so diagnostics see one accounting.
        self.lifecycle: Dict[str, int] = {
            "aborted": 0, "expired": 0, "shed": 0}

    # ------------------------------------------------------------------
    @property
    def merge(self) -> int:
        """Fleet-wide merge of a uniform layout (seed-era API);
        heterogeneous layouts report their widest island."""
        return self.layout.uniform_merge or self.layout.max_merge

    @property
    def groups(self) -> int:
        return self.layout.n_groups

    def _adaptor(self, lead_engine: int) -> KVCacheAdaptor:
        """Requests record their ABSOLUTE lead engine id (stable across
        rebinds); merged groups share the lead engine's table."""
        return self.adaptors[lead_engine]

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.pool.submit(req)

    def abort(self, req_id: str, reason: str = "aborted") -> bool:
        """Terminal mid-flight abort (§D11): client cancellation
        (``aborted``), deadline expiry (``expired``), or load shedding
        (``shed``). Safe at ANY phase — queued, mid-prefill, decoding,
        or paused across a rebind:

        - every KV block returns through the same transactional release
          path a completion uses (``KVCacheAdaptor.release``): private
          segments — including a partially-written live tail — go back
          to their write-time owners' free sets; shared-prefix segments
          drop a refcount and park in the eviction pool (§D10);
        - the backend's ``abort_request`` hook retires the request's
          decode row WITHOUT draining its island (in-flight tokens are
          tombstoned, not synchronized);
        - the request never resurrects: rollback and resume paths skip
          terminal states.

        Returns False when the request is unknown or already terminal
        (cancel/expiry races are expected and benign)."""
        r = self.pool.all.get(req_id)
        if r is None or r.state in TERMINAL_STATES:
            return False
        self.pool.remove(req_id)
        for lst in (self.waiting, self.running, self.paused):
            if r in lst:
                lst.remove(r)
        # free KV wherever the entries actually live — LIVE rebinds
        # keep the blocks on the request's HOME adaptor while
        # engine_group tracks the new island lead, and quarantine
        # recovery can leave engine_group == -1 entirely, so sweep
        # the whole fleet rather than trusting the group index
        for a in self.adaptors:
            if req_id in a.table:
                a.release(req_id)
        hook = getattr(self.backend, "abort_request", None)
        if hook is not None:
            hook(r)
        self._tok_cache.pop(req_id, None)
        # already-built worklists this tick must shed the request too
        # (abort called from a backend hook or mid-tick sweep)
        self._recovered_tick.add(req_id)
        r.state = reason
        r.engine_group = -1
        if r.finish_t is None:
            r.finish_t = self.now
        self.lifecycle[reason] = self.lifecycle.get(reason, 0) + 1
        self.incidents.append({
            "t": self.now, "tick": self._tick, "kind": "abort",
            "req": req_id, "why": reason})
        return True

    def run(self, until_drained: bool = True, max_steps: int = 2_000_000,
            t_end: Optional[float] = None) -> None:
        """Offline driver: tick until drained (or ``t_end``). The
        per-tick machinery lives in ``step`` + ``idle_advance`` so
        other drivers (the §D11 front door, the §D13 async serve loop)
        reuse exactly the same engine; this loop only sequences them.
        Exhausting ``max_steps`` with work still live raises
        ``SchedulerWedged`` (with the full diagnostic) — the cap is a
        livelock backstop, and hitting it is never a clean drain."""
        seen_wedges: set = set()
        for _ in range(max_steps):
            progressed = self.step()
            if t_end is not None and self.now >= t_end:
                break
            if not progressed and not self.idle_advance(
                    seen_wedges, until_drained=until_drained):
                break
        else:
            raise SchedulerWedged(
                f"scheduler exhausted max_steps={max_steps} with work "
                f"still live: {len(self.waiting)} waiting, "
                f"{len(self.running)} running, {len(self.paused)} "
                f"paused (layout {self.layout.describe()})",
                self._diagnostic())
        self.drain_backend()

    def idle_advance(self, seen_wedges: Optional[set] = None,
                     until_drained: bool = True) -> bool:
        """One no-progress transition — the reusable half of the old
        ``run`` loop: advance the clock to the next arrival, idle
        through scripted pool-seizure windows, force-resume stranded
        paused requests, or raise ``SchedulerWedged``. Returns False
        when there is nothing left to drive (fully drained, or the
        caller accepts undrained work); True means "tick again".
        ``seen_wedges`` carries the resume-cycle guard state across
        calls (pass the same set for the whole drive)."""
        nxt = self.pool.next_arrival()
        if nxt is not None:
            self.now = max(self.now, nxt)
            return True
        if not (self.waiting or self.running or self.paused):
            return False
        if not until_drained:
            return False  # caller accepts undrained work
        if self._seized:
            # a scripted pool seizure still holds blocks: a starved
            # fleet here is the fault, not a wedge — idle the tick
            # clock forward until the window closes and the blocks
            # come back
            return True
        # cycle guard: two paused requests whose resume carves conflict
        # can ping-pong (each forced resume re-pauses the other).
        # Revisiting an already-seen (paused set, layout) state means
        # no net progress — raise instead of livelocking to max_steps.
        if seen_wedges is not None:
            state = (frozenset(r.req_id for r in self.paused),
                     self.layout.shapes())
            if state in seen_wedges:
                raise SchedulerWedged(
                    f"scheduler wedged in a resume cycle: "
                    f"{len(self.paused)} paused requests' carves "
                    f"conflict (layout {self.layout.describe()})",
                    self._diagnostic())
            seen_wedges.add(state)
        # nothing runnable but work exists: a paused request can be
        # stranded when its opportunistic resume stays blocked forever
        # (e.g. no future arrivals ever make the busy-island gate
        # open). Force the minimal resume transition directly; if even
        # that cannot make progress the scheduler is genuinely wedged —
        # surface it instead of silently returning with requests
        # stranded in 'paused'.
        if not self.force_resume():
            raise SchedulerWedged(
                f"scheduler wedged with no runnable work: "
                f"{len(self.waiting)} waiting, "
                f"{len(self.running)} running, "
                f"{len(self.paused)} paused "
                f"(layout {self.layout.describe()})",
                self._diagnostic())
        return True

    def force_resume(self) -> bool:
        """Force the minimal resume transition for one stranded paused
        request. Returns True when a request actually left the paused
        set (progress)."""
        for r in list(self.paused):
            if self._transition(self._resume_layout(r)) \
                    and r not in self.paused:
                return True
        return False

    def drain_backend(self) -> None:
        """Surface in-flight generated tokens from async backends (the
        only other drain points are rebind safe boundaries, handled by
        the backend itself)."""
        drain = getattr(self.backend, "drain", None)
        if drain is not None:
            drain()

    # ------------------------------------------------------------------
    def step(self) -> bool:
        """One Algorithm-1 iteration. Returns False if idle."""
        # ⓪ fault clock: scripted faults key on the step index; host-side
        # POOL_EXHAUST seizures open/close here
        self._tick += 1
        self._degraded_tick = False
        if self.injector is not None:
            self.injector.advance(self._tick)
            self._apply_pool_faults()
        # ① Input Processing
        self.waiting.extend(self.pool.pull(self.now, 1 << 30))
        # ② Global Synchronization: one agreed order
        self.waiting.sort(key=lambda r: (-r.priority, r.arrival))
        if self.cfg.max_waiting is not None:
            self._shed_overflow()

        # ③ Mode Determination (policy layer; Flag_SetTP / Flag_ResetTP)
        switched = False
        if self.cfg.fixed_merge is None and self.policy is not None:
            target = self._sanitize(
                self._as_layout(self.policy.decide(self)))
            if target != self.layout:
                switched = self._transition(target)

        # ④/⑥ KV parameterization + execution
        progressed = self._execute_one_step()
        if self.paused and self.pending_layout is None:
            # opportunistic resume: a paused request resumes as soon as
            # every engine its group-restoring carve would reshape is
            # IDLE — no running decodes, no admitted or mid-prefill
            # work, no launch this tick (a priority request still
            # prefilling toward its island must not look idle). The
            # rest of the fleet keeps serving; residents of busy
            # islands — and wide tags whose carve would reshape busy
            # engines — wait for the work to drain first.
            busy = {self.layout.island_of(r.engine_group)
                    for r in self.running}
            busy |= {self.layout.island_of(r.engine_group)
                     for r in self.waiting if r.engine_group >= 0}
            # islands that launched this tick, were mid-step, or are
            # mid-rebind: a just-applied policy transition must not be
            # un-done before its islands even start serving
            busy |= self._busy_islands
            if any(r.priority > 0 for r in self.waiting):
                # queued priority traffic is DESTINED for the widest
                # islands (admission's wide rule) — a just-carved TP
                # island awaiting its first admission is not idle
                maxm = self.layout.max_merge
                busy |= {isl for isl in self.layout.islands
                         if isl.merge == maxm}
            busy_engines = frozenset(
                e for isl in busy for e in isl.engines())
            for r in self.paused:
                target = self._resume_layout(r)
                if self.layout.changed_engines(target) & busy_engines:
                    continue
                if self._transition(target):
                    progressed = self._execute_one_step() or progressed
                break
        if not (progressed or switched):
            return False
        return True

    def _shed_overflow(self) -> None:
        """Bounded admission backstop (§D11): beyond ``cfg.max_waiting``
        queued-but-unplaced requests, shed the lowest-priority newest
        arrivals. Placed (mid-prefill) requests are never shed here —
        their KV is live; the backpressure path owns those. Overload
        thus ends in structured ``shed`` exits, never a wedged pool."""
        unplaced = [r for r in self.waiting
                    if r.prefilled == 0 and r.engine_group < 0]
        excess = len(unplaced) - self.cfg.max_waiting
        if excess <= 0:
            return
        victims = sorted(unplaced,
                         key=lambda r: (r.priority, -r.arrival))[:excess]
        for r in victims:
            self.abort(r.req_id, reason="shed")

    # ------------------------------------------------------------------
    def _as_layout(self, target: Union[FleetLayout, int]) -> FleetLayout:
        if isinstance(target, FleetLayout):
            return target
        if target == self.layout.uniform_merge:
            return self.layout
        return FleetLayout.uniform(self.plan, target)

    def _resume_layout(self, r: Request) -> FleetLayout:
        """The minimal transition that brings a paused request's group
        back: carve the island of its widest tag's OWNER group out of
        the live layout — the rest of the fleet keeps its shape. (The
        owner lead is the tag-aligned engine at or below the request's
        recorded lead: a live-ridden request's lead need not be aligned
        to tags it acquired later.) A request whose KV is SP-placed
        (§D12) resumes onto an island with the SAME write placement:
        its owners span write_tag x sp engines, so the carve restores
        sp = span // write_tag rather than a plain TP group."""
        m = self._tag(r)
        start = (r.engine_group // m) * m if r.engine_group >= 0 else 0
        sp = 1
        entry = self._entry(r)
        if entry is not None and any(
                getattr(s, "shard", -1) >= 0 for s in entry.segments):
            sp = max(m // max(entry.max_tag, 1), 1)
        return self._sanitize(self.layout.carve(start, m, m, sp=sp))

    def _sanitize(self, target: FleetLayout) -> FleetLayout:
        """Re-carve any transition target around the quarantined tiles:
        no healthy engine may be bound into a group with a dead one."""
        if not self.quarantined:
            return target
        return target.quarantine(self.quarantined)

    def _live_ok(self, r: Request, target: FleetLayout) -> bool:
        """Can this request's KV keep being read in place under
        ``target`` (§D8)? Requires (a) a backend whose step programs
        implement cross-tag reads, (b) the new group to CONTAIN every
        segment's owner group — with buddy alignment that reduces to
        new_merge >= max segment tag (aligned pow2 groups around one
        engine nest) — and (c) a tag-readable geometry for every tag
        involved."""
        blr = getattr(self.backend, "live_readable", None)
        if callable(blr) and not blr():
            return False
        g = r.engine_group
        if g < 0:
            return True          # not placed: nothing to carry
        entry = self._entry(r)
        if entry is None or not entry.segments:
            return True
        isl2 = target.island_of(g)
        lead2, m_new, _sp2 = isl2.group_of(g)
        if entry.max_tag > m_new:
            return False         # merge-down: owners outside the group
        # SP placements (§D12) are readable only by an SP island with
        # the SAME write tag (lane staging keys on the shard owners);
        # conversely plain placements cannot ride onto an SP island —
        # its staging path requires every segment to be SP-placed
        sp_placed = any(getattr(s, "shard", -1) >= 0
                        for s in entry.segments)
        if (isl2.sp > 1) != sp_placed:
            return False
        if sp_placed and isl2.write_tag != entry.max_tag:
            return False
        # attached shared prefixes may be owned by a group NOT derivable
        # from this request's lead by buddy alignment — check each
        # recorded owner's fleet position against the new group span
        for s in entry.segments:
            for o in s.owners:
                if not lead2 <= o.engine_id < lead2 + m_new:
                    return False
        # the tag new writes land under: the island's write tag — for a
        # sequence-parallel group (§D12) that is merge // sp, not merge
        return all(self.geom.live_readable(t)
                   for t in set(entry.tags()) | {isl2.write_tag})

    def _incompatible(self, target: FleetLayout) -> List[Request]:
        """Requests whose KV layout the transition would reshape:
        running decodes + partially prefilled admissions on engines
        whose group assignment changes. Everything else rides through
        the rebind untouched — the partial-transition contract. Under
        LIVE, tag-readable requests drop out of the set entirely (for a
        readable architecture a merge-up returns EMPTY): their frozen
        segments stay readable in place, so the rebind owes them
        nothing — no pause, no recompute."""
        changed = self.layout.changed_engines(target)
        bound = list(self.running) + [r for r in self.waiting
                                      if r.prefilled > 0]
        hit = [r for r in bound if r.engine_group in changed]
        if self.cfg.strategy == LIVE:
            return [r for r in hit if not self._live_ok(r, target)]
        return hit

    def _transition(self, target: FleetLayout) -> bool:
        strat = self.cfg.strategy
        target = self._sanitize(target)
        if target == self.layout:
            self.pending_layout = None
            return True
        incompatible = self._incompatible(target)
        if strat == LIVE:
            # riders: running decodes on reshaped engines that stay
            # compatible by reading their segments in place. Their one
            # pending (allocated, unwritten) slot must re-issue under
            # the new mode's view before the next launch.
            changed = self.layout.changed_engines(target)
            riders = [r for r in self.running
                      if r.engine_group in changed
                      and r not in incompatible]
            newly = self._pause(incompatible)
            ok = self._apply_switch(target, newly)
            if ok:
                self.preempt_stats["live_riders"] += len(riders)
                for r in riders:
                    self._retag_or_recompute(r)
            return ok
        if strat == SEQUENTIAL:
            self.pending_layout = target
            if incompatible:
                return False  # wait for the reshaped islands to drain
            return self._apply_switch(target)
        if strat == SOFT:
            self.pending_layout = target
            if incompatible:
                # idle engines speculatively serve waiting TP requests in
                # DP mode (they'll recompute later) — mark them
                for r in self.waiting:
                    if r.mode == "tp" and r.state == "queued":
                        r.state = "spec_dp"
                return False
            # drain complete: recompute any speculative requests' KV
            for r in list(self.running) + self.waiting:
                if r.state == "spec_dp":
                    g = r.engine_group
                    if g >= 0:
                        self.preempt_stats["recomputed_tokens"] += \
                            self._adaptor(g).drop_for_recompute(r.req_id)
                        r.prefilled = 0
                        r.state = "queued"
                        if r in self.running:
                            self.running.remove(r)
                            self.waiting.insert(0, r)
            return self._apply_switch(target)
        # HARD: immediate switch at this (safe) step boundary; only the
        # reshaped islands' requests pause
        newly = self._pause(incompatible)
        return self._apply_switch(target, newly)

    def _pause(self, reqs: Sequence[Request]
               ) -> List[Tuple[Request, str]]:
        """HARD-pause ``reqs``, remembering where each came from so a
        watchdog rollback can reinstate them exactly."""
        newly: List[Tuple[Request, str]] = []
        for r in reqs:
            origin = "running" if r in self.running else "waiting"
            r.state = "paused"
            self.paused.append(r)
            self.preempt_stats["paused"] += 1
            if r in self.running:
                self.running.remove(r)
            if r in self.waiting:
                self.waiting.remove(r)
            newly.append((r, origin))
        return newly

    def _retag_or_recompute(self, r: Request) -> None:
        """Re-issue a rider's pending slot under the (new) current mode;
        if even one group-free block cannot be taken, degrade that one
        request to the SOFT behavior (drop + re-prefill) rather than
        wedging the rebind."""
        ad = self._adaptor(r.engine_group)
        try:
            ad.retag_tail(r.req_id)
        except MemoryError:
            self.preempt_stats["recomputed_tokens"] += \
                ad.drop_for_recompute(r.req_id)
            r.prefilled = 0
            r.state = "queued"
            if r in self.running:
                self.running.remove(r)
                self.waiting.insert(0, r)

    def _apply_switch(self, target: FleetLayout,
                      newly_paused: Sequence[Tuple[Request, str]] = (),
                      enforce_deadline: bool = True) -> bool:
        """Commit a layout transition — under the watchdog. The rebind
        gets a deadline (the backend's clean expectation x
        ``watchdog_slack``); a rebind that faults or blows the deadline
        (reshaped islands failing to drain) is rolled back to the prior
        layout, and every request the attempt paused is reinstated
        where it was — a failed transition never strands paused
        requests."""
        old_layout = self.layout
        exp = self._rebind_expected(target)
        try:
            dt = self._backend_rebind(target)
        except (TransitionFault, EngineFault) as ex:
            self._rollback_transition(target, newly_paused,
                                      f"rebind fault: {ex}")
            bad = getattr(ex, "engines", None)
            if bad:
                self._quarantine_engines(bad)
            return False
        if enforce_deadline and exp is not None \
                and dt > exp * self.cfg.watchdog_slack:
            # deadline blown: rebind back, charging the lost time to the
            # islands the attempt touched
            try:
                self._backend_rebind(old_layout)
            except (TransitionFault, EngineFault):
                pass
            changed = old_layout.changed_engines(target)
            for isl in list(self._clock):
                if set(isl.engines()) & changed:
                    self._clock[isl] = max(self._clock[isl], self.now) + dt
            self._rollback_transition(
                target, newly_paused,
                f"rebind deadline missed: {dt:.3f}s > "
                f"{self.cfg.watchdog_slack:.1f}x expected {exp:.3f}s")
            return False
        # the rebind cost lands on the RESHAPED islands' clocks: an
        # untouched island keeps serving straight through it (the real
        # engine never even drains it). A reshaped island synchronizes
        # with every outgoing island it overlaps (their in-flight steps
        # must complete at the safe point) and then pays the transition.
        old_clock = self._clock
        clock: Dict[Island, float] = {}
        for isl in target.islands:
            prev = old_clock.get(isl)
            if prev is not None:
                clock[isl] = prev
            else:
                inherit = [t for o, t in old_clock.items()
                           if o.start < isl.stop and isl.start < o.stop]
                clock[isl] = max([self.now] + inherit) + dt
        self._clock = clock
        self.layout = target
        self.pending_layout = None
        self.switches += 1
        self._switched_tick = True  # consumed by the next StepLog entry
        bind_fleet(self.adaptors, target)
        # resume paused requests whose group exists again under the new
        # layout — no recomputation needed (KV Cache Adaptor keeps the
        # blocks valid under the mode tags that wrote them). Under LIVE
        # a WIDER group also qualifies (its step programs read the old
        # segments in place); the pending slot then re-issues under the
        # group's mode.
        back = [r for r in self.paused if r.state not in TERMINAL_STATES
                and self._group_restored(r, target)]
        for r in back:
            self.paused.remove(r)
            if r.prefilled < r.prompt_len:
                r.state = "queued"
                self.waiting.insert(0, r)
            else:
                r.state = "running"
                self.running.append(r)
                if self.cfg.strategy == LIVE:
                    self._retag_or_recompute(r)
        return True

    def _backend_rebind(self, target: FleetLayout) -> float:
        rebind = getattr(self.backend, "rebind", None)
        if rebind is not None:
            return rebind(target)
        # legacy backends know only uniform switches
        return self.backend.switch(self.merge,
                                   target.uniform_merge or target.max_merge)

    def _rebind_expected(self, target: FleetLayout) -> Optional[float]:
        """Clean (fault-free) rebind duration from the backend's cost
        model — the watchdog deadline's base. None disables the check."""
        hook = getattr(self.backend, "rebind_expected", None)
        if hook is None:
            return None
        return hook(target)

    def _rollback_transition(self, target: FleetLayout,
                             newly_paused: Sequence[Tuple[Request, str]],
                             why: str) -> None:
        """Undo a failed transition attempt: the layout never changed,
        so reinstate every request the attempt paused exactly where it
        was and drop the pending target."""
        for r, origin in newly_paused:
            if r in self.paused:
                self.paused.remove(r)
            self.preempt_stats["paused"] -= 1
            if r.state in TERMINAL_STATES:
                # aborted/expired while the attempt was in flight: its
                # KV is already released — reinstating would resurrect
                # a terminal request into the running set (§D11)
                continue
            if origin == "running":
                r.state = "running"
                self.running.append(r)
            else:
                r.state = "queued"
                self.waiting.insert(0, r)
        self.pending_layout = None
        self.preempt_stats["rollbacks"] += 1
        self.incidents.append({
            "t": self.now, "tick": self._tick, "kind": "rollback",
            "target": target.describe(), "why": why})

    def _group_restored(self, r: Request, layout: FleetLayout) -> bool:
        """A paused request resumes when its engine's group can read its
        KV again: exactly its widest tag's merge with its lead leading
        (the HARD contract) — or, under LIVE on a readable architecture,
        any group at least that wide (cross-tag reads make the wider
        group equivalent)."""
        g = r.engine_group
        if g < 0:
            return True
        m = self._tag(r)
        isl = layout.island_of(g)
        entry = self._entry(r)
        sp_placed = entry is not None and any(
            getattr(s, "shard", -1) >= 0 for s in entry.segments)
        if self.cfg.strategy == LIVE and self._live_ok(r, layout):
            # _live_ok already enforced the SP placement match (§D12)
            return isl.group_of(g)[1] >= m
        if sp_placed:
            # SP KV resumes only onto an SP island with the same write
            # tag whose group spans every shard owner
            return isl.sp > 1 and isl.write_tag == entry.max_tag \
                and isl.merge == m and (g - isl.start) % m == 0
        return isl.sp == 1 and isl.merge == m \
            and (g - isl.start) % m == 0

    def _tag(self, r: Request) -> int:
        """The merge a request's KV needs to be readable: the widest
        segment tag (owner groups nest, so the widest owner group
        contains them all) — widened further until the aligned group
        around the request's lead also contains every ATTACHED shared
        prefix's owner (a cross-group attach is not buddy-nested)."""
        g = r.engine_group
        if g < 0:
            return self.layout.merge_of(0)
        entry = self._entry(r)
        if not entry:
            return self.layout.merge_of(g)
        m = entry.max_tag
        owners = {o.engine_id for s in entry.segments for o in s.owners}
        if owners:
            widest = self.plan.valid_merges()[-1]
            while m < widest and not all(
                    (g // m) * m <= e < (g // m) * m + m for e in owners):
                m *= 2
        return m

    def _prompt_ids(self, r: Request):
        """The exact prompt token ids the backend will prefill for
        ``r`` — the bytes content addressing hashes. Backends exposing
        ``prompt_tokens`` (the real engine, with its pinned recovery
        prompts) are authoritative; otherwise the shared deterministic
        generator."""
        ids = self._tok_cache.get(r.req_id)
        if ids is None:
            hook = getattr(self.backend, "prompt_tokens", None)
            ids = hook(r) if hook is not None \
                else prompt_token_ids(r, self.geom.cfg.vocab_size)
            self._tok_cache[r.req_id] = ids
        return ids

    def _entry(self, r: Request):
        g = r.engine_group
        if 0 <= g < len(self.adaptors) and r.req_id in self.adaptors[g].table:
            return self.adaptors[g].table[r.req_id]
        for a in self.adaptors:
            if r.req_id in a.table:
                return a.table[r.req_id]
        return None

    # ------------------------------------------------------------------
    def _execute_one_step(self) -> bool:
        layout = self.layout
        eps = 1e-12
        # requests recovered during THIS pass (quarantine victims,
        # backpressure evictions): already-built worklists must shed
        # them before launching
        self._recovered_tick = set()
        # islands whose previous step has completed may launch; the
        # others are mid-step (the real engine's async dispatch overlap)
        ready = {isl for isl in layout.islands
                 if self._clock[isl] <= self.now + eps}
        # admissions: fill READY island groups with queued requests
        # needing prefill. Group affinity implements the paper's Fig. 3
        # split: priority requests prefer the widest island (the TP
        # binding the policy carved for them), background prefers the
        # narrowest — so DP islands keep absorbing throughput traffic
        # while a bound TP island serves the latency SLO. Placement is
        # sticky: a mid-prefill request stays on the group whose adaptor
        # holds its blocks.
        admit: List[Request] = []
        leads = [(isl, lead) for isl in layout.islands
                 for lead in isl.lead_engines()]
        group_load: Dict[int, int] = {lead: 0 for _, lead in leads}
        for r in self.running:
            # live riders keep their ADMISSION lead, which need not lead
            # their current (wider) group — account them where they run
            isl_r = layout.island_of(r.engine_group)
            group_load[isl_r.group_of(r.engine_group)[0]] += 1
        for r in self.waiting:
            # mid-prefill requests hold a batch row on their sticky
            # group across ticks; admission must keep counting it or a
            # multi-chunk prompt's group overfills past the engine's
            # per-group batch (fold-recovered prompts always span
            # several chunks, so the recovery path hits this)
            if r.engine_group >= 0 and r.prefilled > 0:
                isl_r = layout.island_of(r.engine_group)
                group_load[isl_r.group_of(r.engine_group)[0]] += 1
        mem_blocked: set = set()   # leads waiting on their own pool
        reserved: Dict[int, int] = {}   # blocks promised this tick
        fits = getattr(self.backend, "request_fits", None)
        widest = self.plan.valid_merges()[-1]
        # while priority traffic is live anywhere in the system, the
        # widest islands are its bind (§D7 Fig. 3): background work
        # admitted there during a lull would hold batch rows for its
        # whole decode and stall the next priority burst's TTFT —
        # admit it to the narrow islands only (when any exist)
        prio_live = any(r.priority > 0 and not r.done
                        for r in self.running) or \
            any(r.priority > 0 for r in self.waiting)
        for r in list(self.waiting):
            if r.state not in ("queued", "spec_dp"):
                continue
            if r.engine_group >= 0 and r.prefilled > 0:
                # sticky mid-prefill placement: the group's adaptor holds
                # its blocks — but only take the next chunk when the
                # REMAINING context still fits the pool (decode growth
                # competes for blocks). KV pools are per engine, so a
                # full pool blocks further admissions to THIS group only,
                # never the rest of the fleet.
                ad = self._adaptor(r.engine_group)
                ent = ad.table.get(r.req_id)
                have = ent.length if ent else 0
                if ad.can_allocate(
                        max(r.total_context() - have, 0),
                        req_id=r.req_id):
                    admit.append(r)
                else:
                    mem_blocked.add(r.engine_group)
                continue

            if fits is not None and not fits(r, widest):
                # over the per-request block cap under EVERY mode — but
                # with elastic SP (§D12) the best placement is a pure-SP
                # island at the widest degree, whose per-engine block
                # need is 1/sp of a TP group's; only reject when even
                # that cannot hold it
                if not (getattr(self.policy, "sp", False)
                        and fits(r, Island(0, widest, widest, sp=widest))):
                    r.state = "rejected"
                    self.waiting.remove(r)
                    continue
            if fits is not None and not any(
                    fits(r, isl) for isl in layout.islands):
                # block capacity B(m) grows with merge: too big for
                # every LIVE island, but some valid mode could hold it —
                # keep it queued for a future layout (the same
                # wait-for-resources stance as pool exhaustion)
                continue
            # the latency-class bind is the widest TP island; an SP
            # island's merge is wide but its write tag (merge // sp) is
            # what sets decode latency — never the priority bind (§D12)
            tp_merges = [il.merge for il in layout.islands if il.sp == 1]
            max_tp = max(tp_merges) if tp_merges else 1
            wide = r.priority > 0 and max_tp > 1
            if wide:
                # a TP binding exists for this latency class: place ONLY
                # there — leaking onto a DP island because the bound
                # island is mid-step (or mid-rebind) would pin the
                # request to DP latency for its whole life. It stays
                # queued the tick or two until its island's clock
                # arrives.
                cands = [il for il in leads
                         if il[0].merge == max_tp and il[0].sp == 1]
                if self.quarantined and not any(
                        not (set(range(lead, lead + isl.merge))
                             & self.quarantined)
                        for isl, lead in cands):
                    # every widest island lost an engine: degraded
                    # latency beats starving the priority class
                    wide = False
                    cands = leads
            else:
                cands = leads
                if prio_live and layout.max_merge > 1:
                    narrow = [il for il in leads
                              if il[0].merge < layout.max_merge]
                    if narrow:
                        cands = narrow
            order = sorted(
                cands, key=lambda il: (
                    -il[0].merge if r.priority > 0 else il[0].merge,
                    group_load[il[1]], il[1]))
            placed = False
            for isl, lead in order:
                if isl not in ready or lead in mem_blocked:
                    continue
                if self.quarantined and (
                        set(range(lead, lead + isl.merge))
                        & self.quarantined):
                    continue  # group lost an engine: never admit to it
                if group_load[lead] >= self.cfg.max_batch_per_group:
                    continue
                if fits is not None and not fits(r, isl):
                    continue
                # RESERVE the full-context block need: two prompts
                # admitted to one group in the same tick must not both
                # count the free pool (chunked prefill would exhaust it
                # mid-stream and wedge both — neither ever decodes).
                # Prefix-cache hits DISCOUNT the reservation: attached
                # blocks are never allocated, so a shared-prefix burst
                # must not be refused admission for them (§D10).
                # folded (recovered) prompts embed harvested output
                # tokens that prompt_token_ids cannot regenerate — no
                # content identity, so they bypass the cache entirely
                use_pc = self.prefix_cache is not None and not r.folded \
                    and isl.sp == 1  # SP lanes carry only SP placements
                ad = self._adaptor(lead)
                cached = 0
                if use_pc:
                    cached = ad.cached_prefix_tokens(
                        self._prompt_ids(r),
                        cross_tag_ok=self._live_backend)
                blocks = -(-max(r.total_context() - cached, 0)
                           // ad.capacity)
                if isl.sp > 1:
                    # SP placement (§D12): blocks round-robin across the
                    # island's shard pools — the reservation is the
                    # per-shard share, checked against the tightest pool
                    need = -(-blocks // isl.sp)
                    free = min(
                        self.adaptors[lead + j * isl.write_tag]
                        .free_blocks() for j in range(isl.sp))
                else:
                    need = blocks
                    free = ad.free_blocks()
                if free - reserved.get(lead, 0) >= need:
                    r.engine_group = lead  # absolute lead engine
                    group_load[lead] += 1
                    reserved[lead] = reserved.get(lead, 0) + need
                    if use_pc:
                        c = ad.attach_prefix(
                            r.req_id, self._prompt_ids(r),
                            cross_tag_ok=self._live_backend)
                        if c:
                            # prefill starts at the first uncached token
                            r.prefilled = c
                    admit.append(r)
                    placed = True
                    break
            if not placed:
                if wide:
                    continue  # wait for the TP island, don't block others
                if ready:
                    break  # head-of-line blocking: wait for room
        # ⑥ execution: Sarathi-style mixed step — chunked prefills
        # piggybacked with the decode batch (paper §1: chunked prefill
        # and continuous batching preserved), so decode cadence never
        # starves behind admissions. One launch set per READY island,
        # islands dispatched back-to-back and overlapped: each runs on
        # its own completion clock, so a slow TP island never throttles
        # its DP neighbors' token cadence. Backends exposing ``mixed``
        # run an island's prefill chunks AND decode batch as ONE
        # compiled launch (§Perf D6); others (simulation, recurrent
        # archs) fall back to the sequential prefill->decode pair —
        # token-identical by construction.
        mixed = getattr(self.backend, "mixed", None)
        sup = getattr(self.backend, "supports_mixed", None)
        backend_mixed = mixed is not None and (sup is None or sup())
        idx_of = {isl: i for i, isl in enumerate(layout.islands)}
        pre_by = [[] for _ in layout.islands]
        dec_by = [[] for _ in layout.islands]
        for r in admit:
            if r.prefilled < r.prompt_len:
                pre_by[idx_of[layout.island_of(r.engine_group)]].append(r)
        for r in self.running:
            dec_by[idx_of[layout.island_of(r.engine_group)]].append(r)
        launched = False
        any_mixed = any_pre = any_dec = False
        suspects: set = set()   # engines to quarantine after the loop
        # islands busy as of THIS tick: mid-step/mid-rebind at tick
        # start, or launched below (snapshotted here because the
        # clock advance at the end of the tick hides both)
        self._busy_islands = set(layout.islands) - ready
        for isl, pre_i, dec_i in zip(layout.islands, pre_by, dec_by):
            if self._recovered_tick:
                # an earlier island's backpressure eviction may have
                # recovered requests right out of this island's lists
                pre_i = [r for r in pre_i
                         if r.req_id not in self._recovered_tick]
                dec_i = [r for r in dec_i
                         if r.req_id not in self._recovered_tick]
            if isl not in ready or not (pre_i or dec_i):
                continue
            self._busy_islands.add(isl)
            start = max(self._clock[isl], self.now)
            finished: List[Request] = []
            chunk_of: Dict[str, int] = {}
            if pre_i:
                chunks: Dict[int, List[Tuple[str, int]]] = {}
                for r in pre_i:
                    if r.sched_t is None:
                        r.sched_t = self.now
                    chunk = min(self.cfg.prefill_chunk,
                                r.prompt_len - r.prefilled)
                    if isl.sp > 1:
                        # SP islands (§D12) stage one KV block per chunk
                        # per row (a chunk's slots must stay within one
                        # shard's block): clamp to the next block edge
                        cap = self._adaptor(r.engine_group).capacity
                        chunk = min(chunk, cap - r.prefilled % cap)
                    chunk_of[r.req_id] = chunk
                    chunks.setdefault(r.engine_group, []).append(
                        (r.req_id, chunk))
                dropped: set = set()
                for g, items in chunks.items():
                    if not self._alloc_with_backpressure(
                            g, [rid for rid, _ in items],
                            [c for _, c in items]):
                        # group pool stays exhausted even after
                        # evictions: hold these chunks this tick
                        dropped.add(g)
                if dropped or self._recovered_tick:
                    pre_i = [r for r in pre_i
                             if r.engine_group not in dropped
                             and r.req_id not in self._recovered_tick]
                    dec_i = [r for r in dec_i
                             if r.req_id not in self._recovered_tick]
                # promote final-chunk requests BEFORE execution: the
                # island's decode batch this tick includes them (their
                # first token comes out of the final prefill step), and
                # ``prefilled`` stays at the chunk's prior length for
                # the backend to read
                for r in list(pre_i):
                    if r.prefilled + chunk_of[r.req_id] < r.prompt_len:
                        continue
                    if not self._alloc_with_backpressure(
                            r.engine_group, [r.req_id], [1]):
                        # no room for even its first output token: undo
                        # the chunk, retry when pressure lifts
                        self._adaptor(r.engine_group).truncate(
                            r.req_id, chunk_of[r.req_id])
                        pre_i.remove(r)
                        continue
                    r.state = "running" if r.state != "spec_dp" \
                        else "spec_dp"
                    self.waiting.remove(r)
                    self.running.append(r)
                    dec_i.append(r)
                    r.generated += 1
                    finished.append(r)
                if self._recovered_tick:
                    pre_i = [r for r in pre_i
                             if r.req_id not in self._recovered_tick]
                    dec_i = [r for r in dec_i
                             if r.req_id not in self._recovered_tick]
                    finished = [r for r in finished
                                if r.req_id not in self._recovered_tick]
            if not (pre_i or dec_i):
                continue
            try:
                dt = 0.0
                if pre_i and dec_i and backend_mixed:
                    dt = mixed(pre_i, dec_i, isl, self.cfg.prefill_chunk)
                    any_mixed = True
                else:
                    if pre_i:
                        dt += self.backend.prefill(pre_i, isl,
                                                   self.cfg.prefill_chunk)
                        any_pre = True
                    if dec_i:
                        dt += self.backend.decode(dec_i, isl)
                        any_dec = True
            except EngineFault as ex:
                # the step's output never materializes: roll the tick's
                # bookkeeping back and mark the dead engines
                self._undo_island_tick(pre_i, finished, chunk_of)
                suspects |= set(ex.engines)
                self.incidents.append({
                    "t": self.now, "tick": self._tick,
                    "kind": "engine_fault", "engines": sorted(ex.engines)})
                continue
            # soft step deadline (detection): an island whose step blew
            # the roofline expectation cfg.health_misses times in a row
            # is treated as failed — a stall the harness can't surface
            # as an exception (hung collective, sick HBM) looks exactly
            # like this
            exp = self._expected_step(pre_i, dec_i, isl)
            if exp is not None and dt > exp * self.cfg.watchdog_slack:
                miss = self._health.get(isl, 0) + 1
                self._health[isl] = miss
                if miss >= self.cfg.health_misses:
                    suspects |= set(isl.engines())
                    self._health.pop(isl, None)
            else:
                self._health.pop(isl, None)
            end = start + dt
            self._clock[isl] = end
            launched = True
            for r in pre_i:
                r.prefilled += chunk_of[r.req_id]
                if self.prefix_cache is not None and not r.folded:
                    # publish freshly-written full prompt blocks so the
                    # NEXT same-prefix request attaches instead of
                    # re-prefilling (§D10); safe here — an EngineFault
                    # rolls the tick back before reaching this point
                    ad = self._adaptor(r.engine_group)
                    ad.commit_prefix(r.req_id, self._prompt_ids(r),
                                     min(r.prefilled, r.prompt_len))
                    if r.prefilled >= r.prompt_len:
                        self._tok_cache.pop(r.req_id, None)
            for r in finished:
                r.first_token_t = end
                r.token_times.append(end)
            if dec_i:
                self._decode_bookkeeping(dec_i, end)
        if suspects:
            self._quarantine_engines(suspects)
            launched = True
        if any_mixed or any_pre:
            self._log("mixed" if any_mixed else "prefill")
        if any_dec:
            self._log("decode")
        if self.pending_layout is not None and \
                not self._incompatible(self.pending_layout):
            self._transition(self.pending_layout)
        # advance the control-plane clock to the earliest mid-step
        # island: the next scheduling decision happens when the fastest
        # busy island completes (uniform layouts: exactly the seed-era
        # += step-duration clock)
        mids = [t for t in self._clock.values() if t > self.now + eps]
        if mids:
            self.now = min(mids)
            return True
        return launched

    def _decode_bookkeeping(self, reqs: Sequence[Request],
                            t: float) -> None:
        """Post-decode accounting for one island's launch, at the
        island's completion time: token counts, next-token slots,
        completions."""
        done = []
        alive: Dict[int, List[str]] = {}
        for r in reqs:
            r.generated += 1
            r.token_times.append(t)
            if not r.done:
                alive.setdefault(r.engine_group, []).append(r.req_id)
            if r.done:
                r.finish_t = t
                r.state = "done"
                done.append(r)
        # next token's slot, one vectorized allocation per adaptor —
        # decode growth under memory pressure sheds the lowest-priority
        # resident (preempt-to-recompute) instead of crashing
        for r in done:
            self.running.remove(r)
            self._adaptor(r.engine_group).release(r.req_id)
        for g, rids in alive.items():
            self._alloc_with_backpressure(g, rids, [1] * len(rids),
                                          evict_self=True)

    # -- fault tolerance (docs/PERF.md §D9) ----------------------------
    def _expected_step(self, pre_i: Sequence[Request],
                       dec_i: Sequence[Request],
                       isl: Island) -> Optional[float]:
        """Clean roofline duration for this island's launch — the soft
        deadline's base. None (no backend hook) disables detection."""
        hook = getattr(self.backend, "expected_step", None)
        if hook is None:
            return None
        return hook(pre_i, dec_i, isl, self.cfg.prefill_chunk)

    def _apply_pool_faults(self) -> None:
        """Open/close scripted POOL_EXHAUST windows: seize free blocks
        from the named engines' pools while the window is active, hand
        them back when it closes. The serving path then exercises the
        real backpressure machinery — no special-cased failure."""
        inj = self.injector
        active: Dict[int, Tuple[int, object]] = {}
        for i, s in inj.pool_faults():
            targets = s.engines or tuple(range(len(self.adaptors)))
            for e in targets:
                active.setdefault(e, (i, s))
        for e in list(self._seized):
            if e not in active:
                self.adaptors[e].restore(self._seized.pop(e))
        for e, (i, s) in active.items():
            if e in self._seized:
                continue
            taken = self.adaptors[e].seize(s.blocks)
            if taken:
                self._seized[e] = taken
                inj.note_pool_fault(i, s)

    def _mark_degraded(self) -> None:
        if not self._degraded_tick:
            self._degraded_tick = True
            self.preempt_stats["degraded_ticks"] += 1

    def _alloc_with_backpressure(self, g: int, rids: Sequence[str],
                                 lens: Sequence[int],
                                 evict_self: bool = False) -> bool:
        """Graceful degradation: allocate KV growth for group ``g``,
        turning MemoryError into preempt-to-recompute — evict the
        lowest-priority resident of the group's engines, retry. With
        ``evict_self`` (decode growth: the batch MUST get next-token
        slots) the batch sheds its own lowest-priority member as the
        last resort; otherwise (prefill chunks) returns False so the
        caller holds the work for a later tick."""
        ad = self._adaptor(g)
        pairs = list(zip(rids, lens))
        while True:
            live = [(rid, t) for rid, t in pairs
                    if rid not in self._recovered_tick]
            if not live:
                return True
            try:
                ad.append_slots_batch([rid for rid, _ in live],
                                      [t for _, t in live])
                return True
            except MemoryError:
                self._mark_degraded()
                victim = self._pick_victim(g, {rid for rid, _ in live})
                if victim is not None:
                    self._recover(victim, "backpressure")
                    continue
                if not evict_self:
                    return False
                rs = [self.pool.all[rid] for rid, _ in live]
                self._recover(min(rs, key=lambda r: (r.priority,
                                                     -r.arrival)),
                              "backpressure")

    def _pick_victim(self, g: int, exclude: set) -> Optional[Request]:
        """Backpressure victim: the lowest-priority (then newest)
        request whose KV owner span overlaps group ``g``'s engines —
        evicting it actually frees blocks this group can take."""
        isl = self.layout.island_of(g)
        lead, m = isl.group_of(g)[:2]
        span = set(range(lead, lead + m))
        cands = []
        for r in (self.running + self.paused
                  + [w for w in self.waiting if w.prefilled > 0]):
            if r.req_id in exclude or r.engine_group < 0 \
                    or r.req_id in self._recovered_tick:
                continue
            t = self._tag(r)
            l2 = (r.engine_group // t) * t
            if set(range(l2, l2 + t)) & span:
                cands.append(r)
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.arrival))

    def _undo_island_tick(self, pre_i: Sequence[Request],
                          finished: Sequence[Request],
                          chunk_of: Dict[str, int]) -> None:
        """A launch died after its tick's slots were issued: un-issue
        them so allocator state matches the tokens that actually
        materialized (none), and un-promote final-chunk requests."""
        for r in finished:
            r.generated -= 1
            r.state = "queued" if r.state != "spec_dp" else "spec_dp"
            if r in self.running:
                self.running.remove(r)
            self.waiting.insert(0, r)
        for r in pre_i:
            n = chunk_of.get(r.req_id, 0) + (1 if r in finished else 0)
            if n:
                self._adaptor(r.engine_group).truncate(r.req_id, n)

    def _quarantine_engines(self, engines) -> None:
        """Failure containment: mark ``engines`` dead, re-carve the
        layout around them (``FleetLayout.quarantine``), and recover —
        priority first — every request whose KV owner span overlaps the
        blast radius. The victims are read off the same
        ``SchedulerDiagnostic`` snapshot the wedge error would show."""
        engines = set(engines) - self.quarantined
        if not engines:
            return
        snap = self._diagnostic()
        self.quarantined |= engines
        self.incidents.append({
            "t": self.now, "tick": self._tick, "kind": "quarantine",
            "engines": sorted(engines), "snapshot": snap})
        target = self._sanitize(self.layout)
        changed = self.layout.changed_engines(target) | engines
        rids = set(snap.running) | set(snap.paused) | {
            rid for isl in snap.islands for rid in isl["prefill"]}
        victims = []
        for rid in rids:
            r = self.pool.all[rid]
            if r.req_id in self._recovered_tick or r.engine_group < 0 \
                    or r.state == "done":
                continue
            t = self._tag(r)
            lead = (r.engine_group // t) * t
            if set(range(lead, lead + t)) & changed \
                    or r.engine_group in changed:
                victims.append(r)
        victims.sort(key=lambda r: (-r.priority, r.arrival))
        for r in victims:
            self._recover(r, "quarantine")
        if target != self.layout:
            # containment is mandatory: a sick engine inflating the
            # re-carve's duration must not roll back its own quarantine
            self._apply_switch(target, enforce_deadline=False)

    def _recover(self, r: Request, why: str) -> None:
        """Re-admit a request whose KV (or island) was lost: drop its
        blocks, fold the already-harvested output tokens into the
        prompt (SOFT-style re-prefill — generated tokens preserved),
        and requeue it at the head of the waiting line. The backend's
        ``recover_request`` hook reports how many generated tokens
        actually survived (an async engine's un-harvested ring dies
        with its island)."""
        hook = getattr(self.backend, "recover_request", None)
        kept = r.generated if hook is None else min(hook(r), r.generated)
        # a LIVE rebind leaves the blocks on the HOME adaptor while
        # engine_group tracks the new island lead — drop the entry
        # wherever it lives or the stale copy leaks past completion
        dropped = 0
        for a in self.adaptors:
            if r.req_id in a.table:
                dropped += a.drop_for_recompute(r.req_id)
        for lst in (self.running, self.paused, self.waiting):
            if r in lst:
                lst.remove(r)
        orig = r.prompt_len - r.folded
        r.prompt_len = orig + kept
        r.folded = kept
        r.generated = kept
        r.prefilled = 0
        r.engine_group = -1
        self._tok_cache.pop(r.req_id, None)
        self._recovered_tick.add(r.req_id)
        self.preempt_stats["recovered"] += 1
        self.preempt_stats["recomputed_tokens"] += dropped
        self.incidents.append({
            "t": self.now, "tick": self._tick, "kind": "recover",
            "req": r.req_id, "why": why, "kept_tokens": kept})
        if r.done:
            # every output token was already harvested: nothing to redo
            r.state = "done"
            if r.finish_t is None:
                r.finish_t = self.now
            return
        r.state = "queued"
        self.waiting.insert(0, r)

    def _diagnostic(self) -> SchedulerDiagnostic:
        islands = []
        for isl in self.layout.islands:
            dec = [r.req_id for r in self.running
                   if self.layout.island_of(r.engine_group) == isl]
            pre = [r.req_id for r in self.waiting
                   if r.engine_group >= 0
                   and self.layout.island_of(r.engine_group) == isl]
            islands.append({
                "span": f"[{isl.start},{isl.stop})",
                "shape": isl.describe(),
                "clock": self._clock.get(isl, 0.0),
                "decode": dec, "prefill": pre})
        return SchedulerDiagnostic(
            t=self.now, tick=self._tick,
            layout=self.layout.describe(),
            islands=tuple(islands),
            waiting=tuple(r.req_id for r in self.waiting),
            running=tuple(r.req_id for r in self.running),
            paused=tuple(r.req_id for r in self.paused),
            pool_free=tuple(len(a._free_set) for a in self.adaptors),
            preempt_stats=dict(self.preempt_stats),
            quarantined=tuple(sorted(self.quarantined)),
            health={f"[{i.start},{i.stop})": m
                    for i, m in self._health.items()},
            lifecycle=dict(self.lifecycle),
            incidents=tuple(self.incidents))

    def _log(self, phase: str) -> None:
        ps = self.prefix_cache.stats if self.prefix_cache is not None \
            else {}
        self.log.append(StepLog(
            t=self.now, merge=self.merge, phase=phase,
            n_running=len(self.running),
            n_queued=len(self.waiting) + self.pool.queue_depth(self.now),
            switched=self._switched_tick,
            islands=self.layout.shapes(),
            degraded=self._degraded_tick,
            prefix_hits=ps.get("hit_requests", 0),
            prefix_misses=ps.get("miss_requests", 0),
            prefix_evictions=ps.get("evictions", 0)))
        self._switched_tick = False
