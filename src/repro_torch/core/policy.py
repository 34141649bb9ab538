"""Workload-aware layout policy (paper §2.3 / §3: the three use cases).

decide() returns the target FleetLayout for the next step:
  UC2 (priority): any high-priority request present -> carve a MINIMAL
      TP island wide enough for its latency SLO (paired with HARD
      preempt scoped to that island) — the paper's Fig. 3 picture: the
      rest of the fleet keeps serving DP traffic through the bind.
  UC3 (long context): a queued request whose context exceeds every live
      island's per-request KV capacity -> merge ONE island until it fits
      (pooled KV); probes the least-loaded group, not group 0. With
      ``sp=True`` (§D12) a context too large for even the WIDEST merge
      is admitted by carving a pure sequence-parallel island instead of
      staying queued forever: ``s`` engines each hold ``1/s`` of the
      tokens at write tag 1, so the per-request capacity scales with
      the island size rather than one engine's pool.
  UC1 (load): queue builds -> dissolve islands to DP in place to drain;
      idle -> merge the fleet wide for latency. Hysteresis avoids
      flapping.

``islands=False`` reproduces the seed-era uniform behavior (fleet-wide
merges with full HARD pauses) — kept as the ``flying`` baseline row in
benchmarks so table1 can quantify what partial rebinds buy.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.modes import FleetLayout
from repro_torch.core.task_pool import PRIORITY_HIGH


@dataclass
class FlyingPolicy:
    # 0 -> minimal TP binding: min(2, widest) engines per island (the
    # smallest nontrivial merge already clears the priority SLO on the
    # roofline, and a small island minimizes the background share the
    # first bind reshapes); uniform mode keeps the seed-era min(4,
    # widest) fleet-wide heuristic ("just enough for near-TP latency
    # while keeping several DP groups").
    priority_merge: int = 0
    dwell_s: float = 2.0           # min seconds between load-driven switches
    islands: bool = True           # False: uniform fleet-wide modes only
    # paired with the LIVE transition strategy (§D8): merge-UP rebinds
    # carry running decodes across for free, so the idle-time latency
    # pre-bind no longer needs the fleet to be empty — only merge-downs
    # (dissolve) still pause, and those keep the usual pressure gates.
    live: bool = False
    # elastic sequence parallelism (§D12): allow UC3 to carve pure-SP
    # islands for contexts no merge group's pool can hold. Requires a
    # backend whose step programs implement the SP write/lane variants
    # (the real engine); simulation backends model the cost directly.
    sp: bool = False

    def __post_init__(self):
        self._last_switch_t = -1e9
        self._priority_bound = False

    # ------------------------------------------------------------------
    def _least_loaded_lead(self, sched):
        """Least-loaded group lead (by running requests, then free
        blocks): the right adaptor to probe for UC3 — a long-context
        request only forces a merge when even the emptiest group cannot
        hold it (the seed-era probe of group 0 merged the fleet while
        another group had room)."""
        load = {lead: 0 for isl in sched.layout.islands
                for lead in isl.lead_engines()}
        for r in sched.running:
            if r.engine_group < 0:
                continue
            isl = sched.layout.island_of(r.engine_group)
            load[isl.group_of(r.engine_group)[0]] += 1
        return min(load, key=lambda g: (load[g],
                                        -sched._adaptor(g).free_blocks()))

    def _bind_island(self, sched, m: int, base=None) -> FleetLayout:
        """Carve an m-engine TP island at the least-disruptive aligned
        position: reuse an existing >=m binding when one is live (sticky
        — re-carving every tick would flap), otherwise pick the aligned
        region currently serving the fewest requests so the bind pauses
        as little background as possible (carving engine 0 regardless
        would reshape whatever happens to live there).  ``base`` lets a
        wrapping policy (ForecastPolicy §D13) carve into a target layout
        it already decided on, rather than the scheduler's current one."""
        layout = base if base is not None else sched.layout
        bg_live = any(r.priority == 0 for r in sched.running) or \
            any(r.priority == 0 for r in sched.waiting)
        for isl in layout.islands:
            if isl.merge < m or isl.sp > 1:
                # an SP island's merge is wide but its WRITE tag is
                # merge // sp — it serves pooled-KV contexts, not the
                # priority latency SLO a TP binding buys (§D12)
                continue
            # reuse a live >=m binding (sticky — re-carving every tick
            # would flap) UNLESS it spans the whole fleet while
            # background traffic needs DP islands: an idle-time
            # fleet-wide pre-bind must carve down, not absorb the fleet
            if isl.n_engines < layout.total_engines or not bg_live:
                return layout
        occ = [0] * layout.total_engines
        for r in sched.running + sched.waiting:
            if r.engine_group >= 0:
                isl = layout.island_of(r.engine_group)
                lead, gm = isl.group_of(r.engine_group)[:2]
                for e in range(lead, min(lead + gm, len(occ))):
                    occ[e] += 1
        start = min(range(0, layout.total_engines, m),
                    key=lambda s: (sum(occ[s:s + m]), s))
        return layout.carve(start, m, m)

    def _bind_sp_island(self, sched, s: int) -> FleetLayout:
        """Carve a pure sequence-parallel island (§D12): ``s`` engines,
        merge ``s``, SP degree ``s`` — every engine holds all KV heads
        (write tag 1) for ``1/s`` of the request's tokens, so the pooled
        per-request capacity is ``s x`` one engine's. Sticky like
        ``_bind_island``: reuse a live island whose SP pool is already
        at least as deep; otherwise carve the least-occupied aligned
        region so the bind reshapes as little background as possible."""
        layout = sched.layout
        for isl in layout.islands:
            if isl.sp >= s:
                return layout
        occ = [0] * layout.total_engines
        for r in sched.running + sched.waiting:
            if r.engine_group >= 0:
                isl = layout.island_of(r.engine_group)
                lead, gm = isl.group_of(r.engine_group)[:2]
                for e in range(lead, min(lead + gm, len(occ))):
                    occ[e] += 1
        # an SP ring must be whole: a quarantined tile inside the carve
        # would be sheared off by _sanitize and the island shattered, so
        # only aligned regions clear of dead engines are candidates
        quar = getattr(sched, "quarantined", frozenset())
        cands = [st for st in range(0, layout.total_engines, s)
                 if not any(e in quar for e in range(st, st + s))]
        if not cands:
            return layout    # no intact region: stay queued (structured)
        start = min(cands, key=lambda st: (sum(occ[st:st + s]), st))
        return layout.carve(start, s, s, sp=s)

    def decide(self, sched) -> FleetLayout:
        plan = sched.plan
        layout = sched.layout
        widest = plan.valid_merges()[-1]
        arrived = sched.waiting + sched.pool.peek_arrived(sched.now)
        running = sched.running

        # UC2: priority traffic -> a TP binding for latency (immediate,
        # no dwell). The paper binds a SUBSET of engines per priority
        # request (Fig. 3): carve a minimal island of `m` engines into a
        # TP group and leave the rest of the layout — and its in-flight
        # requests — untouched. (islands=False approximates with a
        # fleet-wide merge and a full HARD pause.)
        if any(r.priority == PRIORITY_HIGH and not r.done
               for r in arrived + running):
            self._priority_bound = True
            if not self.islands:
                return FleetLayout.uniform(
                    plan, self.priority_merge or min(4, widest))
            m = self.priority_merge or min(2, widest)
            return self._bind_island(sched, m)
        if self._priority_bound:
            # Flag_ResetTP: the priority queue drained. Uniform modes
            # must RELEASE the merge to restore DP throughput — paying
            # the full fleet pause again on the next priority arrival.
            # A bound island is free to hold: its DP neighbors never
            # paused, and the next priority request binds with zero
            # transition — so it stays warm until UC1 pressure below
            # dissolves it.
            self._priority_bound = False
            if not self.islands:
                self._last_switch_t = sched.now
                return FleetLayout.uniform(plan, 1)

        # UC3: long-context request that cannot fit at any live island
        lead = self._least_loaded_lead(sched)
        for r in arrived:
            need = r.total_context()
            if not sched._adaptor(lead).can_allocate(need):
                geom = sched.geom
                m = 1
                while m < widest and \
                        geom.capacity(m) * (geom.num_blocks - 1) < need:
                    m *= 2
                if self.sp and self.islands and \
                        geom.capacity(m) * (geom.num_blocks - 1) < need:
                    # no merge pools enough KV for this context: shard
                    # it by SEQUENCE instead (§D12) — a pure-SP island
                    # of s engines holds s x cap(1) x (nb-1) tokens
                    s = 1
                    while s < widest and \
                            s * geom.capacity(1) * (geom.num_blocks - 1) \
                            < need:
                        s *= 2
                    if s * geom.capacity(1) * (geom.num_blocks - 1) \
                            >= need:
                        return self._bind_sp_island(sched, s)
                    continue  # nothing in the fleet can hold it
                best = layout.max_merge
                if best >= m:
                    # a wide-enough island exists; if EVERY one of its
                    # groups' pools is full, grow the binding (pool
                    # pressure), else wait for the group with room
                    if any(sched._adaptor(g).can_allocate(need)
                           for isl in layout.islands if isl.merge >= m
                           for g in isl.lead_engines()):
                        return layout
                    m = min(best * 2, widest)
                if not self.islands:
                    return FleetLayout.uniform(plan, m)
                return self._bind_island(sched, m)

        # UC1: load adaptation with a time dwell (avoid flapping: each
        # switch pauses/reshapes in-flight state on the islands it
        # touches). Merge-UPS under the LIVE strategy carry in-flight
        # decodes across for free (§D8), so they skip the dwell;
        # merge-downs (dissolve) still pause their tagged requests and
        # keep the full hysteresis.
        depth = len([r for r in arrived if r.state == "queued"])
        target = layout
        if depth >= max(2 * layout.n_groups, 4):
            # drain mode: dissolve TP islands to DP IN PLACE (already-DP
            # islands keep their boundaries — and their windows)
            target = layout.dissolved()
        elif depth == 0 and not running and not sched.paused \
                and not self.live:
            # fully idle: pre-bind a wide TP group so the next arrival
            # gets TP latency (nothing is live, so the fleet-wide
            # reshape pauses no one). Under LIVE the pre-bind is
            # pointless: binding up WHEN the latency request arrives is
            # free (in-flight work rides across), while an anticipatory
            # wide bind tags everything admitted meanwhile with a wide
            # mode that the next dissolve must pause.
            target = FleetLayout.uniform(plan, widest)
        if target == layout:
            return layout
        up = all(target.island_of(e).group_of(e)[1]
                 >= layout.island_of(e).group_of(e)[1]
                 for e in layout.changed_engines(target))
        if sched.now - self._last_switch_t < self.dwell_s \
                and not (self.live and up):
            return layout
        self._last_switch_t = sched.now
        return target


# ---------------------------------------------------------------------------
# §D13: predictive rebind — forecast the arrival process, bind EARLY
# ---------------------------------------------------------------------------

@dataclass
class TierForecast:
    """Holt-style (level + trend) arrival-intensity estimator on an
    irregular event stream, plus an EWMA of per-request context length.

    The level is an exponentially-decayed arrival counter: each arrival
    adds ``1/tau`` and the whole estimate decays with time constant
    ``tau``, so at steady state a Poisson stream of rate λ settles the
    estimate at λ (the classic shot-noise intensity estimator — no
    binning, O(1) per event).  The trend term is an EWMA of the level's
    finite differences, letting ``forecast()`` extrapolate a ramp
    ``horizon`` seconds out instead of only reporting the present.
    """
    tau: float = 4.0        # intensity decay time constant (seconds)
    trend_tau: float = 8.0  # trend smoothing time constant (seconds)
    ctx_alpha: float = 0.1  # context-length EWMA step (per event)

    def __post_init__(self):
        self.lam = 0.0        # arrivals/sec level
        self.trend = 0.0      # d(lam)/dt
        self.ctx = 0.0        # smoothed total_context per request
        self.n = 0            # events observed
        self.last_t = None

    def observe(self, t: float, ctx: int = 0) -> None:
        if self.last_t is None:
            self.last_t = t
        dt = max(t - self.last_t, 0.0)
        decayed = self.lam * math.exp(-dt / self.tau)
        new_lam = decayed + 1.0 / self.tau
        if dt > 0.0:
            a = 1.0 - math.exp(-dt / self.trend_tau)
            self.trend += a * ((new_lam - self.lam) / dt - self.trend)
        self.lam, self.last_t = new_lam, t
        if ctx > 0:
            self.n += 1
            # seed the EWMA with the first sample (else it drags at 0)
            step = 1.0 if self.n == 1 else self.ctx_alpha
            self.ctx += step * (ctx - self.ctx)

    def rate(self, now: float) -> float:
        """Current intensity estimate (decayed to ``now``)."""
        if self.last_t is None:
            return 0.0
        return self.lam * math.exp(-max(now - self.last_t, 0.0) / self.tau)

    def forecast(self, now: float, horizon: float = 0.0) -> float:
        """Holt extrapolation ``horizon`` seconds past ``now``."""
        return max(self.rate(now) + self.trend * horizon, 0.0)


@dataclass
class ForecastPolicy:
    """Predictive layer over :class:`FlyingPolicy` (§D13).

    The inner policy is purely REACTIVE: it carves a priority TP island
    only once a priority request is already sitting in the queue — that
    first request eats the transition latency.  This wrapper watches the
    offered arrival stream (``FrontDoor.submit`` feeds ``observe``),
    keeps a per-tier :class:`TierForecast`, and asks the inner policy to
    pre-carve the island when either

      * the Holt forecast of the priority arrival rate ``horizon_s``
        ahead crosses ``bind_rate`` (ramp detection), or
      * a learned burst period predicts the next onset within ``lead_s``
        (scripted / periodic traffic: fig8's square-wave bursts).

    Hysteresis: once triggered, the bind is held for ``hold_s`` past the
    last above-threshold evaluation so estimator jitter around the
    threshold cannot thrash the fleet; the inner policy's stickiness
    (reuse a live >=m island) makes repeat decisions free.

    ``next_action_t`` exposes the predicted pre-bind instant so an
    event-driven idle loop (FrontDoor/_next_event, AsyncServeLoop) wakes
    up IN TIME to carve the island before the burst lands rather than
    discovering it on the next arrival.
    """
    inner: FlyingPolicy = None
    horizon_s: float = 1.0     # how far ahead decide() extrapolates
    lead_s: float = 0.75       # pre-bind this early before a predicted onset
    bind_rate: float = 1.5     # priority arrivals/sec that warrant a bind
    hold_s: float = 4.0        # hysteresis hold after the signal drops
    tau_s: float = 2.0         # intensity estimator time constant
    periodic: bool = True      # learn onset periodicity (scripted bursts)
    priority_tiers: tuple = ("priority",)

    def __post_init__(self):
        if self.inner is None:
            self.inner = FlyingPolicy()
        self.tiers = {}
        self._active_until = -1e18
        self._above = False         # onset edge-detector state
        self._last_onset = None
        self._period = None         # EWMA onset-to-onset interval
        self._n_onsets = 0
        self.stats = {"prebinds": 0, "forecast_binds": 0,
                      "onsets": 0, "releases": 0}

    # -- passthrough: scheduler/frontdoor introspect these on the policy
    @property
    def sp(self):
        return self.inner.sp

    @property
    def live(self):
        return self.inner.live

    @property
    def islands(self):
        return self.inner.islands

    # ------------------------------------------------------------------
    def _tier(self, tier: str) -> TierForecast:
        tf = self.tiers.get(tier)
        if tf is None:
            tf = self.tiers[tier] = TierForecast(tau=self.tau_s)
        return tf

    def observe(self, t: float, tier: str, ctx: int = 0) -> None:
        """One offered arrival (called by FrontDoor when the virtual
        clock reaches the request's arrival time — never at submit time,
        which would leak future arrivals of a pre-scripted trace)."""
        tf = self._tier(tier)
        tf.observe(t, ctx)
        if tier not in self.priority_tiers or not self.periodic:
            return
        # onset edge-detection with a low/high water band so a single
        # straggler arrival mid-gap cannot register a spurious onset
        r = tf.rate(t)
        if not self._above and r >= self.bind_rate:
            self._above = True
            self.stats["onsets"] += 1
            if self._last_onset is not None:
                gap = t - self._last_onset
                if self._period is None:
                    self._period = gap
                    self._n_onsets = 1
                elif abs(gap - self._period) <= 0.5 * self._period:
                    self._period += 0.3 * (gap - self._period)
                    self._n_onsets += 1
                else:       # pattern broke: restart the learner
                    self._period, self._n_onsets = gap, 1
            self._last_onset = t
        elif self._above and r < 0.5 * self.bind_rate:
            self._above = False

    # ------------------------------------------------------------------
    def _predicted_onset(self, now: float):
        """Next predicted burst onset, or None when the learner has not
        converged (needs >=2 consistent intervals) or the pattern broke
        (the expected onset came and went with no burst)."""
        if not self.periodic or self._period is None \
                or self._n_onsets < 2 or self._last_onset is None:
            return None
        t = self._last_onset + self._period
        if now > t + 0.5 * self._period:
            return None
        return t

    def next_action_t(self, now: float):
        """Wake-up instant for event-driven loops: the moment the fleet
        should pre-bind for the next predicted burst."""
        on = self._predicted_onset(now)
        if on is None:
            return None
        t = on - self.lead_s
        return t if t > now + 1e-9 else None

    def _want_bind(self, now: float) -> bool:
        hot = False
        for tier in self.priority_tiers:
            tf = self.tiers.get(tier)
            if tf is not None and \
                    tf.forecast(now, self.horizon_s) >= self.bind_rate:
                hot = True
                break
        on = self._predicted_onset(now)
        if on is not None and now >= on - self.lead_s:
            hot = True
        if hot:
            self._active_until = now + self.hold_s
            return True
        return now < self._active_until

    def _bind_merge(self, sched) -> int:
        """Island width for the pre-bind: the inner policy's priority
        merge, widened while the forecasted priority context would not
        fit one group's KV pool (the UC3 capacity rule, driven by the
        context-length forecast instead of a queued request)."""
        widest = sched.plan.valid_merges()[-1]
        m = self.inner.priority_merge or min(2, widest)
        ctx = 0.0
        for tier in self.priority_tiers:
            tf = self.tiers.get(tier)
            if tf is not None:
                ctx = max(ctx, tf.ctx)
        geom = sched.geom
        while m < widest and \
                geom.capacity(m) * (geom.num_blocks - 1) < ctx:
            m *= 2
        return m

    @staticmethod
    def _has_island(layout, m: int) -> bool:
        return any(isl.merge >= m and isl.sp == 1
                   for isl in layout.islands)

    def _priority_live(self, sched) -> bool:
        arrived = sched.waiting + sched.pool.peek_arrived(sched.now)
        return any(r.priority == PRIORITY_HIGH and not r.done
                   for r in arrived + sched.running)

    def _maybe_release(self, sched, target):
        """Forecast-driven RELEASE: the estimator went cold (past the
        hysteresis hold), so an idle priority TP island is dissolved to
        give its engines back to DP throughput — the inner policy would
        hold it warm forever (stickiness), which is right reactively
        but wrong when the forecast knows the next burst is a predicted
        onset away (the pre-bind will re-carve it in time)."""
        if target != sched.layout:
            return target      # never second-guess an inner transition
        if not any(t in self.tiers for t in self.priority_tiers):
            return target      # no priority traffic ever observed
        live = sched.running + sched.waiting + list(sched.paused)
        if not live and not sched.pool.peek_arrived(sched.now):
            # fully idle fleet: keeping the island is free, and the
            # inner policy's idle-time wide pre-bind must not be fought
            return target
        occ: set = set()
        for r in live:
            if r.engine_group >= 0:
                isl = target.island_of(r.engine_group)
                lead, gm = isl.group_of(r.engine_group)[:2]
                occ.update(range(lead, lead + gm))
        for isl in target.islands:
            if isl.merge >= 2 and isl.sp == 1 \
                    and not occ.intersection(isl.engines()):
                self.stats["releases"] += 1
                return target.carve(isl.start, isl.n_engines, 1)
        return target

    def decide(self, sched) -> FleetLayout:
        target = self.inner.decide(sched)
        now = sched.now
        if not self.inner.islands:
            return target
        if not self._want_bind(now):
            return self._maybe_release(sched, target)
        m = self._bind_merge(sched)
        out = target
        if not self._has_island(target, m):
            # carve INTO the reactive target (not the current layout):
            # if UC1 queue pressure just dissolved the fleet, the
            # pre-bind rides on top of the dissolve, not against it
            out = self.inner._bind_island(sched, m, base=target)
            if out != target:
                self.stats["forecast_binds"] += 1
        if self._has_island(out, m) \
                and not self._has_island(sched.layout, m) \
                and not self._priority_live(sched):
            # the payoff case: the fleet gains a priority-capable
            # island while NO priority request exists yet — the next
            # burst lands warm (whether the forecast carved it or
            # adopted the inner policy's wide target at the wake tick)
            self.stats["prebinds"] += 1
        return out
