"""Overload-hardened serving front door (docs/PERF.md §D11).

Continuous admission for the dynamic scheduler. Every request moves
through an explicit lifecycle

    QUEUED -> ADMITTED -> PREFILL -> DECODE -> {DONE, ABORTED,
                                                EXPIRED, SHED}

with per-tier SLO classes (priority / standard / background — a tier's
scheduler priority maps onto the §D7 island placement: priority admits
to the widest TP island, background to the narrowest), TTFT/TPOT
deadlines enforced by a per-tick sweep, client cancellation that
propagates into ``DynamicScheduler.abort`` (the transactional §D9
release path frees every KV block, §D10 shared-prefix refcounts
included; the backend retires the decode row without draining its
island), a bounded admission queue with tiered load shedding, and a
graceful drain that ends in a structured ``SchedulerDiagnostic`` JSON
artifact.

Shedding order under overload (cheapest exit first, hard refusal last):
  1. shed BACKGROUND-tier queued work, newest first;
  2. cap admitted context: stop feeding the scheduler once the
     admitted KV footprint crosses ``admit_ctx_frac`` of fleet pool
     capacity (or ``admit_cap`` requests) — arrivals wait in the
     bounded front-door queue instead of wedging the pool;
  3. reject-with-reason: an over-cap arrived backlog with nothing left
     to shed refuses its overflow outright — lowest tier first, newest
     first within a tier.

Overload therefore terminates in SHED / REJECTED / EXPIRED outcomes —
never a ``SchedulerWedged`` from resource exhaustion.
"""
from __future__ import annotations

import heapq
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.core.modes import Island
from repro_torch.core.scheduler import DynamicScheduler, SchedulerWedged
from repro_torch.core.task_pool import (PRIORITY_HIGH, PRIORITY_NORMAL,
                                  TERMINAL_STATES, Request)

# lifecycle states (the UPPER-CASE view ``state_of`` reports; terminal
# lower-case states live on Request.state itself)
QUEUED = "QUEUED"
ADMITTED = "ADMITTED"
PREFILL = "PREFILL"
DECODE = "DECODE"
DONE = "DONE"
ABORTED = "ABORTED"
EXPIRED = "EXPIRED"
SHED = "SHED"
REJECTED = "REJECTED"


@dataclass(frozen=True)
class SLOClass:
    """One service tier: a scheduler priority (island placement), its
    deadlines, and whether overload may shed it. ``ctx_frac``, when
    set, is a trunk-reservation ceiling: requests of this tier's
    priority AND BELOW may together hold at most this fraction of
    fleet KV capacity, so headroom stays reserved for higher tiers."""
    name: str
    priority: int = PRIORITY_NORMAL
    deadline_ttft: Optional[float] = None   # s from arrival to 1st token
    deadline_tpot: Optional[float] = None   # s per output token (avg)
    sheddable: bool = False
    ctx_frac: Optional[float] = None        # at-or-below-tier KV ceiling


DEFAULT_TIERS: Tuple[SLOClass, ...] = (
    SLOClass("priority", priority=PRIORITY_HIGH),
    SLOClass("standard"),
    SLOClass("background", sheddable=True),
)


@dataclass
class FrontDoorConfig:
    # bounded arrived-but-unadmitted backlog; overflow sheds background
    # first, then rejects the newest non-sheddable arrivals
    queue_cap: int = 512
    # admission ceilings: live requests inside the scheduler, and the
    # admitted KV footprint as a fraction of fleet pool capacity
    admit_cap: int = 0            # 0 = uncapped
    admit_ctx_frac: float = 0.9
    shed: bool = True             # tiered shedding + bounded queue
    enforce_deadlines: bool = True
    drain_grace: float = 120.0    # virtual s to drain in-flight work
    tiers: Tuple[SLOClass, ...] = DEFAULT_TIERS


class FrontDoor:
    """Continuous-admission wrapper around ``DynamicScheduler``."""

    def __init__(self, sched: DynamicScheduler,
                 cfg: Optional[FrontDoorConfig] = None):
        self.sched = sched
        self.cfg = cfg or FrontDoorConfig()
        self.tiers: Dict[str, SLOClass] = {t.name: t
                                           for t in self.cfg.tiers}
        self.requests: Dict[str, Request] = {}   # everything submitted
        self._queue: List[Request] = []          # accepted, unadmitted
        self.reject_reasons: Dict[str, str] = {}
        self.counters = {"submitted": 0, "admitted": 0, "rejected": 0}
        self._admission_open = True
        self._idle_spins = 0
        # arrival observation (§D13): a min-heap of accepted requests
        # keyed by arrival time, drained into the forecasting policy's
        # ``observe`` as the virtual clock reaches each timestamp —
        # never at submit time, or an offline trace (every request
        # submitted up front with future timestamps) would leak the
        # future into the forecast.
        self._observe_q: List[Tuple[float, int, Request]] = []
        self._observe_n = 0
        # admitted-context ceiling in tokens: the fleet's free pool at
        # construction (blocks x block capacity), scaled
        self._fleet_tokens = sum(a.free_blocks() * a.capacity
                                 for a in sched.adaptors)
        self._ctx_cap = self.cfg.admit_ctx_frac * self._fleet_tokens

    # -- intake --------------------------------------------------------
    def submit(self, req: Request, tier: Optional[str] = None) -> bool:
        """Accept or reject one request. The tier (``req.tier`` unless
        overridden) stamps scheduler priority and deadlines. Returns
        False — with the reason in ``reject_reasons`` — when admission
        is closed (draining) or the arrived backlog is already over the
        bounded queue's cap."""
        slo = self.tiers.get(tier or req.tier) \
            or SLOClass(tier or req.tier)
        req.tier = slo.name
        req.priority = slo.priority
        if req.deadline_ttft is None:
            req.deadline_ttft = slo.deadline_ttft
        if req.deadline_tpot is None:
            req.deadline_tpot = slo.deadline_tpot
        self.requests[req.req_id] = req
        self.counters["submitted"] += 1
        if getattr(getattr(self.sched, "policy", None),
                   "observe", None) is not None:
            # offered load, not admitted load: the forecast models the
            # arrival process itself, so shed/rejected requests count
            self._observe_n += 1
            heapq.heappush(self._observe_q,
                           (req.arrival, self._observe_n, req))
        if not self._admission_open:
            return self._reject(req, "draining")
        if self._kv_never_fits(req):
            # structural refusal (§D12): no reachable placement — not
            # even the widest merge, nor (with elastic SP) a fleet-wide
            # pure-SP island — can hold this context's KV. Queueing it
            # would wait forever; the client gets the reason instead.
            return self._reject(req, "kv_never_fits")
        self._queue.append(req)
        if self.cfg.shed:
            # tiered shed pass runs NOW so a high-tier arrival can
            # displace queued background work instead of being refused
            self._shed_backlog()
        return req.state not in TERMINAL_STATES

    def cancel(self, req_id: str, reason: str = "aborted") -> bool:
        """Client cancellation at any phase. Queued requests exit
        without ever touching the scheduler; admitted ones propagate
        into ``DynamicScheduler.abort`` (KV released transactionally,
        decode row retired, never resurrected)."""
        r = self.requests.get(req_id)
        if r is None or r.state in TERMINAL_STATES:
            return False
        if r in self._queue:
            self._queue.remove(r)
            r.state = reason
            r.finish_t = self.sched.now
            self.sched.lifecycle[reason] = \
                self.sched.lifecycle.get(reason, 0) + 1
            return True
        return self.sched.abort(req_id, reason)

    def _kv_never_fits(self, req: Request) -> bool:
        """Can the request's FULL context fit the fleet's best
        placement (§D12)? The widest merge pools ``cap(m)``-token
        blocks over one group's budget; with elastic SP enabled
        (``policy.sp``) the best placement is instead a fleet-wide
        pure-SP island — ``sp`` engines' pools at write tag 1 — and a
        long prompt ROUTES there (the UC3 policy carves the island)
        rather than being refused. Both the pool capacity and the
        backend's per-request block-table cap are checked; only a
        context beyond every reachable placement is structurally
        unservable."""
        sched = self.sched
        widest = sched.plan.valid_merges()[-1]
        ad = sched.adaptors[0]
        need = req.total_context()
        sp_on = bool(getattr(sched.policy, "sp", False))
        best = ad.max_context_tokens(widest)
        if sp_on:
            best = max(best, ad.max_context_tokens(widest, sp=widest))
        if need > best:
            return True
        fits = getattr(sched.backend, "request_fits", None)
        if fits is not None:
            ok = fits(req, widest)
            if not ok and sp_on:
                ok = fits(req, Island(0, widest, widest, sp=widest))
            if not ok:
                return True
        return False

    def _reject(self, req: Request, why: str) -> bool:
        req.state = "rejected"
        req.finish_t = self.sched.now
        self.reject_reasons[req.req_id] = why
        self.counters["rejected"] += 1
        return False

    # -- lifecycle view ------------------------------------------------
    def state_of(self, req_id: str) -> str:
        r = self.requests[req_id]
        if r.state in TERMINAL_STATES:
            return {"done": DONE, "aborted": ABORTED,
                    "expired": EXPIRED, "shed": SHED,
                    "rejected": REJECTED}[r.state]
        if r in self._queue:
            return QUEUED
        if r.prefilled >= r.prompt_len and r.prompt_len > 0:
            return DECODE
        if r.prefilled > 0:
            return PREFILL
        return ADMITTED

    def _observe_arrivals(self) -> None:
        """Feed newly-arrived requests to a forecasting policy (§D13:
        ``ForecastPolicy.observe``). Each request is observed exactly
        once, at the first tick whose clock covers its arrival — the
        same information a live front door would have."""
        observe = getattr(getattr(self.sched, "policy", None),
                          "observe", None)
        if observe is None or not self._observe_q:
            return
        now = self.sched.now
        while self._observe_q and self._observe_q[0][0] <= now:
            t, _, r = heapq.heappop(self._observe_q)
            observe(t, r.tier, r.total_context())

    # -- admission + shedding ------------------------------------------
    def _arrived(self) -> List[Request]:
        now = self.sched.now
        return [r for r in self._queue if r.arrival <= now]

    def _live_in_sched(self) -> List[Request]:
        return [r for r in self.sched.pool.all.values()
                if r.state not in TERMINAL_STATES]

    def _room(self, req: Request, live: List[Request],
              live_ctx: int) -> bool:
        if not self.cfg.shed:
            return True           # unprotected: feed everything through
        if self.cfg.admit_cap and len(live) >= self.cfg.admit_cap:
            return False
        if live_ctx + req.total_context() > self._ctx_cap:
            return False
        slo = self.tiers.get(req.tier, SLOClass(req.tier))
        if slo.ctx_frac is not None:
            # trunk reservation: this tier and everything below it may
            # not crowd out the headroom reserved for higher tiers
            below = sum(q.total_context() for q in live
                        if q.priority <= req.priority)
            if below + req.total_context() \
                    > slo.ctx_frac * self._fleet_tokens:
                return False
        return True

    def _admit(self) -> bool:
        """Move arrived queue entries into the scheduler, highest tier
        first, while the admitted-context cap has room."""
        if not self._queue:
            return False
        now = self.sched.now
        self._queue.sort(key=lambda r: (-r.priority, r.arrival))
        live = self._live_in_sched()
        live_ctx = sum(r.total_context() for r in live)
        moved = False
        for r in list(self._queue):
            if r.arrival > now:
                continue
            if not self._room(r, live, live_ctx):
                continue          # lower tiers may still be smaller
            self._queue.remove(r)
            r.admitted_t = now
            self.sched.submit(r)
            self.counters["admitted"] += 1
            live.append(r)
            live_ctx += r.total_context()
            moved = True
        return moved

    def _shed_backlog(self) -> None:
        """Tiered load shedding on the arrived backlog: background
        newest-first down to the queue cap, then reject the newest
        non-sheddable overflow (the reason clients see)."""
        if not self.cfg.shed:
            return
        over = len(self._arrived()) - self.cfg.queue_cap
        if over <= 0:
            return
        order = {id(r): i for i, r in enumerate(self._queue)}
        newest = sorted(self._arrived(),
                        key=lambda r: (r.arrival, order[id(r)]),
                        reverse=True)
        for r in newest:
            if over <= 0:
                return
            if self.tiers.get(r.tier, SLOClass(r.tier)).sheddable:
                self._queue.remove(r)
                r.state = "shed"
                r.finish_t = self.sched.now
                self.sched.lifecycle["shed"] += 1
                over -= 1
        # nothing sheddable left: refuse overflow outright, lowest
        # tier first, newest first within a tier
        for r in sorted((r for r in newest
                         if r.state not in TERMINAL_STATES),
                        key=lambda r: (r.priority, -order[id(r)])):
            if over <= 0:
                return
            self._queue.remove(r)
            self._reject(r, "queue_full")
            over -= 1

    # -- deadline + cancellation sweep ---------------------------------
    def _sweep(self) -> bool:
        """Per-tick lifecycle enforcement: scripted client cancels
        (always honored — they're client actions, not protection),
        then TTFT/TPOT deadline expiry when enforcement is on."""
        now = self.sched.now
        acted = False
        for r in list(self.requests.values()):
            if r.state in TERMINAL_STATES:
                continue
            if r.cancel_at is not None and now >= r.cancel_at:
                acted |= self.cancel(r.req_id, "aborted")
                continue
            if not self.cfg.enforce_deadlines:
                continue
            if r.deadline_ttft is not None:
                late = (r.first_token_t is None
                        and now > r.arrival + r.deadline_ttft) or \
                    (r.first_token_t is not None
                     and r.first_token_t - r.arrival > r.deadline_ttft)
                if late:
                    # no first token by the deadline — or it landed
                    # past it (a step can outrun the sweep): the
                    # stream is SLO-dead either way, free its capacity
                    acted |= self.cancel(r.req_id, "expired")
                    continue
            if r.deadline_tpot is not None \
                    and r.first_token_t is not None and r.generated > 1:
                last = r.token_times[-1] if r.token_times \
                    else r.first_token_t
                tpot = (last - r.first_token_t) / max(r.generated - 1, 1)
                if tpot > r.deadline_tpot:
                    acted |= self.cancel(r.req_id, "expired")
        self._shed_backlog()
        return acted

    # -- drive ---------------------------------------------------------
    def _next_event(self) -> Optional[float]:
        """Earliest future timestamp the loop must reach while idle:
        queue arrivals, scheduler-pool arrivals, scripted cancels,
        pending TTFT expiries (an expiry IS an event — it frees the
        slot a blocked admission waits on), and a forecasting policy's
        next scheduled action (§D13: a pre-bind AHEAD of a predicted
        burst must fire while the fleet is idle — exactly when no other
        event would wake the loop)."""
        now = self.sched.now
        cands: List[float] = []
        nxt = self.sched.pool.next_arrival()
        if nxt is not None:
            cands.append(nxt)
        hook = getattr(getattr(self.sched, "policy", None),
                       "next_action_t", None)
        if hook is not None:
            t = hook(now)
            if t is not None:
                cands.append(t)
        for r in self._queue:
            if r.arrival > now:
                cands.append(r.arrival)
            elif self.cfg.enforce_deadlines \
                    and r.deadline_ttft is not None:
                cands.append(r.arrival + r.deadline_ttft)
        for r in self.requests.values():
            if r.state in TERMINAL_STATES:
                continue
            if r.cancel_at is not None and r.cancel_at > now:
                cands.append(r.cancel_at)
        future = [c for c in cands if c > now + 1e-12]
        return min(future) if future else None

    def tick(self) -> bool:
        """One continuous-batching iteration — the unit every driver
        (offline ``run`` below, the §D13 ``AsyncServeLoop``) repeats:
        lifecycle sweep (scripted cancels, deadline expiry), admission
        from the bounded queue, one scheduler step, then a second sweep
        so tokens produced THIS tick are judged against their deadlines
        before the next tick's admissions. Returns whether the
        scheduler made progress."""
        self._observe_arrivals()
        self._sweep()
        self._admit()
        progressed = self.sched.step()
        self._sweep()
        return progressed

    def idle_advance(self) -> bool:
        """No-progress transition for one tick: advance the virtual
        clock to the next event (arrival, scripted cancel, pending
        TTFT expiry, forecast pre-bind), force-resume stranded paused
        requests, or raise the structured wedge after 64 fruitless
        spins. Returns False when fully drained."""
        sched = self.sched
        nxt = self._next_event()
        if sched.waiting or sched.running or sched.paused:
            if sched._seized:
                self._idle_spins = 0
                return True       # scripted pool fault window: tick on
            if sched.force_resume():
                self._idle_spins = 0
                return True
            if nxt is not None:
                sched.now = max(sched.now, nxt)
                return True
            self._idle_spins += 1
            if self._idle_spins > 64:
                raise SchedulerWedged(
                    f"front door wedged: {len(sched.waiting)} "
                    f"waiting, {len(sched.running)} running, "
                    f"{len(sched.paused)} paused and no future "
                    f"event (layout {sched.layout.describe()})",
                    sched._diagnostic())
            return True
        if nxt is None:
            return False          # fully drained
        sched.now = max(sched.now, nxt)
        return True

    def run(self, max_steps: int = 2_000_000,
            t_end: Optional[float] = None) -> None:
        """Serve until everything submitted reached a terminal state
        (or ``t_end``). Mirrors ``DynamicScheduler.run``'s idle logic —
        forced resume for stranded paused requests, structured wedge
        when nothing can progress — with the lifecycle sweep and
        admission control folded into every tick. Exhausting
        ``max_steps`` with live work raises ``SchedulerWedged`` (the
        cap is a livelock backstop, never a clean exit)."""
        sched = self.sched
        self._idle_spins = 0
        for _ in range(max_steps):
            progressed = self.tick()
            if t_end is not None and sched.now >= t_end:
                break
            if progressed:
                self._idle_spins = 0
                continue
            if not self.idle_advance():
                break
        else:
            raise SchedulerWedged(
                f"front door exhausted max_steps={max_steps} with work "
                f"still live: {len(sched.waiting)} waiting, "
                f"{len(sched.running)} running, {len(sched.paused)} "
                f"paused (layout {sched.layout.describe()})",
                sched._diagnostic())
        sched.drain_backend()

    # -- graceful shutdown ---------------------------------------------
    def shutdown(self, path: Optional[str] = None,
                 reason: str = "shutdown") -> Dict:
        """Graceful drain: stop admission (queued work exits as shed),
        serve in-flight requests for up to ``drain_grace`` virtual
        seconds, abort whatever remains, and emit the structured
        diagnostic artifact (written to ``path`` when given). On ranks
        every rank drains, in step; rank 0 alone writes ``path``."""
        self._admission_open = False
        for r in list(self._queue):
            self._queue.remove(r)
            r.state = "shed"
            r.finish_t = self.sched.now
            self.sched.lifecycle["shed"] += 1
        try:
            self.run(t_end=self.sched.now + self.cfg.drain_grace)
        except SchedulerWedged:
            pass                  # the diagnostic below records it all
        for r in self._live_in_sched():
            self.sched.abort(r.req_id, "aborted")
        diag = self.diagnostic(reason)
        if path is not None and not (dist.is_initialized()
                                     and dist.get_rank()):
            with open(path, "w") as f:
                json.dump(diag, f, indent=2, sort_keys=True, default=str)
                f.write("\n")
        return diag

    # -- observability -------------------------------------------------
    def diagnostic(self, reason: str = "snapshot") -> Dict:
        """The scheduler's structured diagnostic plus the front door's
        own accounting (per-tier lifecycle counts, queue state,
        rejection reasons)."""
        d = self.sched._diagnostic().to_dict()
        per_tier: Dict[str, Dict[str, int]] = {}
        for r in self.requests.values():
            t = per_tier.setdefault(r.tier, {})
            key = r.state if r.state in TERMINAL_STATES else "live"
            t[key] = t.get(key, 0) + 1
        d["frontdoor"] = {
            "reason": reason,
            "queued": len(self._queue),
            "counters": dict(self.counters),
            "lifecycle": dict(self.sched.lifecycle),
            "tiers": per_tier,
            "reject_reasons": dict(self.reject_reasons),
        }
        return d
