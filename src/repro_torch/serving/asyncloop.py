"""Event-driven async serving core (§D13).

``AsyncServeLoop`` lifts the front door's continuous-batching tick
(``FrontDoor.tick`` / ``idle_advance``) onto an asyncio event loop so
requests can arrive AT ANY TIME — from the HTTP server, the load
generator, or a test — instead of being scripted into an offline trace.
The loop owns exactly one coroutine that repeats:

    tick (sweep -> admit -> scheduler step -> sweep)  ->  pump streams

and parks on an ``asyncio.Event`` whenever the fleet is fully drained,
so an idle server burns no CPU.  Every submission gets a
:class:`TokenStream` — a bounded ``asyncio.Queue`` of token events the
client consumes with ``async for``.  The bound is the backpressure
contract: a consumer that stops reading fills its queue, at which point
the loop ABORTS the request through the existing lifecycle
(``FrontDoor.cancel`` -> ``DynamicScheduler.abort`` -> transactional KV
release) rather than buffering without limit or stalling other streams.
Client disconnects take the same path via :meth:`AsyncServeLoop.abort`.

Two pacing modes:

* ``pace="virtual"`` — never sleeps; the virtual clock free-runs exactly
  like the offline ``FrontDoor.run`` loop (idle gaps are jumped, not
  waited out).  This is the benchmark/saturation mode: the async path
  must stay within 1.1x of offline throughput on the same trace, and it
  can, because the per-tick machinery is byte-identical — only the
  stream pump and a cooperative yield ride on top.
* ``pace="wall"`` — the virtual clock tracks wall time: each tick first
  advances ``sched.now`` to the wall-elapsed instant, and whenever the
  simulated clock runs AHEAD of the wall the loop sleeps the difference,
  so streamed tokens reach clients at the simulated rate.  This is the
  interactive HTTP mode (sim backends serve in "real time"; the real
  engine's steps consume wall time anyway).

Token identity (§D13 contract): with a real engine backend the stream
carries the tokens the engine actually harvested (non-draining
``harvested_tokens`` peek per tick, ``generated_tokens`` flush at the
terminal state), so under greedy decoding the streamed sequence is
identical to what the offline path reads back after ``run()``.  Sim
backends model cost, not content — the stream synthesizes a
DETERMINISTIC token id per (request, index) so the identity property is
still testable end-to-end over HTTP.
"""
from __future__ import annotations

import asyncio
from typing import Dict, List, Optional, Tuple

from repro_torch.core.task_pool import TERMINAL_STATES, Request
from repro_torch.serving.frontdoor import FrontDoor
from repro_torch.serving.metrics import RollingTierMetrics

# sim backends carry no token content: synthesize a deterministic id
# per (req_id, index) — a pure function, so any two runs of any driver
# (offline, async, HTTP) agree on every stream byte
_FNV_OFF, _FNV_PRIME, _SYNTH_VOCAB = 0xcbf29ce484222325, 0x100000001b3, 50257


def synth_token(req_id: str, index: int) -> int:
    h = _FNV_OFF
    for ch in req_id:
        h = ((h ^ ord(ch)) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    h = ((h ^ (index + 1)) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return int(h % _SYNTH_VOCAB)


_EOS = object()     # terminal sentinel queued by finalize()


class TokenStream:
    """Bounded per-request token stream.

    Events are ``("token", index, token_id, t)`` tuples; iteration ends
    when the request reaches a terminal lifecycle state (``final_state``
    then holds it, ``reason`` any rejection reason).  ``overflowed`` is
    set when the consumer fell behind and the loop aborted the request.
    The queue NEVER blocks the serve loop: ``push`` refuses once
    ``maxsize`` token events are buffered and a refused push is the
    abort signal, so one dead client cannot stall the tick that every
    other stream rides on.

    The terminal transition is delivered IN-BAND: ``finalize`` enqueues
    a sentinel after the buffered tokens (the underlying queue is
    unbounded so the sentinel always fits — the bound applies to token
    events only), which keeps the consumer's wait a single
    ``queue.get()`` — this loop serves thousands of streams, and a
    per-token ``asyncio.wait`` race against a close-event would
    dominate the §D13 saturation budget.
    """

    def __init__(self, req_id: str, maxsize: int = 256):
        self.req_id = req_id
        self.maxsize = maxsize
        self.q: asyncio.Queue = asyncio.Queue()
        self.final_state: Optional[str] = None
        self.reason: Optional[str] = None
        self.overflowed = False
        self._closed = False

    # -- producer side (serve loop) ------------------------------------
    def push(self, ev: Tuple) -> bool:
        if self.q.qsize() >= self.maxsize:
            return False
        self.q.put_nowait(ev)
        return True

    def finalize(self, state: str, reason: Optional[str] = None) -> None:
        if self._closed:
            return
        self.final_state = state
        self.reason = reason
        self._closed = True
        self.q.put_nowait(_EOS)

    @property
    def closed(self) -> bool:
        return self._closed

    # -- consumer side -------------------------------------------------
    def __aiter__(self):
        return self

    async def __anext__(self):
        ev = await self.q.get()
        if ev is _EOS:
            # re-queue so a second iteration terminates too instead of
            # hanging on an empty queue
            self.q.put_nowait(_EOS)
            raise StopAsyncIteration
        return ev

    async def collect(self) -> List[int]:
        """Consume the whole stream, returning the token ids in order."""
        return [ev[2] async for ev in self]


class AsyncServeLoop:
    """The always-on continuous-batching driver (§D13)."""

    def __init__(self, door: FrontDoor, *, pace: str = "virtual",
                 stream_buf: int = 256, wall_dilation: float = 1.0,
                 rolling: Optional[RollingTierMetrics] = None):
        assert pace in ("virtual", "wall"), pace
        self.door = door
        self.pace = pace
        self.stream_buf = stream_buf
        self.wall_dilation = wall_dilation  # virtual s per wall s scale
        self.rolling = rolling or RollingTierMetrics()
        self.streams: Dict[str, TokenStream] = {}
        self._seen: Dict[str, int] = {}     # req_id -> events emitted
        self._wake = asyncio.Event()
        self._stopping = False
        self._task: Optional[asyncio.Task] = None
        self._t0: Optional[float] = None    # wall anchor for pace="wall"
        self.ticks = 0

    # -- client API ----------------------------------------------------
    def submit(self, req: Request, tier: Optional[str] = None) -> TokenStream:
        """Submit a request, receiving its token stream. Arrivals in
        the past clamp to the current clock (a live client cannot have
        arrived before now); future arrivals (trace replay in virtual
        pace) are honored — the front door holds them until the clock
        gets there."""
        req.arrival = max(req.arrival, self._now())
        st = TokenStream(req.req_id, maxsize=self.stream_buf)
        self.streams[req.req_id] = st
        ok = self.door.submit(req, tier)
        if not ok:
            # rejected/shed at the door: terminal before the first tick
            self._finalize(req, st)
        self._wake.set()
        return st

    def abort(self, req_id: str, reason: str = "aborted") -> bool:
        """Client disconnect / explicit cancel: propagates into the
        lifecycle (KV released transactionally); the stream finalizes
        on the next pump."""
        out = self.door.cancel(req_id, reason)
        self._wake.set()
        return out

    async def start(self) -> None:
        self._task = asyncio.ensure_future(self.run())

    async def stop(self) -> None:
        """Stop the loop (in-flight work is left to ``door.shutdown``
        for a graceful drain — stopping is not draining)."""
        self._stopping = True
        self._wake.set()
        if self._task is not None:
            await self._task
            self._task = None

    # -- clock ---------------------------------------------------------
    def _now(self) -> float:
        if self.pace == "wall" and self._t0 is not None:
            return max(self.door.sched.now, self._wall_virt())
        return self.door.sched.now

    def _wall_virt(self) -> float:
        loop = asyncio.get_event_loop()
        return (loop.time() - self._t0) * self.wall_dilation

    # -- engine --------------------------------------------------------
    async def run(self) -> None:
        """The serve coroutine: tick while there is work, pump token
        streams after every tick, park on the wake event when drained.
        Mirrors ``FrontDoor.run``'s idle machinery exactly — the §D13
        saturation contract depends on this loop adding nothing but the
        stream pump to the offline path."""
        door, sched = self.door, self.door.sched
        if self.pace == "wall" and self._t0 is None:
            self._t0 = asyncio.get_event_loop().time() \
                - sched.now / self.wall_dilation
        door._idle_spins = 0
        while not self._stopping:
            if self.pace == "wall":
                sched.now = max(sched.now, self._wall_virt())
            progressed = door.tick()
            self.ticks += 1
            self._pump()
            if progressed:
                door._idle_spins = 0
                if self.pace == "wall":
                    ahead = sched.now - self._wall_virt()
                    if ahead > 1e-4:
                        # simulated clock outran the wall: pace token
                        # delivery to simulated time
                        await asyncio.sleep(ahead / self.wall_dilation)
                    else:
                        await asyncio.sleep(0)
                else:
                    await asyncio.sleep(0)   # cooperative yield
                continue
            # no progress: idle machinery (clock jump / forced resume /
            # structured wedge) or park until something arrives
            if self.pace == "wall":
                nxt = door._next_event()
                has_live = sched.waiting or sched.running or sched.paused
                if nxt is None and not has_live:
                    await self._park(None)
                    continue
                if nxt is not None:
                    delay = (nxt - self._wall_virt()) / self.wall_dilation
                    if delay > 1e-4:
                        await self._park(delay)
                        sched.now = max(sched.now, self._wall_virt())
                        continue
                if not door.idle_advance():
                    await self._park(None)
            else:
                if not door.idle_advance():
                    await self._park(None)
                else:
                    await asyncio.sleep(0)
        sched.drain_backend()
        self._pump()

    async def _park(self, timeout: Optional[float]) -> None:
        """Sleep until woken (new submission, abort, stop) or timeout."""
        try:
            await asyncio.wait_for(self._wake.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self._wake.clear()

    # -- stream pump ---------------------------------------------------
    def _token_ids(self, r: Request, lo: int, hi: int) -> List[int]:
        """Token ids for stream indices [lo, hi): real harvested tokens
        when the backend surfaces content, deterministic synthetic ids
        otherwise. May return FEWER than hi-lo ids on a real engine
        whose in-flight window hasn't harvested the tail yet — those
        stream on a later pump (or at the terminal flush)."""
        backend = self.door.sched.backend
        peek = getattr(backend, "harvested_tokens", None)
        if peek is None:
            return [synth_token(r.req_id, i) for i in range(lo, hi)]
        return list(peek(r.req_id)[lo:hi])

    def _finalize(self, r: Request, st: TokenStream) -> None:
        backend = self.door.sched.backend
        flush = getattr(backend, "generated_tokens", None)
        if flush is not None and r.state == "done":
            # terminal flush: drain the in-flight window so the stream
            # carries every token the offline path would read back
            toks = flush(r.req_id)
            lo = self._seen.get(r.req_id, 0)
            for i, tok in enumerate(toks[lo:], start=lo):
                if not st.push(("token", i, tok, self.door.sched.now)):
                    break
        st.finalize(r.state, self.door.reject_reasons.get(r.req_id))
        self.streams.pop(r.req_id, None)
        self._seen.pop(r.req_id, None)
        self.rolling.note_request(r)

    def _pump(self) -> None:
        """Emit newly generated tokens into every live stream; abort
        slow consumers whose bounded queue is full; finalize terminal
        requests. O(live streams) per tick."""
        now = self.door.sched.now
        by_tier: Dict[str, int] = {}
        for rid, st in list(self.streams.items()):
            r = self.door.requests.get(rid)
            if r is None:
                continue
            seen = self._seen.get(rid, 0)
            if r.generated > seen:
                ids = self._token_ids(r, seen, r.generated)
                pushed = 0
                for i, tok in enumerate(ids, start=seen):
                    if st.push(("token", i, tok, now)):
                        pushed += 1
                    else:
                        # backpressure contract: bounded buffer is full
                        # -> the request exits ABORTED through the
                        # normal lifecycle, KV released, other streams
                        # untouched. Tokens already queued stay
                        # readable; nothing more is produced or kept.
                        st.overflowed = True
                        self.door.cancel(rid, "aborted")
                        break
                by_tier[r.tier] = by_tier.get(r.tier, 0) + pushed
                # advance by what actually streamed: a real engine's
                # in-flight window may harvest fewer ids than
                # r.generated (they stream on a later pump), and an
                # overflowed stream never re-emits (it is aborted)
                self._seen[rid] = seen + pushed
            if r.state in TERMINAL_STATES:
                self._finalize(r, st)
        for tier, n in by_tier.items():
            self.rolling.note_tokens(now, tier, n)

    # -- observability -------------------------------------------------
    def metrics(self) -> Dict:
        """Live metrics snapshot for the /metrics endpoint."""
        sched = self.door.sched
        out = {
            "now": sched.now,
            "ticks": self.ticks,
            "layout": sched.layout.describe(),
            "live_streams": len(self.streams),
            "queued": len(self.door._queue),
            "waiting": len(sched.waiting),
            "running": len(sched.running),
            "paused": len(sched.paused),
            "counters": dict(self.door.counters),
            "lifecycle": dict(sched.lifecycle),
            "tiers": self.rolling.report(sched.now),
        }
        pol = getattr(sched, "policy", None)
        stats = getattr(pol, "stats", None)
        if stats:
            out["forecast"] = dict(stats)
        return out
