"""The followers of a multi-rank ``--serve`` fleet.

The port runs one process per rank, each with the same
``DynamicScheduler``, and the ranks agree only through collectives. Over
HTTP the inputs that are not deterministic (requests and their ids,
arrivals clamped to the wall, client disconnects, slow-consumer aborts,
the wall clock itself) reach rank 0 alone, whose ``AsyncServeLoop``
leads: before each action it broadcasts the inputs it recorded since the
last one, the action and a digest of its state.

``Follower.run`` is the loop of every other rank. It applies each
message's inputs in order to its own ``FrontDoor`` and scheduler through
the calls rank 0 made (``door.submit``, ``door.cancel``, the value of
``sched.now``), checks its digest against rank 0's, and takes the
action: ``tick``, ``idle_advance``, ``drain_backend``, ``shutdown``; a
heartbeat carries inputs and no action. After a tick or a drain it runs
the leader's stream pump without the streams: the terminal flush
(``generated_tokens``, which harvests over the world) of each request
that finished, in the leader's order, so that their collectives meet.
Which requests finished is the same on every rank; the pump's cancels
of slow consumers are not, and reach the followers with the next
message, before any other input or action (a cancel between two
harvests of the same flush changes no state but which tombstones the
engine still holds, and those only filter harvests). It reads no clock,
owns no socket and keeps no streams. A digest that differs raises
``RuntimeError`` naming the rank and the tick before the action, so an
input that diverged is caught before any collective of the tick it
would change.
"""
from __future__ import annotations

import hashlib
from typing import Dict

from repro_torch.core.task_pool import TERMINAL_STATES


def digest(door, ticks: int) -> Dict:
    """What every rank's state must agree on: the loop's ticks, the
    scheduler's clock, layout, switches and lifecycle counts, and every
    live request's lengths, arrival, priority, state, progress and group
    (hashed)."""
    sched = door.sched
    live = [(r.req_id, r.prompt_len, r.output_len, r.arrival, r.priority,
             r.state, r.generated, r.prefilled, r.engine_group)
            for r in door.requests.values()
            if r.state not in TERMINAL_STATES]
    return {"tick": ticks, "now": sched.now,
            "layout": sched.layout.describe(),
            "switches": sched.switches,
            "lifecycle": sorted(sched.lifecycle.items()),
            "requests": hashlib.blake2b(repr(live).encode(),
                                        digest_size=8).hexdigest()}


class Follower:
    """Replays rank 0's inputs on ranks 1..N-1, tick by tick."""

    def __init__(self, door, pool):
        self.door = door
        self.pool = pool
        # the leader's streams, in its order: the requests whose
        # terminal flush its pump has yet to make
        self.order: Dict[str, None] = {}
        self.ticks = 0
        self.actions: Dict[str, int] = {}   # messages taken, by action

    def run(self) -> None:
        """Follow until rank 0's shutdown has been drained here too."""
        door = self.door
        door._idle_spins = 0
        while True:
            action, inputs, want = self.pool.host_broadcast()
            self.actions[action] = self.actions.get(action, 0) + 1
            for ev in inputs:
                self._apply(ev)
            self._check(want)
            if action == "tick":
                if door.tick():
                    door._idle_spins = 0
                self.ticks += 1
                self._pump()
            elif action == "idle":
                door.idle_advance()
            elif action == "drain":
                door.sched.drain_backend()
                self._pump()
            elif action == "stop":
                door.shutdown()
            elif action == "end":
                return

    def _apply(self, ev) -> None:
        kind = ev[0]
        door = self.door
        if kind == "submit":
            _, req, tier = ev
            if door.submit(req, tier):
                self.order[req.req_id] = None
        elif kind == "cancel":
            door.cancel(ev[1], ev[2])
        elif kind == "now":
            door.sched.now = ev[1]
        elif kind == "overflow":
            for rid in ev[1]:
                door.cancel(rid, "aborted")

    def _pump(self) -> None:
        """The leader's stream pump without its streams: the same
        terminal flushes, in its order."""
        door = self.door
        flush = getattr(door.sched.backend, "generated_tokens", None)
        for rid in list(self.order):
            r = door.requests[rid]
            if r.state in TERMINAL_STATES:
                if flush is not None and r.state == "done":
                    flush(rid)
                del self.order[rid]

    def _check(self, want: Dict) -> None:
        got = digest(self.door, self.ticks)
        for key, value in want.items():
            if got[key] != value:
                raise RuntimeError(
                    f"rank {self.pool.rank} diverged from rank 0 at tick "
                    f"{want['tick']}: {key} is {got[key]!r}, rank 0's "
                    f"{value!r}")
