"""Global Task Pool (paper Fig. 3): arrivals land here; engines pull.

Requests carry the attributes the three use cases key on: priority
(use case 2), prompt/context length (use case 3), and arrival time
(use case 1 — load tracking)."""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional
from collections import deque

import numpy as np

PRIORITY_HIGH = 1
PRIORITY_NORMAL = 0

# terminal lifecycle states (§D11): once here, a request never re-enters
# any scheduler list — rollback/resume paths skip them, metrics close
# over them. 'done' is the only successful exit; the others record WHY
# the request left (client abort, deadline expiry, load shed, admission
# rejection).
TERMINAL_STATES = frozenset(
    {"done", "aborted", "expired", "shed", "rejected"})


@dataclass
class Request:
    req_id: str
    arrival: float
    prompt_len: int
    output_len: int
    priority: int = PRIORITY_NORMAL
    # 'auto' lets the policy pick; 'tp' forces a TP binding (paper Alg. 1:
    # req.mode = TP with req.num_engines)
    mode: str = "auto"
    num_engines: int = 1
    # shared-prefix workloads (§D10): requests drawn from the same
    # system-prompt pool carry the SAME prefix_seed, so their first
    # prefix_len prompt tokens are identical — the prefix cache's
    # content addressing finds them without any workload-level hints.
    prefix_seed: Optional[int] = None
    prefix_len: int = 0
    # SLO class (§D11): the front door maps tier names onto scheduler
    # priority (island placement) and per-tier deadlines. Deadlines are
    # RELATIVE: TTFT in seconds from arrival, TPOT in seconds per output
    # token (enforced on the running average). ``cancel_at`` scripts a
    # client cancellation at an absolute virtual time (workload replay).
    tier: str = "standard"
    deadline_ttft: Optional[float] = None
    deadline_tpot: Optional[float] = None
    cancel_at: Optional[float] = None

    # runtime bookkeeping
    state: str = "queued"  # queued|prefilling|running|paused|spec_dp|done
    engine_group: int = -1
    generated: int = 0
    prefilled: int = 0
    # fault recovery: tokens harvested before a quarantine/eviction and
    # folded into the prompt for re-prefill. The request's KV footprint
    # is prompt_len + output_len - folded (each folded token is BOTH the
    # tail of the recovery prompt and one already-produced output token,
    # so it occupies a single slot).
    folded: int = 0
    first_token_t: Optional[float] = None
    finish_t: Optional[float] = None
    sched_t: Optional[float] = None      # first scheduling (queue time)
    admitted_t: Optional[float] = None   # front-door admission (§D11)
    token_times: List[float] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.generated >= self.output_len

    def total_context(self) -> int:
        return self.prompt_len + self.output_len - self.folded


def prompt_token_ids(r: Request, vocab_size: int) -> np.ndarray:
    """Deterministic synthetic prompt for a request — the SINGLE source
    of prompt bytes for real backends and content hashing. Requests
    without a prefix regenerate exactly the seed-era stream (req_id
    seed); shared-prefix requests prepend ``prefix_len`` tokens drawn
    from ``prefix_seed`` so pool-mates share identical leading ids."""
    pl = min(max(int(r.prefix_len), 0), r.prompt_len) \
        if r.prefix_seed is not None else 0
    rng = np.random.default_rng(abs(hash(r.req_id)) % (1 << 31))
    body = rng.integers(0, vocab_size, size=r.prompt_len - pl)
    if not pl:
        return body
    prng = np.random.default_rng(int(r.prefix_seed) % (1 << 31))
    return np.concatenate([prng.integers(0, vocab_size, size=pl), body])


class TaskPool:
    """FIFO within priority class; high priority drains first."""

    def __init__(self):
        self._q: Deque[Request] = deque()
        self._hq: Deque[Request] = deque()
        self.all: Dict[str, Request] = {}
        self._ctr = itertools.count()

    def submit(self, req: Request) -> None:
        self.all[req.req_id] = req
        (self._hq if req.priority == PRIORITY_HIGH else self._q).append(req)

    def pull(self, now: float, k: int) -> List[Request]:
        """Step 1 — ProcessInputSocket(): requests that have arrived."""
        out: List[Request] = []
        for q in (self._hq, self._q):
            while q and len(out) < k and q[0].arrival <= now:
                out.append(q.popleft())
        return out

    def remove(self, req_id: str) -> bool:
        """Drop a not-yet-pulled request from the arrival queues (client
        cancellation before admission, §D11). The ``all`` index keeps
        the request so metrics and lifecycle accounting still see it."""
        for q in (self._hq, self._q):
            for r in q:
                if r.req_id == req_id:
                    q.remove(r)
                    return True
        return False

    def peek_arrived(self, now: float) -> List[Request]:
        return [r for r in itertools.chain(self._hq, self._q)
                if r.arrival <= now]

    def queue_depth(self, now: float) -> int:
        return len(self.peek_arrived(now))

    def next_arrival(self) -> Optional[float]:
        cands = [q[0].arrival for q in (self._hq, self._q) if q]
        return min(cands) if cands else None

    def empty(self) -> bool:
        return not self._q and not self._hq
