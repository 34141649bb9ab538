"""Streaming-inference metrics (paper §6.1.4): TTFT, TPOT, ILT, queue
time, peak generation throughput — plus the per-tier SLO report the
front door's lifecycle accounting feeds (§D11: p50/p99 per tier,
lifecycle counters, goodput = met-SLO completions / admitted)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.core.task_pool import PRIORITY_HIGH, Request


@dataclass
class Summary:
    mean_ttft: float
    p90_ttft: float
    mean_queue: float
    p90_queue: float
    median_tpot: float
    mean_ilt: float
    peak_throughput: float
    total_tokens: int
    makespan: float

    def row(self) -> Dict[str, float]:
        return self.__dict__.copy()


def summarize(reqs: Sequence[Request], *, window: float = 5.0,
              priority_only: bool = False) -> Summary:
    # terminal non-done exits (§D11: aborted/expired/shed) carry a
    # finish_t too — only completions count toward serving metrics
    done = [r for r in reqs if r.finish_t is not None
            and r.state == "done"]
    if priority_only:
        done = [r for r in done if r.priority == PRIORITY_HIGH]
    if not done:
        return Summary(*([float("nan")] * 7), 0, 0.0)
    ttft = np.array([r.first_token_t - r.arrival for r in done])
    queue = np.array([(r.sched_t or r.first_token_t) - r.arrival
                      for r in done])
    tpots, ilts = [], []
    events: List[float] = []
    for r in done:
        events.extend(r.token_times)
        if len(r.token_times) > 1:
            its = np.diff(np.array(r.token_times))
            ilts.append(float(np.mean(its)))
            tpots.append(float((r.finish_t - r.first_token_t)
                               / max(r.generated - 1, 1)))
    ev = np.sort(np.array(events))
    peak = 0.0
    if len(ev) > 1:
        j = 0
        for i in range(len(ev)):
            while ev[i] - ev[j] > window:
                j += 1
            peak = max(peak, (i - j + 1) / window)
    makespan = max(r.finish_t for r in done) - min(r.arrival for r in done)
    return Summary(
        mean_ttft=float(np.mean(ttft)),
        p90_ttft=float(np.percentile(ttft, 90)),
        mean_queue=float(np.mean(queue)),
        p90_queue=float(np.percentile(queue, 90)),
        median_tpot=float(np.median(tpots)) if tpots else float("nan"),
        mean_ilt=float(np.mean(ilts)) if ilts else float("nan"),
        peak_throughput=peak,
        total_tokens=int(sum(r.generated for r in done)),
        makespan=float(makespan),
    )


def met_slo(r: Request) -> bool:
    """Did a COMPLETED request meet every deadline its tier set? The
    goodput numerator (§D11). Unset deadlines don't constrain."""
    if r.state != "done" or r.first_token_t is None:
        return False
    if r.deadline_ttft is not None \
            and r.first_token_t - r.arrival > r.deadline_ttft:
        return False
    if r.deadline_tpot is not None and r.generated > 1:
        tpot = (r.finish_t - r.first_token_t) / max(r.generated - 1, 1)
        if tpot > r.deadline_tpot:
            return False
    return True


def _pct(vals: List[float], q: float) -> float:
    return float(np.percentile(np.array(vals), q)) if vals \
        else float("nan")


def tier_report(reqs: Sequence[Request]) -> Dict[str, Dict]:
    """Per-tier lifecycle + latency report (§D11): p50/p99 TTFT and
    TPOT over completions, terminal-state counters, and goodput
    (done-within-SLO / admitted — requests the front door let into the
    scheduler, whatever their fate)."""
    out: Dict[str, Dict] = {}
    for tier in sorted({r.tier for r in reqs}):
        rs = [r for r in reqs if r.tier == tier]
        done = [r for r in rs if r.state == "done"
                and r.first_token_t is not None]
        ttft = [r.first_token_t - r.arrival for r in done]
        tpot = [(r.finish_t - r.first_token_t) / max(r.generated - 1, 1)
                for r in done if r.generated > 1]
        admitted = [r for r in rs if r.admitted_t is not None]
        met = sum(1 for r in done if met_slo(r))
        out[tier] = {
            "n": len(rs),
            "admitted": len(admitted),
            "done": len(done),
            "aborted": sum(1 for r in rs if r.state == "aborted"),
            "expired": sum(1 for r in rs if r.state == "expired"),
            "shed": sum(1 for r in rs if r.state == "shed"),
            "rejected": sum(1 for r in rs if r.state == "rejected"),
            "p50_ttft_s": _pct(ttft, 50), "p99_ttft_s": _pct(ttft, 99),
            "p50_tpot_s": _pct(tpot, 50), "p99_tpot_s": _pct(tpot, 99),
            "goodput": met / max(len(admitted), 1),
        }
    return out


# ---------------------------------------------------------------------------
# §D13: rolling metrics for the LIVE /metrics endpoint
# ---------------------------------------------------------------------------

class RollingTierMetrics:
    """Sliding-window per-tier serving metrics for an always-on server.

    ``tier_report`` above is an offline post-mortem over a finished
    trace; a live endpoint needs the same percentiles over a *trailing
    window* plus an instantaneous token rate, updated in O(1) amortized
    per event.  The async serve loop feeds it two event streams:

      * ``note_request(r)`` when a request reaches a terminal state
        (window-evicted after ``window_s``), and
      * ``note_tokens(t, tier, n)`` for streamed-token counts (one call
        per tick per tier, pre-aggregated — not one per token).

    Lifecycle counters are cumulative (a counter that silently forgot
    aborts would hide a leak); latencies and rates are windowed.
    """

    def __init__(self, window_s: float = 60.0):
        from collections import deque
        self.window_s = window_s
        self._done = {}      # tier -> deque[(finish_t, ttft, tpot, met)]
        self._tokens = {}    # tier -> deque[(t, n)]
        self.counters: Dict[str, Dict[str, int]] = {}
        self._deque = deque

    def _tier(self, store, tier):
        d = store.get(tier)
        if d is None:
            d = store[tier] = self._deque()
        return d

    def _count(self, tier: str, key: str, n: int = 1) -> None:
        c = self.counters.setdefault(tier, {})
        c[key] = c.get(key, 0) + n

    def _evict(self, d, now: float) -> None:
        horizon = now - self.window_s
        while d and d[0][0] < horizon:
            d.popleft()

    # ------------------------------------------------------------------
    def note_request(self, r: Request) -> None:
        """One request reaching a terminal lifecycle state."""
        self._count(r.tier, r.state)
        if r.admitted_t is not None:
            self._count(r.tier, "admitted")
        if r.state != "done" or r.first_token_t is None:
            return
        ttft = r.first_token_t - r.arrival
        tpot = (r.finish_t - r.first_token_t) / max(r.generated - 1, 1) \
            if r.generated > 1 else float("nan")
        d = self._tier(self._done, r.tier)
        d.append((r.finish_t, ttft, tpot, met_slo(r)))
        self._evict(d, r.finish_t)

    def note_tokens(self, t: float, tier: str, n: int = 1) -> None:
        if n <= 0:
            return
        d = self._tier(self._tokens, tier)
        d.append((t, n))
        self._evict(d, t)

    # ------------------------------------------------------------------
    def report(self, now: float) -> Dict[str, Dict]:
        """Per-tier window report, shaped like ``tier_report`` rows so
        dashboards can consume either."""
        out: Dict[str, Dict] = {}
        tiers = set(self._done) | set(self._tokens) | set(self.counters)
        for tier in sorted(tiers):
            d = self._tier(self._done, tier)
            self._evict(d, now)
            ttft = [e[1] for e in d]
            tpot = [e[2] for e in d if e[2] == e[2]]   # drop NaNs
            tok = self._tier(self._tokens, tier)
            self._evict(tok, now)
            span = min(self.window_s, max(now - tok[0][0], 1e-9)) \
                if tok else self.window_s
            met = sum(1 for e in d if e[3])
            row = {
                "window_s": self.window_s,
                "done_window": len(d),
                "p50_ttft_s": _pct(ttft, 50), "p99_ttft_s": _pct(ttft, 99),
                "p50_tpot_s": _pct(tpot, 50), "p99_tpot_s": _pct(tpot, 99),
                "tok_per_s": sum(n for _, n in tok) / span,
                "goodput_window": met / max(len(d), 1),
            }
            row.update(self.counters.get(tier, {}))
            out[tier] = row
        return out
