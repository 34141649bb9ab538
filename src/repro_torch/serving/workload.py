"""Synthetic workload generator (paper §6.1.3).

Request lengths: prompts U[128, 4000] tokens, outputs U[64, 512].
Traffic: arrival rate alternates between low (2-5 req/s) and bursty
(10-30 req/s) phases. Deterministic given a seed, so comparisons across
systems see the *same offered load* (paper §6.2 'Same offered load').

§D11 extensions (front-door overload scenarios), all gated behind
non-default spec fields so the seed-era stream is untouched:
  - arrival processes: ``poisson`` (homogeneous) and ``bursty``
    (Markov-modulated on/off Poisson — exponential phase lengths, the
    on-phase rate multiplied by ``burst_mult``) beside the seed-era
    ``phased`` alternation;
  - heavy-tail lengths: ``length_dist='lognormal'`` samples prompt and
    output lengths lognormally (median at the range's geometric mean,
    clamped to the range — the range's top end IS the tail);
  - scripted client cancellations: a ``cancel_frac`` of requests carry
    a ``cancel_at`` timestamp drawn ``cancel_after`` seconds past
    arrival;
  - tier mix: ``priority_frac`` → tier 'priority' (scheduler
    PRIORITY_HIGH, the TP-island latency class), ``background_frac`` →
    tier 'background' (sheddable), remainder 'standard'.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.task_pool import PRIORITY_HIGH, PRIORITY_NORMAL, Request


@dataclass
class WorkloadSpec:
    n_requests: int = 4000
    prompt_range: Tuple[int, int] = (128, 4000)
    output_range: Tuple[int, int] = (64, 512)
    low_rate: Tuple[float, float] = (2.0, 5.0)
    burst_rate: Tuple[float, float] = (10.0, 30.0)
    phase_seconds: float = 60.0        # low-load phase length
    burst_seconds: float = 0.0         # 0 -> same as phase_seconds
    priority_frac: float = 0.0       # UC2 workloads set > 0
    long_context_frac: float = 0.0   # UC3: fraction with huge prompts
    long_prompt: int = 200_000
    # shared-prefix traffic (§D10): a pool of system prompts / few-shot
    # preambles. With probability prefix_hit a request draws one pool
    # entry (same prefix_seed+prefix_len => identical leading tokens,
    # so the content-addressed cache shares their KV blocks). Tier mix
    # rides on priority_frac — priority and background requests draw
    # from the SAME pool, the cross-layout sharing case.
    prefix_pool: int = 0             # number of distinct shared prefixes
    prefix_hit: float = 0.0          # P(request uses a pool prefix)
    prefix_range: Tuple[int, int] = (0, 0)  # prefix length range (tokens)
    # arrival process (§D11): 'phased' (seed-era alternation),
    # 'poisson' (homogeneous at ``rate``), or 'bursty' (on/off
    # modulated Poisson: exponential phase lengths with means
    # phase_seconds / burst_seconds, on-phase rate = rate * burst_mult)
    arrival: str = "phased"
    rate: float = 10.0
    burst_mult: float = 8.0
    # heavy-tail lengths (§D11): 'uniform' (seed-era) or 'lognormal'
    length_dist: str = "uniform"
    lognormal_sigma: float = 0.8
    # scripted client cancellations (§D11)
    cancel_frac: float = 0.0
    cancel_after: Tuple[float, float] = (0.5, 8.0)
    # tier mix (§D11): background is the sheddable class
    background_frac: float = 0.0
    seed: int = 0


def _rint(rng, lo, hi) -> int:
    """rng.integers tolerant of degenerate (lo == hi) ranges."""
    return int(rng.integers(lo, hi)) if hi > lo else int(lo)


def _length(rng, spec: WorkloadSpec, lo: int, hi: int) -> int:
    if spec.length_dist == "lognormal":
        # heavy tail: median at the geometric mean of the range, tail
        # clamped at the range top (the range IS the model's capacity)
        med = math.sqrt(max(lo, 1) * max(hi, lo + 1))
        v = med * math.exp(rng.normal(0.0, spec.lognormal_sigma))
        return int(min(max(v, lo), hi))
    return _rint(rng, lo, hi)


def generate(spec: WorkloadSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    # pre-draw the pool so every pool-mate of prefix k agrees on both
    # the seed AND the length (a length mismatch would silently break
    # content identity between supposed pool-mates)
    pool: List[Tuple[int, int]] = []
    if spec.prefix_pool and spec.prefix_hit > 0:
        lo, hi = spec.prefix_range
        pool = [(int(rng.integers(1, 1 << 30)), _rint(rng, lo, hi))
                for _ in range(spec.prefix_pool)]
    reqs: List[Request] = []
    t = 0.0
    phase_low = True         # phased: low/burst alternation
    in_burst = False         # bursty: inside an on-phase
    phase_end = spec.phase_seconds
    for i in range(spec.n_requests):
        if spec.arrival == "poisson":
            t += rng.exponential(1.0 / max(spec.rate, 1e-9))
        elif spec.arrival == "bursty":
            r_now = spec.rate * (spec.burst_mult if in_burst else 1.0)
            t += rng.exponential(1.0 / max(r_now, 1e-9))
            while t > phase_end:
                in_burst = not in_burst
                mean = (spec.burst_seconds or spec.phase_seconds) \
                    if in_burst else spec.phase_seconds
                phase_end += rng.exponential(mean)
        else:
            lo, hi = spec.low_rate if phase_low else spec.burst_rate
            rate = rng.uniform(lo, hi)
            t += rng.exponential(1.0 / rate)
            while t > phase_end:
                phase_low = not phase_low
                phase_end += (spec.phase_seconds if phase_low
                              else (spec.burst_seconds
                                    or spec.phase_seconds))
        prompt = _length(rng, spec, *spec.prompt_range)
        if spec.long_context_frac and rng.uniform() < spec.long_context_frac:
            prompt = spec.long_prompt
        out = _length(rng, spec, *spec.output_range)
        prio = PRIORITY_HIGH if (spec.priority_frac and
                                 rng.uniform() < spec.priority_frac) \
            else PRIORITY_NORMAL
        tier = "priority" if prio == PRIORITY_HIGH else "standard"
        if prio == PRIORITY_NORMAL and spec.background_frac and \
                rng.uniform() < spec.background_frac \
                / max(1.0 - spec.priority_frac, 1e-9):
            tier = "background"
        cancel_at: Optional[float] = None
        if spec.cancel_frac and rng.uniform() < spec.cancel_frac:
            cancel_at = t + rng.uniform(*spec.cancel_after)
        pseed: Optional[int] = None
        plen = 0
        if pool and rng.uniform() < spec.prefix_hit:
            pseed, plen = pool[int(rng.integers(len(pool)))]
            # the prefix replaces the prompt's head, never grows the
            # request: total context is unchanged vs the uncached run
            plen = min(plen, prompt - 1)  # keep >=1 private token
        reqs.append(Request(req_id=f"req{i}", arrival=t, prompt_len=prompt,
                            output_len=out, priority=prio, tier=tier,
                            cancel_at=cancel_at,
                            prefix_seed=pseed, prefix_len=plen))
    return reqs
