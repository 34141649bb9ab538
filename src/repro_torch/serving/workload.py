"""Synthetic workload generator (paper §6.1.3), as the port's launcher
uses it: Poisson arrivals at ``rate`` requests per second, prompt and
output lengths uniform over their ranges. Deterministic given a seed,
and the same stream as the JAX package's ``generate`` with
``arrival='poisson'`` and every other knob at its default.

The phased and bursty arrival processes, heavy-tail lengths, tier
mixes, cancellations, shared prefixes and long-context requests drive
features the port does not have yet; they come with those features.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from repro_torch.core.task_pool import Request


@dataclass
class WorkloadSpec:
    n_requests: int = 4000
    prompt_range: Tuple[int, int] = (128, 4000)
    output_range: Tuple[int, int] = (64, 512)
    rate: float = 10.0               # poisson arrivals per second
    seed: int = 0


def _rint(rng, lo, hi) -> int:
    """rng.integers tolerant of degenerate (lo == hi) ranges."""
    return int(rng.integers(lo, hi)) if hi > lo else int(lo)


def generate(spec: WorkloadSpec) -> List[Request]:
    rng = np.random.default_rng(spec.seed)
    reqs: List[Request] = []
    t = 0.0
    for i in range(spec.n_requests):
        t += rng.exponential(1.0 / max(spec.rate, 1e-9))
        prompt = _rint(rng, *spec.prompt_range)
        out = _rint(rng, *spec.output_range)
        reqs.append(Request(req_id=f"req{i}", arrival=t, prompt_len=prompt,
                            output_len=out))
    return reqs
