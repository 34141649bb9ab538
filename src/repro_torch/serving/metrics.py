"""Streaming-inference metrics (paper §6.1.4): TTFT, TPOT, ILT, queue
time, peak generation throughput.

The per-tier SLO report and the rolling metrics of the HTTP endpoint
come with the front door and the server, which are not ported."""
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

