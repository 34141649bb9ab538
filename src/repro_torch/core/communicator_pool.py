"""Communicator Pool (paper §4.3) at one rank.

The pool hands out one step function per runner key, looked up in O(1)
on the serving path and built once. The keys are the JAX package's:
``(island_merge, phase, sampled, donate, batch_bucket, seq_bucket,
mb_bucket, n_engines, live, sp)``, so a run of either package touches
the same key set. Eager PyTorch compiles nothing per key yet; the keys
are where captured CUDA graphs will hang.

Batch and sequence extents are bucketed with ``bucket_pow2``: callers
pad their host batches to the bucket, so chunk-length variation reuses
a key instead of adding one.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import Island, ParallelPlan, island_mode
from repro_torch.core.steps import build_serve_step


def bucket_pow2(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class CommunicatorPool:
    """Step functions keyed by island shape, phase and buckets."""

    def __init__(self, model, plan: ParallelPlan, geom: PoolGeometry):
        self.model = model
        self.plan = plan
        self.geom = geom
        self._runners: Dict[Tuple, Callable] = {}

    def runner(self, island: Island, phase: str, *, sampled: bool = False,
               batch_bucket: Optional[int] = None,
               seq_bucket: Optional[int] = None,
               mb_bucket: Optional[int] = None) -> Callable:
        """Step fn for (island shape, phase, variant). ``sampled`` fuses
        greedy sampling into the step. The key's ``donate`` slot is always
        True (the port updates the pools in place, as the JAX package's
        donated steps do) and its ``live`` slot None (no live cross-layout
        reads yet)."""
        key = (island.merge, phase, sampled, True, batch_bucket,
               seq_bucket, mb_bucket, island.n_engines, None, island.sp)
        if key not in self._runners:
            run, _ = build_serve_step(
                self.model, island_mode(self.plan, island), self.geom,
                phase=phase, sampled=sampled)
            self._runners[key] = run
        return self._runners[key]
