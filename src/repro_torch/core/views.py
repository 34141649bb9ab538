"""Logical weight views at one rank.

The JAX package stores weights sharded over the engine-tile axes and lets
each rank of a merged TP group *activate* a slice of its resident shard
(paper §4.1, Eq. 1). This slice of the port serves one card, so every
weight is whole on the device and every view is the identity: the
single-rank ``TPContext`` below is the counterpart of the JAX package's
``SINGLE`` context, its collectives the identity. The multi-rank context
comes with the islands slice.
"""
from __future__ import annotations

from dataclasses import dataclass


def v2(n: int) -> int:
    """2-adic valuation."""
    if n <= 0:
        return 0
    k = 0
    while n % 2 == 0:
        n //= 2
        k += 1
    return k


def pow2_shards(n: int, tp: int) -> int:
    """Largest power-of-two shard count for an n-unit dim under degree tp."""
    return min(1 << v2(n), tp) if n > 0 else 1


@dataclass(frozen=True)
class TPContext:
    """Parallel-execution geometry of one rank that holds every weight
    whole: views return their input and collectives are the identity."""

    tp: int = 1

    def __post_init__(self):
        if self.tp != 1:
            raise NotImplementedError(
                "multi-rank TP groups arrive with the islands slice")

    def compute_shards(self, n: int) -> int:
        return pow2_shards(n, self.tp)

    def local_units(self, n: int) -> int:
        return n // self.compute_shards(n)

    def activate(self, w, dim: int, n: int):
        return w

    def psum(self, x, n: int = 0):
        return x


SINGLE = TPContext()


def make_serving_ctx(merge: int, engine_rows: int,
                     tp_base: int) -> TPContext:
    """TPContext for a serving mode; the port serves merge 1 on one card."""
    return TPContext(tp=merge * engine_rows * tp_base)
