"""Communicator Pool (paper §4.3), one process per rank.

On GPUs the reconfiguration bottleneck is process-group creation. The
pool therefore builds, at construction, one ``torch.distributed`` group
for every TP group any layout of the plan can hold: each buddy-aligned
power-of-two run of engines with its ('ed', 'model') ranks
(``modes.tp_group_ranks``; the islands of ``modes.enumerate_layouts``
are made of them). ``dist.new_group`` is collective over the whole
world, so every rank creates every group in one fixed order, members or
not; it cannot be lazy. At runtime a mode switch is an O(1) lookup of
the island's group (``seat``); nothing is created on the critical path.
``stats`` records the group build time against the lookup time (the
paper's live switch against its cold start).

Backend, by topology: ``nccl`` when every rank has a card of its own,
``gloo`` when ranks share one or run on the CPU (``world_backend``);
``describe`` says which runs. Host-side agreement (step durations,
token harvests) goes over a gloo group of the whole world.

The pool also hands out one step function per runner key, looked up in
O(1) on the serving path and built once. The keys are the JAX
package's: ``(island_merge, phase, sampled, donate, batch_bucket,
seq_bucket, mb_bucket, n_engines, live, sp)``, keyed by island SHAPE, so
a run of either package touches the same key set; the step takes the
island's group at call time, as the JAX package's resolves the device
slice. Batch and sequence extents are bucketed with ``bucket_pow2``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import (Island, ParallelPlan, island_mode,
                                    tp_group_ranks)
from repro_torch.core.steps import build_serve_step
from repro_torch.core.views import CommStats, RankGroup


def bucket_pow2(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def world_backend(device: torch.device, world: int) -> str:
    """The process-group backend for ``world`` ranks on ``device``'s
    kind: NCCL when each rank has a card of its own (NCCL refuses two
    ranks on one card), gloo when ranks share a card or run on the CPU
    (gloo takes CUDA tensors, staging them through the host)."""
    if device.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def world() -> Tuple[int, int]:
    """(rank, world size): (0, 1) without an initialized process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


@dataclass
class PoolStats(CommStats):
    groups: int = 0
    group_build_s: float = 0.0
    lookups: int = 0
    lookup_s: float = 0.0


class Seat(NamedTuple):
    """Where this rank sits in one island: its DP group, its batch rows
    ``[lo, hi)`` of the island's batch, whether it leads the group, and
    the group's TP collectives (None at tp 1)."""
    group: int
    lo: int
    hi: int
    lead: bool
    comm: Optional[RankGroup]


class CommunicatorPool:
    """Eager TP groups, per-island seats and step functions."""

    def __init__(self, model, plan: ParallelPlan, geom: PoolGeometry,
                 sample: Tuple[float, int] = (0.0, 0), *,
                 batch_per_engine: int = 1):
        self.model = model
        self.plan = plan
        self.geom = geom
        self.sample = sample  # (temperature, top_k) for sampled runners
        self.bpe = batch_per_engine
        self._runners: Dict[Tuple, Callable] = {}
        self._seats: Dict[Island, Optional[Seat]] = {}
        self.stats = PoolStats()
        self.rank, self.world = world()
        n_dev = plan.pods * plan.devices_per_pod
        if self.world != n_dev:
            raise ValueError(f"{plan} spans {n_dev} ranks; this world has "
                             f"{self.world}")
        self.backend = dist.get_backend() if self.world > 1 else None
        self.host_group = None
        self._groups: Dict[Tuple[int, int], RankGroup] = {}
        if self.world > 1:
            t0 = time.perf_counter()
            self.host_group = dist.new_group(backend="gloo")
            for ranks in tp_group_ranks(plan):
                if len(ranks) == 1:
                    continue          # tp 1: no collective to make
                handle = dist.new_group(ranks=list(ranks))
                self.stats.groups += 1
                if self.rank in ranks:
                    self._groups[(ranks[0], len(ranks))] = RankGroup(
                        handle, ranks, ranks.index(self.rank), self.stats)
            self.stats.group_build_s = time.perf_counter() - t0

    def describe(self) -> str:
        if self.world == 1:
            return "1 rank, no process group"
        return (f"{self.world} ranks over {self.backend}; "
                f"{self.stats.groups} TP groups built in "
                f"{self.stats.group_build_s * 1e3:.1f} ms")

    def seat(self, island: Island) -> Optional[Seat]:
        """This rank's seat in ``island``, None when the island does not
        hold it: an O(1) lookup of groups built at construction."""
        t0 = time.perf_counter()
        s = self._seats.get(island, False)
        if s is False:
            tile = self.plan.engine_rows * self.plan.tp_base
            width = island.merge * tile
            local = self.rank - island.start * tile
            s = None
            if 0 <= local < island.n_engines * tile:
                g = local // width
                first = island.start * tile + g * width
                comm = self._groups[(first, width)] if width > 1 else None
                bpg = self.bpe * island.merge
                s = Seat(g, g * bpg, (g + 1) * bpg, self.rank == first,
                         comm)
            self._seats[island] = s
        self.stats.lookups += 1
        self.stats.lookup_s += time.perf_counter() - t0
        return s

    def host_max(self, x: float) -> float:
        """The max of ``x`` over every rank (one CPU all_reduce)."""
        if self.world == 1:
            return x
        t = torch.tensor([x], dtype=torch.float64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        self.stats.host_collectives += 1
        return float(t[0])

    def host_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum a CPU tensor over every rank, in place (one all_reduce)."""
        if self.world > 1:
            dist.all_reduce(t, group=self.host_group)
            self.stats.host_collectives += 1
        return t

    def runner(self, island: Island, phase: str, *, sampled: bool = False,
               batch_bucket: Optional[int] = None,
               seq_bucket: Optional[int] = None,
               mb_bucket: Optional[int] = None) -> Callable:
        """Step fn ``run(params, states, batch, comm)`` for (island shape,
        phase, variant). ``sampled`` fuses the pool's ``sample=
        (temperature, top_k)`` into the step. The key's ``donate`` slot
        is always True (the port updates the pools in place, as the JAX
        package's donated steps do) and its ``live`` slot None (no live
        cross-layout reads yet)."""
        key = (island.merge, phase, sampled, True, batch_bucket,
               seq_bucket, mb_bucket, island.n_engines, None, island.sp)
        if key not in self._runners:
            run, _ = build_serve_step(
                self.model, island_mode(self.plan, island), self.geom,
                phase=phase, sample=self.sample if sampled else None)
            self._runners[key] = run
        return self._runners[key]
