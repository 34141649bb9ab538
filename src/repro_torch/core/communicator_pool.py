"""Communicator Pool (paper §4.3), one process per rank.

On GPUs the reconfiguration bottleneck is process-group creation. The
pool therefore builds, at construction, one ``torch.distributed`` group
for every TP group any layout of the plan can hold: each buddy-aligned
power-of-two run of engines with its ('ed', 'model') ranks
(``modes.tp_group_ranks``; the islands of ``modes.enumerate_layouts``
are made of them), and beside each TP group of a merge above 1 the view
groups of its merge axis, one per storage rank: the group's ranks that
hold the same storage shard, over which the live cross-layout reads
merge their partials (the JAX package's ``view_axes``; at one rank per
engine the view group is the TP group itself), and, for a MoE model
whose experts are stored over 'ed' (``ep > 1``), the 'ed' groups
(``modes.ed_group_ranks``: one engine's ranks of one 'model' index),
over which the MoE layer's all_to_alls run (a dense model on a tile of
several rows needs none: its TP group spans ('merge', 'ed', 'model')).
A group equal to one already built is that group (at ``tp_base`` 1 an
'ed' group is the merge-1 TP group). ``dist.new_group`` is
collective over the whole world, so every rank creates every group in
one fixed order, members or not; it cannot be lazy. At runtime a mode
switch is an O(1) lookup of the island's groups (``seat``); nothing is
created on the critical path.
``stats`` records the group build time against the lookup time (the
paper's live switch against its cold start).

Backend, by topology: ``nccl`` when every rank has a card of its own,
``gloo`` when ranks share one or run on the CPU (``world_backend``);
``describe`` says which runs. Host-side agreement (step durations,
token harvests, and under ``--serve`` rank 0's per-tick inputs,
``host_broadcast``) goes over a gloo group of the whole world.

The pool also hands out one step function per runner key, looked up in
O(1) on the serving path and built once. The keys are the JAX
package's: ``(island_merge, phase, sampled, donate, batch_bucket,
seq_bucket, mb_bucket, n_engines, live, sp)``, keyed by island SHAPE, so
a run of either package touches the same key set; the step takes the
island's group at call time, as the JAX package's resolves the device
slice. Batch and sequence extents are bucketed with ``bucket_pow2``.
"""
from __future__ import annotations

import pickle
import time
from dataclasses import dataclass
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import (Island, ParallelPlan, ed_group_ranks,
                                    island_mode, tp_group_ranks)
from repro_torch.core.steps import build_serve_step
from repro_torch.core.views import (CommStats, RankGroup, make_serving_ctx,
                                    tensor_bytes)


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
    groups: int = 0           # process groups built (TP, view and 'ed')
    ed_groups: int = 0        # of them, the 'ed' groups
    group_build_s: float = 0.0
    lookups: int = 0
    lookup_s: float = 0.0
    broadcasts: int = 0       # host_broadcast calls (the serve lockstep)
    broadcast_s: float = 0.0  # their wall time on this rank


class Seat(NamedTuple):
    """Where this rank sits in one island: its DP group, its batch rows
    ``[lo, hi)`` of the island's batch, whether it leads the group, the
    group's TP collectives (None at tp 1), its view group's (None at
    merge 1) and its 'ed' group's: the ranks of its engine at its 'model'
    index, over which a MoE layer with its experts stored over 'ed'
    exchanges its dispatch buffers (None unless ``ep > 1``)."""
    group: int
    lo: int
    hi: int
    lead: bool
    comm: Optional[RankGroup]
    view: Optional[RankGroup] = None
    ed: Optional[RankGroup] = None


class CommunicatorPool:
    """Eager TP, view and 'ed' groups, per-island seats and step
    functions."""

    def __init__(self, model, plan: ParallelPlan, geom: PoolGeometry,
                 sample: Tuple[float, int] = (0.0, 0), *,
                 batch_per_engine: int = 1, window: Optional[int] = None):
        self.model = model
        self.plan = plan
        self.geom = geom
        self.sample = sample  # (temperature, top_k) for sampled runners
        self.bpe = batch_per_engine
        self.window = window  # sliding window of every serving step
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
        self.view_groups = 0  # of stats.groups, those of a merge axis
        cfg = getattr(model, "cfg", None)
        moe = getattr(cfg, "moe", None)
        # the expert-parallel degree of every mode of the plan
        self.ep = make_serving_ctx(1, plan.engine_rows, plan.tp_base,
                                   moe.num_experts if moe else 0).ep
        # 'ed' groups one already built stands for (the merge-1 TP group)
        self.ed_shared = 0
        # this rank's groups by their world ranks (a view group equal to
        # its TP group is that group)
        self._groups: Dict[Tuple[int, ...], RankGroup] = {}
        if self.world > 1:
            t0 = time.perf_counter()
            self.host_group = dist.new_group(backend="gloo")
            tile = plan.engine_rows * plan.tp_base
            built = set()
            todo = []             # (members, kind), in one fixed order
            for ranks in tp_group_ranks(plan):
                todo.append((ranks, "tp"))
                if len(ranks) > tile:
                    todo += [(ranks[s::tile], "view") for s in range(tile)]
            if self.ep > 1:
                todo += [(g, "ed") for g in ed_group_ranks(plan)]
            for members, kind in todo:
                if len(members) == 1:
                    continue          # one rank: no collective to make
                if members in built:
                    self.ed_shared += kind == "ed"
                    continue
                built.add(members)
                handle = dist.new_group(ranks=list(members))
                self.stats.groups += 1
                self.view_groups += kind == "view"
                self.stats.ed_groups += kind == "ed"
                if self.rank in members:
                    self._groups[members] = RankGroup(
                        handle, members, members.index(self.rank),
                        self.stats)
            self.stats.group_build_s = time.perf_counter() - t0

    def describe(self) -> str:
        if self.world == 1:
            return "1 rank, no process group"
        tp = self.stats.groups - self.view_groups - self.stats.ed_groups
        return (f"{self.world} ranks over {self.backend}; {tp} TP groups, "
                f"{self.view_groups} view groups and "
                f"{self.stats.ed_groups} 'ed' groups built in "
                f"{self.stats.group_build_s * 1e3:.1f} ms"
                + (f" ({self.ed_shared} 'ed' groups are TP groups)"
                   if self.ed_shared else ""))

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
                ranks = tuple(range(first, first + width))
                comm = self._groups[ranks] if width > 1 else None
                # the merge axis at this rank's storage rank
                members = ranks[(self.rank - first) % tile::tile]
                view = self._groups[members] if len(members) > 1 else None
                ed = None
                if self.ep > 1:
                    # its merge index's ranks at its 'model' index, as
                    # ``ed_group_ranks`` slices them
                    m, j = divmod(self.rank - first, tile)
                    j %= self.plan.tp_base
                    ed = self._groups[ranks[m * tile + j:(m + 1) * tile:
                                            self.plan.tp_base]]
                bpg = self.bpe * island.merge
                s = Seat(g, g * bpg, (g + 1) * bpg, self.rank == first,
                         comm, view, ed)
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
        self.stats.add_bytes("all-reduce", tensor_bytes(t))
        return float(t[0])

    def host_broadcast(self, obj=None):
        """Rank 0's ``obj`` on every rank (one pickled broadcast over the
        host group; the other ranks pass nothing). At one rank it is
        ``obj`` itself, with no collective and nothing counted."""
        if self.world == 1:
            return obj
        t0 = time.perf_counter()
        box = [obj if self.rank == 0 else None]
        dist.broadcast_object_list(box, src=0, group=self.host_group)
        self.stats.host_collectives += 1
        # the pickled object (what broadcast_object_list sends) and its
        # int64 length
        self.stats.add_bytes("collective-broadcast",
                             len(pickle.dumps(box[0])) + 8)
        self.stats.broadcasts += 1
        self.stats.broadcast_s += time.perf_counter() - t0
        return box[0]

    def host_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum a CPU tensor over every rank, in place (one all_reduce)."""
        if self.world > 1:
            dist.all_reduce(t, group=self.host_group)
            self.stats.host_collectives += 1
            self.stats.add_bytes("all-reduce", tensor_bytes(t))
        return t

    def runner(self, island: Island, phase: str, *, sampled: bool = False,
               batch_bucket: Optional[int] = None,
               seq_bucket: Optional[int] = None,
               mb_bucket: Optional[int] = None,
               live: Optional[Tuple[int, ...]] = None) -> Callable:
        """Step fn ``run(params, states, batch, comm, view, ed)`` for
        (island shape, phase, variant): ``comm``, ``view`` and ``ed`` are
        the island seat's TP, view and 'ed' groups. ``sampled`` fuses the
        pool's ``sample=(temperature, top_k)`` into the step. ``live``
        selects the cross-layout read variant: the ordered lane-tag tuple
        of the block segments the batch carries (``None``: the
        single-view step); an SP island (``island.sp > 1``) runs the SP
        write variant of it. The
        key's ``donate`` slot is always True (the port updates the pools
        in place, as the JAX package's donated steps do)."""
        key = (island.merge, phase, sampled, True, batch_bucket,
               seq_bucket, mb_bucket, island.n_engines, live, island.sp)
        if key not in self._runners:
            run, _ = build_serve_step(
                self.model, island_mode(self.plan, island), self.geom,
                phase=phase, sample=self.sample if sampled else None,
                live=live, sp=island.sp, window=self.window)
            self._runners[key] = run
        return self._runners[key]
