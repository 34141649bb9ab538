"""Logical weight views: the device-side half of the Model Weights
Manager (paper §4.1, Eq. 1), one process per rank.

Storage convention: weights are *stored* sharded over the engine-tile
axes ``('ed','model')`` (when the partition dim divides) and
**replicated** over the DP axes ``('dp','merge')``. Each rank holds its
full engine shard. Merging ``m`` engines into a TP group does not
reshard storage; each rank *activates* a rank-selected slice of its
resident shard, a ``narrow`` view that copies nothing:

    W_active = View(W_full, dim, rank, m)          (paper Eq. 1)

All parallel degrees are powers of two, which gives nested shardings:
for a dimension of n units the compute shard count is ``want =
min(2**v2(n), tp)``; ranks in excess of ``want`` replicate compute
(``rep = tp // want``) and row-parallel partial sums are pre-scaled by
``1/rep`` so a single full-group psum stays correct. This covers GQA KV
heads below the TP degree (the reduced llama3-8b's one KV head at tp 2
and above).

``TPContext`` is the geometry of one mode, built once per runner; the
step binds it at call time to the process group of the island it runs
(``bind``), as the JAX package resolves the device slice from the
island-committed arrays, and to its view group: the ranks of the merge
axis at this rank's storage rank, over which the live cross-layout
reads merge their partials (``lse_merge(..., view=True)``). With ``tp == 1`` every helper is the identity,
so the same model code serves one rank and trains. Where the JAX
package reads ``lax.axis_index`` over the TP axes ``('merge', 'ed',
'model')``, the port reads this rank's index in its TP group, whose
ranks are listed in that order (``core/modes.py::island_ranks``).

Training (``make_train_ctx``) runs the same model code under autograd,
where the JAX package lets GSPMD place the collectives. Every rank of a
TP group computes the replicated part of the model (norms, routing, the
loss) alike, and the train step seeds its backward with ``1 / tp``, so
the gradient of a tensor replicated over the group is held as per-rank
partials that sum to the whole, while a sharded tensor's gradient is
whole on its rank. ``psum`` under autograd (``_PSum``) is therefore an
all_reduce both ways: forward it sums the row-parallel partials, and
backward it sums the partial gradients its replicated output received
into the whole gradient of each rank's input. The pre-scale by
``1 / replication`` is an ordinary op, so autograd mirrors it. A leaf
that no rank shards over 'model' (a norm, the router, K/V projections
of fewer heads than ``tp``) thus ends with a partial gradient on each
rank, and the train step sums those over the group; nothing in the
model marks where replicated values enter sharded compute. Under
``no_grad`` (serving) the collectives are the plain ones.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


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


@dataclass
class CommStats:
    """Collectives issued, by the TP groups (device tensors) and by the
    host group (step durations, token harvests), and their calls and
    result bytes by kind under the JAX package's names (``all-reduce``,
    ``all-gather``, ``all-to-all``, ``collective-broadcast``; the
    roofline's ``wire_bytes`` takes the bytes)."""
    collectives: int = 0
    host_collectives: int = 0
    nbytes: Dict[str, int] = dataclasses.field(default_factory=dict)
    calls: Dict[str, int] = dataclasses.field(default_factory=dict)

    def add_bytes(self, kind: str, n: int) -> None:
        """One collective of ``kind`` whose result is ``n`` bytes."""
        self.nbytes[kind] = self.nbytes.get(kind, 0) + int(n)
        self.calls[kind] = self.calls.get(kind, 0) + 1


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class RankGroup:
    """One TP group as this rank sees it: the ``torch.distributed``
    process group, its world ranks in TP rank order, this rank's index
    among them, and the counter every collective adds to. Each
    collective returns a new tensor and leaves its input as it was."""

    def __init__(self, handle, ranks: Sequence[int], index: int,
                 stats: Optional[CommStats] = None):
        self.handle = handle
        self.ranks = tuple(ranks)
        self.index = index
        self.stats = stats if stats is not None else CommStats()

    @property
    def size(self) -> int:
        return len(self.ranks)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        y = x.clone()
        dist.all_reduce(y, op=getattr(dist.ReduceOp, op.upper()),
                        group=self.handle)
        self.stats.collectives += 1
        self.stats.add_bytes("all-reduce", tensor_bytes(y))
        return y

    def all_gather(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in self.ranks]
        dist.all_gather(out, x, group=self.handle)
        self.stats.collectives += 1
        self.stats.add_bytes("all-gather", tensor_bytes(x) * len(out))
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` [size * m, ...] cut along dim 0 into ``size`` chunks,
        chunk j to rank j; returns the chunks received, rank i's at i."""
        x = x.contiguous()
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x, group=self.handle)
        self.stats.collectives += 1
        self.stats.add_bytes("all-to-all", tensor_bytes(y))
        return y


class _PSum(torch.autograd.Function):
    """The sum over a TP group, differentiable: the backward sums the
    output's per-rank partial gradients (module docstring)."""

    @staticmethod
    def forward(ctx, x, group: RankGroup):
        ctx.group = group
        return group.all_reduce(x, "sum")

    @staticmethod
    def backward(ctx, grad):
        return ctx.group.all_reduce(grad.contiguous(), "sum"), None


@dataclass(frozen=True)
class TPContext:
    """Parallel-execution geometry of one mode at one rank."""

    tp: int = 1           # total TP degree = view_m * storage_shards
    view_m: int = 1       # merge factor realized by views over replicated storage
    ep: int = 1           # expert-parallel storage degree (over 'ed')
    # the TP group's collectives; None until bound (always None at tp 1)
    group: Optional[RankGroup] = dataclasses.field(default=None,
                                                   compare=False)
    # the merge axis alone: the TP group's ranks that share this rank's
    # storage rank (the JAX package's ``view_axes``); None until bound,
    # and at view_m 1, where it is this rank alone
    view_group: Optional[RankGroup] = dataclasses.field(default=None,
                                                        compare=False)
    # the 'ed' axis alone: the TP group's ranks at this rank's merge and
    # 'model' index (expert parallelism's all_to_all); None until bound,
    # and at ep 1
    ed_group: Optional[RankGroup] = dataclasses.field(default=None,
                                                      compare=False)

    def __post_init__(self):
        if self.group is not None and self.group.size != self.tp:
            raise ValueError(f"a TP group of {self.group.size} ranks "
                             f"for tp={self.tp}")
        if self.view_group is not None \
                and self.view_group.size != self.view_m:
            raise ValueError(f"a view group of {self.view_group.size} "
                             f"ranks for view_m={self.view_m}")
        if self.ed_group is not None and self.ed_group.size != self.ep:
            raise ValueError(f"an 'ed' group of {self.ed_group.size} "
                             f"ranks for ep={self.ep}")

    @property
    def storage_shards(self) -> int:
        return self.tp // self.view_m

    def bind(self, group: Optional[RankGroup],
             view_group: Optional[RankGroup] = None,
             ed_group: Optional[RankGroup] = None) -> "TPContext":
        """This geometry over one island's TP group and, for the live
        reads' merges, its view group, and for expert parallelism its
        'ed' group (tp 1: itself)."""
        if self.tp == 1:
            return self
        if group is None:
            raise ValueError(f"tp={self.tp} needs its rank group")
        return dataclasses.replace(self, group=group, view_group=view_group,
                                   ed_group=ed_group)

    def ed_members(self, index: int) -> Tuple[int, ...]:
        """The TP-group indices of the 'ed' group of the rank at
        ``index``: its merge and 'model' index, every 'ed' index."""
        shards = self.storage_shards
        per = shards // self.ep                  # 'model' ranks an 'ed' row
        m, rest = divmod(index, shards)
        return tuple(m * shards + e * per + rest % per
                     for e in range(self.ep))

    # ---- ranks (the JAX package's traced lax.axis_index) ---------------
    def _index(self) -> int:
        if self.tp == 1:
            return 0
        if self.group is None:
            raise RuntimeError("TPContext not bound to a rank group")
        return self.group.index

    def stripe_index(self) -> int:
        """This rank's index over ('merge', 'ed', 'model')."""
        return self._index()

    def view_rank(self) -> int:
        return self._index() // self.storage_shards

    def storage_rank(self) -> int:
        return self._index() % self.storage_shards

    def storage_major_rank(self) -> int:
        """Rank ordering in which consecutive ranks share a storage shard
        contiguously: r = storage_rank * view_m + view_rank."""
        if self.tp == 1:
            return 0
        return self.storage_rank() * self.view_m + self.view_rank()

    def ep_rank(self) -> int:
        """This rank's index over 'ed' (the storage index is
        ``ed * tp_base + model``)."""
        if self.ep == 1:
            return 0
        return self.storage_rank() // (self.storage_shards // self.ep)

    # ---- sharding arithmetic ------------------------------------------
    def stored_shards(self, n: int) -> int:
        """Storage shard count the weights manager uses for an n-unit dim:
        full engine-tile sharding when divisible, else replicated."""
        s = self.storage_shards
        return s if (n % s == 0) else 1

    def compute_shards(self, n: int) -> int:
        return pow2_shards(n, self.tp)

    def replication(self, n: int) -> int:
        """How many ranks replicate each compute slice of an n-unit dim
        (row-parallel partials are pre-scaled by 1/replication)."""
        return self.tp // self.compute_shards(n)

    def local_units(self, n: int) -> int:
        return n // self.compute_shards(n)

    def stored_units(self, n: int) -> int:
        """Units of an n-unit dim in this rank's storage shard (the
        merge-1 frame): what the live cross-layout reads compute in
        before slicing back to the mode's compute shard."""
        return n // self.stored_shards(n)

    # ---- the view primitive (paper Eq. 1) ------------------------------
    def activate(self, w: torch.Tensor, dim: int, n: int) -> torch.Tensor:
        """This rank's compute slice of a weight whose ``dim`` holds ``n``
        logical units. ``w`` is the local *storage* shard
        (``stored_shards(n)``-way). A view of ``w``; ``w`` itself when
        there is nothing to slice."""
        if self.tp == 1:
            return w
        stored = self.stored_shards(n)
        want = self.compute_shards(n)
        if want == stored:
            return w
        if stored == 1:
            idx = (self.storage_major_rank() * want) // self.tp
            cnt = want
        else:
            rep = self.tp // want
            idx = self.view_rank() // rep
            cnt = want // stored
        size = w.shape[dim] // cnt
        return w.narrow(dim, idx * size, size)

    def activate_view(self, w: torch.Tensor, dim: int) -> torch.Tensor:
        """Slice ``dim`` by the merge (view) rank only, for tensors whose
        storage axes are managed separately."""
        if self.view_m == 1:
            return w
        size = w.shape[dim] // self.view_m
        return w.narrow(dim, self.view_rank() * size, size)

    def slice_of_rank(self, r: int, n: int) -> int:
        """Which logical slice of an n-unit dim TP rank r computes (the
        static mirror of ``activate``'s indexing)."""
        stored = self.stored_shards(n)
        want = self.compute_shards(n)
        storage = self.storage_shards
        view_rank = r // storage
        storage_rank = r % storage
        if stored == 1:
            smr = storage_rank * self.view_m + view_rank
            return (smr * want) // self.tp
        rep = self.tp // want
        return storage_rank * (want // stored) + view_rank // rep

    # ---- collectives ----------------------------------------------------
    def psum(self, x: torch.Tensor, n: int = 0) -> torch.Tensor:
        """Row-parallel reduction over the TP group; if the reduced dim had
        ``n`` logical units with replication, pre-scale so duplicates do
        not over-count."""
        if self.tp == 1:
            return x
        return self.psum_scaled(x, self.replication(n) if n else 1)

    def psum_scaled(self, x: torch.Tensor, rep: int) -> torch.Tensor:
        if self.tp == 1:
            return x
        if rep > 1:
            x = x / rep
        if torch.is_grad_enabled() and x.requires_grad:
            return _PSum.apply(x, self.group)
        return self.group.all_reduce(x, "sum")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else self.group.all_reduce(x, "max")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.tp == 1 else self.group.all_reduce(x, "min")

    def gather_heads(self, x: torch.Tensor, n: int, axis: int
                     ) -> torch.Tensor:
        """All-gather a head-sharded tensor back to full logical heads,
        one representative rank per logical slice in slice order (so
        replicas are dropped). x has n // shards units along ``axis``;
        returns n units."""
        if self.tp == 1:
            return x
        want = self.compute_shards(n)
        parts = self.group.all_gather(x)
        reps: List[Optional[int]] = [None] * want
        for r in range(self.tp):
            s = self.slice_of_rank(r, n)
            if reps[s] is None:
                reps[s] = r
        return torch.cat([parts[r] for r in reps], dim=axis)

    def lse_merge(self, acc: torch.Tensor, l: torch.Tensor, m: torch.Tensor,
                  wire_dtype: Optional[torch.dtype] = None,
                  view: bool = False) -> torch.Tensor:
        """Merge online-softmax partials across ranks: acc [..,H,D] fp32
        unnormalized, l [..,H] denominators, m [..,H] maxima -> full
        attention output [..,H,D] fp32. The merge runs over the TP group,
        or with ``view`` over the view group alone: the live cross-layout
        reads hold partials of one stored head across the merge axis,
        while the other ('ed', 'model') positions hold other heads.
        ``wire_dtype`` (e.g. bf16) halves the summed bytes: with w <= 1
        the summand is max-normalized, so bf16 loses only mantissa bits
        against the fp32 result."""
        if view:
            if self.view_m == 1:
                return acc / torch.clamp_min(l[..., None], 1e-30)
            if self.view_group is None:
                raise RuntimeError("TPContext not bound to a view group")
            group = self.view_group
        elif self.tp == 1:
            return acc / torch.clamp_min(l[..., None], 1e-30)
        else:
            group = self.group
        m_g = group.all_reduce(m, "max")
        w = torch.exp(m - m_g)
        num_in = acc * w[..., None]
        if wire_dtype is not None:
            num_in = num_in.to(wire_dtype)
        num = group.all_reduce(num_in, "sum").float()
        den = group.all_reduce(l * w, "sum")
        return num / torch.clamp_min(den[..., None], 1e-30)


SINGLE = TPContext()


def make_train_ctx(tp_base: int, group: Optional[RankGroup] = None
                   ) -> TPContext:
    """TPContext of one training rank: TP over its 'model' group of
    ``tp_base`` ranks, storage over 'model' alone (no merge views)."""
    ctx = TPContext(tp=tp_base)
    return ctx.bind(group) if group is not None else ctx


def make_serving_ctx(merge: int, engine_rows: int, tp_base: int,
                     n_experts: int = 0,
                     group: Optional[RankGroup] = None,
                     view_group: Optional[RankGroup] = None,
                     ed_group: Optional[RankGroup] = None) -> TPContext:
    """TPContext for a flying-serving mode over ('dp', 'merge', 'ed',
    'model'); ``group``, ``view_group`` and ``ed_group`` bind it to one
    island's TP, view and 'ed' groups (see ``TPContext.bind``). ``ep`` is
    the JAX package's: ``engine_rows`` when a MoE model's ``n_experts``
    split over them (the MoE layer's all_to_all then runs over the 'ed'
    group)."""
    ep = engine_rows if (n_experts and n_experts % engine_rows == 0
                         and engine_rows > 1) else 1
    ctx = TPContext(tp=merge * engine_rows * tp_base, view_m=merge, ep=ep)
    return ctx.bind(group, view_group, ed_group) if group is not None \
        else ctx
