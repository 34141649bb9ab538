"""Flying-serving parallel modes and heterogeneous fleet layouts.

A *ParallelPlan* fixes the per-architecture engine tiling of the pod mesh
(DESIGN.md §4): the pod's ``(data=16, model=16)`` grid is factored into
``dp_engines`` independent engine tiles of ``engine_rows x tp_base``
devices. A *FlyingMode* is one runtime configuration: ``merge`` adjacent
engines bound into a TP group (the paper's bind primitive). merge=1 is
pure DP-of-engines; merge=dp_engines is full TP.

A *FleetLayout* generalizes the single fleet-wide merge to the paper's
headline use case (Fig. 3, §2.3 UC2): an ordered partition of the engine
tiles into contiguous, buddy-aligned power-of-two *islands*, each with
its OWN merge — e.g. 8 engines as ``[TP4-island | 4x DP]``. A uniform
mode is the degenerate single-island layout. Every island spans a
contiguous slice of the flat device order, so the zero-copy invariant
holds island-locally: reinterpreting an island's merge moves no bytes,
and islands untouched by a rebind keep their buffers (and their async
in-flight windows) untouched.

An island may additionally carry a *sequence-parallel* degree ``sp``
(docs/PERF.md §D12): its ``merge`` engines split into ``sp`` shards of
``write_tag = merge // sp`` engines each, and a request's KV spreads
across the shards BY TOKEN RANGE instead of (only) by head. A request
served by an SP island is therefore no longer bounded by one engine's
pool — its per-request context capacity is ``sp x`` a write-tag
group's. ``sp=1`` (the default) is the plain TP/DP island; ``sp ==
merge`` is a pure-SP island whose shards each hold ALL kv heads (write
tag 1). ``group_of`` returns ``(lead, group_merge, shard)`` so callers
can address the shard ring, and ``changed_engines`` treats an
SP-degree change like any other reshape.

The port runs one process per device (a *rank*). Where the JAX package
reshapes ``jax.devices()`` into a mode mesh over ``MODE_AXES``, the port
reshapes the world ranks ``0 .. n-1`` the same way (``mode_ranks``,
``island_ranks``): rank ``r`` is the JAX package's device ``r``, so the
same rank holds the same storage shard under every mode, and a rank's
position on the mesh axes gives its TP rank arithmetic
(``core/views.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

MODE_AXES = ("pod", "dp", "merge", "ed", "model")

@dataclass(frozen=True)
class ParallelPlan:
    engine_rows: int = 1     # r: data-axis rows per engine tile
    tp_base: int = 16        # model axis extent
    data_rows: int = 16      # data axis extent per pod
    pods: int = 1

    @property
    def dp_engines(self) -> int:
        return self.data_rows // self.engine_rows

    @property
    def devices_per_pod(self) -> int:
        return self.data_rows * self.tp_base

    def valid_merges(self) -> Tuple[int, ...]:
        """Topology-aware group identification (paper §4.3): contiguous
        power-of-two merges only — linear, not exponential, enumeration."""
        ms = []
        m = 1
        while m <= self.dp_engines:
            ms.append(m)
            m *= 2
        return tuple(ms)


@dataclass(frozen=True)
class FlyingMode:
    plan: ParallelPlan
    merge: int

    def __post_init__(self):
        if self.merge not in self.plan.valid_merges():
            raise ValueError(
                f"merge={self.merge} not in {self.plan.valid_merges()}")

    @property
    def dp(self) -> int:
        """Independent engine groups after merging."""
        return self.plan.dp_engines // self.merge

    @property
    def tp(self) -> int:
        """Effective TP degree of a merged group."""
        return self.merge * self.plan.engine_rows * self.plan.tp_base

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        return (self.plan.pods, self.dp, self.merge, self.plan.engine_rows,
                self.plan.tp_base)

    def describe(self) -> str:
        return (f"{self.plan.pods}pod x {self.dp}DP x {self.tp}TP "
                f"(merge={self.merge}, tile={self.plan.engine_rows}x"
                f"{self.plan.tp_base})")


def plan_for(cfg, pods: int = 1, data_rows: int = 16, tp_base: int = 16
             ) -> ParallelPlan:
    return ParallelPlan(engine_rows=cfg.engine_rows, tp_base=tp_base,
                        data_rows=data_rows, pods=pods)


# ---------------------------------------------------------------------------
# heterogeneous fleet layouts (per-island DP/TP coexistence)
# ---------------------------------------------------------------------------

def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class Island:
    """A contiguous, buddy-aligned slice of the fleet's engine tiles
    bound to one merge. ``n_engines // merge`` independent DP groups of
    ``merge`` engines each; a pure TP island has ``n_engines == merge``.
    Two islands with the same ``shape`` run the same compiled programs
    (the Communicator Pool keys runners by shape, not position).

    ``sp`` adds the sequence-parallel axis (docs/PERF.md §D12): each
    merge group splits into ``sp`` *shards* of ``merge // sp`` engines.
    KV is written under the shard-width tag (``write_tag``) and new
    blocks round-robin across the shards, so one request's context pools
    the whole group's block budget instead of a single engine's.
    Attention still runs as ONE merge-wide collective — each shard
    computes partial attention over its resident tokens and the existing
    LSE merge combines them — so the mesh (and the zero-copy invariant)
    is exactly that of a plain merge-``m`` island. ``sp=1`` is the
    classic head-sharded island and keeps equality/hash with pre-SP
    layouts."""
    start: int       # absolute first engine tile
    n_engines: int   # pow2 tile count; start % n_engines == 0
    merge: int       # pow2 TP binding, 1 <= merge <= n_engines
    sp: int = 1      # pow2 sequence-parallel degree, divides merge

    def __post_init__(self):
        if not _is_pow2(self.n_engines):
            raise ValueError(f"island size {self.n_engines} not a pow2")
        if not _is_pow2(self.merge) or self.merge > self.n_engines:
            raise ValueError(
                f"merge={self.merge} invalid for a {self.n_engines}-engine "
                f"island")
        if not _is_pow2(self.sp) or self.merge % self.sp != 0:
            raise ValueError(
                f"sp={self.sp} invalid: must be a pow2 dividing "
                f"merge={self.merge}")
        if self.start % self.n_engines != 0:
            raise ValueError(
                f"island [{self.start}, {self.stop}) not buddy-aligned")

    @property
    def write_tag(self) -> int:
        """Tag (engines per SP shard) new KV blocks are written under."""
        return self.merge // self.sp

    @property
    def stop(self) -> int:
        return self.start + self.n_engines

    @property
    def groups(self) -> int:
        return self.n_engines // self.merge

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n_engines, self.merge)

    def engines(self) -> range:
        return range(self.start, self.stop)

    def lead_engines(self) -> range:
        """Absolute lead engine of each DP group within the island."""
        return range(self.start, self.stop, self.merge)

    def group_of(self, engine: int) -> Tuple[int, int, int]:
        """(absolute lead engine, merge, sp) of the group serving
        `engine` — the identity that decides whether a rebind reshapes
        it. ``sp`` is part of the identity: changing only the SP degree
        of a group changes its write placement and compiled programs, so
        its engines must ride a transition like any other rebind."""
        lead = self.start + ((engine - self.start) // self.merge) * self.merge
        return (lead, self.merge, self.sp)

    def describe(self) -> str:
        if self.sp > 1:
            t = self.write_tag
            kind = f"SP{self.sp}" if t == 1 else f"TP{t}xSP{self.sp}"
        else:
            kind = f"TP{self.merge}" if self.merge > 1 else "DP"
        return f"{self.groups}x{kind}" if self.groups > 1 else kind


def _buddy_pieces(start: int, stop: int) -> Iterator[Tuple[int, int]]:
    """Decompose [start, stop) into maximal buddy-aligned pow2 pieces."""
    while start < stop:
        size = (start & -start) or 1 << ((stop - start).bit_length() - 1)
        while size > stop - start:
            size >>= 1
        yield (start, size)
        start += size


@dataclass(frozen=True)
class FleetLayout:
    """Ordered partition of the fleet's engine tiles into islands.

    The runtime invariant everything hangs off: islands are contiguous,
    cover every engine exactly once, and each is buddy-aligned — so
    every island's devices are a contiguous slice of the flat
    device order and per-island sub-meshes reinterpret
    (never move) resident shards. Uniform modes are the single-island
    degenerate case (``FleetLayout.uniform``)."""
    plan: ParallelPlan
    islands: Tuple[Island, ...]

    def __post_init__(self):
        total = self.total_engines
        pos = 0
        for isl in self.islands:
            if isl.start != pos:
                raise ValueError(
                    f"islands not contiguous at engine {pos}: {self.islands}")
            pos = isl.stop
        if pos != total:
            raise ValueError(
                f"islands cover {pos} of {total} engines: {self.islands}")

    @property
    def total_engines(self) -> int:
        return self.plan.pods * self.plan.dp_engines

    @staticmethod
    def uniform(plan: ParallelPlan, merge: int) -> "FleetLayout":
        n = plan.pods * plan.dp_engines
        return FleetLayout(plan, (Island(0, n, merge),))

    @staticmethod
    def of(plan: ParallelPlan,
           shapes: Sequence[Tuple[int, ...]]) -> "FleetLayout":
        """Build from ordered (n_engines, merge[, sp]) shapes."""
        islands, pos = [], 0
        for shp in shapes:
            n, m = shp[0], shp[1]
            sp = shp[2] if len(shp) > 2 else 1
            islands.append(Island(pos, n, m, sp))
            pos += n
        return FleetLayout(plan, tuple(islands))

    # -- lookups ---------------------------------------------------------
    def island_of(self, engine: int) -> Island:
        for isl in self.islands:
            if isl.start <= engine < isl.stop:
                return isl
        raise IndexError(f"engine {engine} outside fleet "
                         f"[0, {self.total_engines})")

    def merge_of(self, engine: int) -> int:
        return self.island_of(engine).merge

    @property
    def max_merge(self) -> int:
        return max(isl.merge for isl in self.islands)

    @property
    def uniform_merge(self) -> Optional[int]:
        """The fleet-wide merge when the layout is uniform, else None."""
        return self.islands[0].merge if len(self.islands) == 1 else None

    @property
    def n_groups(self) -> int:
        return sum(isl.groups for isl in self.islands)

    def shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple(isl.shape for isl in self.islands)

    def describe(self) -> str:
        return "[" + " | ".join(i.describe() for i in self.islands) + "]"

    # -- layout algebra --------------------------------------------------
    def carve(self, start: int, n_engines: int, merge: int,
              sp: int = 1) -> "FleetLayout":
        """Bind engines [start, start+n) into one island of `merge`
        (optionally sequence-parallel of degree `sp`), splitting any
        partially-overlapped island into buddy pieces that KEEP their
        old merge where the piece still holds a whole group (those
        engines' group assignment — hence their serving state — is
        untouched). Remainder pieces that cannot hold a whole group of
        the old island fall back to sp=1 (an SP placement narrower than
        its group is meaningless)."""
        target = Island(start, n_engines, merge, sp)
        out = []
        for isl in self.islands:
            if isl.stop <= target.start or isl.start >= target.stop:
                out.append(isl)
                continue
            if target.start <= isl.start and isl.stop <= target.stop:
                continue  # fully replaced
            for lo, hi in ((isl.start, min(isl.stop, target.start)),
                           (max(isl.start, target.stop), isl.stop)):
                for ps, pn in _buddy_pieces(lo, hi):
                    pm = min(isl.merge, pn)
                    out.append(Island(ps, pn, pm,
                                      isl.sp if pm == isl.merge else 1))
        out.append(target)
        out.sort(key=lambda i: i.start)
        return FleetLayout(self.plan, tuple(out))

    def dissolved(self) -> "FleetLayout":
        """Every island to pure DP (merge=1) IN PLACE: boundaries are
        preserved so already-DP islands are untouched by the rebind."""
        return FleetLayout(self.plan, tuple(
            isl if isl.merge == 1 else Island(isl.start, isl.n_engines, 1)
            for isl in self.islands))

    def quarantine(self, engines) -> "FleetLayout":
        """Re-carve buddy-aligned islands around dead engine tiles: each
        quarantined engine becomes a singleton DP island (no healthy
        engine shares a collective with it), and the buddy remainders of
        any group it belonged to fall back to the widest merge they can
        still sustain. Engines whose group contained no dead tile keep
        their group identity — ``changed_engines`` against the result is
        exactly the blast radius of the failure."""
        out = self
        for e in sorted(set(engines)):
            isl = out.island_of(e)
            if isl.n_engines == 1:
                continue  # already isolated
            out = out.carve(e, 1, 1)
        return out

    def changed_engines(self, new: "FleetLayout") -> frozenset:
        """Engines whose GROUP assignment (lead engine, merge, sp) differs
        under `new` — the partial-rebind scope: only requests on these
        engines are incompatible with the transition, and only islands
        containing them drain. Splitting a DP island leaves its engines
        out of this set (their groups are identical either way)."""
        return frozenset(
            e for e in range(self.total_engines)
            if self.island_of(e).group_of(e) != new.island_of(e).group_of(e))


def island_plan(plan: ParallelPlan, island: Island) -> ParallelPlan:
    """The sub-plan an island's programs compile against: same engine
    tile, data rows covering only the island's engines."""
    return ParallelPlan(engine_rows=plan.engine_rows, tp_base=plan.tp_base,
                        data_rows=island.n_engines * plan.engine_rows,
                        pods=1)


def island_mode(plan: ParallelPlan, island: Island) -> FlyingMode:
    return FlyingMode(island_plan(plan, island), island.merge)


def mode_ranks(mode: FlyingMode) -> np.ndarray:
    """World ranks in the mode mesh's device order: the flat rank order
    reshaped row-major over ``MODE_AXES`` (the JAX package's
    ``mode_mesh`` over ``jax.devices()``), identical across modes."""
    n = mode.plan.pods * mode.plan.devices_per_pod
    return np.arange(n).reshape(mode.mesh_shape)


def island_ranks(plan: ParallelPlan, island: Island) -> np.ndarray:
    """World ranks of one island, shaped ``(1, groups, merge, engine_rows,
    tp_base)`` over ``MODE_AXES`` (the JAX package's ``island_mesh``): a
    contiguous slice of the flat rank order. ``[0, g]`` flattened is DP
    group ``g``'s TP group, in TP rank order ('merge', 'ed', 'model')."""
    tile = plan.engine_rows * plan.tp_base
    ranks = np.arange(island.start * tile, island.stop * tile)
    return ranks.reshape(1, island.groups, island.merge, plan.engine_rows,
                         plan.tp_base)


def tp_group_ranks(plan: ParallelPlan) -> Tuple[Tuple[int, ...], ...]:
    """Every TP group any layout of this plan can hold: for each pow2
    merge ``m``, each buddy-aligned run of ``m`` engines with its
    ('ed', 'model') ranks, in a fixed order (merge, then position). A
    rank sits in one group per merge."""
    tile = plan.engine_rows * plan.tp_base
    total = plan.pods * plan.dp_engines
    out = []
    m = 1
    while m <= total:
        for start in range(0, total, m):
            out.append(tuple(range(start * tile, (start + m) * tile)))
        m *= 2
    return tuple(out)


def ed_group_ranks(plan: ParallelPlan) -> Tuple[Tuple[int, ...], ...]:
    """Every 'ed' group of every TP group ``tp_group_ranks`` yields: in a
    TP group of ``merge * engine_rows * tp_base`` ranks (TP rank order
    ('merge', 'ed', 'model')), the ranks of one merge index and one
    'model' index (``TPContext.ed_members``). Such a group lies inside
    one engine tile, so every merge's TP groups share them: one group
    per engine and 'model' index, in that order, each listed once."""
    tile = plan.engine_rows * plan.tp_base
    out = {}
    for ranks in tp_group_ranks(plan):
        for m in range(len(ranks) // tile):
            for j in range(plan.tp_base):
                g = ranks[m * tile + j:(m + 1) * tile:plan.tp_base]
                out.setdefault(g, None)
    return tuple(out)


def enumerate_layouts(plan: ParallelPlan) -> Tuple[FleetLayout, ...]:
    """All valid layouts: every buddy decomposition of the engine range
    crossed with every per-island merge. NOTE: this count is doubly
    exponential in fleet size (12 at 4 engines, 148 at 8, ~22k at 16,
    ~5e8 at 32) — it exists for tests and small-fleet introspection.
    Precompilation never needs it: runners key on island SHAPES, and the
    distinct (n_engines, merge) pairs (``island_shapes``) number only
    O(log^2 fleet)."""
    def region(start: int, n: int):
        m = 1
        while m <= n:
            yield (Island(start, n, m),)
            m *= 2
        if n > 1:
            h = n // 2
            for left in region(start, h):
                for right in region(start + h, h):
                    yield left + right
    total = plan.pods * plan.dp_engines
    return tuple(FleetLayout(plan, isls) for isls in region(0, total))


def island_shapes(plan: ParallelPlan) -> Tuple[Tuple[int, int], ...]:
    """The distinct island shapes any layout of this plan can contain —
    the communicator pool's (linear) precompile key space."""
    shapes = []
    n = 1
    while n <= plan.pods * plan.dp_engines:
        m = 1
        while m <= n:
            shapes.append((n, m))
            m *= 2
        n *= 2
    return tuple(shapes)
