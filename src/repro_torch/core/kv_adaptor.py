"""KV Cache Adaptor (paper §4.2): one physical block pool, mode-dependent
*logical* interpretation.

Physical invariant (paper Eq. 2): per-device block bytes
``M_block = B_base * kvh_dev * head_dim * P_size`` never change. Under a
merge-m TP group the per-device head slice shrinks to ``kvh_dev/m`` so
token capacity grows ``B(m) = m * B_base`` (paper Eq. 3 / Alg. 1 step 4:
``B_req = B_base*N_eng``, ``H_req = H_base/N_eng``). Device pools are
stored FLAT ``[num_blocks, block_elems]``; each compiled mode *views*
them ``[num_blocks, B(m), kvh_dev/m, hd]`` — a metadata reshape, no
reallocation, no migration.

The host side is the ``LogicalTable``: request -> ordered *segments*,
each carrying a PLACEMENT TAG ``(mode_tag, shard)`` and the block ids
plus owner group that realize it. Each segment's blocks are written
under one placement and FROZEN when the request crosses a rebind: new
tokens append into a fresh segment under the current placement's
capacity. A request is NOT bound to one TP group: its segments may be
owned by different groups of the same island — the only invariant is
that every owner group is inside the island that serves the request.
The per-segment contract (§4.2 extended, docs/PERF.md §D8/§D12): a
block is *written* only under the placement that opened its segment,
but it may be *read* under any later mode by an island that contains
the segment's owner group — each owner computes partial attention over
the (head slice, token range) it physically holds and the serve step
LSE-combines partials across the island. That is what lets the LIVE
transition strategy carry running decodes across a rebind with zero
pauses and zero recomputation; Hard-Preempt (suspend, blocks resident)
and Soft-Preempt (recompute) remain the fallbacks for architectures
whose layout is not tag-readable (``PoolGeometry.live_readable``).

Sequence-parallel placements (§D12): an SP island (``Island.sp > 1``)
splits its merge group into ``sp`` shards of ``write_tag`` engines.
Each shard is its own allocation group; new blocks round-robin across
the shard ring (one single-block segment per block, ``Segment.shard``
recording the rotation slot) so ONE request pools ALL shards' block
budgets — context capacity scales with engine count even after
head-splitting is exhausted. Attention is the same per-segment partial
+ LSE-merge collective, just with token-range (rather than head-slice)
disjointness, and elastic SP-degree changes are ordinary LIVE rebinds:
the live block keeps filling, only future rotation widens.

Allocation is a free-list over physical block ids PER ENGINE. When
engines are bound into a TP group (``bind_group``), a group allocation
takes ids that are free on EVERY member — the same id then addresses
the written block on each member's pool — and releases return each
segment's ids to the adaptors that owned them at write time, so blocks
held by another engine's in-flight (or paused) requests are never
clobbered by the merged group's writes.

Arch caveats (DESIGN.md §5): MLA's compressed cache and MQA's single KV
head cannot head-shard, so their view (and capacity) is mode-invariant —
``capacity_scales`` reports whether Eq. 3 applies, ``live_readable``
whether cross-tag reads are possible at all.

Cross-request prefix cache (docs/PERF.md §D10): on top of the segment
machinery, the adaptor can content-address full prompt blocks. Each
committed block gets a CHAINED hash key (previous block's key + mode
tag + token ids), so a block's identity includes everything before it;
a new request's prompt is walked block-by-block against the index and
its leading segment ATTACHES to resident blocks (refcount++, zero
prefill) — copy-on-write at block granularity: shared blocks are
immutable, the first divergent or partial block starts a private
segment, so no device copy is ever needed. Cached blocks keep their
writer's mode tag and owner group; the per-segment live-read contract
above is exactly what makes a prefix cached under one merge readable
from islands running another. Blocks whose refcount drops to zero are
PARKED in a per-owner eviction pool (LRU), not freed — reclaimed on
demand when the free list runs dry, and drained first by ``seize``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.modes import FlyingMode, ParallelPlan
from repro_torch.core.views import pow2_shards


@dataclass(frozen=True)
class PoolGeometry:
    """Static geometry of one architecture's per-device pool.

    Two layouts:
      - 'head': the paper's scheme — pool holds this device's KV-head
        slice for ALL tokens of its engine; capacity scales with merge
        only while KV heads can split further (Eq. 3's regime).
      - 'striped' (beyond-paper, DESIGN.md/EXPERIMENTS §Perf): the pool
        holds ALL KV heads for every tp-th token (context parallelism).
        Capacity then scales with the FULL TP degree for any architecture
        — including MLA's compressed cache and MQA — restoring Eq. 3
        universally on wide TPU tiles.
    """
    cfg: ArchConfig
    plan: ParallelPlan
    num_blocks: int
    block_base: int  # B_base: tokens/block in the base (merge=1) mode
    layout: str = "head"  # 'head' | 'striped'

    @property
    def storage_tp(self) -> int:
        return self.plan.engine_rows * self.plan.tp_base

    def stripe_factor(self, merge: int) -> int:
        return merge * self.plan.engine_rows * self.plan.tp_base

    @property
    def kvh_dev_base(self) -> int:
        """KV heads per device in the base mode (>=1; replication below)."""
        kv = self.cfg.num_kv_heads
        if self.cfg.mla is not None or kv == 0:
            return 1
        return kv // pow2_shards(kv, self.storage_tp)

    @property
    def token_width(self) -> int:
        """Per-token per-device elements in base mode (one of k/v pool)."""
        cfg = self.cfg
        if cfg.mla is not None:
            return cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
        kv = cfg.num_kv_heads
        if self.layout == "striped":
            return kv * cfg.resolved_head_dim  # all heads, strided tokens
        kvh_dev = kv // pow2_shards(kv, self.storage_tp)
        return kvh_dev * cfg.resolved_head_dim

    @property
    def block_elems(self) -> int:
        """The invariant: physical elements per block per device."""
        return self.block_base * self.token_width

    # ---- mode-dependent logical view -----------------------------------
    def head_split(self, merge: int) -> int:
        """How much of `merge` can be absorbed by head-splitting."""
        cfg = self.cfg
        if cfg.mla is not None or cfg.num_kv_heads == 0:
            return 1
        kvh = self.kvh_dev_base
        return min(1 << _v2(kvh), merge)

    def capacity(self, merge: int) -> int:
        """B(m): effective tokens per block under merge m (paper Eq. 3;
        striped layout generalizes it to the full TP degree)."""
        if self.layout == "striped":
            return self.block_base * self.stripe_factor(merge)
        return self.block_base * self.head_split(merge)

    def capacity_scales(self, merge: int) -> bool:
        if self.layout == "striped":
            return True
        return self.head_split(merge) == merge

    def live_readable(self, merge: int) -> bool:
        """Whether KV written under OTHER tags can be read in place by a
        merge-m group (per-segment partial attention + LSE combine,
        docs/PERF.md §D8). Head layout needs clean nested head sharding:
        both q and kv heads must divide the engine tile exactly and
        split ``merge`` further ways (capacity_scales' regime) — MLA's
        compressed cache and MQA's single KV head never qualify, so
        those keep the HARD/SOFT fallbacks. Striped pools satisfy Eq. 3
        universally (tokens carry ALL heads); real-execution backends
        additionally gate on what their step programs implement."""
        if self.layout == "striped":
            return True
        cfg = self.cfg
        if cfg.mla is not None or cfg.num_kv_heads <= 0:
            return False
        st = self.storage_tp
        kv, H = cfg.num_kv_heads, cfg.num_heads
        if kv % st or H % st:
            return False
        if not self.capacity_scales(merge):
            return False
        return (kv // st) % merge == 0 and (H // st) % merge == 0

    def view_shape(self, merge: int) -> Tuple[int, ...]:
        """Logical per-device pool view for a compiled mode."""
        cfg = self.cfg
        if cfg.mla is not None:
            return (self.num_blocks, self.block_base, self.token_width)
        hd = cfg.resolved_head_dim
        if self.layout == "striped":
            return (self.num_blocks, self.block_base, cfg.num_kv_heads, hd)
        hs = self.head_split(merge)
        return (self.num_blocks, self.block_base * hs,
                self.kvh_dev_base // hs, hd)

    def view(self, flat_pool, merge: int):
        """Reinterpret the flat physical pool for a mode — pure reshape."""
        return flat_pool.reshape(flat_pool.shape[:-2] + self.view_shape(merge))

    def flat_shape(self) -> Tuple[int, int]:
        return (self.num_blocks, self.block_elems)


def _v2(n: int) -> int:
    k = 0
    while n > 0 and n % 2 == 0:
        n //= 2
        k += 1
    return k


# ---------------------------------------------------------------------------
# host-side logical table + allocator
# ---------------------------------------------------------------------------

def ragged_arange(lens: np.ndarray) -> np.ndarray:
    """[0..l0), [0..l1), ... concatenated — one vectorized pass. Shared
    by the adaptor's batch builders and the engine's batch assembly."""
    lens = np.asarray(lens, np.int64)
    total = int(lens.sum())
    return np.arange(total) - np.repeat(np.cumsum(lens) - lens, lens)


@dataclass
class Segment:
    """One mode's contiguous run of a request's tokens.

    ``start`` is the first global token position the segment covers;
    its token count is ``entry.length - start`` for the live (last)
    segment and ``next_segment.start - start`` for frozen ones. The
    last block of a frozen segment may be partially filled — crossing a
    rebind freezes it; new tokens go to a fresh segment under the new
    capacity. ``owners`` are the adaptors whose physical pools hold the
    segment's blocks (the TP-group members at write time) — releases
    return ids to exactly these.

    ``shared`` marks a refcounted prefix-cache segment: its blocks are
    immutable (copy-on-write — appends always open a fresh private
    segment) and release/truncate DETACH its ``cached`` entries instead
    of freeing the ids.

    ``(tag, shard)`` together form the segment's PLACEMENT TAG
    (docs/PERF.md §D12). ``shard >= 0`` marks a sequence-parallel
    placement: the segment holds exactly ONE block, written by shard
    ``shard`` of the island's SP ring at allocation time — ``owners``
    are that shard's ``tag``-wide TP group, so the block stores the
    full ``tag``-slice of KV heads for its token range and nothing
    else. ``shard == -1`` is the classic head-sharded placement (the
    whole merge group owns every token)."""
    tag: int
    start: int
    ids: List[int] = field(default_factory=list)
    owners: Tuple["KVCacheAdaptor", ...] = ()
    shared: bool = False
    cached: Tuple["CachedBlock", ...] = ()
    shard: int = -1


@dataclass
class RequestKV:
    mode_tag: int                  # tag of the CURRENT (write) segment
    segments: List[Segment] = field(default_factory=list)
    length: int = 0                # tokens currently cached (all segments)
    # sequence-parallel rotation cursor: blocks allocated so far under
    # SP placements — block k lands on ring shard ``k % len(ring)``.
    # Survives SP-degree rebinds (the rotation just continues over the
    # wider/narrower ring), so growth stays balanced across shards.
    sp_cursor: int = 0
    _ids_np: Optional[np.ndarray] = field(default=None, repr=False,
                                          compare=False)

    @property
    def block_ids(self) -> List[int]:
        """All block ids in segment (write) order — the seed-era flat
        view; position math over it is only valid single-segment."""
        return [b for s in self.segments for b in s.ids]

    @property
    def max_tag(self) -> int:
        return max((s.tag for s in self.segments), default=self.mode_tag)

    def tags(self) -> Tuple[int, ...]:
        return tuple(s.tag for s in self.segments)

    def seg_tokens(self, i: int) -> int:
        """Token count of segment i (frozen segments end where the next
        one starts)."""
        segs = self.segments
        end = segs[i + 1].start if i + 1 < len(segs) else self.length
        return end - segs[i].start

    def ids_np(self) -> np.ndarray:
        """Cached int32 view of the concatenated block ids (rebuilt only
        on growth) — the vectorized batch builders index this without
        re-converting the Python lists every step."""
        n = sum(len(s.ids) for s in self.segments)
        if self._ids_np is None or len(self._ids_np) != n:
            if n:
                self._ids_np = np.concatenate(
                    [np.asarray(s.ids, np.int32) for s in self.segments
                     if s.ids])
            else:
                self._ids_np = np.empty((0,), np.int32)
        return self._ids_np


# ---------------------------------------------------------------------------
# content-addressed prefix cache (§D10)
# ---------------------------------------------------------------------------

def _chain_key(prev: int, tag: int, tokens) -> int:
    """Chained content hash of one full block: previous block's key +
    writer mode tag + the block's token ids. Chaining makes a block's
    identity include EVERYTHING before it, so equal keys imply equal
    full prefixes; tag is mixed in because capacity (tokens/block) and
    the physical head slicing differ per tag — chains never mix tags.
    Process-stable is sufficient (the index lives in one process)."""
    return hash((prev, tag, np.asarray(tokens, np.int64).tobytes()))


@dataclass(eq=False)
class CachedBlock:
    """One content-addressed full block resident in its owners' pools.

    ``refcount`` counts attached requests (including the writer until
    it releases). At zero the block is PARKED in every owner's
    ``_evict_pool`` — still in the index, revivable by the next attach —
    and only actually freed by LRU reclaim, ``seize`` or eviction."""
    key: int
    block_id: int
    tag: int
    owners: Tuple["KVCacheAdaptor", ...]
    refcount: int = 0
    last_use: int = 0
    # adaptor whose ``_parked_clean`` counter this parked block is
    # credited to (None = not counted; see PrefixCache._count_parked)
    counted: Optional["KVCacheAdaptor"] = None


class PrefixCache:
    """Fleet-wide content-addressed index over committed prompt blocks.

    One instance is shared by every adaptor in the fleet (the scheduler
    wires it); block ids inside entries are per-owner-pool, so the same
    id on different engines never collides — the chained key is the
    global identity. ``stats`` are cumulative counters surfaced in
    ``StepLog``/serve."""

    def __init__(self) -> None:
        self.index: Dict[int, CachedBlock] = {}
        self.tags: set = set()          # tags with >=1 committed chain
        self._clock = 0
        self.stats = {"hit_requests": 0, "miss_requests": 0,
                      "hit_tokens": 0, "inserted_blocks": 0,
                      "evictions": 0}

    def touch(self, cb: CachedBlock) -> None:
        self._clock += 1
        cb.last_use = self._clock

    def _count_parked(self, cb: CachedBlock) -> None:
        """O(owners) bookkeeping at park time: credit the block to its
        lead owner's ``_parked_clean`` counter when its owners are
        exactly one bound group — that group can reclaim it with a
        single eviction, so ``free_blocks`` may count it as allocatable
        WITHOUT scanning the pools (the scan is O(parked blocks) and
        sits on the per-tick admission path). Blocks whose ownership no
        longer matches any group (layout changed under them) are not
        credited — they stay reclaimable via the exact ``_reclaimable``
        slow path; ``bind_fleet`` recounts everything on rebind."""
        lead = min(cb.owners, key=lambda a: a.engine_id)
        if set(cb.owners) == set(lead.group):
            cb.counted = lead
            lead._parked_clean += 1

    def _uncount(self, cb: CachedBlock) -> None:
        if cb.counted is not None:
            cb.counted._parked_clean -= 1
            cb.counted = None

    def evict(self, cb: CachedBlock) -> None:
        """Drop one refcount-0 block: remove it from the index and
        return its id to every owner's free pool. Descendant chain
        entries become unreachable (lookups walk from the root) and age
        out of the pool by the same LRU — they are never resurrected
        because their parent key is gone."""
        assert cb.refcount == 0, "evicting a referenced prefix block"
        self._uncount(cb)
        self.index.pop(cb.key, None)
        for a in cb.owners:
            if a._evict_pool.pop(cb.block_id, None) is not None:
                a._give_back((cb.block_id,))
        self.stats["evictions"] += 1


class KVCacheAdaptor:
    """Constant-time metadata remapping across DP/TP layouts (paper §4.2.2).

    One physical free list PER ENGINE; per-request logical entries carry
    ordered (mode_tag, block_ids) segments. ``switch_mode`` is O(1): it
    only changes the capacity used for FUTURE allocations (a fresh
    segment opens on the next append). ``bind_group`` scopes allocation
    to a TP group: ids are taken only when free on every member and
    handed back to the members that owned them at write time.
    """

    def __init__(self, geom: PoolGeometry):
        self.geom = geom
        # last block reserved as the parked-write scratch slot. ``free``
        # is a candidate stack that may hold STALE entries (ids another
        # group member allocated); ``_free_set`` is the truth — pops
        # validate against it lazily, so cross-member removal never
        # rewrites the list.
        self.free: List[int] = list(range(geom.num_blocks - 1))
        self._free_set = set(self.free)
        self.table: Dict[str, RequestKV] = {}
        self.merge = 1
        self.group: Tuple["KVCacheAdaptor", ...] = (self,)
        # ids free on EVERY group member, maintained incrementally (one
        # shared set object per group; None while ungrouped). Exact and
        # O(members) per block take/return — never re-intersected on the
        # admission path.
        self._group_free_set: Optional[set] = None
        # prefix cache (None = content addressing off; legacy behavior
        # is then bit-identical). ``_evict_pool`` parks this engine's
        # refcount-0 cached blocks: id -> CachedBlock, reclaimed LRU.
        self.prefix_cache: Optional[PrefixCache] = None
        self._evict_pool: Dict[int, CachedBlock] = {}
        # parked blocks credited to THIS adaptor as lead of a clean
        # owner group — free_blocks' O(group) reclaimable credit
        self._parked_clean = 0
        # fleet position, stamped by bind_fleet — cross-group owner
        # offsets in the engine's per-segment staging need it.
        self.engine_id = 0
        # sequence-parallel ring (§D12): shard-lead adaptors of this
        # engine's SP island, in shard order, or None outside SP islands.
        # Set by bind_fleet; new blocks round-robin across the ring.
        self._sp_ring: Optional[Tuple["KVCacheAdaptor", ...]] = None

    # -- O(1) mode switch --------------------------------------------------
    def switch_mode(self, merge: int) -> None:
        self.merge = merge

    def bind_group(self, members: Sequence["KVCacheAdaptor"]) -> None:
        """Set the TP-group allocation domain: future takes draw ids free
        on EVERY member (each member's pool physically receives the
        group's writes at that id). All members of one group must be
        bound with the same list (``bind_fleet`` does) so they share one
        group-free set object."""
        self.group = tuple(members) if members else (self,)
        self._group_free_set = None

    @property
    def capacity(self) -> int:
        return self.geom.capacity(self.merge)

    # -- allocation ----------------------------------------------------------
    def _group_free(self) -> set:
        """The shared ids-free-on-every-member set (computed once per
        rebind, maintained incrementally by takes/returns)."""
        if self._group_free_set is None:
            shared = set.intersection(*(a._free_set for a in self.group))
            for a in self.group:
                a._group_free_set = shared
        return self._group_free_set

    def free_blocks(self) -> int:
        """Blocks allocatable by THIS adaptor's group: free here AND on
        every bound member, plus cold cached blocks the group could
        reclaim on demand (refcount 0, parked in eviction pools). The
        reclaim credit is the incremental ``_parked_clean`` counter —
        O(group), not a pool scan; cross-layout leftovers it undercounts
        remain reclaimable via ``_take_blocks``' exact slow path."""
        base = (len(self._free_set) if len(self.group) <= 1
                else len(self._group_free()))
        if self.prefix_cache is not None:
            return base + sum(a._parked_clean for a in self.group)
        return base

    def _reclaimable(self) -> set:
        """Ids the group could free by evicting cold cached blocks: on
        EVERY member the id is either already free or parked refcount-0
        in the eviction pool (so one eviction pass makes it group-free).
        Excludes ids that are group-free already. Referenced blocks
        (refcount >= 1) are never in either set, hence untouchable."""
        cand = set()
        for a in self.group:
            cand.update(a._evict_pool.keys())
        if not cand:
            return cand
        if len(self.group) <= 1:
            return {b for b in cand if b not in self._free_set}
        gf = self._group_free()
        return {b for b in cand if b not in gf
                and all(b in a._free_set or b in a._evict_pool
                        for a in self.group)}

    def _lru_stamp(self, b: int) -> Tuple[int, int]:
        """LRU order for reclaim: oldest last-use across the group's
        parked copies first, id as deterministic tie-break."""
        stamp = 0
        for a in self.group:
            cb = a._evict_pool.get(b)
            if cb is not None:
                stamp = max(stamp, cb.last_use)
        return (stamp, b)

    def _reclaim(self, ids: Sequence[int]) -> None:
        """Evict the given parked cached blocks so their ids become
        group-free. ``evict`` returns each id to every OWNER's free
        pool; owners outside this group just get a free block back. The
        explicit shared-set add covers members that already had the id
        free (their ``_give_back`` never runs)."""
        pc = self.prefix_cache
        for b in ids:
            for a in self.group:
                cb = a._evict_pool.get(b)
                if cb is not None:
                    pc.evict(cb)
                    break
            if len(self.group) > 1 and \
                    all(b in a._free_set for a in self.group):
                self._group_free().add(b)

    def can_allocate(self, n_tokens: int, merge: Optional[int] = None,
                     req_id: Optional[str] = None) -> bool:
        """Mirror of ``allocate``'s need math: counts the blocks (and the
        free space in the last partial block) a ``req_id``'s live
        segment already holds, so resumed/chunked requests are admitted
        exactly when ``allocate`` would succeed."""
        m = merge if merge is not None else self.merge
        ring = self._sp_ring
        if ring and len(ring) > 1 and m == self.merge:
            cap = self.geom.capacity(m)
            room, cur = 0, 0
            if req_id is not None:
                e = self.table.get(req_id)
                if e:
                    cur = e.sp_cursor
                    seg = e.segments[-1] if e.segments else None
                    if seg and not seg.shared and seg.shard >= 0 \
                            and seg.tag == m:
                        room = cap * len(seg.ids) - (e.length - seg.start)
            per = self._sp_plan(max(n_tokens - room, 0), cur)
            return all(a.free_blocks() >= p for a, p in zip(ring, per))
        cap = self.geom.capacity(m)
        have = 0
        seg_tok = n_tokens
        if req_id is not None:
            e = self.table.get(req_id)
            if e and e.segments and e.segments[-1].tag == m \
                    and not e.segments[-1].shared:
                seg = e.segments[-1]
                have = len(seg.ids)
                seg_tok = (e.length - seg.start) + n_tokens
        need = -(-seg_tok // cap) - have
        return self.free_blocks() >= max(need, 0)

    def _take_blocks(self, n: int) -> List[int]:
        """Pop n ids free on every group member; remove them from every
        member's free set. Raises MemoryError without side effects when
        fewer than n are group-free."""
        if n <= 0:
            return []
        grouped = len(self.group) > 1
        usable = self._group_free() if grouped else self._free_set
        if len(usable) < n:
            # reclaim-on-demand: evict cold cached blocks (LRU) to cover
            # the shortfall. Transactional — the can-we check happens
            # BEFORE any eviction, so a MemoryError evicts nothing.
            reclaim = (self._reclaimable()
                       if self.prefix_cache is not None else set())
            if len(usable) + len(reclaim) < n:
                raise MemoryError("KV pool exhausted"
                                  + (" across TP group" if grouped else ""))
            short = n - len(usable)
            self._reclaim(sorted(reclaim, key=self._lru_stamp)[:short])
        got: List[int] = []
        skipped: List[int] = []
        while self.free and len(got) < n:
            b = self.free.pop()
            if b not in self._free_set:
                continue                     # stale entry: lazily dropped
            if b in usable:
                got.append(b)
            else:
                skipped.append(b)
        self.free.extend(reversed(skipped))
        assert len(got) == n, "free stack lost track of the free set"
        self._free_set.difference_update(got)
        if grouped:
            usable.difference_update(got)
            for a in self.group:
                if a is not self:
                    a._free_set.difference_update(got)
        return got

    def _give_back(self, ids: Sequence[int]) -> None:
        for b in ids:
            if b not in self._free_set:
                self._free_set.add(b)
                self.free.append(b)
                if len(self.group) > 1:
                    shared = self._group_free()
                    if all(b in a._free_set for a in self.group):
                        shared.add(b)
        # candidate-stack compaction: stale entries accumulate under
        # cross-member churn; rebuild deterministically when they
        # dominate (sorted -> identical pop order for adaptors that saw
        # identical op sequences)
        if len(self.free) > 2 * len(self._free_set) + 64:
            self.free = sorted(self._free_set)

    def allocate(self, req_id: str, n_tokens: int) -> RequestKV:
        """Alg. 1 step 4: KVCacheMgr.Allocate(req, B_req, H_req). Appends
        always target the CURRENT mode's segment — a tag change freezes
        the old segment in place (its blocks stay readable via the
        per-segment contract) and opens a new one.

        Exception-safe: the block take is the ONLY failure point and it
        happens before any table/segment mutation, so a MemoryError
        leaves the entry, the free stacks and the shared group-free set
        exactly as they were (the backpressure path retries after
        evicting a victim and must see clean state)."""
        if self._sp_ring and len(self._sp_ring) > 1:
            return self._allocate_sp(req_id, n_tokens)
        cap = self.capacity
        entry = self.table.get(req_id)
        seg = entry.segments[-1] if entry and entry.segments else None
        # shared prefix segments are immutable (copy-on-write): appends
        # after an attached prefix always open a fresh private segment
        fresh = seg is None or seg.tag != self.merge or seg.shared
        seg_tok = 0 if fresh else entry.length - seg.start
        held = 0 if fresh else len(seg.ids)
        need = -(-(seg_tok + n_tokens) // cap) - held
        new: List[int] = []
        if need > 0:
            try:
                new = self._take_blocks(need)
            except MemoryError:
                raise MemoryError(f"KV pool exhausted for {req_id}")
        if entry is None:
            entry = RequestKV(mode_tag=self.merge)
            self.table[req_id] = entry
        if fresh:
            seg = Segment(tag=self.merge, start=entry.length,
                          owners=self.group)
            entry.segments.append(seg)
            entry.mode_tag = self.merge
        if new:
            seg.ids.extend(new)
            entry._ids_np = None
        return entry

    # -- sequence-parallel allocation (§D12) -------------------------------
    def _sp_plan(self, need_tokens: int, cursor: int) -> List[int]:
        """Per-shard block need for ``need_tokens`` NEW tokens (live-block
        room already subtracted), starting the rotation at ``cursor``."""
        ring = self._sp_ring
        per = [0] * len(ring)
        for j in range(-(-need_tokens // self.capacity) if need_tokens else 0):
            per[(cursor + j) % len(ring)] += 1
        return per

    def _allocate_sp(self, req_id: str, n_tokens: int) -> RequestKV:
        """Sequence-parallel ``allocate``: one SEGMENT PER BLOCK, blocks
        round-robined across the island's SP ring (``sp_cursor`` keeps
        rotation across calls and across SP-degree rebinds). The live
        block's free room is consumed first; each overflow block opens a
        fresh ``(tag, shard)``-placed segment owned by the next shard's
        TP group. Transactional like ``allocate``: every shard's budget
        is checked BEFORE any block is taken or any entry mutates."""
        ring = self._sp_ring
        cap = self.capacity
        entry = self.table.get(req_id)
        seg = entry.segments[-1] if entry and entry.segments else None
        live = (seg is not None and not seg.shared and seg.shard >= 0
                and seg.tag == self.merge)
        room = cap * len(seg.ids) - (entry.length - seg.start) if live else 0
        cur = entry.sp_cursor if entry else 0
        per = self._sp_plan(max(n_tokens - room, 0), cur)
        for j, (a, p) in enumerate(zip(ring, per)):
            if p > a.free_blocks():
                raise MemoryError(
                    f"KV pool exhausted on SP shard {j} for {req_id}")
        if entry is None:
            entry = RequestKV(mode_tag=self.merge)
            self.table[req_id] = entry
        nblocks = sum(per)
        if nblocks:
            pos = seg.start + cap * len(seg.ids) if live else entry.length
            for j in range(nblocks):
                shard = (cur + j) % len(ring)
                a = ring[shard]
                bid = a._take_blocks(1)[0]
                entry.segments.append(Segment(
                    tag=self.merge, start=pos + j * cap, ids=[bid],
                    owners=a.group, shard=shard))
            entry.sp_cursor = cur + nblocks
            entry._ids_np = None
        entry.mode_tag = self.merge
        return entry

    def append_slots(self, req_id: str, n_tokens: int) -> np.ndarray:
        """Flat device slots for the next n_tokens (allocating as needed).
        Slot = block_id * capacity + segment-local offset, matching the
        current mode's view (writes only ever target the live segment —
        under SP, the covering run of per-block segments)."""
        entry = self.allocate(req_id, n_tokens)
        cap = self.capacity
        if self._sp_ring and len(self._sp_ring) > 1:
            if n_tokens <= 0:
                return np.empty((0,), np.int32)
            # tokens span the tail run of single-block SP segments whose
            # block reaches past the current length
            L = entry.length
            cov: List[Segment] = []
            for sg in reversed(entry.segments):
                if sg.shard < 0 or sg.tag != self.merge \
                        or sg.start + cap <= L:
                    break
                cov.append(sg)
            cov.reverse()
            starts = np.asarray([sg.start for sg in cov], np.int64)
            ids = np.asarray([sg.ids[0] for sg in cov], np.int64)
            pos = L + np.arange(n_tokens, dtype=np.int64)
            k = np.searchsorted(starts, pos, side="right") - 1
            slots = ids[k] * cap + (pos - starts[k])
            entry.length += n_tokens
            return slots.astype(np.int32)
        seg = entry.segments[-1]
        pos = (entry.length - seg.start) + np.arange(n_tokens)
        ids = np.asarray(seg.ids, np.int64)
        slots = ids[pos // cap] * cap + pos % cap
        entry.length += n_tokens
        return slots.astype(np.int32)

    def retag_tail(self, req_id: str) -> None:
        """Re-issue the request's single pending (allocated, not yet
        written) token slot under the CURRENT mode: roll the last token
        back out of the frozen segment (freeing a block that becomes
        surplus) and append it to a fresh current-tag segment. Called by
        the scheduler for requests riding a LIVE rebind — their next
        decode write must land under the new view. Raises MemoryError if
        the new segment's first block cannot be taken.

        Placement-aware (§D12): the no-op condition is that the tail
        segment's PLACEMENT matches the current one — same tag AND same
        sequence-parallel-ness. An SP tail under an SP ring stays put
        even across an SP-degree rebind (the live block's owners are
        unchanged; only future rotation widens), so an SP2→SP4 rebind
        re-issues nothing."""
        entry = self.table.get(req_id)
        if not entry or not entry.segments:
            return
        seg = entry.segments[-1]
        sp = bool(self._sp_ring and len(self._sp_ring) > 1)
        if seg.tag == self.merge and (seg.shard >= 0) == sp:
            return
        assert entry.length > seg.start, "no pending token to retag"
        self.truncate(req_id, 1)
        self.append_slots(req_id, 1)

    def truncate(self, req_id: str, n_tokens: int) -> None:
        """Roll the last ``n_tokens`` allocated slots back out of the
        entry, freeing surplus blocks to the adaptors that own them and
        popping segments the rollback empties. The undo primitive under
        ``retag_tail`` — and, for fault recovery, the rollback for an
        island launch that failed AFTER its slots were issued (the
        scheduler un-issues the tick's slots so allocator state matches
        the tokens that actually materialized)."""
        entry = self.table.get(req_id)
        if not entry or n_tokens <= 0:
            return
        entry.length = max(entry.length - n_tokens, 0)
        while entry.segments:
            seg = entry.segments[-1]
            owners = seg.owners or (self,)
            if entry.length < seg.start:
                if seg.shared:
                    self._detach(seg.cached)
                    seg.cached = ()
                else:
                    for a in owners:
                        a._give_back(seg.ids)
                if seg.shard >= 0:
                    entry.sp_cursor = max(entry.sp_cursor - 1, 0)
                entry.segments.pop()
                continue
            cap = self.geom.capacity(seg.tag)
            keep = -(-(entry.length - seg.start) // cap)
            if seg.shared:
                # refcounted, never freed here — detach the surplus tail
                if len(seg.ids) > keep:
                    self._detach(seg.cached[keep:])
                    seg.cached = seg.cached[:keep]
                    del seg.ids[keep:]
            else:
                while len(seg.ids) > keep:
                    b = seg.ids.pop()
                    for a in owners:
                        a._give_back((b,))
            if entry.length == seg.start and not seg.ids:
                if seg.shard >= 0:
                    entry.sp_cursor = max(entry.sp_cursor - 1, 0)
                entry.segments.pop()
            break
        if entry.segments:
            entry.mode_tag = entry.segments[-1].tag
        entry._ids_np = None

    def block_table(self, req_id: str, max_blocks: int) -> np.ndarray:
        ids = self.table[req_id].ids_np()
        if len(ids) > max_blocks:
            raise ValueError(
                f"request {req_id} holds {len(ids)} blocks > block-table "
                f"width {max_blocks}; attention would silently drop the "
                f"context tail (clamp belongs in the engine's admission "
                f"gate, not here)")
        out = np.zeros((max_blocks,), np.int32)
        out[:len(ids)] = ids
        return out

    # -- vectorized batch builders (§Perf D3) -----------------------------
    def lengths_batch(self, req_ids: Sequence[str]) -> np.ndarray:
        """Cached-token counts for a batch of requests, [N] int64."""
        tab = self.table
        return np.fromiter((tab[r].length for r in req_ids), np.int64,
                           len(req_ids))

    def block_table_batch(self, req_ids: Sequence[str], max_blocks: int,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
        """[N, max_blocks] block table; identical rows to per-request
        ``block_table``. ``out`` lets callers reuse a persistent host
        buffer (rows are fully overwritten). One vectorized scatter over
        the flattened (request, block) index space — the same
        padded-table trick as ``append_slots_batch`` — instead of a
        Python loop per request. Raises ValueError (naming the request)
        if any block list exceeds the table width: truncation silently
        drops the context tail."""
        n = len(req_ids)
        if out is None:
            out = np.zeros((n, max_blocks), np.int32)
        else:
            out[:n].fill(0)
        tab = self.table
        ids = [tab[r].ids_np() for r in req_ids]
        lens = np.fromiter((len(a) for a in ids), np.int64, n)
        over = lens > max_blocks
        if over.any():
            i = int(np.argmax(over))
            raise ValueError(
                f"request {req_ids[i]} holds {int(lens[i])} blocks > "
                f"block-table width {max_blocks}; attention would "
                f"silently drop the context tail")
        if n and int(lens.sum()):
            rowcat = np.repeat(np.arange(n), lens)
            offcat = ragged_arange(lens)
            cat = np.concatenate(ids)
            out[rowcat, offcat] = cat
        return out[:n]

    def append_slots_batch(self, req_ids: Sequence[str],
                           n_tokens) -> np.ndarray:
        """Batched ``append_slots``: one padded [N, max(n)] int32 slot
        array (-1 padding) for the next ``n_tokens[i]`` tokens of each
        request, allocating blocks as needed. Row i equals the
        per-request ``append_slots(req_ids[i], n_tokens[i])`` under the
        same allocation order; the slot math is a single vectorized pass
        over the flattened (request, offset) index space — segment-local
        positions against each entry's live segment."""
        n = len(req_ids)
        if np.isscalar(n_tokens):
            lens = np.full((n,), int(n_tokens), np.int64)
        else:
            lens = np.asarray(n_tokens, np.int64)
        ring = self._sp_ring
        if ring and len(ring) > 1:
            # SP batch: aggregate the per-SHARD need across rows before
            # any row allocates (same transactional contract as below,
            # but the budget is per shard, not one group pool)
            cap = self.capacity
            per = [0] * len(ring)
            for rid, t in zip(req_ids, lens):
                e = self.table.get(rid)
                room, cur = 0, 0
                if e:
                    cur = e.sp_cursor
                    seg = e.segments[-1] if e.segments else None
                    if seg and not seg.shared and seg.shard >= 0 \
                            and seg.tag == self.merge:
                        room = cap * len(seg.ids) - (e.length - seg.start)
                for j, p in enumerate(
                        self._sp_plan(max(int(t) - room, 0), cur)):
                    per[j] += p
            for j, (a, p) in enumerate(zip(ring, per)):
                if p > a.free_blocks():
                    raise MemoryError(
                        f"KV pool exhausted on SP shard {j}: batch of "
                        f"{n} needs {p} blocks, {a.free_blocks()} free")
            T = int(lens.max()) if n else 0
            out = np.full((n, T), -1, np.int32)
            for i, (rid, t) in enumerate(zip(req_ids, lens)):
                out[i, : int(t)] = self.append_slots(rid, int(t))
            return out
        # transactional pre-check: total block need vs the group-free
        # budget BEFORE any entry mutates. The per-request allocates
        # below draw from the same budget sequentially, so a shortfall
        # mid-batch would otherwise leave a prefix of requests grown —
        # this way a MemoryError leaves every entry, free stack, and the
        # shared group-free set exactly as they were.
        cap = self.capacity
        need = 0
        for rid, t in zip(req_ids, lens):
            e = self.table.get(rid)
            if e and e.segments and e.segments[-1].tag == self.merge \
                    and not e.segments[-1].shared:
                seg = e.segments[-1]
                need += max(
                    -(-(e.length - seg.start + int(t)) // cap)
                    - len(seg.ids), 0)
            else:
                need += -(-int(t) // cap)
        if need > self.free_blocks():
            raise MemoryError(
                f"KV pool exhausted: batch of {n} needs {need} blocks, "
                f"{self.free_blocks()} group-free")
        entries = [self.allocate(rid, int(t))
                   for rid, t in zip(req_ids, lens)]
        segs = [e.segments[-1] for e in entries]
        cap = self.capacity
        T = int(lens.max()) if n else 0
        out = np.full((n, T), -1, np.int64)
        total = int(lens.sum())
        if total:
            starts = np.fromiter(
                (e.length - s.start for e, s in zip(entries, segs)),
                np.int64, n)
            rowcat = np.repeat(np.arange(n), lens)
            offcat = ragged_arange(lens)
            poscat = np.repeat(starts, lens) + offcat
            maxb = max(len(s.ids) for s in segs)
            btab = np.zeros((n, maxb), np.int64)
            for i, s in enumerate(segs):
                btab[i, : len(s.ids)] = s.ids
            blockcat = btab[rowcat, poscat // cap]
            out[rowcat, offcat] = blockcat * cap + poscat % cap
        for e, t in zip(entries, lens):
            e.length += int(t)
        return out.astype(np.int32)

    def release(self, req_id: str) -> None:
        entry = self.table.pop(req_id, None)
        if entry:
            self._free_entry(entry)

    def drop_for_recompute(self, req_id: str) -> int:
        """Soft-Preempt: discard the request's blocks; it re-prefills
        under the new layout. Returns tokens to recompute."""
        entry = self.table.pop(req_id, None)
        if not entry:
            return 0
        self._free_entry(entry)
        return entry.length

    def _free_entry(self, entry: RequestKV) -> None:
        """Free an entry's blocks: private segments return ids to their
        owners; shared prefix segments only drop a refcount — the cached
        content stays resident (parked at zero) for the next hit."""
        for seg in entry.segments:
            if seg.shared:
                self._detach(seg.cached)
            else:
                for a in (seg.owners or (self,)):
                    a._give_back(seg.ids)

    # -- prefix cache: attach / commit (§D10) ------------------------------
    def _detach(self, cbs: Sequence[CachedBlock]) -> None:
        """Drop one reference from each cached block; at zero the block
        parks in every owner's eviction pool (LRU-stamped), NOT the free
        stack — the next attach revives it, reclaim/seize free it."""
        pc = self.prefix_cache
        for cb in cbs:
            cb.refcount -= 1
            assert cb.refcount >= 0, "prefix block refcount underflow"
            if cb.refcount == 0:
                if pc is not None:
                    pc.touch(cb)
                    pc._count_parked(cb)
                for a in cb.owners:
                    a._evict_pool[cb.block_id] = cb

    def _chain_readable(self, tag: int, owners, cross_tag_ok: bool) -> bool:
        """Whether THIS group can read a cached chain written under
        ``tag`` by ``owners`` (§D8 rules): same tag needs the exact same
        group (same ids address the same physical blocks on every
        member); an older tag rides the live-read path — every owner
        must be inside this group and the geometry must support
        cross-tag partial attention at both tags. Newer (wider) tags are
        never readable: this group lacks some owner's pool."""
        if tag == self.merge:
            return set(owners) == set(self.group)
        if tag < self.merge:
            return (cross_tag_ok
                    and self.geom.live_readable(tag)
                    and self.geom.live_readable(self.merge)
                    and set(owners) <= set(self.group))
        return False

    def _lookup_prefix(self, tokens, tag: int,
                       cross_tag_ok: bool) -> List[CachedBlock]:
        """Longest readable cached chain for this prompt under ``tag``.
        Capped at ``(len(tokens)-1)//cap`` FULL blocks so at least one
        prompt token always prefills — the final position's logits are
        needed to sample the first output token."""
        pc = self.prefix_cache
        cap = self.geom.capacity(tag)
        nfull = (len(tokens) - 1) // cap
        chain: List[CachedBlock] = []
        prev = 0
        for i in range(nfull):
            key = _chain_key(prev, tag, tokens[i * cap:(i + 1) * cap])
            cb = pc.index.get(key)
            if cb is None or not self._chain_readable(
                    tag, cb.owners, cross_tag_ok):
                break
            chain.append(cb)
            prev = key
        return chain

    def cached_prefix_tokens(self, tokens,
                             cross_tag_ok: bool = False) -> int:
        """Lookup-only: how many leading prompt tokens an attach would
        satisfy from cache right now (admission discounts these)."""
        pc = self.prefix_cache
        if pc is None or len(tokens) <= 1:
            return 0
        best = 0
        for tag in sorted(pc.tags):
            n = len(self._lookup_prefix(tokens, tag, cross_tag_ok)) \
                * self.geom.capacity(tag)
            best = max(best, n)
        return best

    def attach_prefix(self, req_id: str, tokens,
                      cross_tag_ok: bool = False) -> int:
        """Content-addressed admission: attach the request's leading
        tokens to the longest readable cached chain (refcount++ per
        block, zero prefill work) as a single SHARED segment. Returns
        the number of tokens satisfied (0 = miss; the request starts
        with no entry and prefills from scratch)."""
        pc = self.prefix_cache
        if pc is None or req_id in self.table or len(tokens) <= 1:
            return 0
        best: List[CachedBlock] = []
        best_tag, best_tok = 0, 0
        for tag in sorted(pc.tags):
            chain = self._lookup_prefix(tokens, tag, cross_tag_ok)
            ntok = len(chain) * self.geom.capacity(tag)
            if ntok > best_tok:
                best, best_tag, best_tok = chain, tag, ntok
        if not best:
            pc.stats["miss_requests"] += 1
            return 0
        for cb in best:
            if cb.refcount == 0:           # revive a parked block
                pc._uncount(cb)
                for a in cb.owners:
                    a._evict_pool.pop(cb.block_id, None)
            cb.refcount += 1
            pc.touch(cb)
        seg = Segment(tag=best_tag, start=0,
                      ids=[cb.block_id for cb in best],
                      owners=best[0].owners, shared=True,
                      cached=tuple(best))
        self.table[req_id] = RequestKV(mode_tag=best_tag,
                                       segments=[seg], length=best_tok)
        pc.stats["hit_requests"] += 1
        pc.stats["hit_tokens"] += best_tok
        return best_tok

    def commit_prefix(self, req_id: str, tokens, written: int) -> int:
        """Publish the request's freshly-prefilled full prompt blocks
        into the index, moving them from its private segment into the
        (possibly new) leading shared segment with refcount 1 — the
        request itself now references them like any attacher, so its
        release parks rather than frees them.

        Only clean single-tag entries publish: every segment must carry
        the CURRENT tag and be owned by exactly this group (cross-tag
        attachments stay private — their chain would mix tags). On a key
        collision the FIRST inserter wins and the walk stops: extending
        past a foreign block would leave a chain gap. Returns blocks
        committed."""
        pc = self.prefix_cache
        entry = self.table.get(req_id)
        if pc is None or entry is None or not entry.segments:
            return 0
        if any(s.tag != self.merge for s in entry.segments):
            return 0
        head = entry.segments[0] if entry.segments[0].shared else None
        priv = entry.segments[-1]
        if priv.shared or len(entry.segments) != (2 if head else 1):
            return 0
        if set(priv.owners or (self,)) != set(self.group):
            return 0
        cap = self.capacity
        base = len(head.ids) if head else 0
        upto = min(written, len(tokens)) // cap
        prev = head.cached[-1].key if head and head.cached else 0
        new_cbs: List[CachedBlock] = []
        for i in range(base, upto):
            key = _chain_key(prev, self.merge,
                             tokens[i * cap:(i + 1) * cap])
            if key in pc.index:
                break                      # first inserter wins
            cb = CachedBlock(key=key, block_id=priv.ids[i - base],
                             tag=self.merge,
                             owners=priv.owners or (self,), refcount=1)
            pc.touch(cb)
            pc.index[key] = cb
            new_cbs.append(cb)
            prev = key
        if not new_cbs:
            return 0
        pc.tags.add(self.merge)
        moved = len(new_cbs)
        if head is None:
            head = Segment(tag=self.merge, start=0,
                           owners=priv.owners or (self,), shared=True)
            entry.segments.insert(0, head)
        head.ids.extend(priv.ids[:moved])
        head.cached += tuple(new_cbs)
        del priv.ids[:moved]
        priv.start += moved * cap
        if not priv.ids and entry.length <= priv.start:
            entry.segments.remove(priv)
            entry.mode_tag = head.tag
        entry._ids_np = None
        pc.stats["inserted_blocks"] += moved
        return moved

    # -- fault injection (POOL_EXHAUST) -----------------------------------
    def seize(self, n: int = -1) -> List[int]:
        """Take up to ``n`` free ids (-1 = all) out of THIS engine's
        pool — a scripted memory burst. Deterministic (sorted take) and
        group-consistent: the shared group-free set shrinks with the
        member, so group allocations see the pressure immediately.
        ``restore`` hands the ids back when the fault window closes.

        Prefix-cache aware: the eviction pool is drained FIRST (cold
        refcount-0 cached blocks become free and seizable); blocks with
        live references are never in the free set or the pool, so a
        degraded tick can NEVER rip a shared prefix out from under
        another request."""
        pc = self.prefix_cache
        if pc is not None and self._evict_pool:
            want = -1 if n < 0 else max(n - len(self._free_set), 0)
            for b in sorted(self._evict_pool):
                if want == 0:
                    break
                cb = self._evict_pool.get(b)
                if cb is None:
                    continue               # freed as a co-owner above
                pc.evict(cb)
                if want > 0:
                    want -= 1
        avail = sorted(self._free_set)
        taken = avail if n < 0 else avail[:n]
        self._free_set.difference_update(taken)
        if len(self.group) > 1:
            self._group_free().difference_update(taken)
        return taken

    def restore(self, ids: Sequence[int]) -> None:
        """Return ids taken by ``seize`` to the free pool."""
        self._give_back(ids)

    # -- capacity accounting (paper §6.4 Table 2) -----------------------------
    def max_context_tokens(self, merge: int, sp: int = 1) -> int:
        """Max context a single request can hold when merging m engines:
        the TP group pools the per-engine block budget. With ``sp > 1``
        (a sequence-parallel island, §D12), the merge group splits into
        ``sp`` shards of width ``merge // sp`` and the request pools ALL
        shards' block budgets — capacity scales with engine COUNT even
        when head-splitting is exhausted, which is the whole point."""
        if sp > 1:
            return sp * (self.geom.num_blocks - 1) \
                * self.geom.capacity(merge // sp)
        cap = self.geom.capacity(merge)
        # merging m engines gives the request m engines' pools: blocks are
        # symmetric per device, so the request sees num_blocks * B(m)
        return (self.geom.num_blocks - 1) * cap


def bind_fleet(adaptors: Sequence[KVCacheAdaptor], layout) -> None:
    """Wire every engine's adaptor to its layout group: switch the
    allocation capacity AND the group allocation domain (shared helper
    for the engine and the scheduler-owned adaptor path). Also stamps
    each adaptor's fleet position — attached shared segments may be
    owned by a group other than the reader's, and the engine's staging
    derives the owner lead from ``engine_id``."""
    for i, a in enumerate(adaptors):
        a.engine_id = i
        a._sp_ring = None
    for isl in layout.islands:
        sp = getattr(isl, "sp", 1)
        for lead in isl.lead_engines():
            if sp > 1:
                # sequence-parallel island (§D12): the merge group splits
                # into ``sp`` shards of width ``write_tag``; each shard is
                # its own allocation group writing under the narrow tag,
                # and every member carries the ring of shard leads so
                # allocation can round-robin new blocks across shards.
                t = isl.write_tag
                ring = tuple(adaptors[lead + j * t] for j in range(sp))
                for j in range(sp):
                    shard = [adaptors[e] for e in
                             range(lead + j * t, lead + (j + 1) * t)]
                    for a in shard:
                        a.switch_mode(t)
                        a.bind_group(shard)
                for e in range(lead, lead + isl.merge):
                    adaptors[e]._sp_ring = ring
            else:
                members = [adaptors[e]
                           for e in range(lead, lead + isl.merge)]
                for a in members:
                    a.switch_mode(isl.merge)
                    a.bind_group(members)
    # recount the parked-clean reclaim credit under the NEW groups: a
    # block parked clean under the old layout may now straddle groups
    # (not cheaply reclaimable) and vice versa. O(parked) per rebind.
    pcs = {id(a.prefix_cache): a.prefix_cache for a in adaptors
           if a.prefix_cache is not None}
    if pcs:
        for a in adaptors:
            a._parked_clean = 0
        seen = set()
        for a in adaptors:
            for cb in a._evict_pool.values():
                if id(cb) not in seen:
                    seen.add(id(cb))
                    cb.counted = None
                    next(iter(pcs.values()))._count_parked(cb)
