"""FlyingEngine: real-execution runtime over a fleet of ranks, one
process per rank.

Binds the substrate pieces on the rank's device: its storage shard of
the canonical-layout weights (Model Weights Manager), its invariant flat
KV pools (KV Cache Adaptor), the eager TP groups and per-key step
functions (Communicator Pool), and the per-engine allocators. Implements
the scheduler's Backend protocol, so the same DynamicScheduler drives
simulation and real execution.

The fleet runs a ``FleetLayout``: an ordered partition of the engine
tiles into contiguous pow2-aligned islands, each with its OWN merge.
Every island holds a zero-copy *view* of the canonical params and of
the rank's state pools, plus its own async token ring, decode cache and
sync counters. ``rebind(layout)`` drains ONLY the islands it reshapes,
at the step boundary, and re-scopes their params and pools by view
(under ``check_zero_copy`` every weight and pool ``data_ptr`` is
asserted unchanged); islands present in both layouts keep their
in-flight windows and decode caches, and their ``island_sync_stats``
do not move.

The process model is SPMD: every rank runs the same host program (the
same scheduler, the same engine bookkeeping), as the JAX package's one
controller runs one SPMD program. A rank launches only the steps of the
islands that hold it, on its DP group's rows of the island's batch, and
its TP group's collectives join the ranks of the group. Host state stays
identical on every rank: each island's harvested tokens are summed over
the world from each DP group's lead rank, and each step's duration is
the max over the ranks (one CPU all_reduce), so every rank's scheduler
makes the same decisions. ``ParallelPlan(1, 1, 1)`` is one rank with no
process group.

LIVE rebinds keep in-flight requests where they are: a rider's KV spans
block segments written under earlier merges, and its steps read every
segment in place (one partial sweep a lane, merged over the island's
view group; ``live_readable``). A sequence-parallel island (``sp > 1``)
spreads one request's blocks round-robin over its shards and reads them
the same way. Live and SP decode caches are re-staged every step but
keep their key, so the device token ring still feeds back.

Faults follow the ``FaultInjector``'s script, which every rank replays
alike: a launch on an island holding a dead engine raises
``EngineFault`` on every rank before any collective (``_fault_gate``); a
scripted REBIND_FAIL or DRAIN_CORRUPT raises ``TransitionFault`` before
the layout moves; a dead or corrupted island's unharvested tokens are
discarded, not drained. A recovered request (a quarantine, or an
eviction under KV backpressure) pins its original prompt plus every
token that reached the host as its new prompt. STALL is ignored: it
scales simulated step times, and wall time is measured.

Zero-sync hot path: steady-state decode performs no host
synchronization and no per-token device->host transfer. Sampling
(greedy, or temperature and top-k with per-row seeds, drawn as the
reference draws them) is fused into the step (device-resident token ids
feed straight back into the next step), the KV pools update in place,
host batch prep is vectorized numpy over persistent staging buffers,
and steps run ahead of the host inside a bounded in-flight window (a
CUDA event per step). Tokens surface only at harvests (every
``harvest_limit`` steps) and drain points (``generated_tokens``,
``drain``, rebinds) as batched transfers; ``harvested_tokens`` peeks at
what has surfaced without draining. ``sync_stats`` counts every class
of host crossing. At tp > 1 every collective also meets the group's
other ranks, and gloo's synchronize the host with the card: the pool
counts them (``pool.stats``).

Prefill is chunked: long prompts stream through ``prefill_chunk``-sized
slices with absolute positions and per-request prior lengths, and when
prefill chunks co-reside with a decode batch the scheduler drives
``mixed()`` — one step covering both phases, with promoted requests'
first tokens routed on device.

Mamba-2 and RecurrentGemma keep part of a request's state in recurrent
rows, batch-dense per island (``Model.recurrent_state``: the group's
``bpe * merge`` rows at the island's TP width). A request takes a row of
its group at its first prefill chunk, zeroed, and keeps it until it
finishes, is aborted, recovered or dropped (``release_row``); every step
stages ``valid``, each row's real positions (the chunk's tokens, 1 in a
decode step, 0 for a row that sits the step out), so ragged chunks and
idle rows leave the states where their requests' tokens put them. These
families run no mixed step. A rebind that reshapes an island rebuilds
its rows, so the scheduler re-prefills that island's requests first
(``has_request_rows``). The JAX engine does none of this: its rows are
handed out anew every step, its pads run through the recurrence and its
reshapes restart the states from zero (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.communicator_pool import (CommunicatorPool, Seat,
                                                bucket_pow2)
from repro_torch.core.faults import TransitionFault
from repro_torch.core.kv_adaptor import (KVCacheAdaptor, PoolGeometry,
                                         bind_fleet, ragged_arange)
from repro_torch.core.modes import (FleetLayout, FlyingMode, Island,
                                    ParallelPlan)
from repro_torch.core.steps import fresh_states
from repro_torch.core.task_pool import Request, prompt_token_ids
from repro_torch.core.views import make_serving_ctx
from repro_torch.core.weights_manager import WeightsManager, _ptrs
from repro_torch.device import resolve_device
from repro_torch.models.model import Model


@dataclass
class SyncStats:
    """Host<->device crossings on the serving path.

    ``host_argmax`` is the guarded quantity: per-request device->host
    logit reads (the legacy path does one per token). The fused path
    keeps it at zero; tokens leave the device only as whole-batch
    harvests (``d2h_batched``) at drain points."""
    steps: int = 0            # steps launched
    host_argmax: int = 0      # per-token device->host reads (legacy path)
    d2h_batched: int = 0      # batched [B] token harvests (drain points)
    window_waits: int = 0     # bounded in-flight window completion waits
    drains: int = 0           # explicit drain events (readout)


class _DecodeCache:
    """Steady-state decode batch state: persistent numpy buffers plus
    incrementally-advanced per-request metadata. While the running set
    is unchanged, per-step batch prep is a handful of whole-array numpy
    ops (lengths += 1, vectorized slot math) — no per-request Python.
    ``mb`` is the bucketed block-table width the staging buffers were
    built for; crossing a bucket boundary rebuilds the cache."""
    __slots__ = ("key", "rows", "row_reqs", "entries", "lengths", "nblk",
                 "cap", "bufs", "mb", "live")

    def __init__(self, key, rows, row_reqs, entries, lengths, nblk, cap,
                 bufs, mb, live=None):
        self.key = key
        self.rows = rows
        self.row_reqs = row_reqs
        self.entries = entries
        self.lengths = lengths
        self.nblk = nblk
        self.cap = cap
        self.bufs = bufs
        self.mb = mb
        # the lane tags when any entry's KV spans mode-tagged segments
        # (or the island is SP): the cache is re-staged every step but
        # keeps its key, so the token ring still feeds back
        self.live = live


class _IslandRT:
    """Per-island runtime: the island's view of the parameters and state
    pools on this rank (None where the island does not hold the rank)
    plus everything the hot path keeps warm between steps. Untouched by
    rebinds of OTHER islands: the partial-drain contract rides on this
    isolation."""
    __slots__ = ("island", "seat", "params", "states", "B", "stats",
                 "pending", "last_tok", "last_src", "last_key", "steady",
                 "held")

    def __init__(self, island: Island, seat: Optional[Seat], params, states,
                 B: int):
        self.island = island
        self.seat = seat        # this rank's rows and TP group, or None
        self.params = params
        # per group, per kind: flat (k, v) pools, or the island's own
        # recurrent rows
        self.states = states
        self.B = B              # island batch rows = n_engines * bpe
        self.stats = SyncStats()
        # async token ring: this rank's device token tensors not yet
        # harvested (None on a rank the island does not hold), each with
        # the island rows it holds and the event that marks its completion
        self.pending: List[Tuple[Optional[torch.Tensor],
                                 Tuple[Tuple[int, str], ...],
                                 Optional[torch.cuda.Event]]] = []
        self.last_tok: Dict[str, Tuple[torch.Tensor, int]] = {}
        self.last_src: Optional[torch.Tensor] = None
        self.last_key = None
        self.steady: Optional[_DecodeCache] = None
        # recurrent families: req_id -> the island row it holds (host
        # bookkeeping, the same on every rank)
        self.held: Dict[str, int] = {}


def _rank_device(device: torch.device, rank: int) -> torch.device:
    """``cuda`` without an index means the rank's card: ``cuda:(rank %
    device_count)``."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return device


def _check_engine_family(cfg) -> None:
    """Refuse the modality families: neither engine stages a request's
    ``frontend_embeds``, so the JAX package's engine serves whisper over
    zero cross caches and InternVL2 without its image prefix. These
    models serve through ``build_serve_step`` only (ROADMAP.md, Queue 1
    item 3)."""
    what = ("an enc-dec model (cross caches)" if cfg.enc_dec is not None
            else "a vision-prefix model (frontend embeddings)"
            if cfg.frontend is not None else None)
    if what is not None:
        raise NotImplementedError(
            f"{cfg.name}: FlyingEngine does not serve {what}: no engine "
            f"stages a request's frontend_embeds (the JAX engine serves "
            f"such models over zero caches or without their prefix); "
            f"engine-level serving of these families is ROADMAP.md Queue "
            f"1 item 3, step-level serving runs through "
            f"core.steps.build_serve_step")


class FlyingEngine:
    def __init__(self, model: Model, plan: ParallelPlan, geom: PoolGeometry,
                 params, *, batch_per_engine: int = 4,
                 max_blocks_per_req: int = 16, fused_sampling: bool = True,
                 async_window: int = 2, temperature: float = 0.0,
                 top_k: int = 0, harvest_limit: int = 512,
                 mixed_step: bool = True, injector=None,
                 seed_mode: str = "fleet", device=None,
                 layout: Optional[FleetLayout] = None,
                 check_zero_copy: bool = False):
        """``params`` is the full parameter tree (the JAX package's, or a
        seeded one); each rank keeps its storage shard of it. Under
        ``torch.distributed`` the world is the plan's ranks and this
        process is one of them; without a process group the plan must be
        ``ParallelPlan(1, 1, 1)``."""
        model.check_serving()
        _check_engine_family(model.cfg)
        self.pool = CommunicatorPool(model, plan, geom,
                                     sample=(temperature, top_k),
                                     batch_per_engine=batch_per_engine)
        self.rank, self.world = self.pool.rank, self.pool.world
        self.device = _rank_device(resolve_device(device), self.rank)
        if _rank_device(model.device, self.rank) != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        if self.world > 1 and not fused_sampling:
            raise NotImplementedError(
                "the legacy host-argmax path reads logits of one rank; "
                "multi-rank serving samples in the step")
        self.model = model
        self.cfg = model.cfg
        self.plan = plan
        self.geom = geom
        self.bpe = batch_per_engine
        self.max_blocks = max_blocks_per_req
        self.check_zero_copy = check_zero_copy
        self.fused = fused_sampling
        self.window = max(int(async_window), 0)
        self.temperature = temperature
        # pending token steps an island may hold before a harvest frees
        # them to the host token buffer
        self.harvest_limit = max(int(harvest_limit), 1)
        self.mixed_step = mixed_step
        assert seed_mode in ("fleet", "request"), seed_mode
        self.seed_mode = seed_mode
        assert fused_sampling or temperature <= 0.0, \
            "the legacy host path samples greedily; temperature/top_k " \
            "need fused_sampling=True"

        # Mamba-2 / RG-LRU: per-request recurrent rows in each island
        self._recurrent = any(model.pools_of(k) == 0
                              for seq, _ in model.plan for k in seq)
        self.wm = WeightsManager(self.cfg, plan)
        tile = plan.engine_rows * plan.tp_base
        # canonical placement: this rank's storage shard; every island
        # holding the rank views these tensors
        self.params = self.wm.storage_shard(params, self.rank % tile,
                                            self.device)
        # the rank's flat pools: one set, viewed by whichever island
        # holds the rank under every layout
        self._pools = self._fresh_states()
        # what check_zero_copy holds every island's views to (an island's
        # recurrent rows are its own)
        self._resident = (_ptrs(self.params),
                          _ptrs(self._paged(self._pools)))
        self.adaptors = [KVCacheAdaptor(geom)
                         for _ in range(plan.dp_engines * plan.pods)]
        self.layout = layout or FleetLayout.uniform(plan, 1)
        if self.layout.plan != plan:
            raise ValueError(f"layout of {self.layout.plan}, engine of "
                             f"{plan}")
        self._check_islands(self.layout)
        self.islands: List[_IslandRT] = [
            self._make_rt(isl) for isl in self.layout.islands]
        self._rt_of: Dict[Island, _IslandRT] = {
            rt.island: rt for rt in self.islands}
        bind_fleet(self.adaptors, self.layout)
        self.switch_log: List[float] = []
        self.sync_stats = SyncStats()
        # scripted fault schedule (core/faults.py); the scheduler adopts
        # it from here, so one script drives injection and detection
        self.injector = injector
        self._token_buf: Dict[str, List[int]] = {}
        # aborted requests: ids retired WITHOUT an island drain, whose
        # tokens in-flight steps may still carry; harvests drop them.
        # Cleared at the next fleet-wide drain.
        self._retired: set = set()
        self._prompt_cache: Dict[str, np.ndarray] = {}
        # recovery-folded prompts (orig prompt ++ harvested tokens): the
        # seed-based regeneration knows nothing of folds, so they are
        # pinned verbatim
        self._pinned_prompts: Dict[str, np.ndarray] = {}
        self._bt_scratch: Optional[np.ndarray] = None
        self._host_bufs: Dict[Tuple, Dict[str, np.ndarray]] = {}
        self._seed_iota: Dict[int, torch.Tensor] = {}
        self._seed_cursor = 0

    # ------------------------------------------------------------------
    @property
    def n_engines(self) -> int:
        return self.plan.dp_engines * self.plan.pods

    def island_sync_stats(self, island: Island) -> SyncStats:
        """Per-island host-crossing counters: the partial-rebind contract
        surface (an untouched island's ``drains`` must not move)."""
        return self._rt_of[island].stats

    def _global_batch(self) -> int:
        return self.n_engines * self.bpe

    def _resolve(self, island: Union[Island, int]) -> _IslandRT:
        """Island handle -> runtime. A bare int merge addresses the
        uniform layout."""
        if isinstance(island, Island):
            rt = self._rt_of.get(island)
            assert rt is not None, \
                f"{island} not in live layout {self.layout.describe()}"
            return rt
        assert self.layout.uniform_merge == island, \
            f"merge={island} vs live layout {self.layout.describe()}"
        return self.islands[0]

    # ------------------------------------------------------------------
    # island views: zero-copy params and pools
    # ------------------------------------------------------------------
    def _fresh_states(self):
        """Per group, per kind: the rank's flat (k, v) pools ``[n_layers,
        num_blocks, block_elems]`` on the device, zeroed (MLA: its one
        compressed pool). Each step views them in its island's mode and
        writes them in place."""
        return fresh_states(self.model, FlyingMode(self.plan, 1), self.geom,
                            device=self.device)

    def _paged(self, states):
        """``states`` without the recurrent rows: the flat pools every
        island views."""
        return [[st for kind, st in zip(kind_seq, group)
                 if self.model.pools_of(kind)]
                for (kind_seq, _), group in zip(self.model.plan, states)]

    def _island_states(self, isl: Island):
        """The states ``isl``'s steps take on this rank: the flat pools,
        and for a Mamba-2 or RG-LRU layer the island's own recurrent rows,
        zeroed: its group's ``bpe * merge`` rows at its TP width."""
        if not self._recurrent:
            return self._pools
        ctx = make_serving_ctx(isl.merge, self.plan.engine_rows,
                               self.plan.tp_base)
        model = self.model

        def rows(kind, n):
            one = model.recurrent_state(kind, ctx=ctx,
                                        batch=self.bpe * isl.merge,
                                        device=self.device)
            return {"mixer": tuple(t.new_zeros((n,) + tuple(t.shape))
                                   for t in one)}
        return [tuple(rows(kind, n) if model.pools_of(kind) == 0 else st
                      for kind, st in zip(kind_seq, group))
                for (kind_seq, n), group in zip(model.plan, self._pools)]

    def _row_leaves(self, states) -> List[torch.Tensor]:
        """Every recurrent leaf ``[n_layers, rows, ...]`` of ``states``."""
        return [t for (kind_seq, _), group in zip(self.model.plan, states)
                for kind, st in zip(kind_seq, group)
                if self.model.pools_of(kind) == 0 for t in st["mixer"]]

    def _check_islands(self, layout: FleetLayout) -> None:
        """An SP island reads every block through the live lanes: its
        write tag and merge must be tag-readable. With a MoE model's
        experts over 'ed' (``ep > 1``) the engine serves head-layout
        pools only: a striped pool raises here (the JAX engine has no
        live read program for it either)."""
        ep = self.pool.ep
        if ep > 1 and self.geom.layout == "striped":
            raise NotImplementedError(
                f"striped pools with the experts over 'ed' (ep={ep}): no "
                f"test holds them against the JAX package (ROADMAP.md "
                f"Queue 1 item 5)")
        for isl in layout.islands:
            if isl.sp > 1 and not (
                    self.live_readable()
                    and self.geom.live_readable(isl.write_tag)
                    and self.geom.live_readable(isl.merge)):
                raise ValueError(
                    f"{isl}: sequence parallelism needs live-readable "
                    f"tags {isl.write_tag} and {isl.merge}")

    def _make_rt(self, isl: Island) -> _IslandRT:
        seat = self.pool.seat(isl)
        params = states = None
        if seat is not None:
            params = self.wm.island_view(self.params)
            states = self._island_states(isl)
        return _IslandRT(isl, seat, params, states,
                         isl.n_engines * self.bpe)

    # ------------------------------------------------------------------
    # the bind/release primitive: partial rebind
    # ------------------------------------------------------------------
    def rebind(self, layout: Union[FleetLayout, int]) -> float:
        """Transition to another fleet layout, draining ONLY the islands
        it reshapes. Untouched islands (same start, size and merge) keep
        their in-flight windows, decode caches and device token rings;
        reshaped islands hit the step-boundary safe point, then their
        param and pool views re-scope over the tensors the rank already
        holds (asserted under ``check_zero_copy``: every ``data_ptr``
        unchanged). A reshaped island's recurrent rows are built anew,
        zeroed, and its held rows forgotten (``has_request_rows``: the
        scheduler re-prefills their requests first). Returns the
        duration, the max over the ranks."""
        if isinstance(layout, int):
            layout = FleetLayout.uniform(self.plan, layout)
        assert layout.plan == self.plan
        if layout == self.layout:
            return 0.0
        self._check_islands(layout)
        inj = self.injector
        if inj is not None and inj.take_rebind_fault() is not None:
            # scripted failure BEFORE any state moves: the engine stays
            # bound to the old layout, which the scheduler's rollback
            # assumes
            raise TransitionFault(f"scripted rebind failure (tick "
                                  f"{inj.tick})")
        t0 = time.perf_counter()
        new_set = set(layout.islands)
        changed = [rt for rt in self.islands if rt.island not in new_set]
        changed_engs = {e for rt in changed for e in rt.island.engines()}
        dead: set = set()
        if inj is not None:
            s = inj.take_drain_corrupt(changed_engs)
            if s is not None:
                bad = (set(s.engines) & changed_engs) or set(s.engines)
                # the corruption IS the loss of the named islands'
                # in-flight tokens; the layout is untouched, so rollback
                # plus recovery stays well defined
                for rt in changed:
                    if set(rt.island.engines()) & bad:
                        self._discard_island(rt)
                raise TransitionFault("drain corrupted at the rebind safe "
                                      "point", engines=bad)
            dead = set(inj.dead_engines())
        for rt in changed:
            # a dead engine cannot answer the drain: its island's
            # unharvested tokens are lost (the same choice on every
            # rank, so the drain's world collective still meets)
            if set(rt.island.engines()) & dead:
                self._discard_island(rt)
            else:
                self._drain_island(rt)
        keep = self._rt_of
        self.islands = [keep.get(isl) or self._make_rt(isl)
                        for isl in layout.islands]
        self._rt_of = {rt.island: rt for rt in self.islands}
        self.layout = layout
        bind_fleet(self.adaptors, layout)
        # staging buffers are keyed per island: drop dead islands' so
        # layout churn doesn't grow host memory without bound
        self._host_bufs = {k: v for k, v in self._host_bufs.items()
                           if k[1] in new_set}
        if self.check_zero_copy:
            # every island holding this rank views the buffers bound at
            # construction
            w, p = self._resident
            assert all(_ptrs(rt.params) == w
                       and _ptrs(self._paged(rt.states)) == p
                       for rt in self.islands if rt.seat is not None), \
                "rebind moved bytes!"
        dt = self.pool.host_max(time.perf_counter() - t0)
        self.switch_log.append(dt)
        return dt

    def switch(self, old: int, new: int) -> float:
        """Uniform transition: rebind to the uniform layout of ``new`` (a
        whole-fleet reshape: everything drains)."""
        if old == new:
            return 0.0
        assert self.layout.uniform_merge == old, \
            f"switch({old},...) vs live layout {self.layout.describe()}"
        return self.rebind(FleetLayout.uniform(self.plan, new))

    # ------------------------------------------------------------------
    # batched execution over the scheduler's request lists
    # ------------------------------------------------------------------
    def _rows(self, reqs: Sequence[Request],
              isl: Island) -> Dict[str, int]:
        """Assign each request a padded-batch row within its island's
        group: in order of the list, or for a recurrent family the row it
        holds (``_take_rows``)."""
        bpg = self.bpe * isl.merge
        counters: Dict[int, int] = {}
        rows: Dict[str, int] = {}
        held = self._rt_of[isl].held
        for r in reqs:
            assert isl.start <= r.engine_group < isl.stop, \
                (r.req_id, r.engine_group, isl)
            if self._recurrent:
                row = held.get(r.req_id)
                assert row is not None, \
                    (r.req_id, "holds no recurrent row in", isl)
                rows[r.req_id] = row
                continue
            g = (r.engine_group - isl.start) // isl.merge
            i = counters.get(g, 0)
            assert i < bpg, "group batch overflow"
            rows[r.req_id] = g * bpg + i
            counters[g] = i + 1
        return rows

    def _take_rows(self, rt: _IslandRT, reqs: Sequence[Request]) -> None:
        """Give each of ``reqs`` (requests whose prefill starts from
        zero) the lowest free row of its group and zero that row in every
        recurrent leaf on this rank, so that a reused row never carries
        another request's state. A row held from an earlier start is
        released first."""
        isl = rt.island
        bpg = self.bpe * isl.merge
        fresh = []
        for r in reqs:
            self.release_row(r)
            g = (r.engine_group - isl.start) // isl.merge
            taken = set(rt.held.values())
            row = next((g * bpg + i for i in range(bpg)
                        if g * bpg + i not in taken), None)
            assert row is not None, "group batch overflow"
            rt.held[r.req_id] = row
            fresh.append(row)
        seat = rt.seat
        local = [row - seat.lo for row in fresh
                 if seat is not None and seat.lo <= row < seat.hi]
        if local:
            idx = self._h2d(np.asarray(local, np.int64))
            for leaf in self._row_leaves(rt.states):
                leaf.index_fill_(1, idx, 0)

    def release_row(self, r: Request) -> None:
        """Scheduler hook: free the recurrent row ``r`` holds, if any (it
        finished, or its prefill restarts from zero). A decode cache or
        token feed-back keyed on a batch that held it is dropped, since
        the same requests may come back on other rows."""
        rid = r.req_id
        for rt in self.islands:
            if rt.held.pop(rid, None) is not None and rt.steady is not None \
                    and rid in rt.steady.key[1]:
                rt.steady = None
                rt.last_key = None

    def has_request_rows(self) -> bool:
        """Scheduler capability hook: does part of a request's state live
        in a batch row of its island (Mamba-2 and RG-LRU rows), outside
        the paged blocks? Such a row does not survive a rebind that
        reshapes its island (the island's rows are rebuilt at its new
        group size and TP width), so the scheduler re-prefills those
        requests from a folded prompt instead of pausing them or letting
        them ride; and a prefix cache, which shares KV blocks, cannot
        share it. The JAX engine has no such hook: it rebuilds a reshaped
        island's recurrent states from zeros and resumes its requests on
        them (``src/repro/core/engine.py:385-391``), which loses their
        state; the port departs from it here (ROADMAP.md, Queue 3)."""
        return self._recurrent

    def _bufs(self, key: Tuple) -> Dict[str, np.ndarray]:
        """Persistent preallocated host staging buffers, keyed by
        (phase, island, batch, mb_bucket[, seq]). Reused across steps;
        ``_h2d`` uploads a snapshot, so reuse never races an upload."""
        b = self._host_bufs.get(key)
        if b is not None:
            return b
        phase, _, B, mb = key[0], key[1], key[2], key[3]
        if phase == "decode":
            b = {"toks": np.zeros((B, 1), np.int32),
                 "pos": np.zeros((B, 1), np.int32),
                 "slots": np.full((B,), -1, np.int32),
                 "btab": np.zeros((B, mb), np.int32),
                 "ctxl": np.ones((B,), np.int32),
                 "valid": np.zeros((B,), np.int32)}
        else:
            T = key[4]
            b = {"toks": np.zeros((B, T), np.int32),
                 "pos": np.zeros((B, T), np.int32),
                 "slots": np.full((B, T), -1, np.int32),
                 "btab": np.zeros((B, mb), np.int32),
                 "prior": np.zeros((B,), np.int32),
                 "lastp": np.zeros((B,), np.int32),
                 "valid": np.zeros((B,), np.int32)}
        self._host_bufs[key] = b
        return b

    def _mb_bucket(self, max_need_blocks: int) -> int:
        """Bucketed block-table width: pow2 over the max blocks any live
        request needs, capped at the engine's configured max."""
        return min(bucket_pow2(max(int(max_need_blocks), 1)),
                   self.max_blocks)

    def _up(self, rt: _IslandRT, buf: np.ndarray) -> Optional[torch.Tensor]:
        """Upload this rank's rows ``[lo, hi)`` of an island-wide staging
        buffer (None on a rank the island does not hold)."""
        seat = rt.seat
        if seat is None:
            return None
        if seat.lo or seat.hi != buf.shape[0]:
            buf = buf[seat.lo:seat.hi]
        return self._h2d(buf)

    def _h2d(self, buf: np.ndarray) -> torch.Tensor:
        """Upload a snapshot of a REUSED staging buffer. The host copy is
        taken before this returns (into fresh pinned memory on the card's
        path, which the caching host allocator keeps until the async copy
        has run), so the next step may mutate ``buf`` while this step's
        transfer is still in flight."""
        if self.device.type == "cpu":
            return torch.from_numpy(buf.copy())
        return torch.from_numpy(buf).pin_memory().to(self.device,
                                                     non_blocking=True)

    def _fill_block_tables(self, btab: np.ndarray, rows: np.ndarray,
                           reqs: Sequence[Request]) -> None:
        """Scatter the adaptors' vectorized batch tables into the padded
        host buffer (staged through a persistent scratch buffer)."""
        if self._bt_scratch is None:
            self._bt_scratch = np.zeros(
                (self._global_batch(), self.max_blocks), np.int32)
        mb = btab.shape[1]
        by_ad: Dict[int, List[int]] = {}
        for i, r in enumerate(reqs):
            by_ad.setdefault(r.engine_group, []).append(i)
        for g, idxs in by_ad.items():
            ad = self.adaptors[g]
            rids = [reqs[i].req_id for i in idxs]
            btab[rows[np.asarray(idxs)]] = \
                ad.block_table_batch(rids, mb,
                                     out=self._bt_scratch[:, :mb])

    # -- device token ring ---------------------------------------------
    def _tokens_in(self, rt: _IslandRT, reqs: Sequence[Request],
                   rows: np.ndarray, key, host: np.ndarray) -> torch.Tensor:
        """Previous-token input of this rank's rows [hi - lo, 1] without
        any device->host read: rows whose last token is still
        device-resident are gathered on device from the producing step's
        output; rows already harvested come from the host token buffer.
        None on a rank the island does not hold."""
        seat = rt.seat
        if seat is None:
            return None
        if key is not None and key == rt.last_key \
                and rt.last_src is not None:
            # unchanged membership: the previous step's output IS this
            # step's input — feed it straight back
            return rt.last_src.reshape(-1, 1)
        host.fill(0)
        per_src: Dict[int, Tuple[torch.Tensor, List[int], List[int]]] = {}
        for r, row in zip(reqs, rows):
            if not seat.lo <= row < seat.hi:
                continue            # another DP group's row
            ent = rt.last_tok.get(r.req_id)
            if ent is None:
                buf = self._token_buf.get(r.req_id)
                if buf:
                    host[row, 0] = buf[-1]
            else:
                src, srow = ent
                rec = per_src.setdefault(id(src), (src, [], []))
                rec[1].append(srow - seat.lo)
                rec[2].append(int(row) - seat.lo)
        tok = self._up(rt, host)
        for src, srows, drows in per_src.values():
            tok[self._h2d(np.asarray(drows, np.int64)), 0] = \
                src[self._h2d(np.asarray(srows, np.int64))]
        return tok

    def _note_tokens(self, rt: _IslandRT, key,
                     toks_dev: Optional[torch.Tensor],
                     row_reqs: Tuple[Tuple[int, str], ...]) -> None:
        ev = None
        if toks_dev is not None and toks_dev.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(toks_dev.device))
        rt.pending.append((toks_dev, row_reqs, ev))
        for row, rid in row_reqs:
            rt.last_tok[rid] = (toks_dev, row)
        rt.last_src = toks_dev
        rt.last_key = key
        # depth-0 window = synchronous dispatch; otherwise wait for the
        # step that left the bounded in-flight window to COMPLETE (no
        # transfer — tokens stay on device)
        if self.window == 0 or len(rt.pending) > self.window:
            self._wait(rt.pending[-self.window - 1])
            self.sync_stats.window_waits += 1
            rt.stats.window_waits += 1
        if len(rt.pending) >= self.harvest_limit:
            self._harvest(rt)

    @staticmethod
    def _wait(entry) -> None:
        ev = entry[2]
        if ev is not None:
            ev.synchronize()

    def _harvest(self, rt: _IslandRT) -> None:
        """Move one island's pending device token tensors into the host
        token buffer (one batched [B] transfer per step harvested, never
        per-token; over several ranks, one world sum for them all)."""
        if self.world > 1:
            arrs = list(self._island_tokens(rt))
        else:
            arrs = [t.cpu().numpy() for t, _, _ in rt.pending]
        for arr, (_, row_reqs, _) in zip(arrs, rt.pending):
            self.sync_stats.d2h_batched += 1
            rt.stats.d2h_batched += 1
            for row, rid in row_reqs:
                if rid in self._retired:
                    continue    # aborted mid-flight: drop, don't buffer
                self._token_buf.setdefault(rid, []).append(int(arr[row]))
        rt.pending.clear()
        rt.last_tok.clear()

    def _island_tokens(self, rt: _IslandRT) -> np.ndarray:
        """[n_pending, B] token ids of one island, the same on every rank:
        each DP group's lead rank puts its rows' tokens in, every other
        rank zeros, and one all_reduce over the world sums them. Every
        rank harvests the same island at the same point of the same host
        program, so the collective always meets."""
        buf = torch.zeros((len(rt.pending), rt.B), dtype=torch.int64)
        seat = rt.seat
        if seat is not None and seat.lead and rt.pending:
            buf[:, seat.lo:seat.hi] = torch.stack(
                [t for t, _, _ in rt.pending]).cpu()
        return self.pool.host_sum(buf).numpy()

    def _drain_island(self, rt: _IslandRT) -> None:
        """Safe-point synchronization of ONE island: surface its
        in-flight tokens and drop its device-resident feeding state."""
        if rt.pending:
            self._harvest(rt)
            self.sync_stats.drains += 1
            rt.stats.drains += 1
        rt.last_tok.clear()
        rt.last_src = None
        rt.last_key = None

    def _discard_island(self, rt: _IslandRT) -> None:
        """Fault path: drop one island's in-flight tokens WITHOUT
        harvesting them (the engine they live on is dead, or the drain
        was corrupted). Only the host token buffer survives."""
        rt.pending.clear()
        rt.last_tok.clear()
        rt.last_src = None
        rt.last_key = None
        rt.steady = None

    def _fault_gate(self, isl: Island) -> None:
        """Raise ``EngineFault`` when a scripted-dead engine sits in this
        island (a launch spanning it would hang on its collective). Every
        rank raises here, before any collective of the step."""
        if self.injector is not None:
            self.injector.check_launch(list(isl.engines()))

    def drain(self) -> None:
        """Fleet-wide safe point (scheduler end-of-run, host readout)."""
        for rt in self.islands:
            self._drain_island(rt)
        # no pending ring references any retired row anymore
        self._retired.clear()

    def abort_request(self, r: Request) -> None:
        """Scheduler abort hook: retire one request's row WITHOUT
        draining its island. Steps already launched may still carry the
        row, so the retired id tombstones it and harvests drop its
        tokens; the decode cache keys on batch membership, so the next
        launch rebuilds without the row."""
        rid = r.req_id
        self.release_row(r)
        self._retired.add(rid)
        self._token_buf.pop(rid, None)
        self._prompt_cache.pop(rid, None)
        self._pinned_prompts.pop(rid, None)
        for rt in self.islands:
            rt.last_tok.pop(rid, None)

    # -- sampling seeds -------------------------------------------------
    def _seeds(self, rt: _IslandRT) -> Optional[torch.Tensor]:
        """Per-row sampling seeds without per-step host uploads: the iota
        of this rank's rows is a cached device tensor; each step adds
        only the scalar cursor on the device (the same uint32 values as
        ``base + arange(B)`` mod 2**32, rows ``[lo, hi)`` of them)."""
        if self.temperature <= 0.0:
            return None
        # a fleet-wide cursor advanced by each draw's OWN batch size, so
        # launches of different batch sizes get disjoint seed ranges
        base = self._seed_cursor
        self._seed_cursor = (base + rt.B) & 0xFFFFFFFF
        seat = rt.seat
        if seat is None:
            return None
        iota = self._seed_iota.get((seat.lo, seat.hi))
        if iota is None:
            iota = torch.arange(seat.lo, seat.hi, dtype=torch.int64,
                                device=self.device)
            self._seed_iota[(seat.lo, seat.hi)] = iota
        return (iota + base) & 0xFFFFFFFF

    def _sample_seeds(self, rt: _IslandRT, reqs: Sequence[Request], rows,
                      phase: str) -> Optional[torch.Tensor]:
        """Per-launch sampling seeds. ``seed_mode='fleet'`` (default) is
        the cursor draw above: cheapest, but the stream depends on how
        many launches preceded this one. ``'request'`` derives each row's
        seed from (req_id, output index), so token streams do not depend
        on batching nor on how much prefill ran (a prefix-cache hit skips
        launches, which would shift the cursor). The scheduler promotes
        (generated += 1) BEFORE launching, so a final prefill chunk
        samples index ``generated - 1`` (== 0) and decode rows sample
        ``generated``, alike on the mixed and sequential paths."""
        if self.temperature <= 0.0:
            return None
        if self.seed_mode != "request":
            return self._seeds(rt)
        host = np.zeros((rt.B,), np.int64)
        for r, row in zip(reqs, rows):
            idx = max(r.generated - 1, 0) if phase == "prefill" \
                else r.generated
            host[int(row)] = abs(hash((r.req_id, int(idx)))) & 0xFFFFFFFF
        return self._up(rt, host)

    # ------------------------------------------------------------------
    def _stage_prefill(self, rt: _IslandRT, reqs: Sequence[Request],
                       mb_min: int = 1):
        """Host staging for one chunked-prefill launch. Each request's
        chunk covers prompt positions ``[r.prefilled, min(entry.length,
        prompt_len))``: the scheduler has already allocated the chunk's
        slots and only advances ``prefilled`` after the launch, so at
        staging time ``prefilled`` IS the prior context length. Returns
        (batch, rows, final_mask, T, mb, live)."""
        isl = rt.island
        B = rt.B
        n = len(reqs)
        prompts = [self._prompt_tokens(r) for r in reqs]
        entries = [self.adaptors[r.engine_group].table[r.req_id]
                   for r in reqs]
        plens = np.fromiter((len(p) for p in prompts), np.int64, n)
        elens = np.fromiter((e.length for e in entries), np.int64, n)
        # prompt positions cached once this chunk lands (entry.length may
        # already include the first decode token's slot on final chunks)
        end = np.minimum(elens, plens)
        prior = np.fromiter((max(int(r.prefilled), 0) for r in reqs),
                            np.int64, n)
        prior = np.minimum(prior, end)
        if self._recurrent:
            self._take_rows(rt, [r for r, p in zip(reqs, prior) if p == 0])
        rows_map = self._rows(reqs, isl)
        rows = np.fromiter((rows_map[r.req_id] for r in reqs), np.int64, n)
        if self.geom.layout == "striped" and prior.any():
            raise ValueError(
                "a striped prefill is fresh only: prompts must fit one "
                "prefill chunk (prior context of "
                f"{[r.req_id for r, p in zip(reqs, prior) if p]})")
        chunk = end - prior
        final = end >= plens
        # seq bucket: pad the CHUNK extent to pow2 so chunk-length
        # variation reuses one runner key per bucket; mb bucket: the
        # block-table width tracks the widest live request
        T = bucket_pow2(max(int(chunk.max()), 1))
        nblocks = max(len(e.block_ids) for e in entries)
        if isl.sp > 1:
            # blocks spread over sp lanes; each lane's table is bounded
            lane_blocks = -(-nblocks // isl.sp)
            assert lane_blocks <= self.max_blocks, \
                f"request needs {lane_blocks} blocks a lane > " \
                f"max_blocks_per_req={self.max_blocks}"
            mb = max(self._mb_bucket(lane_blocks), mb_min)
        else:
            assert nblocks <= self.max_blocks, \
                f"request needs {nblocks} blocks > max_blocks_per_req=" \
                f"{self.max_blocks}"
            mb = max(self._mb_bucket(nblocks), mb_min)
        live = self._live_tags(entries, isl)
        bufs = self._bufs(("prefill", isl, B, mb, T))
        toks, slots, btab = bufs["toks"], bufs["slots"], bufs["btab"]
        toks.fill(0)
        slots.fill(-1)
        btab.fill(0)
        cap = self.geom.capacity(isl.write_tag)
        write_segs: List = [None] * n
        if live is None:
            self._fill_block_tables(btab, rows, reqs)
        if isl.sp > 1:
            # each chunk lands in ONE per-block SP segment (the write
            # carries one owner shard a row), so the scheduler issues
            # block-aligned chunks on SP islands
            for i, (r, e) in enumerate(zip(reqs, entries)):
                lo, hi = int(prior[i]), int(end[i])
                if hi <= lo:
                    continue
                assert lo // cap == (hi - 1) // cap, \
                    (r.req_id, "SP chunk spans blocks", lo, hi, cap)
                write_segs[i] = next(
                    sg for sg in reversed(e.segments)
                    if sg.start <= lo < sg.start + cap and sg.shard >= 0)
        if int(chunk.sum()):
            rowcat = np.repeat(np.arange(n), chunk)
            offcat = ragged_arange(chunk)
            poscat = np.repeat(prior, chunk) + offcat
            rcat = rows[rowcat]
            toks[rcat, offcat] = np.concatenate(
                [p[lo:hi] for p, lo, hi in zip(prompts, prior, end)])
            if live is None:
                # single-segment entries: global positions index the
                # staged table directly
                blockcat = btab[rcat, poscat // cap].astype(np.int64)
                slots[rcat, offcat] = blockcat * cap + poscat % cap
            elif isl.sp > 1:
                # slot = write block * cap + block-local offset
                blk = np.fromiter((sg.ids[0] if sg is not None else 0
                                   for sg in write_segs), np.int64, n)
                st = np.fromiter((sg.start if sg is not None else 0
                                  for sg in write_segs), np.int64, n)
                slots[rcat, offcat] = np.repeat(blk, chunk) * cap \
                    + (poscat - np.repeat(st, chunk))
            else:
                # chunk write slots are RUN-LOCAL against each entry's
                # current-tag run: a rebind froze the earlier segments,
                # so global positions no longer index one table
                tails = [self._seg_runs(e)[-1] for e in entries]
                for r, t_run in zip(reqs, tails):
                    assert t_run[0] == isl.merge, \
                        (r.req_id, "chunk not under the island merge",
                         t_run[0], isl.merge)
                seg_start = np.fromiter((t_run[1] for t_run in tails),
                                        np.int64, n)
                spos = poscat - np.repeat(seg_start, chunk)
                maxb = max(len(t_run[2]) for t_run in tails)
                segtab = np.zeros((n, maxb), np.int64)
                for i, t_run in enumerate(tails):
                    segtab[i, :len(t_run[2])] = t_run[2]
                slots[rcat, offcat] = segtab[rowcat, spos // cap] * cap \
                    + spos % cap
        priorb = bufs["prior"]
        priorb.fill(0)
        priorb[rows] = prior
        # sample each request at its true final chunk position: the token
        # must not depend on the padded window length or on co-batching
        lastp = bufs["lastp"]
        lastp.fill(0)
        lastp[rows] = np.maximum(chunk - 1, 0)
        posb = bufs["pos"]
        posb[:] = np.arange(T, dtype=np.int32)[None]
        posb[rows] += prior[:, None].astype(np.int32)
        batch = {
            "tokens": self._up(rt, toks),
            "positions": self._up(rt, posb),
            "slots": self._up(rt, slots),
            "last_pos": self._up(rt, lastp),
        }
        if self._recurrent:
            # the chunk's real tokens; 0 leaves a row's state untouched
            validb = bufs["valid"]
            validb.fill(0)
            validb[rows] = chunk
            batch["valid"] = self._up(rt, validb)
        if live is None:
            batch["block_table"] = self._up(rt, btab)
            batch["prior_len"] = self._up(rt, priorb)
        elif isl.sp > 1:
            lanes = self._sp_lanes(isl, reqs, entries, rows, B, prior,
                                   write_segs)
            wown = np.zeros((B,), np.int32)
            for i, (r, sg) in enumerate(zip(reqs, write_segs)):
                if sg is not None:
                    wown[rows[i]] = min(o.engine_id for o in sg.owners) \
                        - self._group_lead(isl, r)
            lanes["write_own"] = wown
        else:
            cur_start = np.fromiter(
                (self._seg_runs(e)[-1][1] for e in entries), np.int64, n)
            lanes = self._seg_arrays(isl, reqs, entries, rows, B, live,
                                     prior - cur_start)
        if live is not None:
            batch.update({k: self._up(rt, v) for k, v in lanes.items()})
        return batch, rows, final, T, mb, live

    def prefill(self, reqs: Sequence[Request], island: Union[Island, int],
                chunk_tokens: int) -> float:
        rt = self._resolve(island)
        self._fault_gate(rt.island)
        t0 = time.perf_counter()
        batch, rows, final, T, mb, live = self._stage_prefill(rt, reqs)
        seeds = self._sample_seeds(rt, reqs, rows, "prefill")
        if seeds is not None:
            batch["sample_seeds"] = seeds
        runner = self.pool.runner(
            rt.island, "prefill", sampled=self.fused,
            batch_bucket=rt.B, seq_bucket=T, mb_bucket=mb, live=live)
        self.sync_stats.steps += 1
        rt.stats.steps += 1
        out = self._launch(rt, runner, batch)
        if self.fused:
            # only FINAL chunks emit a token; mid-prompt chunks leave the
            # device token ring (and its decode feed-back key) untouched
            row_reqs = tuple((int(row), r.req_id)
                             for row, r, f in zip(rows, reqs, final) if f)
            if row_reqs:
                # prefill membership never matches a decode key: the next
                # decode gathers these first tokens on device by row map
                self._note_tokens(rt, None, out, row_reqs)
        else:
            for r, row, f in zip(reqs, rows, final):
                if f:
                    self._host_token(rt, r, out[row])
        return self._elapsed(t0)

    def _launch(self, rt: _IslandRT, runner, batch):
        """Run one step of ``rt``'s island on this rank's rows (nothing on
        a rank the island does not hold); returns its output."""
        seat = rt.seat
        if seat is None:
            return None
        states = rt.states
        args = (rt.params, states, batch)
        if seat.comm is not None:
            args += (seat.comm, seat.view, seat.ed)
        out, rt.states = runner(*args)
        if self.check_zero_copy:
            # the step wrote the pools it was given, in place
            assert rt.states is states \
                and _ptrs(self._paged(states)) == self._resident[1], \
                "a step moved the pools"
        return out

    def _elapsed(self, t0: float) -> float:
        """A step's duration: the slowest rank's, so that every rank's
        scheduler clock advances alike."""
        return self.pool.host_max(time.perf_counter() - t0)

    def _host_token(self, rt: _IslandRT, r: Request,
                    logits_row: torch.Tensor) -> None:
        """Legacy path: one device->host argmax read per token."""
        tok = int(torch.argmax(logits_row))
        self.sync_stats.host_argmax += 1
        rt.stats.host_argmax += 1
        self._token_buf.setdefault(r.req_id, []).append(tok)

    # ------------------------------------------------------------------
    def request_fits(self, r: Request, merge) -> bool:
        """Admission gate: can this request's full context EVER sit in
        one ``max_blocks_per_req``-wide block table under ``merge`` (a
        bare merge or an Island)? Over-cap requests are rejected up front
        instead of crashing the serve loop mid-stream. On an SP island
        the blocks round-robin over ``sp`` lanes, so the gate is a
        lane's width."""
        if isinstance(merge, Island) and merge.sp > 1:
            cap = self.geom.capacity(merge.write_tag)
            need = -(-r.total_context() // cap)
            return -(-need // merge.sp) <= self.max_blocks
        m = merge.merge if isinstance(merge, Island) else merge
        cap = self.geom.capacity(m)
        need = -(-r.total_context() // cap)
        return need <= self.max_blocks

    def live_readable(self) -> bool:
        """Scheduler capability hook: can this backend carry in-flight
        requests' KV across a rebind in place? The geometry half
        (``PoolGeometry.live_readable`` a tag) is the scheduler's check;
        this half covers what the steps implement: the head-layout paged
        pool, no MLA, no sliding window, non-recurrent, non-enc-dec. A
        MoE model's experts over 'ed' (``ep > 1``) take part: a live or
        SP step's tokens split over 'ed' as a plain step's do."""
        cfg = self.cfg
        return (self.geom.layout == "head"
                and cfg.mla is None
                and cfg.enc_dec is None
                and cfg.family not in ("ssm", "hybrid")
                and self.pool.window is None)

    def supports_mixed(self) -> bool:
        """Mixed steps cover the head-layout pool: a striped pool runs
        prefill and decode as two launches, and so do the recurrent
        families (a mixed step would run their rows in two batches)."""
        return (self.mixed_step and self.fused
                and self.geom.layout != "striped" and not self._recurrent)

    def mixed(self, prefills: Sequence[Request], decodes: Sequence[Request],
              island: Union[Island, int], chunk_tokens: int) -> float:
        """One step for a Sarathi-style mixed tick: prefill chunk rows and
        the decode batch share a single step keyed
        ``(island_merge, 'mixed', ..., batch_bucket, chunk_bucket,
        mb_bucket, n_engines)``. ``decodes`` may include requests whose
        FINAL chunk is in ``prefills`` this step (the scheduler promotes
        before launching); their first-token input routes on device from
        the prefill output rows via ``d_src_rows``."""
        rt = self._resolve(island)
        isl = rt.island
        self._fault_gate(isl)
        assert self.fused, "mixed step requires fused sampling"
        ents = [self.adaptors[r.engine_group].table[r.req_id]
                for r in list(prefills) + list(decodes)]
        if self._live_tags(ents, isl) is not None:
            # cross-tag segments in the tick: the mixed step has no live
            # variant, so this transient phase runs the token-identical
            # sequential prefill -> decode pair
            return (self.prefill(prefills, island, chunk_tokens)
                    + self.decode(decodes, island))
        t0 = time.perf_counter()
        B = rt.B
        cap = self.geom.capacity(isl.merge)
        # shared mb bucket: the widest need of either phase, so both
        # block tables stage at one width per runner key
        pre_blocks = max(len(self.adaptors[r.engine_group]
                             .table[r.req_id].block_ids) for r in prefills)
        dec_len = max(self.adaptors[r.engine_group].table[r.req_id].length
                      for r in decodes)
        mb = max(self._mb_bucket(pre_blocks),
                 self._mb_bucket(-(-int(dec_len) // cap)))
        pbatch, prows, final, T, mb, _ = self._stage_prefill(rt, prefills,
                                                             mb_min=mb)
        c = self._decode_cache(rt, decodes, mb_min=mb)
        bufs, drows = c.bufs, c.rows
        tokens = self._stage_decode(rt, decodes, c)
        # on-device routing for rows promoted out of THIS step's prefill
        bpg = self.bpe * isl.merge
        src = np.full((B,), -1, np.int32)
        p_row_of = {r.req_id: int(row)
                    for r, row, f in zip(prefills, prows, final) if f}
        for r, drow in zip(decodes, drows):
            pr = p_row_of.get(r.req_id)
            if pr is not None:
                src[drow] = pr % bpg
        batch = {"p_" + k: v for k, v in pbatch.items()}
        batch.update({
            "d_tokens": tokens,
            "d_positions": self._up(rt, bufs["pos"]),
            "d_slots": self._up(rt, bufs["slots"]),
            "d_block_table": self._up(rt, bufs["btab"]),
            "d_context_len": self._up(rt, bufs["ctxl"]),
            "d_src_rows": self._up(rt, src),
        })
        # two seed draws mirror the sequential two-launch assignment, so
        # stochastic sampling stays token-identical across the fusion
        p_seeds = self._sample_seeds(rt, prefills, prows, "prefill")
        d_seeds = self._sample_seeds(rt, decodes, drows, "decode")
        if p_seeds is not None:
            batch["p_sample_seeds"] = p_seeds
            batch["d_sample_seeds"] = d_seeds
        runner = self.pool.runner(
            rt.island, "mixed", sampled=True,
            batch_bucket=B, seq_bucket=T, mb_bucket=mb)
        self.sync_stats.steps += 1  # ONE step for the island's tick
        rt.stats.steps += 1
        p_toks, d_toks = self._launch(rt, runner, batch) or (None, None)
        prow_reqs = tuple((int(row), r.req_id)
                          for row, r, f in zip(prows, prefills, final) if f)
        if prow_reqs:
            self._note_tokens(rt, None, p_toks, prow_reqs)
        self._note_tokens(rt, c.key, d_toks, c.row_reqs)
        return self._elapsed(t0)

    # ------------------------------------------------------------------
    # live cross-layout staging
    # ------------------------------------------------------------------
    def _live_tags(self, entries, isl: Island) -> Optional[Tuple[int, ...]]:
        """The lane-tag tuple when the step must run the live (lane)
        variant; None selects the single-view step. Two triggers: (a) an
        entry's KV spans segments tagged other than the island's merge:
        one lane per distinct tag, sorted; (b) the island is
        sequence-parallel: one lane per SP shard, all of the write tag
        (blocks round-robin over the shards, so position arithmetic over
        one concatenated table never holds). Same-tag shared prefix
        segments alone do not trigger it: their blocks are full and
        aligned under one capacity."""
        if isl.sp > 1:
            return (isl.write_tag,) * isl.sp
        tags = {s.tag for e in entries for s in e.segments}
        if tags <= {isl.merge}:
            return None
        tags.add(isl.merge)
        return tuple(sorted(tags))

    @staticmethod
    def _seg_runs(e):
        """Contiguous same-tag segments merged into one run each: ``[tag,
        start, ids, owners]`` in order (a shared prefix head and its
        private same-tag continuation are block-aligned under one
        capacity, so the staging below only ever sees runs)."""
        runs = []
        for s in e.segments:
            if runs and runs[-1][0] == s.tag:
                runs[-1][2].extend(s.ids)
            else:
                runs.append([s.tag, s.start, list(s.ids), s.owners])
        return runs

    @staticmethod
    def _group_lead(isl: Island, r: Request) -> int:
        """The lead engine of the merge group serving ``r`` in ``isl``."""
        return isl.start + ((r.engine_group - isl.start) // isl.merge) \
            * isl.merge

    def _seg_arrays(self, isl: Island, reqs: Sequence[Request], entries,
                    rows: np.ndarray, B: int, tags, cur_len
                    ) -> Dict[str, np.ndarray]:
        """Per-lane (block table, token count, owner offset) host arrays
        of the live step: lane ``i`` carries tag ``tags[i]`` as
        ``lt{i}_bt``/``lt{i}_len``/``lt{i}_own``. ``cur_len[i]`` is entry
        i's current-tag run's token count (decode: with the incoming
        token; prefill: the prior tokens only). Owner offsets are the
        merge-axis offsets of the group that wrote the run, from the
        owners' fleet positions when recorded (an attached shared prefix
        may be owned by a group unrelated to the reader's lead), else by
        buddy alignment."""
        m = isl.merge
        out: Dict[str, np.ndarray] = {}
        runs_of = [self._seg_runs(e) for e in entries]
        for lane, t in enumerate(tags):
            per = []
            for i, (r, e) in enumerate(zip(reqs, entries)):
                runs = runs_of[i]
                match = [k for k, run in enumerate(runs) if run[0] == t]
                assert len(match) <= 1, \
                    (r.req_id, "non-contiguous tag runs", e.tags())
                if not match:
                    per.append((i, [], 0, 0))
                    continue
                k = match[0]
                _, start, ids, owners = runs[k]
                if t == m:
                    ntok = cur_len[i]
                else:
                    stop = runs[k + 1][1] if k + 1 < len(runs) else e.length
                    ntok = stop - start
                own_lead = (min(o.engine_id for o in owners) if owners
                            else (r.engine_group // t) * t)
                own = own_lead - self._group_lead(isl, r)
                assert 0 <= own <= m - t, (r.req_id, t, own, m)
                per.append((i, ids, ntok, own))
            mb_t = bucket_pow2(max([len(ids) for _, ids, _, _ in per] + [1]))
            bt = np.zeros((B, mb_t), np.int32)
            ln = np.zeros((B,), np.int32)
            ow = np.zeros((B,), np.int32)
            for i, ids, ntok, own in per:
                row = rows[i]
                bt[row, :len(ids)] = ids
                ln[row] = ntok
                ow[row] = own
            out[f"lt{lane}_bt"] = bt
            out[f"lt{lane}_len"] = ln
            out[f"lt{lane}_own"] = ow
        return out

    def _sp_lanes(self, isl: Island, reqs: Sequence[Request], entries,
                  rows: np.ndarray, B: int, upto, write_segs
                  ) -> Dict[str, np.ndarray]:
        """Per-lane host arrays of a sequence-parallel island: lane j
        holds shard j's blocks of each request, in allocation order.
        ``upto[i]`` bounds the tokens credited a lane for entry i (decode:
        ``entry.length`` with the pending token; prefill: the prior
        tokens only, the chunk's keys enter through the causal lane).
        ``write_segs[i]`` (or None) is the row's write-block segment: its
        shard is ROTATED to the LAST lane, which the prefill step treats
        as the causal lane (lane-local key positions stay consistent
        because every block of a lane before its last is full). Lanes
        are resolved from each segment's OWNERS relative to the group
        lead, so they stay valid across an SP-degree rebind."""
        t, s = isl.write_tag, isl.sp
        n = len(reqs)
        cap = self.geom.capacity(t)
        ids_rl: List[List[List[int]]] = [[[] for _ in range(s)]
                                         for _ in range(n)]
        len_rl = np.zeros((n, s), np.int64)
        perm = np.tile(np.arange(s), (n, 1))
        for i, (r, e) in enumerate(zip(reqs, entries)):
            g_lead = self._group_lead(isl, r)
            for sg in e.segments:
                assert sg.tag == t and sg.shard >= 0, \
                    (r.req_id, "non-SP segment on an SP island", sg.tag,
                     sg.shard)
                lane = (min(o.engine_id for o in sg.owners) - g_lead) // t
                assert 0 <= lane < s, (r.req_id, lane, s)
                ids_rl[i][lane].extend(sg.ids)
                len_rl[i][lane] += min(max(int(upto[i]) - sg.start, 0),
                                       cap * len(sg.ids))
            w = write_segs[i]
            if w is not None:
                wl = (min(o.engine_id for o in w.owners) - g_lead) // t
                perm[i] = [j for j in range(s) if j != wl] + [wl]
        mb_l = bucket_pow2(max(
            [len(ids) for per in ids_rl for ids in per] + [1]))
        out: Dict[str, np.ndarray] = {}
        for q in range(s):
            bt = np.zeros((B, mb_l), np.int32)
            ln = np.zeros((B,), np.int32)
            ow = np.zeros((B,), np.int32)
            for i in range(n):
                j = int(perm[i][q])
                row = rows[i]
                ids = ids_rl[i][j]
                bt[row, :len(ids)] = ids
                ln[row] = len_rl[i][j]
                ow[row] = j * t
            out[f"lt{q}_bt"] = bt
            out[f"lt{q}_len"] = ln
            out[f"lt{q}_own"] = ow
        return out

    # ------------------------------------------------------------------
    def _decode_cache(self, rt: _IslandRT, reqs: Sequence[Request],
                      mb_min: int = 1) -> _DecodeCache:
        key = (rt.island, tuple(r.req_id for r in reqs))
        c = rt.steady
        if c is not None and c.key == key and c.live is None:
            self._decode_advance(c)
            # crossing an mb bucket boundary rebuilds the cache against
            # wider staging buffers; within a bucket the steady path is
            # untouched. Live caches re-stage every step instead, under
            # the same key, so the token ring still feeds back
            need = max(self._mb_bucket(-(-int(c.lengths.max()) // c.cap)),
                       mb_min)
            if need == c.mb:
                return c
        return self._decode_build(rt, key, reqs, mb_min)

    def _decode_build(self, rt: _IslandRT, key, reqs: Sequence[Request],
                      mb_min: int = 1) -> _DecodeCache:
        isl = rt.island
        B = rt.B
        n = len(reqs)
        rows_map = self._rows(reqs, isl)
        rows = np.fromiter((rows_map[r.req_id] for r in reqs), np.int64, n)
        entries = [self.adaptors[r.engine_group].table[r.req_id]
                   for r in reqs]
        cap = self.geom.capacity(isl.merge)
        lengths = np.fromiter((e.length for e in entries), np.int64, n)
        live = self._live_tags(entries, isl)
        if isl.sp > 1:
            return self._decode_build_sp(rt, key, reqs, entries, rows,
                                         lengths, live)
        if live is not None:
            return self._decode_build_live(rt, key, reqs, entries, rows,
                                           lengths, live)
        nblk = np.fromiter((len(e.block_ids) for e in entries), np.int64, n)
        mb = max(self._mb_bucket(-(-int(lengths.max()) // cap) if n else 1),
                 mb_min)
        bufs = self._bufs(("decode", isl, B, mb))
        # reset: rows not owned by this membership must stay inert
        bufs["slots"].fill(-1)
        bufs["btab"].fill(0)
        bufs["ctxl"].fill(1)
        bufs["pos"].fill(0)
        bufs["valid"].fill(0)
        bufs["valid"][rows] = 1
        self._fill_block_tables(bufs["btab"], rows, reqs)
        row_reqs = tuple((int(row), r.req_id) for row, r in zip(rows, reqs))
        c = _DecodeCache(key, rows, row_reqs, entries, lengths, nblk,
                         cap, bufs, mb)
        rt.steady = c
        return c

    def _decode_build_live(self, rt: _IslandRT, key, reqs, entries,
                           rows: np.ndarray, lengths: np.ndarray,
                           live) -> _DecodeCache:
        """Stage a decode batch whose KV spans mode-tagged segments: the
        incoming token's slot is segment-local in the CURRENT segment
        (the scheduler retagged pending slots at the rebind), and each
        tag gets its own (table, count, owner) rows. Fresh arrays each
        step: a live phase lasts only until its riders complete."""
        isl = rt.island
        assert self.geom.layout == "head", \
            "live cross-layout staging covers the head-layout pool"
        B, n = rt.B, len(reqs)
        cap = self.geom.capacity(isl.merge)
        tails = [self._seg_runs(e)[-1] for e in entries]
        for r, t_run in zip(reqs, tails):
            assert t_run[0] == isl.merge, \
                (r.req_id, "pending slot not retagged", t_run[0], isl.merge)
        seg_start = np.fromiter((t[1] for t in tails), np.int64, n)
        bufs = {"toks": np.zeros((B, 1), np.int32),
                "pos": np.zeros((B, 1), np.int32),
                "slots": np.full((B,), -1, np.int32)}
        p = lengths - 1                     # absolute (rope) positions
        p_loc = p - seg_start               # segment-local write offset
        bufs["pos"][rows, 0] = p
        slot_blk = np.fromiter((t[2][int(pl) // cap]
                                for t, pl in zip(tails, p_loc)), np.int64, n)
        bufs["slots"][rows] = slot_blk * cap + p_loc % cap
        bufs.update(self._seg_arrays(isl, reqs, entries, rows, B, live,
                                     lengths - seg_start))
        return self._live_cache(rt, key, reqs, entries, rows, lengths, cap,
                                bufs, live)

    def _decode_build_sp(self, rt: _IslandRT, key, reqs, entries,
                         rows: np.ndarray, lengths: np.ndarray,
                         live) -> _DecodeCache:
        """Stage a decode batch on a sequence-parallel island: the
        incoming token's slot is block-local in the live per-block
        segment and ``write_own`` names its owner shard; each SP lane
        gets its (table, count, owner) rows from ``_sp_lanes``.
        Re-staged every step like the live path (lane tables shift as
        blocks rotate over the shards), under the same key."""
        isl = rt.island
        assert self.geom.layout == "head", \
            "SP staging covers the head-layout pool"
        B, n = rt.B, len(reqs)
        cap = self.geom.capacity(isl.write_tag)
        bufs = {"toks": np.zeros((B, 1), np.int32),
                "pos": np.zeros((B, 1), np.int32),
                "slots": np.full((B,), -1, np.int32),
                "write_own": np.zeros((B,), np.int32)}
        for i, (r, e) in enumerate(zip(reqs, entries)):
            sg = e.segments[-1]
            assert sg.shard >= 0 and sg.tag == isl.write_tag, \
                (r.req_id, "pending slot not SP-placed", sg.tag, sg.shard)
            p = int(lengths[i]) - 1          # absolute (rope) position
            assert sg.start <= p < sg.start + cap, (r.req_id, p, sg.start)
            row = rows[i]
            bufs["pos"][row, 0] = p
            bufs["slots"][row] = sg.ids[0] * cap + (p - sg.start)
            bufs["write_own"][row] = min(o.engine_id for o in sg.owners) \
                - self._group_lead(isl, r)
        bufs.update(self._sp_lanes(isl, reqs, entries, rows, B, lengths,
                                   [None] * n))
        return self._live_cache(rt, key, reqs, entries, rows, lengths, cap,
                                bufs, live)

    @staticmethod
    def _live_cache(rt, key, reqs, entries, rows, lengths, cap, bufs,
                    live) -> _DecodeCache:
        row_reqs = tuple((int(row), r.req_id) for row, r in zip(rows, reqs))
        nblk = np.fromiter((len(e.block_ids) for e in entries), np.int64,
                           len(reqs))
        c = _DecodeCache(key, rows, row_reqs, entries, lengths, nblk, cap,
                         bufs, 0, live=live)
        rt.steady = c
        return c

    def _decode_advance(self, c: _DecodeCache) -> None:
        """Steady-state step: O(1) whole-array numpy ops. The scheduler
        appended exactly one slot per request since the last step, so
        lengths advance by one; block tables change only on a block
        boundary."""
        c.lengths += 1
        need = -(-c.lengths // c.cap)
        grew = need > c.nblk
        if grew.any():
            btab = c.bufs["btab"]
            for i in np.nonzero(grew)[0]:
                e = c.entries[i]
                ids = e.ids_np()
                row = c.rows[i]
                btab[row, : min(len(ids), c.mb)] = ids[: c.mb]
                c.nblk[i] = len(e.block_ids)

    def _stage_decode(self, rt: _IslandRT, reqs: Sequence[Request],
                      c: _DecodeCache) -> torch.Tensor:
        """Per-step decode staging over the cache's persistent buffers:
        vectorized position/slot/context math plus the device-resident
        previous-token gather. Shared by ``decode`` and ``mixed``."""
        bufs, rows, cap = c.bufs, c.rows, c.cap
        if c.live is None:
            p = c.lengths - 1
            bufs["pos"][rows, 0] = p
            bufs["slots"][rows] = \
                bufs["btab"][rows, p // cap].astype(np.int64) * cap + p % cap
            bufs["ctxl"][rows] = c.lengths
        # live caches staged positions and slots when built (segment-
        # local slot arithmetic); only the token feed-back remains
        return self._tokens_in(rt, reqs, rows, c.key, bufs["toks"])

    def decode(self, reqs: Sequence[Request],
               island: Union[Island, int]) -> float:
        rt = self._resolve(island)
        self._fault_gate(rt.island)
        t0 = time.perf_counter()
        c = self._decode_cache(rt, reqs)
        bufs = c.bufs
        batch = {
            "tokens": self._stage_decode(rt, reqs, c),
            "positions": self._up(rt, bufs["pos"]),
            "slots": self._up(rt, bufs["slots"]),
        }
        if c.live is None:
            batch["block_table"] = self._up(rt, bufs["btab"])
            batch["context_len"] = self._up(rt, bufs["ctxl"])
            if self._recurrent:
                # rows outside this decode batch keep their state
                batch["valid"] = self._up(rt, bufs["valid"])
        else:
            # no total context length: the live step masks from the
            # lanes' counts alone
            batch.update({k: self._up(rt, v) for k, v in bufs.items()
                          if k.startswith("lt") or k == "write_own"})
        seeds = self._sample_seeds(rt, reqs, c.rows, "decode")
        if seeds is not None:
            batch["sample_seeds"] = seeds
        runner = self.pool.runner(
            rt.island, "decode", sampled=self.fused,
            batch_bucket=rt.B, seq_bucket=1, mb_bucket=c.mb, live=c.live)
        self.sync_stats.steps += 1
        rt.stats.steps += 1
        out = self._launch(rt, runner, batch)
        if self.fused:
            self._note_tokens(rt, c.key, out, c.row_reqs)
        else:
            for r, row in zip(reqs, c.rows):
                self._host_token(rt, r, out[row])
        return self._elapsed(t0)

    # ------------------------------------------------------------------
    def _prompt_tokens(self, r: Request) -> np.ndarray:
        p = self._pinned_prompts.get(r.req_id)
        if p is not None:
            # recovery fold: orig ++ harvested tokens, which the req_id
            # seed cannot regenerate
            assert len(p) == r.prompt_len, \
                (r.req_id, "pinned prompt out of sync", len(p), r.prompt_len)
            return p
        p = self._prompt_cache.get(r.req_id)
        if p is None:
            if len(self._prompt_cache) >= 4096:
                # bounded: prompts regenerate from the req_id seed
                self._prompt_cache.pop(next(iter(self._prompt_cache)))
            p = prompt_token_ids(r, self.cfg.vocab_size)
            self._prompt_cache[r.req_id] = p
        return p

    def prompt_tokens(self, r: Request) -> np.ndarray:
        """Scheduler hook: the exact token ids this backend prefills."""
        return self._prompt_tokens(r)

    def recover_request(self, r: Request) -> int:
        """Scheduler recovery hook (a quarantine, or an eviction under KV
        backpressure): drain the request's
        island so that every token it produced reaches the host, pin
        orig prompt ++ those tokens as its prompt, and return how many
        were kept. Called before the scheduler's fold bookkeeping, so
        ``r`` still carries its pre-fold prompt and placement. An island
        with a dead engine is discarded instead: its in-flight tokens
        died with it, and everyone resident there is being recovered. The
        request's recurrent row, if any, is released: its re-prefill
        starts from a zeroed row."""
        rid = r.req_id
        self.release_row(r)
        g = r.engine_group
        if g >= 0:
            rt = self._rt_of.get(self.layout.island_of(g))
            if rt is not None:
                dead = set(self.injector.dead_engines()) \
                    if self.injector is not None else set()
                if set(rt.island.engines()) & dead:
                    self._discard_island(rt)
                else:
                    self._drain_island(rt)
        # the prompt before any earlier fold: the token buffer holds every
        # token the request produced (the JAX engine takes the folded
        # prompt here, so a second recovery pins the first fold's tokens
        # twice)
        orig = np.asarray(self._prompt_tokens(r)[:r.prompt_len - r.folded],
                          dtype=np.int64)
        toks = self._token_buf.get(rid, [])
        self._pinned_prompts[rid] = np.concatenate(
            [orig, np.asarray(toks, dtype=np.int64)])
        self._prompt_cache.pop(rid, None)
        for rt in self.islands:
            rt.last_tok.pop(rid, None)
        return len(toks)

    def generated_tokens(self, req_id: str) -> List[int]:
        self.drain()
        return self._token_buf.get(req_id, [])

    def harvested_tokens(self, req_id: str) -> List[int]:
        """Non-draining peek at the tokens already surfaced for one
        request (streaming). The async serve loop polls this every tick:
        it must never force a safe point, so it sees only the tokens that
        harvests have already moved to the host; the terminal flush
        (``generated_tokens``) drains for the rest once the request
        finishes."""
        return list(self._token_buf.get(req_id, []))
