"""FlyingEngine: real-execution runtime of one island on one CUDA card.

Binds the substrate pieces on the device: the canonical-layout weights
(at one rank the parameters are the canonical tensors themselves, so
there is no weights manager yet), invariant flat KV pools (KV Cache
Adaptor), the per-key step functions (Communicator Pool), and the
per-engine allocators. Implements the scheduler's Backend protocol, so
the same DynamicScheduler drives simulation and real execution.

This slice serves ``ParallelPlan(1, 1, 1)``: one engine, merge 1, a
paged pool. A request evicted under KV backpressure (a full pool, or a
scripted ``POOL_EXHAUST`` window of the ``FaultInjector``) is recovered
as the reference recovers it: its island is drained, and the original
prompt plus every token it produced is pinned as its new prompt.
Rebinding to another layout, live cross-layout segments, sequence
parallelism and the faults that need a launch gate or quarantine arrive
with the islands slice and raise ``NotImplementedError`` here.

Zero-sync hot path: steady-state decode performs no host
synchronization and no per-token device->host transfer. Sampling
(greedy, or temperature and top-k with per-row seeds, drawn as the
reference draws them) is fused into the step (device-resident ``[B]``
token ids feed straight back into the next step), the KV pools update in
place, host batch prep is vectorized numpy over persistent staging
buffers, and steps run ahead of the host inside a bounded in-flight
window (a CUDA event per step). Tokens surface only at harvests (every
``harvest_limit`` steps) and drain points (``generated_tokens``,
``drain``) as batched transfers; ``harvested_tokens`` peeks at what has
surfaced without draining. ``sync_stats`` counts every class of host
crossing.

Prefill is chunked: long prompts stream through ``prefill_chunk``-sized
slices with absolute positions and per-request prior lengths, and when
prefill chunks co-reside with a decode batch the scheduler drives
``mixed()`` — one step covering both phases, with promoted requests'
first tokens routed on device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.communicator_pool import CommunicatorPool, bucket_pow2
from repro_torch.core.faults import POOL_EXHAUST
from repro_torch.core.kv_adaptor import (KVCacheAdaptor, PoolGeometry,
                                         bind_fleet, ragged_arange)
from repro_torch.core.modes import FleetLayout, Island, ParallelPlan
from repro_torch.core.task_pool import Request, prompt_token_ids
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
                 "cap", "bufs", "mb")

    def __init__(self, key, rows, row_reqs, entries, lengths, nblk, cap,
                 bufs, mb):
        self.key = key
        self.rows = rows
        self.row_reqs = row_reqs
        self.entries = entries
        self.lengths = lengths
        self.nblk = nblk
        self.cap = cap
        self.bufs = bufs
        self.mb = mb


class _IslandRT:
    """Per-island runtime: the island's parameters and state pools plus
    everything the hot path keeps warm between steps."""
    __slots__ = ("island", "params", "states", "B", "stats", "pending",
                 "last_tok", "last_src", "last_key", "steady")

    def __init__(self, island: Island, params, states, B: int):
        self.island = island
        self.params = params
        self.states = states    # per group, per kind: flat (k, v) pools
        self.B = B              # island batch rows = n_engines * bpe
        self.stats = SyncStats()
        # async token ring: device token tensors not yet harvested, each
        # with the rows it holds and the event that marks its completion
        self.pending: List[Tuple[torch.Tensor, Tuple[Tuple[int, str], ...],
                                 Optional[torch.cuda.Event]]] = []
        self.last_tok: Dict[str, Tuple[torch.Tensor, int]] = {}
        self.last_src: Optional[torch.Tensor] = None
        self.last_key = None
        self.steady: Optional[_DecodeCache] = None


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


class FlyingEngine:
    def __init__(self, model: Model, plan: ParallelPlan, geom: PoolGeometry,
                 params, *, batch_per_engine: int = 4,
                 max_blocks_per_req: int = 16, fused_sampling: bool = True,
                 async_window: int = 2, temperature: float = 0.0,
                 top_k: int = 0, harvest_limit: int = 512,
                 mixed_step: bool = True, injector=None,
                 seed_mode: str = "fleet", device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        if plan.pods * plan.data_rows * plan.tp_base != 1:
            raise NotImplementedError(
                "the port serves ParallelPlan(1, 1, 1) on one card; "
                "multi-rank islands are a later slice")
        if injector is not None:
            kinds = sorted({s.kind for s in injector.specs} - {POOL_EXHAUST})
            if kinds:
                raise NotImplementedError(
                    f"fault kinds {kinds} need a launch gate or quarantine, "
                    f"which are not ported; the port takes {POOL_EXHAUST}")
        model.check_serving()
        self.model = model
        self.cfg = model.cfg
        self.plan = plan
        self.geom = geom
        self.bpe = batch_per_engine
        self.max_blocks = max_blocks_per_req
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

        self.pool = CommunicatorPool(model, plan, geom,
                                     sample=(temperature, top_k))
        self.params = _tree_to(params, self.device)
        self.adaptors = [KVCacheAdaptor(geom)
                         for _ in range(plan.dp_engines * plan.pods)]
        self.layout = FleetLayout.uniform(plan, 1)
        self.islands: List[_IslandRT] = [
            self._make_rt(isl) for isl in self.layout.islands]
        self._rt_of: Dict[Island, _IslandRT] = {
            rt.island: rt for rt in self.islands}
        bind_fleet(self.adaptors, self.layout)
        self.sync_stats = SyncStats()
        # scripted fault schedule (core/faults.py); the scheduler adopts
        # it from here and applies its POOL_EXHAUST seizures itself
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
    def _fresh_states(self, isl: Island):
        """Per group, per kind: the flat (k, v) pools ``[n_layers,
        num_blocks, block_elems]`` on the device, zeroed. The step views
        them in the island's mode and writes them in place."""
        shape = tuple(self.geom.flat_shape())
        return [tuple({"mixer": tuple(
            torch.zeros((n,) + shape, dtype=self.model.dtype,
                        device=self.device) for _ in range(2))}
            for _ in kind_seq)
            for kind_seq, n in self.model.plan]

    def _make_rt(self, isl: Island) -> _IslandRT:
        return _IslandRT(isl, self.params, self._fresh_states(isl),
                         isl.n_engines * self.bpe)

    def rebind(self, layout: Union[FleetLayout, int]) -> float:
        if isinstance(layout, int):
            layout = FleetLayout.uniform(self.plan, layout)
        if layout == self.layout:
            return 0.0
        raise NotImplementedError("layout rebinds arrive with the islands "
                                  "slice")

    # ------------------------------------------------------------------
    # batched execution over the scheduler's request lists
    # ------------------------------------------------------------------
    def _rows(self, reqs: Sequence[Request],
              isl: Island) -> Dict[str, int]:
        """Assign each request a padded-batch row within its island's
        group."""
        bpg = self.bpe * isl.merge
        counters: Dict[int, int] = {}
        rows: Dict[str, int] = {}
        for r in reqs:
            assert isl.start <= r.engine_group < isl.stop, \
                (r.req_id, r.engine_group, isl)
            g = (r.engine_group - isl.start) // isl.merge
            i = counters.get(g, 0)
            assert i < bpg, "group batch overflow"
            rows[r.req_id] = g * bpg + i
            counters[g] = i + 1
        return rows

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
                 "ctxl": np.ones((B,), np.int32)}
        else:
            T = key[4]
            b = {"toks": np.zeros((B, T), np.int32),
                 "pos": np.zeros((B, T), np.int32),
                 "slots": np.full((B, T), -1, np.int32),
                 "btab": np.zeros((B, mb), np.int32),
                 "prior": np.zeros((B,), np.int32),
                 "lastp": np.zeros((B,), np.int32)}
        self._host_bufs[key] = b
        return b

    def _mb_bucket(self, max_need_blocks: int) -> int:
        """Bucketed block-table width: pow2 over the max blocks any live
        request needs, capped at the engine's configured max."""
        return min(bucket_pow2(max(int(max_need_blocks), 1)),
                   self.max_blocks)

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
        """Previous-token batch input [B,1] without any device->host
        read: rows whose last token is still device-resident are gathered
        on device from the producing step's output; rows already
        harvested come from the host token buffer."""
        B = host.shape[0]
        if key is not None and key == rt.last_key \
                and rt.last_src is not None:
            # unchanged membership: the previous step's [B] output IS
            # this step's input — feed it straight back
            return rt.last_src.reshape(B, 1)
        host.fill(0)
        per_src: Dict[int, Tuple[torch.Tensor, List[int], List[int]]] = {}
        for r, row in zip(reqs, rows):
            ent = rt.last_tok.get(r.req_id)
            if ent is None:
                buf = self._token_buf.get(r.req_id)
                if buf:
                    host[row, 0] = buf[-1]
            else:
                src, srow = ent
                rec = per_src.setdefault(id(src), (src, [], []))
                rec[1].append(srow)
                rec[2].append(int(row))
        tok = self._h2d(host)
        for src, srows, drows in per_src.values():
            tok[self._h2d(np.asarray(drows, np.int64)), 0] = \
                src[self._h2d(np.asarray(srows, np.int64))]
        return tok

    def _note_tokens(self, rt: _IslandRT, key, toks_dev: torch.Tensor,
                     row_reqs: Tuple[Tuple[int, str], ...]) -> None:
        ev = None
        if toks_dev.is_cuda:
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
        per-token)."""
        for toks_dev, row_reqs, _ in rt.pending:
            arr = toks_dev.cpu().numpy()
            self.sync_stats.d2h_batched += 1
            rt.stats.d2h_batched += 1
            for row, rid in row_reqs:
                if rid in self._retired:
                    continue    # aborted mid-flight: drop, don't buffer
                self._token_buf.setdefault(rid, []).append(int(arr[row]))
        rt.pending.clear()
        rt.last_tok.clear()

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
        self._retired.add(rid)
        self._token_buf.pop(rid, None)
        self._prompt_cache.pop(rid, None)
        self._pinned_prompts.pop(rid, None)
        for rt in self.islands:
            rt.last_tok.pop(rid, None)

    # -- sampling seeds -------------------------------------------------
    def _seeds(self, B: int) -> Optional[torch.Tensor]:
        """Per-row sampling seeds without per-step host uploads: the [B]
        iota is a cached device tensor per batch size; each step adds
        only the scalar cursor on the device (the same uint32 values as
        ``base + arange`` mod 2**32)."""
        if self.temperature <= 0.0:
            return None
        iota = self._seed_iota.get(B)
        if iota is None:
            iota = torch.arange(B, dtype=torch.int64, device=self.device)
            self._seed_iota[B] = iota
        # a fleet-wide cursor advanced by each draw's OWN batch size, so
        # launches of different batch sizes get disjoint seed ranges
        base = self._seed_cursor
        self._seed_cursor = (base + B) & 0xFFFFFFFF
        return (iota + base) & 0xFFFFFFFF

    def _sample_seeds(self, B: int, reqs: Sequence[Request], rows,
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
            return self._seeds(B)
        host = np.zeros((B,), np.int64)
        for r, row in zip(reqs, rows):
            idx = max(r.generated - 1, 0) if phase == "prefill" \
                else r.generated
            host[int(row)] = abs(hash((r.req_id, int(idx)))) & 0xFFFFFFFF
        return self._h2d(host)

    def _single_view(self, entries, isl: Island) -> None:
        """The port's steps read one mode view: every KV segment must be
        tagged with the island's merge (no live cross-layout riders)."""
        tags = {s.tag for e in entries for s in e.segments}
        if isl.sp > 1 or not tags <= {isl.merge}:
            raise NotImplementedError(
                "live cross-layout segments are not ported yet")

    # ------------------------------------------------------------------
    def _stage_prefill(self, rt: _IslandRT, reqs: Sequence[Request],
                       mb_min: int = 1):
        """Host staging for one chunked-prefill launch. Each request's
        chunk covers prompt positions ``[r.prefilled, min(entry.length,
        prompt_len))``: the scheduler has already allocated the chunk's
        slots and only advances ``prefilled`` after the launch, so at
        staging time ``prefilled`` IS the prior context length. Returns
        (batch, rows, final_mask, T, mb)."""
        isl = rt.island
        B = rt.B
        n = len(reqs)
        prompts = [self._prompt_tokens(r) for r in reqs]
        rows_map = self._rows(reqs, isl)
        rows = np.fromiter((rows_map[r.req_id] for r in reqs), np.int64, n)
        entries = [self.adaptors[r.engine_group].table[r.req_id]
                   for r in reqs]
        self._single_view(entries, isl)
        plens = np.fromiter((len(p) for p in prompts), np.int64, n)
        elens = np.fromiter((e.length for e in entries), np.int64, n)
        # prompt positions cached once this chunk lands (entry.length may
        # already include the first decode token's slot on final chunks)
        end = np.minimum(elens, plens)
        prior = np.fromiter((max(int(r.prefilled), 0) for r in reqs),
                            np.int64, n)
        prior = np.minimum(prior, end)
        chunk = end - prior
        final = end >= plens
        # seq bucket: pad the CHUNK extent to pow2 so chunk-length
        # variation reuses one runner key per bucket; mb bucket: the
        # block-table width tracks the widest live request
        T = bucket_pow2(max(int(chunk.max()), 1))
        nblocks = max(len(e.block_ids) for e in entries)
        assert nblocks <= self.max_blocks, \
            f"request needs {nblocks} blocks > max_blocks_per_req=" \
            f"{self.max_blocks}"
        mb = max(self._mb_bucket(nblocks), mb_min)
        bufs = self._bufs(("prefill", isl, B, mb, T))
        toks, slots, btab = bufs["toks"], bufs["slots"], bufs["btab"]
        toks.fill(0)
        slots.fill(-1)
        btab.fill(0)
        cap = self.geom.capacity(isl.merge)
        self._fill_block_tables(btab, rows, reqs)
        if int(chunk.sum()):
            rowcat = np.repeat(np.arange(n), chunk)
            offcat = ragged_arange(chunk)
            poscat = np.repeat(prior, chunk) + offcat
            rcat = rows[rowcat]
            toks[rcat, offcat] = np.concatenate(
                [p[lo:hi] for p, lo, hi in zip(prompts, prior, end)])
            blockcat = btab[rcat, poscat // cap].astype(np.int64)
            slots[rcat, offcat] = blockcat * cap + poscat % cap
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
            "tokens": self._h2d(toks),
            "positions": self._h2d(posb),
            "slots": self._h2d(slots),
            "last_pos": self._h2d(lastp),
            "block_table": self._h2d(btab),
            "prior_len": self._h2d(priorb),
        }
        return batch, rows, final, T, mb

    def prefill(self, reqs: Sequence[Request], island: Union[Island, int],
                chunk_tokens: int) -> float:
        rt = self._resolve(island)
        t0 = time.perf_counter()
        batch, rows, final, T, mb = self._stage_prefill(rt, reqs)
        seeds = self._sample_seeds(rt.B, reqs, rows, "prefill")
        if seeds is not None:
            batch["sample_seeds"] = seeds
        runner = self.pool.runner(
            rt.island, "prefill", sampled=self.fused,
            batch_bucket=rt.B, seq_bucket=T, mb_bucket=mb)
        self.sync_stats.steps += 1
        rt.stats.steps += 1
        out, rt.states = runner(rt.params, rt.states, batch)
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
        return time.perf_counter() - t0

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
        one ``max_blocks_per_req``-wide block table under ``merge``?
        Over-cap requests are rejected up front instead of crashing the
        serve loop mid-stream."""
        m = merge.merge if isinstance(merge, Island) else merge
        cap = self.geom.capacity(m)
        need = -(-r.total_context() // cap)
        return need <= self.max_blocks

    def live_readable(self) -> bool:
        """Scheduler capability hook: the port has no live cross-layout
        read program yet."""
        return False

    def supports_mixed(self) -> bool:
        return self.mixed_step and self.fused

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
        assert self.fused, "mixed step requires fused sampling"
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
        pbatch, prows, final, T, mb = self._stage_prefill(rt, prefills,
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
            "d_positions": self._h2d(bufs["pos"]),
            "d_slots": self._h2d(bufs["slots"]),
            "d_block_table": self._h2d(bufs["btab"]),
            "d_context_len": self._h2d(bufs["ctxl"]),
            "d_src_rows": self._h2d(src),
        })
        # two seed draws mirror the sequential two-launch assignment, so
        # stochastic sampling stays token-identical across the fusion
        p_seeds = self._sample_seeds(B, prefills, prows, "prefill")
        d_seeds = self._sample_seeds(B, decodes, drows, "decode")
        if p_seeds is not None:
            batch["p_sample_seeds"] = p_seeds
            batch["d_sample_seeds"] = d_seeds
        runner = self.pool.runner(
            rt.island, "mixed", sampled=True,
            batch_bucket=B, seq_bucket=T, mb_bucket=mb)
        self.sync_stats.steps += 1  # ONE step for the island's tick
        rt.stats.steps += 1
        (p_toks, d_toks), rt.states = runner(rt.params, rt.states, batch)
        prow_reqs = tuple((int(row), r.req_id)
                          for row, r, f in zip(prows, prefills, final) if f)
        if prow_reqs:
            self._note_tokens(rt, None, p_toks, prow_reqs)
        self._note_tokens(rt, c.key, d_toks, c.row_reqs)
        return time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _decode_cache(self, rt: _IslandRT, reqs: Sequence[Request],
                      mb_min: int = 1) -> _DecodeCache:
        key = (rt.island, tuple(r.req_id for r in reqs))
        c = rt.steady
        if c is not None and c.key == key:
            self._decode_advance(c)
            # crossing an mb bucket boundary rebuilds the cache against
            # wider staging buffers; within a bucket the steady path is
            # untouched
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
        self._single_view(entries, isl)
        cap = self.geom.capacity(isl.merge)
        lengths = np.fromiter((e.length for e in entries), np.int64, n)
        nblk = np.fromiter((len(e.block_ids) for e in entries), np.int64, n)
        mb = max(self._mb_bucket(-(-int(lengths.max()) // cap) if n else 1),
                 mb_min)
        bufs = self._bufs(("decode", isl, B, mb))
        # reset: rows not owned by this membership must stay inert
        bufs["slots"].fill(-1)
        bufs["btab"].fill(0)
        bufs["ctxl"].fill(1)
        bufs["pos"].fill(0)
        self._fill_block_tables(bufs["btab"], rows, reqs)
        row_reqs = tuple((int(row), r.req_id) for row, r in zip(rows, reqs))
        c = _DecodeCache(key, rows, row_reqs, entries, lengths, nblk,
                         cap, bufs, mb)
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
        p = c.lengths - 1
        bufs["pos"][rows, 0] = p
        bufs["slots"][rows] = \
            bufs["btab"][rows, p // cap].astype(np.int64) * cap + p % cap
        bufs["ctxl"][rows] = c.lengths
        return self._tokens_in(rt, reqs, rows, c.key, bufs["toks"])

    def decode(self, reqs: Sequence[Request],
               island: Union[Island, int]) -> float:
        rt = self._resolve(island)
        t0 = time.perf_counter()
        c = self._decode_cache(rt, reqs)
        bufs = c.bufs
        batch = {
            "tokens": self._stage_decode(rt, reqs, c),
            "positions": self._h2d(bufs["pos"]),
            "slots": self._h2d(bufs["slots"]),
            "block_table": self._h2d(bufs["btab"]),
            "context_len": self._h2d(bufs["ctxl"]),
        }
        seeds = self._sample_seeds(rt.B, reqs, c.rows, "decode")
        if seeds is not None:
            batch["sample_seeds"] = seeds
        runner = self.pool.runner(
            rt.island, "decode", sampled=self.fused,
            batch_bucket=rt.B, seq_bucket=1, mb_bucket=c.mb)
        self.sync_stats.steps += 1
        rt.stats.steps += 1
        out, rt.states = runner(rt.params, rt.states, batch)
        if self.fused:
            self._note_tokens(rt, c.key, out, c.row_reqs)
        else:
            for r, row in zip(reqs, c.rows):
                self._host_token(rt, r, out[row])
        return time.perf_counter() - t0

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
        """Scheduler recovery hook (KV backpressure): drain the request's
        island so that every token it produced reaches the host, pin
        orig prompt ++ those tokens as its prompt, and return how many
        were kept. Called before the scheduler's fold bookkeeping, so
        ``r`` still carries its pre-fold prompt and placement. An island
        with a dead engine would lose its in-flight tokens instead;
        that needs quarantine, which is not ported."""
        rid = r.req_id
        g = r.engine_group
        if g >= 0:
            rt = self._rt_of.get(self.layout.island_of(g))
            if rt is not None:
                dead = set(self.injector.dead_engines()) \
                    if self.injector is not None else set()
                if set(rt.island.engines()) & dead:
                    raise NotImplementedError(
                        "recovery from a dead island needs quarantine, "
                        "which is not ported")
                self._drain_island(rt)
        orig = np.asarray(self._prompt_tokens(r)[:r.prompt_len],
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
