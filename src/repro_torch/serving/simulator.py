"""Discrete-event simulation backend: analytic roofline cost model.

Per-step durations derive from the same three roofline terms the dry-run
analysis reports (compute / HBM / ICI) — so the simulator is calibrated
by construction against §Roofline. Decode is HBM-bound (weights + KV
reads), prefill is MXU-bound, collectives ride the ICI ring. TP-merge
divides weight/KV bytes per chip (near-linear TPOT gain) but adds
per-layer psum latency — exactly the DP/TP trade the paper exploits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.configs.base import ArchConfig
from repro_torch.core.faults import TransitionFault
from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import ParallelPlan
from repro_torch.core.task_pool import Request, prompt_token_ids
from repro_torch.serving.hardware import Hardware, V5E


@dataclass
class CostModel:
    cfg: ArchConfig
    plan: ParallelPlan
    hw: Hardware = V5E
    dtype_bytes: int = 2

    def __post_init__(self):
        self.n_active = self.cfg.active_params()
        self.n_total = self.cfg.num_params()
        self.kv_token_bytes = (self.cfg.kv_cache_dims_per_token
                               * self.cfg.num_layers * self.dtype_bytes)

    def tp(self, merge: int) -> int:
        return merge * self.plan.engine_rows * self.plan.tp_base

    # -- decode: one token for a batch, memory-bound ---------------------
    def decode_step(self, merge: int, batch_per_group: int,
                    avg_ctx: float) -> float:
        tp = self.tp(merge)
        wbytes = self.n_active * self.dtype_bytes / tp
        kv = self.kv_token_bytes * avg_ctx * batch_per_group / tp
        t_mem = (wbytes + kv) / (self.hw.hbm_bw * self.hw.mfu_decode_bw)
        t_flop = (2 * self.n_active * batch_per_group
                  / (tp * self.hw.peak_flops_bf16 * self.hw.mfu_prefill))
        t_comm = self._comm(tp, batch_per_group, 1)
        return max(t_mem, t_flop) + t_comm

    # -- decode on a sequence-parallel island (§D12) ---------------------
    def decode_step_sp(self, write_merge: int, sp: int,
                       batch_per_group: int, avg_ctx: float) -> float:
        """One decode token on an SP island: weights are sharded only by
        the WRITE tag's TP degree (each shard is a ``write_merge``-wide
        TP group), while the KV read — the long-context term — splits
        across ``sp`` shards on top of TP: every shard scans only its
        1/sp of the resident tokens. Doubling sp therefore halves the
        KV-bytes term but not the weights term, which is exactly the
        sublinear-TPOT shape fig10 measures. The cross-shard flash-style
        LSE combine adds one small collective over the sp ring."""
        tp = self.tp(write_merge)
        wbytes = self.n_active * self.dtype_bytes / tp
        kv = (self.kv_token_bytes * avg_ctx * batch_per_group
              / (tp * max(sp, 1)))
        t_mem = (wbytes + kv) / (self.hw.hbm_bw * self.hw.mfu_decode_bw)
        t_flop = (2 * self.n_active * batch_per_group
                  / (tp * self.hw.peak_flops_bf16 * self.hw.mfu_prefill))
        t_comm = self._comm(tp, batch_per_group, 1) \
            + self._lse_comm(sp, batch_per_group)
        return max(t_mem, t_flop) + t_comm

    def _lse_comm(self, sp: int, batch: int) -> float:
        """Cross-shard LSE merge (§D12): per layer, each rank exchanges
        its [B, heads, hd] partial attention output plus [B, heads]
        stats over the sp ring — tiny next to the KV scan it replaces."""
        if sp <= 1:
            return 0.0
        L = self.cfg.num_layers
        vol = (L * batch * self.cfg.d_model * self.dtype_bytes
               * 2 * (sp - 1) / sp)
        lat = L * self.hw.ici_latency * math.log2(max(sp, 2))
        return vol / self.hw.ici_bw + lat

    # -- prefill: compute-bound -------------------------------------------
    def prefill_step(self, merge: int, tokens_per_group: int,
                     avg_ctx: float = 0.0) -> float:
        tp = self.tp(merge)
        flops = 2 * self.n_active * tokens_per_group
        # causal attention quadratic term
        flops += (2 * 2 * self.cfg.num_layers * self.cfg.d_model
                  * tokens_per_group * (avg_ctx + tokens_per_group / 2))
        t_flop = flops / (tp * self.hw.peak_flops_bf16 * self.hw.mfu_prefill)
        wbytes = self.n_active * self.dtype_bytes / tp
        t_mem = wbytes / (self.hw.hbm_bw * self.hw.mfu_decode_bw)
        t_comm = self._comm(tp, 1, tokens_per_group)
        return max(t_flop, t_mem) + t_comm

    def _comm(self, tp: int, batch: int, tokens: int) -> float:
        if tp <= 1:
            return 0.0
        L = self.cfg.num_layers
        hidden = (batch * tokens * self.cfg.d_model * self.dtype_bytes)
        # 2 all-reduces per layer, ring: 2(p-1)/p volume over ICI
        vol = 2 * L * hidden * 2 * (tp - 1) / tp
        lat = 2 * L * 2 * self.hw.ici_latency * math.log2(max(tp, 2))
        return vol / self.hw.ici_bw + lat

    # -- mode switching -----------------------------------------------------
    def flying_switch(self) -> float:
        return 0.015  # paper Table 2: live switch 15 ms

    def cold_restart(self, tp: int) -> float:
        wbytes = self.n_total * self.dtype_bytes / tp
        return self.hw.startup_fixed + wbytes / self.hw.weight_load_bw


def _merge_of(island) -> int:
    """Backends accept an Island handle or (seed-era) a bare merge."""
    return getattr(island, "merge", island)


def _sp_of(island) -> int:
    """Sequence-parallel degree of an island handle (bare merges: 1)."""
    return getattr(island, "sp", 1)


@dataclass
class SimBackend:
    """Scheduler Backend running on the cost model (no devices).

    Island-aware: each launch simulates ONE island's step from the
    island's merge and its per-group batches, so heterogeneous layouts
    (a TP island beside DP islands) cost exactly what the roofline says
    each island costs — the scheduler overlaps islands by advancing the
    tick to the slowest one."""
    cost: CostModel
    switch_mode: str = "flying"     # 'flying' | 'restart' | 'none'
    dp_throughput_penalty: float = 1.0  # shift-parallelism proxy uses <1
    _layout: object = None          # last rebound layout (restart costing)
    # scripted fault schedule (core/faults.py). The scheduler adopts it
    # from here (like the real engine's adaptors) so one deterministic
    # script drives detection AND injection.
    injector: object = None

    # -- fault hooks -------------------------------------------------------
    def _check_launch(self, island) -> float:
        """Raise EngineFault when a dead engine is in the collective;
        return the stall factor for the step duration otherwise."""
        if self.injector is None:
            return 1.0
        eng = getattr(island, "engines", None)
        if not callable(eng):
            return 1.0          # bare-merge callers carry no identity
        return self.injector.check_launch(list(eng()))

    def _prefill_cost(self, reqs: Sequence[Request], island,
                      chunk_tokens: int) -> float:
        merge = _merge_of(island)
        sp = _sp_of(island)
        if sp > 1:
            # SP island: the chunk's MLP/QKV compute runs on one
            # write-tag-wide shard; attention reads span all shards
            merge = max(merge // sp, 1)
        groups: dict = {}
        for r in reqs:
            c = min(chunk_tokens, r.prompt_len)
            groups[r.engine_group] = groups.get(r.engine_group, 0) + c
        worst = max(groups.values())
        return self.cost.prefill_step(merge, worst)

    def _decode_cost(self, reqs: Sequence[Request], island) -> float:
        merge = _merge_of(island)
        sp = _sp_of(island)
        groups: dict = {}
        ctx: dict = {}
        for r in reqs:
            groups[r.engine_group] = groups.get(r.engine_group, 0) + 1
            ctx[r.engine_group] = ctx.get(r.engine_group, 0) \
                + r.prompt_len + r.generated - r.folded
        worst = 0.0
        for g, b in groups.items():
            if sp > 1:
                t = self.cost.decode_step_sp(max(merge // sp, 1), sp,
                                             b, ctx[g] / b)
            else:
                t = self.cost.decode_step(merge, b, ctx[g] / b)
            worst = max(worst, t)
        return worst / self.dp_throughput_penalty

    def prefill(self, reqs: Sequence[Request], island,
                chunk_tokens: int) -> float:
        f = self._check_launch(island)
        return self._prefill_cost(reqs, island, chunk_tokens) * f

    def decode(self, reqs: Sequence[Request], island) -> float:
        f = self._check_launch(island)
        return self._decode_cost(reqs, island) * f

    def expected_step(self, prefills: Sequence[Request],
                      decodes: Sequence[Request], island,
                      chunk_tokens: int) -> float:
        """Clean (fault-free) roofline duration of one island launch —
        the scheduler's soft step deadline derives from this."""
        dt = 0.0
        if prefills:
            dt += self._prefill_cost(prefills, island, chunk_tokens)
        if decodes:
            dt += self._decode_cost(decodes, island)
        return dt

    def rebind(self, layout) -> float:
        """Partial layout transition: the reshaped islands re-bind live
        (one O(1) lookup regardless of how many islands moved); static
        baselines cold-restart the widest RESHAPED binding — islands
        the transition leaves alone cost nothing.

        Fault hooks fire BEFORE any state moves, so a scripted
        REBIND_FAIL / DRAIN_CORRUPT leaves the backend still bound to
        the old layout — exactly what the scheduler's rollback
        assumes."""
        old = self._layout
        factor = 1.0
        if self.injector is not None:
            s = self.injector.take_rebind_fault()
            if s is not None:
                raise TransitionFault(
                    f"scripted rebind failure (tick {self.injector.tick})")
            if old is not None:
                changed = old.changed_engines(layout)
                s = self.injector.take_drain_corrupt(changed)
                if s is not None:
                    bad = (set(s.engines) & changed) or set(s.engines)
                    raise TransitionFault(
                        "drain corrupted at the rebind safe point",
                        engines=bad)
                if changed:
                    factor = self.injector.stall_factor(changed)
        self._layout = layout
        if self.switch_mode == "flying":
            return self.cost.flying_switch() * factor
        if self.switch_mode == "restart":
            kept = set(old.islands) if old is not None else set()
            reshaped = [i.merge for i in layout.islands if i not in kept]
            m = max(reshaped) if reshaped else layout.max_merge
            return self.cost.cold_restart(self.cost.tp(m)) * factor
        return 0.0

    def rebind_expected(self, layout) -> Optional[float]:
        """Clean rebind duration — the transition watchdog's deadline
        base (call BEFORE ``rebind``: restart costing reads the
        still-bound old layout)."""
        if self.switch_mode == "flying":
            return self.cost.flying_switch()
        if self.switch_mode == "restart":
            old = self._layout
            kept = set(old.islands) if old is not None else set()
            reshaped = [i.merge for i in layout.islands if i not in kept]
            m = max(reshaped) if reshaped else layout.max_merge
            return self.cost.cold_restart(self.cost.tp(m))
        return None

    def prompt_tokens(self, req: Request):
        """Prompt bytes for content hashing (§D10) — the same
        deterministic stream a real engine would prefill."""
        return prompt_token_ids(req, self.cost.cfg.vocab_size)

    def recover_request(self, req: Request) -> int:
        """Synchronous backend: every counted token was host-visible
        when its step returned, so recovery preserves them all."""
        return req.generated

    def switch(self, old: int, new: int) -> float:
        """Seed-era uniform transition (kept for direct callers)."""
        if old == new:
            return 0.0
        if self.switch_mode == "flying":
            return self.cost.flying_switch()
        if self.switch_mode == "restart":
            return self.cost.cold_restart(self.cost.tp(new))
        return 0.0

    def drain(self) -> None:
        """Synchronous backend: nothing in flight."""

    def live_readable(self) -> bool:
        """Capability hook for the LIVE strategy (§D8): the simulator
        models a fleet whose step programs implement cross-tag reads;
        the scheduler's per-request geometry gate
        (``PoolGeometry.live_readable``) still decides which requests
        actually qualify."""
        return True
