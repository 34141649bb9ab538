"""The port's multi-rank islands against the JAX package's, on the CPU.

One process per rank, joined over gloo (``repro_torch.launch.ranks``):
``ParallelPlan(1, 2, 4)`` is 8 ranks, 4 engines of 2 ranks each, as the
JAX package's multi-device scripts run it on 8 forced host devices.
Every rank runs one torch thread under ``PYTHONHASHSEED=0``; every
spawn has its own join deadline, so a missed collective fails the test
instead of hanging it.

The JAX side runs in a subprocess, this file's ``__main__``, with 8
forced host devices. There it patches ``AbstractMesh`` to take the pair
form the JAX package passes (jax 0.9 refuses it; see
``tests/test_torch_engine.py``) and nothing else: both packages'
engines report ``live_readable()`` True, so their schedulers decide
alike (the reduced llama3-8b's one KV head makes no tag above its own
readable, so LIVE pauses what it cannot carry, as HARD does; the LIVE
lanes themselves are held in ``tests/test_torch_live.py``). It writes the reduced llama3-8b parameters, the
distributed step logits of ``tests/md_scripts/check_serve_consistency.py``
at merges 1, 2 and 4, the scheduler runs of
``tests/md_scripts/check_engine_e2e.py`` and the island run of
``tests/md_scripts/check_island_serving.py`` into a temporary directory.
Both packages' scheduler runs report a fixed 10 ms a step and a rebind,
so the phases they choose depend on nothing measured.

What is held: rank grids against the JAX meshes; ``TPContext``'s
collectives, slices and ``slice_of_rank`` at 2 and 4 ranks; the weights
manager's storage rules against the JAX package's partition specs;
zero-copy weights and pools across merges 1 -> 2 -> 4 -> 1 -> 2; step
logits within the reference's rtol = atol = 3e-3 of the JAX
distributed step and of the one-rank port, greedy tokens identical;
scheduler runs under HARD, SOFT, SEQUENTIAL and LIVE token-identical to
the JAX package's with equal phase logs, preempt_stats and runner keys;
a TP2 island carved beside a DP island over two partial rebinds, whose
untouched island never drains; every fault kind accepted and scripted
on two ranks; SP islands and the live-read gates (a sliding window
refuses both).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import FlyingEngine
from repro_torch.core.faults import (DRAIN_CORRUPT, KILL, REBIND_FAIL, STALL,
                                     FaultInjector, FaultSpec)
from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
from repro_torch.core.modes import (FleetLayout, FlyingMode, Island,
                                    ParallelPlan, island_ranks, mode_ranks,
                                    tp_group_ranks)
from repro_torch.core.views import RankGroup, TPContext
from repro_torch.launch.ranks import spawn
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import FixedClock  # noqa: E402  (reports 10 ms a step)

ARCH = "llama3-8b"
PLAN = (1, 2, 4)            # engine_rows, tp_base, data_rows: 8 ranks
MERGES = (1, 2, 4)
STRATEGIES = ("hard", "soft", "sequential", "live")
B, T = 4, 10                # check_serve_consistency's batch and prompt
BPE, PROMPT = 2, 8          # check_island_serving's
RTOL = ATOL = 3e-3          # check_serve_consistency's tolerance
SPAWN_S = 180.0             # join deadline of each spawn


def _key_text(keys) -> list:
    return sorted(repr(tuple(k)) for k in keys)


def _write_json(path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=True)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# the JAX side: ``python tests/test_torch_islands.py OUT_DIR``
# ---------------------------------------------------------------------------

def reference_main(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO / "tests" / "md_scripts"))
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.core.engine import FlyingEngine as JEngine
    from repro.core.kv_adaptor import KVCacheAdaptor as JAdaptor
    from repro.core.kv_adaptor import PoolGeometry as JGeometry
    from repro.core.modes import FleetLayout as JLayout
    from repro.core.modes import FlyingMode as JMode
    from repro.core.modes import ParallelPlan as JPlan
    from repro.core.modes import island_mesh, mode_mesh
    from repro.core.policy import FlyingPolicy as JPolicy
    from repro.core.scheduler import DynamicScheduler as JScheduler
    from repro.core.scheduler import SchedulerConfig as JSConfig
    from repro.core.steps import build_serve_step
    from repro.core.task_pool import Request as JRequest
    from repro.core.views import SINGLE
    from repro.core.weights_manager import WeightsManager
    from repro.models.cache import TrainBackend
    from repro.models.model import build_model
    import check_island_serving as cis
    from check_serve_consistency import global_states

    class PairMesh(jax.sharding.AbstractMesh):
        def __init__(self, axis_sizes, axis_names=None, *a, **kw):
            if axis_names is None:
                axis_names = tuple(n for n, _ in axis_sizes)
                axis_sizes = tuple(s for _, s in axis_sizes)
            super().__init__(axis_sizes, axis_names, *a, **kw)
    jax.sharding.AbstractMesh = PairMesh

    cfg = jget(ARCH).reduced()
    model = build_model(cfg, jnp.float32)
    params = model.init(jax.random.key(0))
    np.savez(os.path.join(out, "params.npz"),
             *[np.asarray(a) for a in jax.tree.leaves(params)])
    plan = JPlan(*PLAN)

    # rank grids: the mode and island meshes' device ids
    grids = {f"mode{m}": [[d.id for d in mode_mesh(JMode(plan, m))
                           .devices.flat]] for m in MERGES}
    L_DP = JLayout.of(plan, [(2, 1), (2, 1)])
    for isl in L_DP.carve(0, 2, 2).islands + L_DP.islands:
        grids[repr((isl.start, isl.n_engines, isl.merge))] = \
            [[d.id for d in island_mesh(plan, isl).devices.flat]]
    _write_json(os.path.join(out, "grids.json"), grids)

    # step logits (check_serve_consistency.run_arch, merges 1, 2, 4)
    toks = jax.random.randint(jax.random.key(1), (B, T + 1), 0,
                              cfg.vocab_size)
    ref, _, _ = model.forward(params, SINGLE, mode="train", tokens=toks,
                              backend=TrainBackend())
    steps = {"tokens": np.asarray(toks),
             "single_prefill": np.asarray(ref[:, -2]),
             "single_decode": np.asarray(ref[:, -1])}
    wm = WeightsManager(cfg, plan)
    for merge in MERGES:
        mode = JMode(plan, merge)
        mesh = mode_mesh(mode)
        p_sh = jax.device_put(params, wm.shardings(params, mesh))
        groups = plan.pods * mode.dp
        bpg = B // groups
        geom = _step_geom(JGeometry, cfg, plan, merge, bpg)
        adaptors = [JAdaptor(geom) for _ in range(groups)]
        for a in adaptors:
            a.switch_mode(merge)
        slots, btab, max_blocks = _prefill_tables(adaptors, geom, merge,
                                                  bpg)
        st = global_states(model, geom, mode, bpg, mesh, "prefill")
        prefill, _, _ = build_serve_step(model, mode, geom, phase="prefill")
        batch = {"tokens": toks[:, :T],
                 "positions": jnp.broadcast_to(jnp.arange(T)[None], (B, T)),
                 "slots": jnp.asarray(slots),
                 "block_table": jnp.asarray(btab),
                 "prior_len": jnp.zeros((B,), jnp.int32)}
        lp, st = jax.jit(prefill)(p_sh, st, batch)
        dslots, btab2 = _decode_tables(adaptors, bpg, max_blocks)
        decode, _, _ = build_serve_step(model, mode, geom, phase="decode")
        dbatch = {"tokens": toks[:, T:T + 1],
                  "positions": jnp.full((B, 1), T, jnp.int32),
                  "slots": jnp.asarray(dslots),
                  "block_table": jnp.asarray(btab2),
                  "context_len": jnp.full((B,), T + 1, jnp.int32)}
        ld, st = jax.jit(decode)(p_sh, st, dbatch)
        steps[f"prefill{merge}"] = np.asarray(lp)
        steps[f"decode{merge}"] = np.asarray(ld)
    np.savez(os.path.join(out, "steps.npz"), **steps)

    # scheduler runs (check_engine_e2e.main, with a fixed clock)
    geom = JGeometry(cfg, plan, num_blocks=64, block_base=4)
    runs = {}
    for strategy in STRATEGIES:
        eng = JEngine(model, plan, geom, params, batch_per_engine=2,
                      max_blocks_per_req=16, prefill_len=8,
                      check_zero_copy=True)
        runs[strategy] = _sched_run(
            eng, lambda e: JScheduler(plan, geom, FixedClock(e), JSConfig(
                strategy=strategy, max_batch_per_group=2, prefill_chunk=8),
                policy=JPolicy()), JRequest)
    _write_json(os.path.join(out, "sched.json"), runs)

    # the island run (check_island_serving.run, its first engine)
    eng = JEngine(model, plan, geom, params, batch_per_engine=BPE,
                  prefill_len=PROMPT, check_zero_copy=True, layout=L_DP)
    toks_isl, b_stats = cis.run(eng, L_DP, L_DP.carve(0, 2, 2),
                                drain_everything=False)
    _write_json(os.path.join(out, "island.json"),
                {"toks": toks_isl, "b_drains": b_stats.drains,
                 "switches": len(eng.switch_log)})


def _step_geom(Geom, cfg, plan, merge, bpg):
    """check_serve_consistency's pool: enough blocks for the batch."""
    probe = Geom(cfg, plan, num_blocks=2, block_base=4)
    cap = probe.capacity(merge)
    need = bpg * (-(-(T + 1) // cap)) + 2
    return Geom(cfg, plan, num_blocks=max(need, 10), block_base=4)


def _prefill_tables(adaptors, geom, merge, bpg):
    slots = np.stack([np.concatenate(
        [adaptors[b // bpg].append_slots(f"r{b}", T)]) for b in range(B)])
    max_blocks = -(-(T + 1) // geom.capacity(merge)) + 1
    btab = np.stack([adaptors[b // bpg].block_table(f"r{b}", max_blocks)
                     for b in range(B)])
    return slots, btab, max_blocks


def _decode_tables(adaptors, bpg, max_blocks):
    dslots = np.stack([adaptors[b // bpg].append_slots(f"r{b}", 1)[0]
                       for b in range(B)])
    btab = np.stack([adaptors[b // bpg].block_table(f"r{b}", max_blocks)
                     for b in range(B)])
    return dslots, btab


def _sched_run(eng, make_sched, Request) -> dict:
    """check_engine_e2e's trace: 10 requests 10 ms apart, 8-token
    prompts, 4 tokens out, request 5 at priority 1."""
    sched = make_sched(eng)
    for i in range(10):
        sched.submit(Request(req_id=f"r{i}", arrival=i * 0.01, prompt_len=8,
                             output_len=4, priority=1 if i == 5 else 0))
    sched.run(max_steps=500)
    done = sorted(r.req_id for r in sched.pool.all.values()
                  if r.state == "done")
    return {"done": done,
            "toks": {rid: list(map(int, eng.generated_tokens(rid)))
                     for rid in done},
            "phases": [l.phase for l in sched.log],
            "layouts": [[l.merge, l.switched, [list(i) for i in l.islands]]
                        for l in sched.log],
            "switches": sched.switches,
            "preempt": dict(sched.preempt_stats),
            "keys": _key_text(eng.pool._runners)}


# ---------------------------------------------------------------------------
# the port's ranks (module-level: the spawned children import them)
# ---------------------------------------------------------------------------

def _port_params(ref_dir: str, cfg):
    like = Model(cfg, torch.float32, torch.device("meta")).init(
        torch.Generator(device="cpu"))
    with np.load(os.path.join(ref_dir, "params.npz")) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return params_from_numpy(cfg, ckpt.tree_unflatten(like, leaves))


def _stack(ref_dir, plan_args=PLAN):
    from repro_torch.models.model import build_model
    cfg = get_config(ARCH).reduced()
    return (cfg, build_model(cfg, torch.float32, "cpu"),
            _port_params(ref_dir, cfg), ParallelPlan(*plan_args))


def ctx_rank(rank, world, out):
    """TPContext at ``world`` ranks, each view factor: slices, rank
    arithmetic and collectives against single-process arithmetic."""
    import torch.distributed as dist
    group = RankGroup(dist.new_group(list(range(world))), range(world),
                      rank)
    m = 1
    while m <= world:
        ctx = TPContext(tp=world, view_m=m).bind(group)
        assert ctx.stripe_index() == rank
        assert ctx.storage_major_rank() == \
            ctx.storage_rank() * m + ctx.view_rank()
        assert (ctx.view_rank(), ctx.storage_rank()) == \
            divmod(rank, world // m)
        v = torch.arange(4 * m, dtype=torch.float32).reshape(2, 2 * m)
        assert torch.equal(ctx.activate_view(v, 1),
                           v[:, 2 * ctx.view_rank():2 * ctx.view_rank() + 2])
        if world // m >= 2:          # 'ed' of 2 engine rows
            assert TPContext(tp=world, view_m=m, ep=2).bind(
                group).ep_rank() == ctx.storage_rank() // (world // m // 2)
        for n in (1, 2, 4, 8, 3):
            # a weight of n units of width 3 along dim 1, whole storage
            # shard when n does not divide the storage shards
            stored = ctx.stored_shards(n)
            full = torch.arange(5 * n * 3, dtype=torch.float32).reshape(
                5, n * 3)
            w = full.narrow(1, (ctx.storage_rank() % stored)
                            * (n * 3 // stored), n * 3 // stored) \
                if stored > 1 else full
            a = ctx.activate(w, 1, n)
            assert a.untyped_storage().data_ptr() == \
                full.untyped_storage().data_ptr()          # a view
            s, units = ctx.slice_of_rank(rank, n), ctx.local_units(n)
            assert torch.equal(a, full[:, s * units * 3:(s + 1) * units * 3])
            x_all = [torch.randn(2, units, 4,
                                 generator=torch.Generator().manual_seed(
                                     100 + r)) for r in range(world)]
            x = x_all[rank]
            # the first rank computing each slice, in slice order
            first = {}
            for r in range(world):
                first.setdefault(ctx.slice_of_rank(r, n), r)
            full_x = torch.cat([x_all[first[k]] for k in sorted(first)],
                               dim=1)
            assert torch.equal(ctx.gather_heads(x, n, 1), full_x)
            rep = ctx.replication(n)
            got = ctx.psum(x, n)
            assert torch.allclose(got, sum(x_all) / rep, atol=1e-6)
        m *= 2
    x_all = [torch.randn(3, 5, generator=torch.Generator().manual_seed(r))
             for r in range(world)]
    stacked = torch.stack(x_all)
    ctx = TPContext(tp=world, view_m=1).bind(group)
    assert torch.equal(ctx.pmax(x_all[rank]), stacked.amax(0))
    assert torch.equal(ctx.pmin(x_all[rank]), stacked.amin(0))
    assert torch.equal(x_all[rank], torch.randn(
        3, 5, generator=torch.Generator().manual_seed(rank)))  # untouched
    # lse_merge over a split key set equals attention over all keys
    q = torch.randn(2, 3, 8, generator=torch.Generator().manual_seed(50))
    k = torch.randn(world * 4, 2, 3, 8,
                    generator=torch.Generator().manual_seed(51))
    v = torch.randn(world * 4, 2, 3, 8,
                    generator=torch.Generator().manual_seed(52))
    s = torch.einsum("bhd,kbhd->bhk", q, k)
    want = torch.einsum("bhk,kbhd->bhd", s.softmax(-1), v)
    sl = s[..., rank * 4:(rank + 1) * 4]
    mx = sl.amax(-1)
    e = torch.exp(sl - mx[..., None])
    acc = torch.einsum("bhk,kbhd->bhd", e, v[rank * 4:(rank + 1) * 4])
    for wire in (None, torch.bfloat16):
        got = ctx.lse_merge(acc, e.sum(-1), mx, wire_dtype=wire)
        tol = 1e-5 if wire is None else 2e-2
        assert torch.allclose(got, want, atol=tol, rtol=tol), wire
    if rank == 0:
        _write_json(out, {"world": world,
                          "collectives": group.stats.collectives})


def zero_copy_rank(rank, world, ref_dir, out):
    """check_zero_copy.py: weights and pools stay put across merges
    1 -> 2 -> 4 -> 1 -> 2 while serving a step at each."""
    from repro_torch.core.task_pool import Request
    from repro_torch.core.weights_manager import _ptrs
    cfg, model, params, plan = _stack(ref_dir)
    geom = PoolGeometry(cfg, plan, num_blocks=16, block_base=4)
    eng = FlyingEngine(model, plan, geom, params, batch_per_engine=2,
                       device="cpu", check_zero_copy=True)
    w0, p0 = _ptrs(eng.params), _ptrs(eng._pools)
    views = []
    for i, m in enumerate((2, 4, 1, 2)):
        eng.rebind(m)
        rt = eng.islands[0]
        r = Request(req_id=f"z{i}", arrival=0.0, prompt_len=4,
                    output_len=1 << 30)
        r.engine_group = 0
        eng.adaptors[0].append_slots(r.req_id, 4)
        eng.prefill([r], rt.island, 4)
        assert _ptrs(rt.params) == w0 and _ptrs(rt.states) == p0
        views.append(eng.generated_tokens(r.req_id))
        eng.adaptors[0].release(r.req_id)
    assert _ptrs(eng.params) == w0 and _ptrs(eng._pools) == p0
    if rank == 0:
        _write_json(out, {"switches": len(eng.switch_log),
                          "tokens": views})


def steps_rank(rank, world, ref_dir, out):
    """check_serve_consistency.py at merges 1, 2 and 4: one prefill and
    one decode step, each rank on its DP group's rows; rank 0 of each
    group writes them."""
    from repro_torch.core.communicator_pool import CommunicatorPool
    from repro_torch.core.steps import build_serve_step
    from repro_torch.core.weights_manager import WeightsManager
    cfg, model, params, plan = _stack(ref_dir)
    toks = torch.from_numpy(np.load(os.path.join(ref_dir, "steps.npz"))
                            ["tokens"]).long()
    shard = WeightsManager(cfg, plan).storage_shard(params, rank % 2)
    # one row per engine: each DP group's rows are B // dp = merge
    pool = CommunicatorPool(model, plan, None, batch_per_engine=1)
    res = {}
    for merge in MERGES:
        mode = FlyingMode(plan, merge)
        bpg = B // mode.dp
        geom = _step_geom(PoolGeometry, cfg, plan, merge, bpg)
        seat = pool.seat(Island(0, 4, merge))
        adaptors = [KVCacheAdaptor(geom) for _ in range(mode.dp)]
        for a in adaptors:
            a.switch_mode(merge)
        slots, btab, max_blocks = _prefill_tables(adaptors, geom, merge,
                                                  bpg)
        dslots, btab2 = _decode_tables(adaptors, bpg, max_blocks)
        rows = slice(seat.lo, seat.hi)
        pools = [tuple({"mixer": tuple(torch.zeros(
            (n,) + geom.flat_shape()) for _ in range(2))} for _ in ks)
            for ks, n in model.plan]
        prefill, _ = build_serve_step(model, mode, geom, phase="prefill")
        decode, _ = build_serve_step(model, mode, geom, phase="decode")
        i32 = torch.int32
        lp, pools = prefill(shard, pools, {
            "tokens": toks[rows, :T].to(i32),
            "positions": torch.arange(T, dtype=i32)[None].expand(bpg, T),
            "slots": torch.from_numpy(slots[rows]).to(i32),
            "block_table": torch.from_numpy(btab[rows]).to(i32),
            "prior_len": torch.zeros((bpg,), dtype=i32)}, seat.comm)
        ld, pools = decode(shard, pools, {
            "tokens": toks[rows, T:T + 1].to(i32),
            "positions": torch.full((bpg, 1), T, dtype=i32),
            "slots": torch.from_numpy(dslots[rows]).to(i32),
            "block_table": torch.from_numpy(btab2[rows]).to(i32),
            "context_len": torch.full((bpg,), T + 1, dtype=i32)},
            seat.comm)
        res[f"prefill{merge}"] = lp.numpy()
        res[f"decode{merge}"] = ld.numpy()
        res[f"rows{merge}"] = np.arange(seat.lo, seat.hi)
    np.savez(f"{out}.{rank}.npz", **res)


def sched_rank(rank, world, ref_dir, out):
    """check_engine_e2e.py under each strategy, with the fixed clock."""
    from repro_torch.core.policy import FlyingPolicy
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    cfg, model, params, plan = _stack(ref_dir)
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    runs = {}
    for strategy in STRATEGIES:
        eng = FlyingEngine(model, plan, geom, params, batch_per_engine=2,
                           max_blocks_per_req=16, device="cpu",
                           check_zero_copy=True)
        runs[strategy] = _sched_run(
            eng, lambda e: DynamicScheduler(plan, geom, FixedClock(e),
                                            SchedulerConfig(
                strategy=strategy, max_batch_per_group=2, prefill_chunk=8),
                policy=FlyingPolicy()), Request)
        runs[strategy]["collectives"] = eng.pool.stats.collectives
        runs[strategy]["host_collectives"] = eng.pool.stats.host_collectives
    _write_json(f"{out}.{rank}.json", runs)


def _island_reqs(tag, groups, per_group):
    from repro_torch.core.task_pool import Request
    reqs = []
    for g in groups:
        for i in range(per_group):
            r = Request(req_id=f"{tag}{g}_{i}", arrival=0.0,
                        prompt_len=PROMPT, output_len=1 << 30)
            r.engine_group = g
            reqs.append(r)
    return reqs


def _start(eng, reqs, island):
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, PROMPT)
    eng.prefill(reqs, island, PROMPT)
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, 1)


def _decode(eng, reqs, island, steps=1):
    for _ in range(steps):
        eng.decode(reqs, island)
        for r in reqs:
            eng.adaptors[r.engine_group].append_slots(r.req_id, 1)


def _release(eng, reqs):
    for r in reqs:
        eng.adaptors[r.engine_group].release(r.req_id)


def _island_run(eng, L_DP, L_TP, drain_everything):
    """check_island_serving.run: DP everywhere -> a TP2 island over
    engines [0, 2) while island B (engines [2, 4)) keeps decoding -> back
    to DP. Returns (tokens, island B's counters before the readout)."""
    isl_a_dp, isl_b = L_DP.islands
    isl_a_tp = L_TP.islands[0]
    bg = _island_reqs("b", (2, 3), BPE)
    ab = _island_reqs("a", (0, 1), BPE)
    _start(eng, bg, isl_b)
    _start(eng, ab, isl_a_dp)
    _decode(eng, bg, isl_b, 2)
    _decode(eng, ab, isl_a_dp, 2)
    _release(eng, ab)
    if drain_everything:
        eng.drain()
    eng.rebind(L_TP)
    prio = _island_reqs("p", (0,), BPE * 2)
    _start(eng, prio, isl_a_tp)
    for _ in range(4):
        _decode(eng, prio, isl_a_tp)
        _decode(eng, bg, isl_b)
    _release(eng, prio)
    if drain_everything:
        eng.drain()
    eng.rebind(L_DP)
    post = _island_reqs("c", (0, 1), BPE)
    _start(eng, post, isl_a_dp)
    for _ in range(3):
        _decode(eng, post, isl_a_dp)
        _decode(eng, bg, isl_b)
    b = eng.island_sync_stats(isl_b)
    b_stats = {"drains": b.drains, "d2h_batched": b.d2h_batched}
    toks = {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
            for r in bg + ab + prio + post}
    return toks, b_stats


def island_rank(rank, world, ref_dir, out):
    """check_island_serving.py without LIVE: the partial-rebind run,
    the drain-everything run, and the rank's view of both."""
    cfg, model, params, plan = _stack(ref_dir)
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    L_DP = FleetLayout.of(plan, [(2, 1), (2, 1)])
    L_TP = L_DP.carve(0, 2, 2)
    res = {}
    for drain in (False, True):
        eng = FlyingEngine(model, plan, geom, params, batch_per_engine=BPE,
                           device="cpu", check_zero_copy=True, layout=L_DP)
        isl_b = L_DP.islands[1]
        rt_b = eng._rt_of[isl_b]
        toks, b_stats = _island_run(eng, L_DP, L_TP, drain)
        res["drain" if drain else "partial"] = {
            "toks": toks, "b": b_stats,
            "b_kept": eng._rt_of[isl_b] is rt_b,
            "b_warm": rt_b.steady is not None,
            "switches": len(eng.switch_log),
            "host_argmax": eng.sync_stats.host_argmax}
    _write_json(f"{out}.{rank}.json", res)


def uniform_rank(rank, world, ref_dir, out):
    """The equivalent uniform fleets of check_island_serving.py: two
    engines (4 ranks) at merge 2, then at merge 1."""
    cfg, model, params, plan = _stack(ref_dir, (1, 2, 2))
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    res = {}
    for merge, spec, steps in (
            (2, [(f"p0_{i}", 0) for i in range(BPE * 2)], 4),
            (1, [(f"b{g}_{i}", g - 2) for g in (2, 3)
                 for i in range(BPE)], 9)):
        from repro_torch.core.task_pool import Request
        eng = FlyingEngine(model, plan, geom, params, batch_per_engine=BPE,
                           device="cpu")
        eng.switch(1, merge)
        reqs = []
        for rid, group in spec:
            r = Request(req_id=rid, arrival=0.0, prompt_len=PROMPT,
                        output_len=1 << 30)
            r.engine_group = group
            reqs.append(r)
        _start(eng, reqs, merge)
        _decode(eng, reqs, merge, steps)
        res.update({r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
                    for r in reqs})
    if rank == 0:
        _write_json(out, res)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    """The JAX side's outputs (one subprocess for the module)."""
    out = tmp_path_factory.mktemp("jax_islands")
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(out)


def _spawn(fn, world, *args):
    spawn(fn, world, args, timeout=SPAWN_S, threads=1)


def _per_rank(out, world, ext):
    return [(_read_json if ext == "json" else np.load)(f"{out}.{r}.{ext}")
            for r in range(world)]


@pytest.fixture(scope="module")
def port_steps(ref_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("steps") / "steps")
    _spawn(steps_rank, 8, ref_dir, out)
    return _per_rank(out, 8, "npz")


@pytest.fixture(scope="module")
def port_sched(ref_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("sched") / "sched")
    _spawn(sched_rank, 8, ref_dir, out)
    return _per_rank(out, 8, "json")


@pytest.fixture(scope="module")
def port_islands(ref_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("islands")
    _spawn(island_rank, 8, ref_dir, str(d / "isl"))
    _spawn(uniform_rank, 4, ref_dir, str(d / "uniform.json"))
    return _per_rank(str(d / "isl"), 8, "json"), \
        _read_json(d / "uniform.json")


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

def test_rank_grids_match_the_jax_meshes(ref_dir):
    """Rank r is the JAX package's device r on every mode and island
    mesh."""
    grids = _read_json(os.path.join(ref_dir, "grids.json"))
    plan = ParallelPlan(*PLAN)
    for m in MERGES:
        assert mode_ranks(FlyingMode(plan, m)).ravel().tolist() == \
            grids[f"mode{m}"][0]
    L_DP = FleetLayout.of(plan, [(2, 1), (2, 1)])
    for isl in L_DP.carve(0, 2, 2).islands + L_DP.islands:
        key = repr((isl.start, isl.n_engines, isl.merge))
        assert island_ranks(plan, isl).ravel().tolist() == grids[key][0]


def test_tp_groups_cover_every_island():
    """The pool's eager groups: every TP group of every layout of the
    plan, 7 at 4 engines of 2 ranks."""
    from repro_torch.core.modes import enumerate_layouts
    plan = ParallelPlan(*PLAN)
    groups = set(tp_group_ranks(plan))
    assert len(groups) == len(tp_group_ranks(plan)) == 7
    for layout in enumerate_layouts(plan):
        for isl in layout.islands:
            grid = island_ranks(plan, isl)
            for g in range(isl.groups):
                assert tuple(grid[0, g].ravel().tolist()) in groups


@pytest.mark.parametrize("tp,view_m,n", [
    (t, m, n) for t in (2, 4, 8) for m in (1, 2, 4, 8) if m <= t
    for n in (1, 2, 3, 4, 8, 16)])
def test_slice_of_rank_matches_jax(tp, view_m, n):
    from repro.core.views import TPContext as JaxTPContext
    got = TPContext(tp=tp, view_m=view_m)
    want = JaxTPContext(tp=tp, view_m=view_m)
    assert [got.slice_of_rank(r, n) for r in range(tp)] == \
        [want.slice_of_rank(r, n) for r in range(tp)]
    assert (got.compute_shards(n), got.replication(n), got.local_units(n),
            got.stored_shards(n)) == \
        (want.compute_shards(n), want.replication(n), want.local_units(n),
         want.stored_shards(n))


@pytest.mark.parametrize("world", [2, 4])
def test_tp_context_collectives(world, tmp_path):
    """activate slices, rank arithmetic, psum with replication,
    pmax/pmin, gather_heads and lse_merge (fp32 and a bf16 wire) at
    every view factor, over gloo."""
    out = tmp_path / "ctx.json"
    _spawn(ctx_rank, world, str(out))
    assert _read_json(out)["collectives"] > 0


@pytest.mark.parametrize("arch", [ARCH, "mamba2-2.7b", "recurrentgemma-9b",
                                  "phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-236b"])
@pytest.mark.parametrize("plan", [(1, 2, 4), (2, 2, 4), (1, 4, 2)])
def test_storage_rules_match_jax_specs(arch, plan):
    """Each leaf's storage shards are the JAX package's serving
    partition specs, dim for dim."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.core.modes import ParallelPlan as JPlan
    from repro.core.weights_manager import WeightsManager as JWM
    from repro.models.model import build_model
    from repro_torch.core.weights_manager import WeightsManager
    jcfg = jget(arch).reduced()
    jm = build_model(jcfg, jnp.float32)
    specs = jax.tree.leaves(JWM(jcfg, JPlan(*plan)).partition_specs(
        jm.param_specs()), is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec))
    shapes = [tuple(s.shape) for s in jax.tree.leaves(jm.param_specs())]
    paths = [tuple(str(getattr(k, "key", "")) for k in p
                   if hasattr(k, "key"))
             for p, _ in jax.tree_util.tree_flatten_with_path(
                 jm.param_specs())[0]]
    wm = WeightsManager(get_config(arch).reduced(), ParallelPlan(*plan))
    axes = {"ed,model": ("ed", "model") if plan[0] > 1 else "model",
            "ed": "ed", "model": "model"}
    sharded = 0
    for path, shape, spec in zip(paths, shapes, specs):
        want = [e for e in tuple(spec) + (None,) * (len(shape) - len(spec))]
        got = [None] * len(shape)
        for d, k, ax in wm.shard_dims(path, shape):
            got[d] = axes[ax]
            sharded += 1
        assert got == want, (path, shape)
    assert sharded > 0


def test_storage_shard_is_the_rank_slice():
    """A rank's storage shard holds its engine-tile slice of each sharded
    leaf, copied into storage of its own; replicated leaves are the
    tensors themselves."""
    from repro_torch.core.weights_manager import WeightsManager
    cfg = get_config(ARCH).reduced()
    params = Model(cfg, torch.float32).init(torch.Generator().manual_seed(0))
    wm = WeightsManager(cfg, ParallelPlan(*PLAN))
    s0, s1 = (wm.storage_shard(params, r) for r in (0, 1))
    wq = params["groups"][0][0]["attn"]["wq"]
    assert torch.equal(torch.cat([s0["groups"][0][0]["attn"]["wq"],
                                  s1["groups"][0][0]["attn"]["wq"]], -1), wq)
    assert s0["groups"][0][0]["attn"]["wq"].data_ptr() != wq.data_ptr()
    wk = params["groups"][0][0]["attn"]["wk"]          # KV 1: replicated
    assert s1["groups"][0][0]["attn"]["wk"] is wk
    assert torch.equal(torch.cat([s0["embed"]["tok"], s1["embed"]["tok"]]),
                       params["embed"]["tok"])
    with pytest.raises(ValueError):
        wm.storage_shard(params, 2)


def test_zero_copy_across_merges(ref_dir, tmp_path):
    """Weights and pools keep every data_ptr on every rank across merges
    1 -> 2 -> 4 -> 1 -> 2, each serving a step."""
    out = tmp_path / "zc.json"
    _spawn(zero_copy_rank, 8, ref_dir, str(out))
    got = _read_json(out)
    assert got["switches"] == 4 and all(len(t) == 1 for t in got["tokens"])


@pytest.fixture(scope="module")
def port_single(ref_dir):
    """The one-rank port's train-mode logits at the step positions (the
    JAX script's single-device reference, run by the port)."""
    from repro_torch.core.views import SINGLE
    from repro_torch.models.cache import TrainBackend
    cfg, model, params, _ = _stack(ref_dir)
    toks = torch.from_numpy(np.load(os.path.join(ref_dir, "steps.npz"))
                            ["tokens"]).long()
    logits, _, _ = model.forward(params, SINGLE, mode="train", tokens=toks,
                                 backend=TrainBackend())
    logits = logits.detach().numpy()
    return {"prefill": logits[:, -2], "decode": logits[:, -1]}


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_step_logits_match_jax(ref_dir, port_steps, port_single, merge,
                               phase):
    """Every rank's rows of the distributed step are within 3e-3 of the
    JAX distributed step, of the JAX single-device forward and of the
    one-rank port's; the ranks of a TP group agree bit for bit, and
    greedy tokens are the JAX step's."""
    want = np.load(os.path.join(ref_dir, "steps.npz"))
    got = np.zeros_like(want[f"{phase}{merge}"])
    by_rows = {}
    for r, res in enumerate(port_steps):
        rows = res[f"rows{merge}"]
        lg = res[f"{phase}{merge}"]
        key = tuple(rows.tolist())
        if key in by_rows:
            assert np.array_equal(lg, by_rows[key]), (r, merge)
        by_rows[key] = lg
        got[rows] = lg
    assert len(by_rows) == 4 // merge
    np.testing.assert_allclose(got, want[f"{phase}{merge}"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, want[f"single_{phase}"], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got, port_single[phase], rtol=RTOL,
                               atol=ATOL)
    ref_tok = want[f"{phase}{merge}"].argmax(-1)
    top2 = np.sort(want[f"{phase}{merge}"], -1)[:, -2:]
    flips = [(b, float(top2[b, 1] - top2[b, 0])) for b in range(B)
             if got[b].argmax() != ref_tok[b]]
    assert flips == [], f"greedy tokens flip at (row, margin) {flips}"


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_scheduler_matches_jax(ref_dir, port_sched, strategy):
    """check_engine_e2e.py: 10 of 10 done, token streams, phase logs,
    layouts, preempt_stats and runner keys equal to the JAX package's,
    the same on every rank."""
    want = _read_json(os.path.join(ref_dir, "sched.json"))[strategy]
    runs = [p[strategy] for p in port_sched]
    got = runs[0]
    # the host program is the same on every rank; the TP collectives a
    # rank joins depend on which islands hold it
    assert all({**r, "collectives": 0} == {**got, "collectives": 0}
               for r in runs[1:])
    assert len(got["done"]) == 10
    for k in ("done", "toks", "phases", "layouts", "switches", "preempt",
              "keys"):
        assert got[k] == want[k], k
    assert got["switches"] > 0
    assert got["collectives"] > 0


def test_island_serving_matches_jax(ref_dir, port_islands):
    """check_island_serving.py without LIVE: over two partial rebinds
    the untouched island keeps its runtime, its warm decode cache and
    zero drains; its streams equal the drain-everything run's, the JAX
    package's and the equivalent uniform fleets'."""
    runs, uniform = port_islands
    assert all(r == runs[0] for r in runs[1:])
    part, full = runs[0]["partial"], runs[0]["drain"]
    assert part["b"] == {"drains": 0, "d2h_batched": 0}
    assert part["b_kept"] and part["b_warm"]
    assert full["b"]["drains"] > 0
    assert part["switches"] == 2 and part["host_argmax"] == 0
    assert part["toks"] == full["toks"]
    want = _read_json(os.path.join(ref_dir, "island.json"))
    assert want["b_drains"] == 0 and want["switches"] == 2
    assert part["toks"] == want["toks"]
    for rid, seq in uniform.items():
        assert part["toks"][rid] == seq, rid


def test_launcher_serves_on_eight_cpu_ranks():
    """``launch.serve --ranks 8 --tp-base 2`` on the CPU: the JAX
    package's ``--real`` plan, ``ParallelPlan(1, 2, 4)``, spawned by the
    launcher itself; every request done through layout switches, rank
    0 alone printing."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--dtype", "float32", "--ranks", "8",
         "--tp-base", "2", "--requests", "8", "--num-blocks", "64",
         "--block-base", "4", "--batch-per-engine", "2", "--prompt-range",
         "8", "24", "--output-range", "4", "8", "--prefill-chunk", "8",
         "--max-blocks-per-req", "16", "--priority-frac", "0.25"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert out.count("requests done : 8/8") == 1
    assert "8 ranks over gloo; 7 TP groups" in out
    switches = int(out.split("mode switches :")[1].split()[0])
    assert switches > 0
    assert "host_argmax=0" in out


@pytest.mark.parametrize("argv", [["--ranks", "3"],
                                  ["--ranks", "4", "--tp-base", "3"],
                                  ["--ranks", "2", "--serve"],
                                  ["--ranks", "2", "--sim"]])
def test_launcher_refuses_rank_counts_it_cannot_serve(argv):
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.parse_config(argv)


def fault_rank(rank, world, out):
    """Each fault kind scripted on two engines of one rank each
    (``ParallelPlan(1, 1, 2)``, a DP island per engine): an engine's
    request prefilled and decoded, the fault armed at tick 1, then a
    decode or a rebind to TP2."""
    from repro_torch.core.faults import EngineFault, TransitionFault
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model
    cfg = get_config(ARCH).reduced()
    model = build_model(cfg, torch.float32, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    plan = ParallelPlan(1, 1, 2)
    geom = PoolGeometry(cfg, plan, num_blocks=32, block_base=4)
    dp = FleetLayout.of(plan, [(1, 1), (1, 1)])
    res = {}
    for kind in (None, KILL, STALL, REBIND_FAIL, DRAIN_CORRUPT):
        spec = FaultSpec(kind=kind or STALL, tick=1 << 20) if kind is None \
            else FaultSpec(kind=kind, tick=1,
                           engines=() if kind == REBIND_FAIL else (1,))
        inj = FaultInjector([spec])
        eng = FlyingEngine(model, plan, geom, params, batch_per_engine=2,
                           device="cpu", layout=dp, injector=inj)
        reqs = []
        for g in (0, 1):
            r = Request(req_id=f"e{g}", arrival=0.0, prompt_len=PROMPT,
                        output_len=1 << 30)
            r.engine_group = g
            reqs.append(r)
            _start(eng, [r], dp.island_of(g))
            _decode(eng, [r], dp.island_of(g), 2)
        inj.advance(1)
        got = {"raised": None}
        try:
            if kind in (REBIND_FAIL, DRAIN_CORRUPT):
                eng.rebind(2)
            else:
                for r in reqs:
                    _decode(eng, [r], dp.island_of(r.engine_group))
        except (EngineFault, TransitionFault) as ex:
            got["raised"] = [type(ex).__name__, sorted(ex.engines)]
        got["layout"] = eng.layout.describe()
        inj.advance(2)
        if kind in (REBIND_FAIL, DRAIN_CORRUPT):
            eng.rebind(2)           # the window has closed
            got["after"] = eng.layout.describe()
        got["toks"] = {r.req_id: list(map(int, eng.generated_tokens(
            r.req_id))) for r in reqs}
        got["fired"] = len(inj.fired)
        res[str(kind)] = got
    _write_json(f"{out}.{rank}.json", res)


@pytest.fixture(scope="module")
def port_faults(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("faults") / "faults")
    _spawn(fault_rank, 2, out)
    runs = _per_rank(out, 2, "json")
    assert runs[0] == runs[1]
    return runs[0]


@pytest.mark.parametrize("kind", [KILL, STALL, REBIND_FAIL, DRAIN_CORRUPT])
def test_fault_kinds_accepted_and_scripted(port_faults, kind):
    """Every fault kind is taken at construction and plays its script on
    both ranks alike: KILL makes the dead engine's launch raise
    EngineFault (the other island decodes on); STALL is ignored on the
    wall clock (tokens as without faults); REBIND_FAIL and DRAIN_CORRUPT
    raise TransitionFault before the layout moves (DRAIN_CORRUPT
    discarding the named island's unharvested tokens), and the next
    rebind succeeds."""
    base = port_faults["None"]
    got = port_faults[kind]
    assert got["fired"] > 0
    if kind == KILL:
        assert got["raised"] == ["EngineFault", [1]]
        assert got["toks"]["e0"] == base["toks"]["e0"]
        assert got["toks"]["e1"] == base["toks"]["e1"][:3]
    elif kind == STALL:
        assert got["raised"] is None and got["toks"] == base["toks"]
    else:
        engines = [] if kind == REBIND_FAIL else [1]
        assert got["raised"] == ["TransitionFault", engines]
        assert got["layout"] == "[DP | DP]" and got["after"] == "[TP2]"
        assert got["toks"]["e0"] == base["toks"]["e0"][:3]
        # the corrupted island's in-flight tokens are lost; a failed
        # rebind keeps them for the next one
        kept = 0 if kind == DRAIN_CORRUPT else 3
        assert got["toks"]["e1"] == base["toks"]["e1"][:kept]


def _engine_at_one_rank(arch=ARCH):
    cfg = get_config(arch).reduced()
    model = Model(cfg, torch.float32)
    one = ParallelPlan(1, 1, 1)
    return FlyingEngine(model, one, PoolGeometry(cfg, one, num_blocks=8,
                                                 block_base=4),
                        model.init(torch.Generator().manual_seed(0)),
                        device="cpu")


def test_check_islands_takes_sequence_parallel():
    """An SP island needs live-readable tags: the reduced stablelm-1.6b
    (4 KV heads) takes ``Island(0, 2, 2, sp=2)``; the reduced llama3-8b
    (one KV head, no tag above 1 readable) is refused."""
    sp = FleetLayout(ParallelPlan(1, 1, 2), (Island(0, 2, 2, sp=2),))
    _engine_at_one_rank("stablelm-1.6b")._check_islands(sp)
    with pytest.raises(ValueError, match="sequence parallelism"):
        _engine_at_one_rank()._check_islands(sp)


def test_live_readable_follows_the_reference():
    """``live_readable()`` is True for llama3-8b (and its geometry reads
    every tag of two ranks at full width), False under a sliding window,
    as the JAX engine's."""
    eng = _engine_at_one_rank()
    assert eng.live_readable() is True
    full = get_config(ARCH)
    geom = PoolGeometry(full, ParallelPlan(1, 1, 2), num_blocks=8,
                        block_base=32)
    assert geom.live_readable(1) and geom.live_readable(2)
    eng.pool.window = 64
    assert eng.live_readable() is False


def test_live_step_refused_under_a_sliding_window():
    """A live step with a window is refused when it is built (segment-
    local sweeps have lost the absolute key positions), as the JAX
    package's ``build_serve_step`` refuses it; without one it builds."""
    from repro_torch.core.steps import build_serve_step
    cfg = get_config("stablelm-1.6b").reduced()
    model = Model(cfg, torch.float32)
    plan = ParallelPlan(1, 1, 2)
    geom = PoolGeometry(cfg, plan, num_blocks=8, block_base=4)
    mode = FlyingMode(plan, 2)
    with pytest.raises(ValueError, match="sliding windows"):
        build_serve_step(model, mode, geom, phase="decode", live=(1, 2),
                         window=64)
    build_serve_step(model, mode, geom, phase="decode", live=(1, 2))
    build_serve_step(model, mode, geom, phase="decode", window=64)


if __name__ == "__main__":
    reference_main(sys.argv[1])
