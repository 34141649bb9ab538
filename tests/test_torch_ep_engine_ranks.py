"""Serving on an engine tile of two rows: the port's engine at
``ParallelPlan(2, 1, 4)`` on 4 gloo ranks against the JAX package's and
against its own one-rank engine, on the CPU.

``ParallelPlan(2, 1, 4)`` is 2 engines of 2 'ed' rows (one 'model'
rank each). The reduced ``phi3.5-moe-42b-a6.6b`` (GQA + MoE) stores its
4 experts over 'ed' there (``ep = 2``: each rank holds 2, and the MoE
layer's two all_to_alls run over the island seat's 'ed' group); the
reduced ``llama3-8b`` is dense, so its TP group spans ('merge', 'ed',
'model') and it takes no 'ed' group. Both in fp32, on the JAX package's
``model.init(jax.random.key(0))`` weights; the LIVE and SP scenarios
and (e) give both 4 KV heads (``dataclasses.replace`` on both sides),
since at their own one KV head no tag above 1 is readable over 2 'ed'
rows (``PoolGeometry.live_readable``).

The JAX side runs in the background (this file's ``__main__``, 8 forced
host devices, the first 4 in the plan's meshes, under the
``AbstractMesh`` pair-form shim of ``tests/test_torch_engine.py``), its
runs dealt over ``JAX_PARTS`` processes that run at once; part 0 writes
the weights first, and the port's 4 ranks (one spawn for the file)
start once they are there. Held:

(a) each step's logits, ``check_serve_consistency``'s chunked prefill of
    10 tokens and one decode step for 4 requests at merges 1 and 2,
    within its rtol = atol = 3e-3 of the JAX package's distributed step
    under ``shard_map`` at ``JPlan(2, 1, 4)`` and of the JAX single-device
    forward, greedy tokens identical, the ranks of a TP group alike;
(b) a HARD scheduler trace (8 staggered requests, the merge scripted
    1 -> 2 -> 1, a fixed clock) served token for token as the port's
    one-rank engine (``ParallelPlan(1, 1, 1)``) serves the same prompts
    (the reduced capacity factor drops nothing, so the split over 'ed'
    changes no entry), zero-copy checked across both rebinds, with no
    ``dist.new_group`` call after the engine's construction, the same
    schedule and allocator state on every rank;
(c) the JAX engine on the same trace at ``JPlan(2, 1, 4)``: the same
    tokens, phases, layouts, switches, preemption counts, runner keys
    and allocator state;
(d) tokens that do not split over 'ed' (module docstring of
    ``models/moe.py``), in ``test_tokens_that_do_not_split_over_ed``;
(e) a LIVE trace with the prefix cache on, merges 1 -> 2 -> 1, whose
    requests share a prefix written at merge 1 and read again at merges
    2 and 1, on the reduced Phi-3.5-MoE with 4 KV heads: requests ride
    the merge-up in place and a prefix written under tag 1 is attached
    at merge 2 (a live lane step with the experts over 'ed'), tokens
    equal to the one-rank engine's with its own prefix cache and the
    run equal to the JAX engine's;
(f) the LIVE lanes and SP islands of ``tests/test_torch_live.py``'s
    scenarios on the 2-row tile, both models with 4 KV heads: a LIVE
    rebind ``[DP|DP] -> [TP2]`` with a decode and a chunked-prefill rider
    (``live_split``), a LIVE scheduler trace whose merge goes 1 -> 2
    with riders in flight and back to 1 once nothing holds KV
    (``sched_live``), and a context longer than one engine's pool on a
    pure-SP island ``Island(0, 2, 2, sp=2)`` (``sp_split``): tokens equal
    to the one-rank engine's and the run (tokens, schedule, lanes,
    allocator state) equal to the JAX engine's, zero-copy, no
    ``dist.new_group`` after construction, alike on every rank;
and, without the spawn, ``ed_group_ranks`` against the JAX mode meshes'
'ed' axis. The refusal at ``ep > 1`` (striped pools) and a tile of 2
'ed' x 2 'model' ranks' seats run in the same spawn.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.modes import ParallelPlan, ed_group_ranks
from repro_torch.launch.ranks import spawn
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import FixedClock, ScriptedMerge, merge_runs  # noqa: E402
from test_torch_live import live_split, sched_live, sp_split  # noqa: E402

PHI, LLAMA = "phi3.5-moe-42b-a6.6b", "llama3-8b"
ARCHS = (PHI, LLAMA)
PLAN = (2, 1, 4)            # engine_rows, tp_base, data_rows: 4 ranks
WORLD = 4
MERGES = (1, 2)
B, T = 4, 10                # check_serve_consistency's batch and prompt
RTOL = ATOL = 3e-3          # check_serve_consistency's tolerance
SPAWN_S = 240.0             # the spawn's join deadline
# the plans whose 'ed' groups are held against the JAX mode meshes
ED_PLANS = ((2, 1, 4), (2, 2, 2), (8, 1, 8))
# (d): prompts of 9 and 17 tokens end in a 1-token chunk (prefill chunk
# 8), a 1-token prompt is one: at 1 row a group, B x T = 1
ODD_PROMPTS = (9, 1, 17, 6)
# (e): arrivals of the requests sharing one prefix of PREFIX_LEN tokens:
# (b)'s 8, served at merge 1 and, from tick 4, at merge 2, then 2 once
# the merge is 1 again (from tick 24)
PREFIX_ARRIVALS = tuple(0.004 * i for i in range(8)) + (0.5, 0.504)
PREFIX_LEN = 8
KV4 = 4                     # (e) and (f): KV heads, tags 1 and 2 readable
# (f): ``sched_live``'s 8 requests, the last two after the first six are
# done, so that the merge goes back to 1 with nothing in flight
LIVE_ARRIVALS = tuple(0.004 * i for i in range(6)) + (0.5, 0.504)
LIVE_RUNS = ("live", "sched", "sp")
# the one-rank engine's runs, rank r taking the r-th, (r + 4)-th, ...:
# (arch, run)
ONE_RANK = ((PHI, "trace"), (LLAMA, "trace"), (PHI, "odd"),
            (PHI, "prefix")) + tuple((a, run) for run in LIVE_RUNS
                                     for a in ARCHS)
# the JAX side's runs, dealt over processes that run at once (part 0
# writes the weights first): (run, arch); "steps" is (a), "trace" (c);
# (e)'s "prefix" follows "sched" in its part, on the engine that served it
JAX_PARTS = ((("ed", None), ("steps", PHI), ("trace", PHI), ("sp", PHI)),
             (("sched", PHI), ("prefix", PHI)),
             (("sched", LLAMA), ("live", PHI)),
             (("steps", LLAMA), ("trace", LLAMA), ("live", LLAMA),
              ("sp", LLAMA)))


def _write_json(path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=True)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _trace(sched, Request) -> None:
    """8 staggered requests of 8-20 prompt tokens and 6 out (chip_smoke
    phase 14 (a)'s trace)."""
    for i in range(8):
        sched.submit(Request(req_id=f"r{i}", arrival=0.004 * i,
                             prompt_len=8 + 8 * (i % 2), output_len=6))


def _adaptor_state(sched) -> list:
    """Each adaptor's free list in allocation order and its live table."""
    return [[list(map(int, a.free)), sorted(a.table)]
            for a in sched.adaptors]


def _with_allocator(eng, out: dict) -> dict:
    """``out`` with the engine's allocator state (``_adaptor_state``)."""
    out["adaptors"] = _adaptor_state(eng)
    return out


def _kv4(cfg):
    """(e) and (f)'s config: ``cfg`` with KV4 KV heads."""
    return dataclasses.replace(cfg, num_kv_heads=KV4)


def _weights_name(arch: str, kv4: bool) -> str:
    return f"{arch}.kv4" if kv4 else arch


def _live_policy():
    """(f)'s LIVE trace: merge 2 from tick 4, back to 1 at the first tick
    from 5 on where no request holds KV."""
    return ScriptedMerge(4, 5, idle=True)


def _run(eng, sched, Request, submit=_trace) -> dict:
    submit(sched, Request)
    sched.run(max_steps=400)
    reqs = sorted(sched.pool.all.values(), key=lambda r: r.req_id)
    return {"toks": {r.req_id: list(map(int, eng.generated_tokens(
                r.req_id))) for r in reqs},
            "done": sum(r.state == "done" for r in reqs),
            "phases": [l.phase for l in sched.log],
            "layouts": [[l.merge, l.switched, [list(i) for i in l.islands]]
                        for l in sched.log],
            "switches": sched.switches,
            "preempt": dict(sched.preempt_stats),
            "adaptors": _adaptor_state(sched),
            "keys": sorted(repr(tuple(k)) for k in eng.pool._runners)}


# ---------------------------------------------------------------------------
# the JAX side: ``python tests/test_torch_ep_engine_ranks.py OUT_DIR PART``
# ---------------------------------------------------------------------------

def reference_main(out: str, part: int) -> None:
    """Part ``part`` of JAX_PARTS; part 0 first writes every model's
    weights and (a)'s tokens. Writes ``ref.{part}.json``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO / "tests" / "md_scripts"))
    import jax
    import jax.numpy as jnp

    class PairMesh(jax.sharding.AbstractMesh):
        def __init__(self, axis_sizes, axis_names=None, *a, **kw):
            if axis_names is None:
                axis_names = tuple(n for n, _ in axis_sizes)
                axis_sizes = tuple(s for _, s in axis_sizes)
            super().__init__(axis_sizes, axis_names, *a, **kw)
    jax.sharding.AbstractMesh = PairMesh

    from repro.configs import get_config as jget
    from repro.core.engine import FlyingEngine as JEngine
    from repro.core.kv_adaptor import KVCacheAdaptor as JAdaptor
    from repro.core.kv_adaptor import PoolGeometry as JGeometry
    from repro.core.modes import MODE_AXES
    from repro.core.modes import FleetLayout as JLayout
    from repro.core.modes import FlyingMode as JMode
    from repro.core.modes import Island as JIsland
    from repro.core.modes import ParallelPlan as JPlan
    from repro.core.modes import mode_mesh
    from repro.core.scheduler import DynamicScheduler as JScheduler
    from repro.core.scheduler import SchedulerConfig as JSConfig
    from repro.core.steps import build_serve_step
    from repro.core.task_pool import Request as JRequest
    from repro.core.views import SINGLE
    from repro.core.weights_manager import WeightsManager
    from repro.models.cache import TrainBackend
    from repro.models.model import build_model
    from check_serve_consistency import global_states
    from test_torch_islands import (_decode_tables, _prefill_tables,
                                    _step_geom)

    built = {}

    def stack(arch, kv4):
        if (arch, kv4) not in built:
            cfg = jget(arch).reduced()
            cfg = _kv4(cfg) if kv4 else cfg
            model = build_model(cfg, jnp.float32)
            built[arch, kv4] = (cfg, model, model.init(jax.random.key(0)))
        return built[arch, kv4]

    if part == 0:
        for arch in ARCHS:
            for kv4 in (False, True):
                np.savez(os.path.join(out, f"{_weights_name(arch, kv4)}"
                                      f".params.npz"),
                         *[np.asarray(a) for a in jax.tree.leaves(
                             stack(arch, kv4)[2])])
            # (a)'s tokens (check_serve_consistency.run_arch's draw)
            toks = jax.random.randint(jax.random.key(1), (B, T + 1), 0,
                                      stack(arch, False)[0].vocab_size)
            np.save(os.path.join(out, f"{arch}.tokens.npy"),
                    np.asarray(toks))
        (Path(out) / "params.ready").touch()

    plan = JPlan(*PLAN)

    def axis_groups(p, m, name):
        """The device groups along axis ``name`` of the mode mesh of plan
        ``p`` at merge ``m``."""
        ids = np.vectorize(lambda d: d.id)(
            mode_mesh(JMode(JPlan(*p), m)).devices)
        rows = np.moveaxis(ids, MODE_AXES.index(name), -1)
        return {tuple(map(int, r))
                for r in rows.reshape(-1, rows.shape[-1])}

    def ed_axis():
        """The 'ed' axis of every mode mesh of each plan, and the merge
        axis (the live reads' view axis) of PLAN's at merge 2."""
        ed = {repr(p): sorted(set().union(*(
            axis_groups(p, m, "ed") for m in JPlan(*p).valid_merges())))
              for p in ED_PLANS}
        ed["view"] = sorted(axis_groups(PLAN, 2, "merge"))
        return ed

    def steps(arch):
        """(a): the distributed step (check_serve_consistency.run_arch)."""
        cfg, model, params = stack(arch, False)
        toks = jax.random.randint(jax.random.key(1), (B, T + 1), 0,
                                  cfg.vocab_size)
        ref, _, _ = model.forward(params, SINGLE, mode="train", tokens=toks,
                                  backend=TrainBackend())
        got = {"single_prefill": np.asarray(ref[:, -2]),
               "single_decode": np.asarray(ref[:, -1])}
        wm = WeightsManager(cfg, plan)
        for merge in MERGES:
            mode = JMode(plan, merge)
            mesh = mode_mesh(mode)
            p_sh = jax.device_put(params, wm.shardings(params, mesh))
            bpg = B // (plan.pods * mode.dp)
            geom = _step_geom(JGeometry, cfg, plan, merge, bpg)
            adaptors = [JAdaptor(geom) for _ in range(plan.pods * mode.dp)]
            for a in adaptors:
                a.switch_mode(merge)
            slots, btab, max_blocks = _prefill_tables(adaptors, geom, merge,
                                                      bpg)
            st = global_states(model, geom, mode, bpg, mesh, "prefill")
            prefill, _, _ = build_serve_step(model, mode, geom,
                                             phase="prefill")
            lp, st = jax.jit(prefill)(p_sh, st, {
                "tokens": toks[:, :T],
                "positions": jnp.broadcast_to(jnp.arange(T)[None], (B, T)),
                "slots": jnp.asarray(slots),
                "block_table": jnp.asarray(btab),
                "prior_len": jnp.zeros((B,), jnp.int32)})
            dslots, btab2 = _decode_tables(adaptors, bpg, max_blocks)
            decode, _, _ = build_serve_step(model, mode, geom,
                                            phase="decode")
            ld, st = jax.jit(decode)(p_sh, st, {
                "tokens": toks[:, T:T + 1],
                "positions": jnp.full((B, 1), T, jnp.int32),
                "slots": jnp.asarray(dslots),
                "block_table": jnp.asarray(btab2),
                "context_len": jnp.full((B,), T + 1, jnp.int32)})
            got[f"prefill{merge}"] = np.asarray(lp)
            got[f"decode{merge}"] = np.asarray(ld)
        np.savez(os.path.join(out, f"{arch}.steps.npz"), **got)
        return True

    def engine(cfg, model, params, nb=64, **kw):
        return JEngine(model, plan, JGeometry(cfg, plan, num_blocks=nb,
                                              block_base=4), params,
                       batch_per_engine=2, max_blocks_per_req=16,
                       prefill_len=8, check_zero_copy=True, **kw)

    def sched(eng, policy, **kw):
        return JScheduler(plan, eng.geom, FixedClock(eng), JSConfig(
            max_batch_per_group=2, prefill_chunk=8, **kw), policy=policy)

    def trace(arch):
        """(c): the JAX engine on (b)'s trace."""
        eng = engine(*stack(arch, False))
        return _run(eng, sched(eng, ScriptedMerge(4, 24), strategy="hard"),
                    JRequest)

    def live(arch):
        eng = engine(*stack(arch, True))
        return _with_allocator(eng, live_split(eng, JRequest, True))

    served = {}

    def sched_run(arch):
        eng = served[arch] = engine(*stack(arch, True))
        return sched_live(eng, lambda e: sched(e, _live_policy(),
                                               strategy="live"),
                          JRequest, LIVE_ARRIVALS)

    def sp(arch):
        eng = engine(*stack(arch, True), nb=8, layout=JLayout(
            plan, (JIsland(0, 2, 2, sp=2),)))
        return _with_allocator(eng, sp_split(eng, JRequest, True))

    def prefix(arch):
        """(e) on the JAX engine that served (f)'s LIVE trace."""
        eng = served[arch]
        s = sched(eng, _live_policy(), strategy="live", prefix_cache=True)
        got = _run(eng, s, JRequest, _prefix_trace)
        got["hits"] = s.prefix_cache.stats["hit_requests"]
        return got

    runs = {"ed": ed_axis, "steps": steps, "trace": trace, "live": live,
            "sched": sched_run, "sp": sp, "prefix": prefix}
    res = {}
    for run, arch in JAX_PARTS[part]:
        res[run if arch is None else f"{arch}.{run}"] = \
            runs[run]() if arch is None else runs[run](arch)
    _write_json(os.path.join(out, f"ref.{part}.json"), res)


# ---------------------------------------------------------------------------
# the port's ranks (module-level: the spawned children import them)
# ---------------------------------------------------------------------------

def _port_params(ref_dir: str, cfg, name: str):
    like = Model(cfg, torch.float32, torch.device("meta")).init(
        torch.Generator(device="cpu"))
    with np.load(os.path.join(ref_dir, f"{name}.params.npz")) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return params_from_numpy(cfg, ckpt.tree_unflatten(like, leaves),
                             device="cpu")


def _stack(ref_dir: str, arch: str, kv4: bool = False):
    """(config, model, the JAX package's weights) of the reduced
    ``arch``, with KV4 KV heads when ``kv4``."""
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced()
    cfg = _kv4(cfg) if kv4 else cfg
    return (cfg, build_model(cfg, torch.float32, "cpu"),
            _port_params(ref_dir, cfg, _weights_name(arch, kv4)))


def _steps(rank, cfg, model, params, ref_dir, arch, pool) -> dict:
    """(a): one prefill and one decode step at merges 1 and 2 on this
    rank's DP group's rows."""
    from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
    from repro_torch.core.modes import FlyingMode, Island
    from repro_torch.core.steps import build_serve_step
    from repro_torch.core.weights_manager import WeightsManager
    from test_torch_islands import (_decode_tables, _prefill_tables,
                                    _step_geom)
    plan = ParallelPlan(*PLAN)
    shard = WeightsManager(cfg, plan).storage_shard(params, rank % 2)
    toks = torch.from_numpy(np.load(os.path.join(
        ref_dir, f"{arch}.tokens.npy"))).long()
    res = {}
    for merge in MERGES:
        mode = FlyingMode(plan, merge)
        bpg = B // mode.dp
        geom = _step_geom(PoolGeometry, cfg, plan, merge, bpg)
        seat = pool.seat(Island(0, 2, merge))
        adaptors = [KVCacheAdaptor(geom) for _ in range(mode.dp)]
        for a in adaptors:
            a.switch_mode(merge)
        slots, btab, max_blocks = _prefill_tables(adaptors, geom, merge, bpg)
        dslots, btab2 = _decode_tables(adaptors, bpg, max_blocks)
        rows = slice(seat.lo, seat.hi)
        states = [tuple({"mixer": tuple(
            torch.zeros((n,) + geom.flat_shape())
            for _ in range(model.pools_of(kind)))} for kind in ks)
            for ks, n in model.plan]
        prefill, _ = build_serve_step(model, mode, geom, phase="prefill")
        decode, _ = build_serve_step(model, mode, geom, phase="decode")
        groups = (seat.comm, seat.view, seat.ed)
        i32 = torch.int32
        lp, states = prefill(shard, states, {
            "tokens": toks[rows, :T].to(i32),
            "positions": torch.arange(T, dtype=i32)[None].expand(bpg, T),
            "slots": torch.from_numpy(slots[rows]).to(i32),
            "block_table": torch.from_numpy(btab[rows]).to(i32),
            "prior_len": torch.zeros((bpg,), dtype=i32)}, *groups)
        ld, states = decode(shard, states, {
            "tokens": toks[rows, T:T + 1].to(i32),
            "positions": torch.full((bpg, 1), T, dtype=i32),
            "slots": torch.from_numpy(dslots[rows]).to(i32),
            "block_table": torch.from_numpy(btab2[rows]).to(i32),
            "context_len": torch.full((bpg,), T + 1, dtype=i32)}, *groups)
        res[f"prefill{merge}"] = lp.numpy().tolist()
        res[f"decode{merge}"] = ld.numpy().tolist()
        res[f"rows{merge}"] = [seat.lo, seat.hi]
    return res


def _engine(cfg, model, params, plan, bpe=2, nb=64, pool="head", **kw):
    """The engine (``kw`` its keywords) over a pool of ``nb`` blocks in
    ``pool`` layout, and its geometry."""
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    geom = PoolGeometry(cfg, plan, num_blocks=nb, block_base=4,
                        layout=pool)
    return FlyingEngine(model, plan, geom, params, batch_per_engine=bpe,
                        max_blocks_per_req=16, device="cpu",
                        check_zero_copy=True, **kw), geom


def _sched(eng, geom, plan, policy, strategy: str = "hard",
           prefix_cache: bool = False):
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    return DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
        strategy=strategy, max_batch_per_group=eng.bpe, prefill_chunk=8,
        prefix_cache=prefix_cache), policy=policy)


def _odd_trace(sched, Request) -> None:
    for i, n in enumerate(ODD_PROMPTS):
        sched.submit(Request(req_id=f"o{i}", arrival=0.004 * i,
                             prompt_len=n, output_len=4))


def _prefix_trace(sched, Request) -> None:
    """(e): requests of 12-16 prompt tokens whose first PREFIX_LEN are
    one shared prefix, 6 out."""
    for i, t in enumerate(PREFIX_ARRIVALS):
        sched.submit(Request(req_id=f"p{i}", arrival=t,
                             prompt_len=12 + 4 * (i % 2), output_len=6,
                             prefix_seed=5, prefix_len=PREFIX_LEN))


def _attaches(eng) -> list:
    """Wraps every adaptor's ``attach_prefix``: a list it fills with
    (merge, tag of the request's first segment, tokens attached) a hit."""
    seen = []
    for ad in eng.adaptors:
        def attach(req_id, *a, _inner=ad.attach_prefix, _ad=ad, **kw):
            n = _inner(req_id, *a, **kw)
            if n:
                seen.append([_ad.merge, _ad.table[req_id].segments[0].tag,
                             n])
            return n
        ad.attach_prefix = attach
    return seen


def _prefix_run(eng, geom, plan, policy, Request) -> dict:
    """(e): LIVE with the prefix cache on."""
    attached = _attaches(eng)
    sched = _sched(eng, geom, plan, policy, "live", prefix_cache=True)
    got = _run(eng, sched, Request, _prefix_trace)
    got["hits"] = sched.prefix_cache.stats["hit_requests"]
    return got, attached


def _scenario(run: str, stack, plan, Request, eng=None):
    """(engine, fn): the engine of (e)'s or (f)'s ``run`` built over
    ``plan`` with ``stack``'s model and weights (or ``eng``, an engine
    that served another run), and ``fn()`` serving the run on it. On the
    tile the runs switch (merge 1 -> 2, an SP island); the one-rank
    engine serves the same requests at merge 1 (``sp``: from a pool that
    holds the context)."""
    from repro_torch.core.modes import FleetLayout, Island
    tile = plan.dp_engines > 1
    if eng is not None:
        geom = eng.geom
    elif run == "sp" and tile:
        eng, geom = _engine(*stack, plan, nb=8, layout=FleetLayout(
            plan, (Island(0, 2, 2, sp=2),)))
    else:
        eng, geom = _engine(*stack, plan)
    if run == "live":
        return eng, lambda: _with_allocator(eng, live_split(
            eng, Request, tile))
    if run == "sp":
        return eng, lambda: _with_allocator(eng, sp_split(
            eng, Request, tile))
    if run == "sched":
        return eng, lambda: sched_live(eng, lambda e: _sched(
            e, geom, plan, _live_policy() if tile else None, "live"),
            Request, LIVE_ARRIVALS)
    return eng, lambda: _prefix_run(eng, geom, plan, _live_policy()
                                    if tile else None, Request)


@contextlib.contextmanager
def _new_groups():
    """The ``dist.new_group`` calls made inside the block."""
    import torch.distributed as dist
    calls = []
    new_group = dist.new_group
    dist.new_group = lambda *a, **k: calls.append(a) or new_group(*a, **k)
    try:
        yield calls
    finally:
        dist.new_group = new_group


def _refusals(stack, plan) -> dict:
    """What the engine refuses with the experts over 'ed' (the message,
    None where it serves): an SP island (at rebind), a live lane step,
    a striped pool (at construction)."""
    from repro_torch.core.modes import FleetLayout, Island
    got = {}
    eng, _ = _engine(*stack, plan)
    for what, fn in (
            ("sp", lambda: eng.rebind(FleetLayout(plan, (Island(
                0, 2, 2, sp=2),)))),
            ("live", lambda: eng.pool.runner(Island(0, 2, 2), "decode",
                                             live=(1, 2))),
            ("striped", lambda: _engine(*stack, plan, pool="striped"))):
        try:
            fn()
            got[what] = None
        except NotImplementedError as e:
            got[what] = str(e)
    return got


def _held(eng, fn) -> dict:
    """``fn()``'s run on ``eng``, with the ``dist.new_group`` calls it
    made (none may be: every group is built with the engine) and its
    rebinds."""
    rebinds = len(eng.switch_log)
    with _new_groups() as calls:
        got = fn()
    if isinstance(got, tuple):          # (e): the run and its attaches
        got, attached = got
        got["attached"] = attached
    got["new_groups"] = len(calls)
    got["rebinds"] = len(eng.switch_log) - rebinds
    return got


def ep_rank(rank, world, ref_dir, out):
    from repro_torch.core.communicator_pool import CommunicatorPool
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import Island
    from repro_torch.core.task_pool import Request
    plan = ParallelPlan(*PLAN)
    res = {}
    for arch in ARCHS:
        cfg, model, params = _stack(ref_dir, arch)
        # (a)'s B rows over the plan's engines
        pool = CommunicatorPool(model, plan, None,
                                batch_per_engine=B // plan.dp_engines)
        got = {"steps": _steps(rank, cfg, model, params, ref_dir, arch,
                               pool)}
        eng, geom = _engine(cfg, model, params, plan)
        got["describe"] = eng.pool.describe()
        got["live_readable"] = eng.live_readable()
        got["ed_groups"] = eng.pool.stats.ed_groups
        got["seat_ed"] = {m: None if s.ed is None else list(s.ed.ranks)
                          for m in MERGES
                          for s in [eng.pool.seat(Island(0, 2, m))]}
        got["seat_view"] = list(eng.pool.seat(Island(0, 2, 2)).view.ranks)
        # (b): nothing builds a process group past construction
        trace = _held(eng, lambda: _run(eng, _sched(
            eng, geom, plan, ScriptedMerge(4, 24)), Request))
        got["new_groups"] = trace.pop("new_groups")
        got["rebinds"] = trace.pop("rebinds")
        got["trace"] = trace
        st = eng.pool.stats
        got["a2a"] = [st.nbytes.get("all-to-all", 0), st.collectives]
        # (e) and (f): the model with KV4 KV heads; (e) on the engine
        # that served (f)'s LIVE trace, as on the JAX side
        kv4 = _stack(ref_dir, arch, kv4=True)
        for run in LIVE_RUNS + (("prefix",) if arch == PHI else ()):
            eng, fn = _scenario(run, kv4, plan, Request,
                                sched_eng if run == "prefix" else None)
            got[run] = _held(eng, fn)
            if run == "sched":
                sched_eng = eng
        if arch == PHI:
            # (d): one row a group at merge 1
            eng, geom = _engine(cfg, model, params, plan, bpe=1)
            got["odd"] = _run(eng, _sched(eng, geom, plan, None), Request,
                              _odd_trace)
            got["prefix_live_readable"] = [PoolGeometry(
                kv4[0], plan, num_blocks=64, block_base=4).live_readable(m)
                for m in MERGES]
            got["refused"] = _refusals(kv4, plan)
            # a tile of 2 'ed' x 2 'model' ranks: its 'ed' groups are
            # built, not the TP groups'
            p2 = ParallelPlan(2, 2, 2)
            pool2 = CommunicatorPool(model, p2, None)
            seat = pool2.seat(Island(0, 1, 1))
            x = torch.arange(4.0) + 10 * rank
            got["tile"] = {"ed": list(seat.ed.ranks),
                           "comm": list(seat.comm.ranks),
                           "ed_groups": pool2.stats.ed_groups,
                           "groups": pool2.stats.groups,
                           "a2a": seat.ed.all_to_all(x).tolist()}
        res[arch] = got
    # past the world's last collective: this rank's share of the one-rank
    # runs, each engine in a world of one (the prompts come from Python's
    # salted hash, which the ranks seed alike)
    res["one_rank"] = []
    one = ParallelPlan(1, 1, 1)
    for arch, run in ONE_RANK[rank::world]:
        with mock.patch("repro_torch.core.communicator_pool.world",
                        lambda: (0, 1)):
            if run in ("trace", "odd"):
                cfg, model, params = _stack(ref_dir, arch)
                eng, geom = _engine(cfg, model, params, one,
                                    bpe=1 if run == "odd" else 2)
                got = _run(eng, _sched(eng, geom, one, None), Request,
                           _odd_trace if run == "odd" else _trace)
            else:
                got = _held(*_scenario(run, _stack(ref_dir, arch, True),
                                       one, Request))
        res["one_rank"].append([arch, run, got])
    _write_json(f"{out}.{rank}.json", res)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX side, started in the background, its parts at once: the
    port's ranks need only the weights, which part 0 writes first."""
    out = tmp_path_factory.mktemp("jax_ep_engine")
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    procs = []
    for part in range(len(JAX_PARTS)):
        with open(out / f"stderr.{part}.txt", "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(out), str(part)], env=env,
                stdout=subprocess.DEVNULL, stderr=err))
    try:
        yield procs, out
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _jax_failed(procs, out) -> str:
    return "; ".join(
        f"JAX part {i} exited {p.returncode}: "
        f"{(out / f'stderr.{i}.txt').read_text()[-4000:]}"
        for i, p in enumerate(procs) if p.returncode)


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every rank's results, once the JAX side has written the
    weights."""
    procs, ref_dir = jax_side
    deadline = time.monotonic() + 300
    while not (ref_dir / "params.ready").exists():
        assert procs[0].poll() is None, _jax_failed(procs, ref_dir)
        assert time.monotonic() < deadline, "no weights from the JAX side"
        time.sleep(0.2)
    out = str(tmp_path_factory.mktemp("ep_ranks") / "ep")
    spawn(ep_rank, WORLD, (str(ref_dir), out), device_type="cpu",
          timeout=SPAWN_S, threads=1)
    return [_read_json(f"{out}.{r}.json") for r in range(WORLD)]


@pytest.fixture(scope="module")
def ref(jax_side, ranks):
    """The JAX side's results, once every part has finished (the ranks
    run while they do)."""
    procs, out = jax_side
    res = {"dir": str(out)}
    for part, proc in enumerate(procs):
        proc.wait(timeout=900)
        assert proc.returncode == 0, _jax_failed(procs, out)
        res.update(_read_json(out / f"ref.{part}.json"))
    return res


@pytest.fixture(scope="module")
def one_rank(ranks):
    """The port's one-rank engine (``ParallelPlan(1, 1, 1)``) on the same
    weights and requests as the tile, by (arch, run)."""
    return {(arch, run): got for res in ranks
            for arch, run, got in res["one_rank"]}


def _same_on_every_rank(ranks, arch, key):
    got = ranks[0][arch][key]
    for r in ranks[1:]:
        assert r[arch][key] == got
    return got


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plan", ED_PLANS)
def test_ed_groups_match_the_jax_mode_meshes(ref, plan):
    """``ed_group_ranks`` lists exactly the groups along the 'ed' axis of
    the JAX package's mode mesh at every merge of the plan, and each is
    ``TPContext.ed_members`` of its TP group."""
    from repro_torch.core.modes import tp_group_ranks
    from repro_torch.core.views import TPContext
    p = ParallelPlan(*plan)
    got = ed_group_ranks(p)
    assert len(set(got)) == len(got) \
        == p.dp_engines * p.tp_base
    assert sorted(map(list, got)) == ref["ed"][repr(plan)]
    tile = p.engine_rows * p.tp_base
    for ranks in tp_group_ranks(p):
        ctx = TPContext(tp=len(ranks), view_m=len(ranks) // tile,
                        ep=p.engine_rows)
        for i in range(len(ranks)):
            assert tuple(ranks[j] for j in ctx.ed_members(i)) in got


@pytest.mark.parametrize("arch", ARCHS)
def test_view_groups_match_the_jax_mode_mesh(ref, ranks, arch):
    """At merge 2 each rank's view group (the live reads' LSE merge) is
    the JAX mode mesh's merge axis through it: the TP group's ranks at
    its storage rank ('ed' index), ``ranks[s::tile]``."""
    want = [list(g) for g in ref["ed"]["view"]]
    assert len(want) == 2
    for r, res in enumerate(ranks):
        got = res[arch]["seat_view"]
        assert got in want and r in got


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_logits_match_jax(ref, ranks, arch, phase, merge):
    """(a): every row within 3e-3 of the JAX package's distributed step
    and single-device forward; greedy tokens identical; the ranks of a
    TP group bit for bit alike."""
    want = np.load(os.path.join(ref["dir"], f"{arch}.steps.npz"))
    jref = want[f"{phase}{merge}"]
    got = np.zeros_like(jref)
    by_rows = {}
    for r, res in enumerate(ranks):
        st = res[arch]["steps"]
        lo, hi = st[f"rows{merge}"]
        lg = np.asarray(st[f"{phase}{merge}"], dtype=np.float32)
        if (lo, hi) in by_rows:
            assert np.array_equal(lg, by_rows[(lo, hi)]), (r, merge)
        by_rows[(lo, hi)] = lg
        got[lo:hi] = lg
    assert len(by_rows) == 2 // merge
    np.testing.assert_allclose(got, jref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want[f"single_{phase}"], rtol=RTOL,
                               atol=ATOL)
    top2 = np.sort(jref, -1)[:, -2:]
    flips = [(b, float(top2[b, 1] - top2[b, 0])) for b in range(B)
             if got[b].argmax() != jref[b].argmax()]
    assert flips == [], f"greedy tokens flip at (row, margin) {flips}"


def test_pool_builds_ed_groups_for_moe_only(ranks):
    """At ``(2, 1, 4)`` every 'ed' group is a merge-1 TP group (one
    'model' rank a row), so the pool builds none and hands out those;
    the dense model takes none. On a tile of 2 'ed' x 2 'model' ranks
    the pool builds the two 'ed' groups, which carry an all_to_all."""
    for r, res in enumerate(ranks):
        eng_tile = [2 * (r // 2), 2 * (r // 2) + 1]
        phi, llama = res[PHI], res[LLAMA]
        assert phi["seat_ed"] == {"1": eng_tile, "2": eng_tile}
        assert llama["seat_ed"] == {"1": None, "2": None}
        assert phi["ed_groups"] == llama["ed_groups"] == 0
        assert "0 'ed' groups" in phi["describe"] \
            and "(2 'ed' groups are TP groups)" in phi["describe"]
        assert "'ed' groups are TP groups" not in llama["describe"]
        tile = phi["tile"]
        ed = [r % 2, r % 2 + 2]
        assert tile["ed"] == ed and tile["comm"] == [0, 1, 2, 3]
        assert (tile["ed_groups"], tile["groups"]) == (2, 3)
        # chunk j of every 'ed' rank's [0..3] + 10 * rank to 'ed' rank j
        i = ed.index(r)
        assert tile["a2a"] == [10 * s + 2 * i + k for s in ed
                               for k in range(2)]


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_one_rank_tokens(ranks, one_rank, arch):
    """(b): the HARD trace on the 2-row tile, merges 1 -> 2 -> 1: every
    request done with the one-rank engine's tokens, two zero-copy
    rebinds, no process group built on the serving path, the same
    schedule and allocator on every rank; only the MoE model's steps
    run all_to_alls."""
    run = _same_on_every_rank(ranks, arch, "trace")
    want = one_rank[(arch, "trace")]
    assert run["done"] == 8 and want["done"] == 8
    assert run["toks"] == want["toks"]
    merges = [lay[0] for lay in run["layouts"]]
    assert 2 in merges and merges[-1] == 1 and run["switches"] == 2
    for res in ranks:
        assert res[arch]["rebinds"] == 2
        assert res[arch]["new_groups"] == 0
        a2a_bytes, collectives = res[arch]["a2a"]
        assert collectives > 0
        assert (a2a_bytes > 0) == (arch == PHI)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_engine_serves_the_same_trace(ref, ranks, arch):
    """(c): the JAX engine at ``JPlan(2, 1, 4)`` on the same trace: the
    same tokens, schedule, preemption counts, runner keys and
    allocator state."""
    run = _same_on_every_rank(ranks, arch, "trace")
    assert run == ref[f"{arch}.trace"]


def test_tokens_that_do_not_split_over_ed(ranks, one_rank):
    """(d): one row a group at merge 1, so a decode step's tokens and a
    1-token prefill chunk's are one a group, which does not split over
    2 'ed' ranks. The port pads it to two, each 'ed' rank routes one
    (the second a zero row whose output it drops), and the request gets
    its experts: tokens equal the one-rank engine's. The JAX package's
    MoE layer gives each 'ed' rank ``N // ep`` = 0 tokens there, so the
    token gets no routed expert (``src/repro/models/moe.py:136-143``;
    ``tests/test_torch_dryrun.py::test_expert_parallel_moe_on_ranks``
    holds that departure at the layer); its engine is not run here."""
    run = _same_on_every_rank(ranks, PHI, "odd")
    assert run["done"] == len(ODD_PROMPTS)
    assert run["toks"] == one_rank[(PHI, "odd")]["toks"]
    # the runner keys (merge, phase, .., batch, seq, ..): a 1-token
    # prefill chunk (a mixed step's prefill half) and decode steps, at
    # one row a group (the island's batch of 2 over its 2 groups)
    keys = [eval(k) for k in run["keys"]]
    assert any(k[:2] == (1, "mixed") and k[4:6] == (2, 1) for k in keys)
    assert any(k[:2] == (1, "decode") and k[4] == 2 for k in keys)


# what only the port's tile run records, beside what the JAX run holds
PORT_ONLY = ("new_groups", "rebinds", "collectives", "attached")


def _held_run(ranks, ref, arch, run) -> dict:
    """The tile's ``run`` of ``arch``: the same on every rank, no
    process group built past the engine's construction, and equal to
    the JAX engine's run in all it records."""
    got = _same_on_every_rank(ranks, arch, run)
    assert got["new_groups"] == 0
    want = ref[f"{arch}.{run}"]
    for k in set(got) | set(want):
        if k not in PORT_ONLY:
            assert got.get(k) == want.get(k), (arch, run, k)
    return got


def test_prefix_cache_across_merges(ref, ranks, one_rank):
    """(e): LIVE with the prefix cache on, merges 1 -> 2 -> 1, on tags
    the geometry can read across. The engine is ``live_readable`` with
    the experts over 'ed' as without (the dense one on the same tile),
    so requests ride the merge-up in place and a prefix written under
    tag 1 is attached at merge 2 (a live lane step); the requests are
    served with the one-rank engine's tokens, with hits on both sides,
    and the run equals the JAX engine's."""
    for res in ranks:
        assert res[PHI]["live_readable"] is True
        assert res[LLAMA]["live_readable"] is True
        assert res[PHI]["prefix_live_readable"] == [True, True]
    run = _held_run(ranks, ref, PHI, "prefix")
    want = one_rank[(PHI, "prefix")]
    n = len(PREFIX_ARRIVALS)
    assert run["done"] == want["done"] == n
    assert run["toks"] == want["toks"]
    assert merge_runs([lay[0] for lay in run["layouts"]]) == [1, 2, 1]
    assert run["hits"] > 0 and want["hits"] > 0
    # a tag-1 chain attached at merge 2
    assert any(m == 2 and tag == 1 and n > 0
               for m, tag, n in run["attached"]), run["attached"]
    p = run["preempt"]
    assert p["live_riders"] > 0 and p["paused"] == 0 \
        and p["recomputed_tokens"] == 0, p
    assert run["rebinds"] == 2


@pytest.mark.parametrize("arch", ARCHS)
def test_live_rebind_rides_the_tile(ref, ranks, one_rank, arch):
    """(f) ``live_split``: a LIVE rebind ``[DP|DP] -> [TP2]`` of the 2-row
    tile with a decode rider (tags 1, 2) and a chunked prefill streaming
    across it (tags 1, 2), the MoE model's experts over 'ed': tokens
    equal to the one-rank engine's, the run (tokens, tags, runner keys
    with the lane tuple, allocator state) equal to the JAX engine's, one
    zero-copy rebind, no host argmax."""
    run = _held_run(ranks, ref, arch, "live")
    assert run["toks"] == one_rank[(arch, "live")]["toks"]
    assert run["tags"] == {"r0": [1, 2], "lp": [1, 2]}
    assert any("(1, 2)" in k for k in run["keys"])
    assert run["rebinds"] == 1 and run["host_argmax"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_live_scheduler_trace_on_the_tile(ref, ranks, one_rank, arch):
    """(f) ``sched_live``: 8 staggered requests under LIVE, the merge
    scripted 1 -> 2 at tick 4 with decodes and a chunked prefill in
    flight, and back to 1 once nothing holds KV for the last two:
    every request done with the one-rank engine's tokens, riders
    carried with nothing paused or recomputed, two zero-copy rebinds,
    and tokens, phases, layouts, switches, preempt_stats, runner keys
    and allocator state equal to the JAX engine's."""
    run = _held_run(ranks, ref, arch, "sched")
    want = one_rank[(arch, "sched")]
    assert len(run["done"]) == len(want["done"]) == 8
    assert run["toks"] == want["toks"]
    assert merge_runs([lay[0] for lay in run["layouts"]]) == [1, 2, 1]
    p = run["preempt"]
    assert p["live_riders"] > 0 and p["paused"] == 0 \
        and p["recomputed_tokens"] == 0, p
    assert run["switches"] == run["rebinds"] == 2
    assert any("(1, 2)" in k for k in run["keys"])


@pytest.mark.parametrize("arch", ARCHS)
def test_sp_island_on_the_tile(ref, ranks, one_rank, arch):
    """(f) ``sp_split``: a 45-token context over pools of 28 tokens on a
    pure-SP island ``Island(0, 2, 2, sp=2)`` of the 2-row tile, each SP
    lane a whole tile: blocks placed on both shards as the JAX adaptor
    places them, tokens equal to the one-rank engine's from a pool that
    holds the context and to the JAX engine's, allocator state the JAX
    engine's."""
    run = _held_run(ranks, ref, arch, "sp")
    assert run["context"] > run["one_pool"]
    assert {s for s, _ in run["shards"]} == {0, 1}
    assert run["toks"] == one_rank[(arch, "sp")]["toks"]
    assert run["host_argmax"] == 0


def test_refusals_name_their_roadmap_item(ranks):
    """With the experts over 'ed' (the reduced Phi-3.5-MoE with 4 KV
    heads) the engine takes an SP island and builds a live lane step;
    only a striped pool (at construction) raises
    ``NotImplementedError`` naming ROADMAP.md Queue 1 item 5."""
    for res in ranks:
        got = res[PHI]["refused"]
        assert {k for k, v in got.items() if v is not None} == {"striped"}
        assert "ROADMAP.md Queue 1 item 5" in got["striped"], got


def test_ep_without_its_ed_group_raises():
    """A step at ``ep > 1`` given no 'ed' group raises; it never runs
    at ep = 1."""
    from repro_torch.core.views import RankGroup, make_serving_ctx
    from repro_torch.models import moe
    cfg = get_config(PHI).reduced()
    params = Model(cfg, torch.float32, torch.device("cpu")).init(
        torch.Generator().manual_seed(0))
    layer = {k: v[0] for k, v in params["groups"][0][0]["ffn"].items()}
    ctx = make_serving_ctx(1, 2, 1, cfg.moe.num_experts,
                           group=RankGroup(None, range(2), 0))
    assert ctx.ep == 2 and ctx.ed_group is None
    with pytest.raises(NotImplementedError, match="does not fall back"):
        moe.moe_ffn(cfg, layer, torch.zeros(1, 2, cfg.d_model), ctx)


if __name__ == "__main__":
    reference_main(sys.argv[1], int(sys.argv[2]))
