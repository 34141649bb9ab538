"""Serving on an engine tile of two rows: the port's engine at
``ParallelPlan(2, 1, 4)`` on 4 gloo ranks against the JAX package's and
against its own one-rank engine, on the CPU.

``ParallelPlan(2, 1, 4)`` is 2 engines of 2 'ed' rows (one 'model'
rank each). The reduced ``phi3.5-moe-42b-a6.6b`` (GQA + MoE) stores its
4 experts over 'ed' there (``ep = 2``: each rank holds 2, and the MoE
layer's two all_to_alls run over the island seat's 'ed' group); the
reduced ``llama3-8b`` is dense, so its TP group spans ('merge', 'ed',
'model') and it takes no 'ed' group. Both in fp32, on the JAX package's
``model.init(jax.random.key(0))`` weights.

The JAX side runs in the background (this file's ``__main__``, 8 forced
host devices, the first 4 in the plan's meshes, under the
``AbstractMesh`` pair-form shim of ``tests/test_torch_engine.py``); it
writes the weights first, and the port's 4 ranks (one spawn for the
file) start once they are there. Held:

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
    2 and 1, on the reduced Phi-3.5-MoE with 4 KV heads (its 1 KV head
    leaves no tag live-readable; the full-width model's 8 do over 2
    'ed' rows), weights seeded in the port: the engine at ``ep > 1`` is
    not ``live_readable``, so the scheduler carries no request across a
    rebind in place and attaches no prefix across tags (either would
    need a live lane step, refused at ``ep > 1``): it drains as under
    HARD, and the tokens equal the one-rank engine's with its own prefix
    cache;
and, without the spawn, ``ed_group_ranks`` against the JAX mode meshes'
'ed' axis. The refusals at ``ep > 1`` (SP islands, striped pools, live
lanes) and a tile of 2 'ed' x 2 'model' ranks' seats run in the same
spawn.
"""
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
from chip_smoke import FixedClock, ScriptedMerge  # noqa: E402

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
# the one-rank engine's runs, rank r taking the r-th: (arch, trace)
ONE_RANK = ((PHI, "trace"), (LLAMA, "trace"), (PHI, "odd"),
            (PHI, "prefix"))


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
# the JAX side: ``python tests/test_torch_ep_engine_ranks.py OUT_DIR``
# ---------------------------------------------------------------------------

def reference_main(out: str) -> None:
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
    from repro.core.modes import FlyingMode as JMode
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
    for arch in ARCHS:
        cfg = jget(arch).reduced()
        model = build_model(cfg, jnp.float32)
        params = model.init(jax.random.key(0))
        np.savez(os.path.join(out, f"{arch}.params.npz"),
                 *[np.asarray(a) for a in jax.tree.leaves(params)])
        # (a)'s tokens (check_serve_consistency.run_arch's draw)
        toks = jax.random.randint(jax.random.key(1), (B, T + 1), 0,
                                  cfg.vocab_size)
        np.save(os.path.join(out, f"{arch}.tokens.npy"), np.asarray(toks))
        built[arch] = (cfg, model, params, toks)
    (Path(out) / "params.ready").touch()

    # the 'ed' axis of every mode mesh of each plan
    ed = {}
    ax = MODE_AXES.index("ed")
    for p in ED_PLANS:
        plan = JPlan(*p)
        groups = set()
        for m in plan.valid_merges():
            ids = np.vectorize(lambda d: d.id)(
                mode_mesh(JMode(plan, m)).devices)
            rows = np.moveaxis(ids, ax, -1).reshape(-1, p[0])
            groups |= {tuple(map(int, r)) for r in rows}
        ed[repr(p)] = sorted(groups)

    plan = JPlan(*PLAN)
    res = {"ed": ed}
    for arch, (cfg, model, params, toks) in built.items():
        # (a) the distributed step (check_serve_consistency.run_arch)
        ref, _, _ = model.forward(params, SINGLE, mode="train", tokens=toks,
                                  backend=TrainBackend())
        steps = {"single_prefill": np.asarray(ref[:, -2]),
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
            steps[f"prefill{merge}"] = np.asarray(lp)
            steps[f"decode{merge}"] = np.asarray(ld)
        np.savez(os.path.join(out, f"{arch}.steps.npz"), **steps)

        # (c) the JAX engine on (b)'s trace
        geom = JGeometry(cfg, plan, num_blocks=64, block_base=4)
        eng = JEngine(model, plan, geom, params, batch_per_engine=2,
                      max_blocks_per_req=16, prefill_len=8,
                      check_zero_copy=True)
        sched = JScheduler(plan, geom, FixedClock(eng), JSConfig(
            strategy="hard", max_batch_per_group=2, prefill_chunk=8),
            policy=ScriptedMerge(4, 24))
        res[arch] = _run(eng, sched, JRequest)
    _write_json(os.path.join(out, "ref.json"), res)


# ---------------------------------------------------------------------------
# the port's ranks (module-level: the spawned children import them)
# ---------------------------------------------------------------------------

def _port_params(ref_dir: str, cfg, arch: str):
    like = Model(cfg, torch.float32, torch.device("meta")).init(
        torch.Generator(device="cpu"))
    with np.load(os.path.join(ref_dir, f"{arch}.params.npz")) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return params_from_numpy(cfg, ckpt.tree_unflatten(like, leaves),
                             device="cpu")


def _stack(ref_dir: str, arch: str):
    from repro_torch.models.model import build_model
    cfg = get_config(arch).reduced()
    return (cfg, build_model(cfg, torch.float32, "cpu"),
            _port_params(ref_dir, cfg, arch))


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


def _engine(cfg, model, params, plan, bpe=2, **kw):
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4, **kw)
    return FlyingEngine(model, plan, geom, params, batch_per_engine=bpe,
                        max_blocks_per_req=16, device="cpu",
                        check_zero_copy=True), geom


def _sched(eng, geom, plan, policy, prefix_cache: bool = False):
    """HARD, or LIVE with the prefix cache on."""
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    return DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
        strategy="live" if prefix_cache else "hard",
        max_batch_per_group=eng.bpe, prefill_chunk=8,
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


def _prefix_stack():
    """(e)'s model: the reduced Phi-3.5-MoE with 4 KV heads, so that its
    tags are live-readable on the 2-row tile."""
    import dataclasses

    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_config(PHI).reduced(), num_kv_heads=4)
    model = build_model(cfg, torch.float32, "cpu")
    return cfg, model, model.init(torch.Generator().manual_seed(0))


def _prefix_run(eng, geom, plan, policy, Request) -> dict:
    sched = _sched(eng, geom, plan, policy, prefix_cache=True)
    got = _run(eng, sched, Request, _prefix_trace)
    got["hits"] = sched.prefix_cache.stats["hit_requests"]
    return got


def _refusals(cfg, model, params, plan) -> dict:
    """What the engine refuses with the experts over 'ed': an SP island
    (at rebind), a live lane step, a striped pool (at construction)."""
    from repro_torch.core.modes import FleetLayout, Island
    got = {}
    eng, _ = _engine(cfg, model, params, plan)
    for what, fn in (
            ("sp", lambda: eng.rebind(FleetLayout(plan, (Island(
                0, 2, 2, sp=2),)))),
            ("live", lambda: eng.pool.runner(Island(0, 2, 2), "decode",
                                             live=(1, 2)))):
        try:
            fn()
            got[what] = None
        except NotImplementedError as e:
            got[what] = str(e)
    try:
        _engine(cfg, model, params, plan, layout="striped")
        got["striped"] = None
    except NotImplementedError as e:
        got["striped"] = str(e)
    return got


def ep_rank(rank, world, ref_dir, out):
    import torch.distributed as dist

    from repro_torch.core.communicator_pool import CommunicatorPool
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
        # (b): nothing builds a process group past construction
        calls = []
        new_group = dist.new_group
        dist.new_group = lambda *a, **k: calls.append(a) or new_group(
            *a, **k)
        try:
            got["trace"] = _run(eng, _sched(eng, geom, plan,
                                            ScriptedMerge(4, 24)), Request)
        finally:
            dist.new_group = new_group
        got["new_groups"] = len(calls)
        got["rebinds"] = len(eng.switch_log)
        st = eng.pool.stats
        got["a2a"] = [st.nbytes.get("all-to-all", 0), st.collectives]
        if arch == PHI:
            # (d): one row a group at merge 1
            eng, geom = _engine(cfg, model, params, plan, bpe=1)
            got["odd"] = _run(eng, _sched(eng, geom, plan, None), Request,
                              _odd_trace)
            # (e): the prefix cache across the merges
            eng, geom = _engine(*_prefix_stack(), plan)
            got["prefix_live_readable"] = [
                geom.live_readable(m) for m in MERGES]
            got["prefix"] = _prefix_run(eng, geom, plan,
                                        ScriptedMerge(4, 24), Request)
            got["refused"] = _refusals(cfg, model, params, plan)
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
    if rank < len(ONE_RANK):
        # past the world's last collective: this rank's share of the
        # one-rank runs, its engine in a world of one (the prompts come
        # from Python's salted hash, which the ranks seed alike)
        arch, run = ONE_RANK[rank]
        cfg, model, params = _prefix_stack() if run == "prefix" \
            else _stack(ref_dir, arch)
        one = ParallelPlan(1, 1, 1)
        with mock.patch("repro_torch.core.communicator_pool.world",
                        lambda: (0, 1)):
            eng, geom = _engine(cfg, model, params, one,
                                bpe=1 if run == "odd" else 2)
            res["one_rank"] = [arch, run, _prefix_run(
                eng, geom, one, None, Request) if run == "prefix" else _run(
                eng, _sched(eng, geom, one, None), Request,
                _odd_trace if run == "odd" else _trace)]
    _write_json(f"{out}.{rank}.json", res)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX side, started in the background: the port's ranks need
    only its weights, which it writes first."""
    out = tmp_path_factory.mktemp("jax_ep_engine")
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    with open(out / "stderr.txt", "w") as err:
        proc = subprocess.Popen([sys.executable, __file__, str(out)],
                                env=env, stdout=subprocess.DEVNULL,
                                stderr=err)
    try:
        yield proc, out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _jax_failed(proc, out) -> str:
    return f"JAX side exited {proc.returncode}: " \
        f"{(out / 'stderr.txt').read_text()[-4000:]}"


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every rank's results, once the JAX side has written the
    weights."""
    proc, ref_dir = jax_side
    deadline = time.monotonic() + 300
    while not (ref_dir / "params.ready").exists():
        assert proc.poll() is None, _jax_failed(proc, ref_dir)
        assert time.monotonic() < deadline, "no weights from the JAX side"
        time.sleep(0.2)
    out = str(tmp_path_factory.mktemp("ep_ranks") / "ep")
    spawn(ep_rank, WORLD, (str(ref_dir), out), device_type="cpu",
          timeout=SPAWN_S, threads=1)
    return [_read_json(f"{out}.{r}.json") for r in range(WORLD)]


@pytest.fixture(scope="module")
def ref(jax_side, ranks):
    """The JAX side's results, once it has finished (the ranks run while
    it does)."""
    proc, out = jax_side
    proc.wait(timeout=900)
    assert proc.returncode == 0, _jax_failed(proc, out)
    return {"dir": str(out), **_read_json(out / "ref.json")}


@pytest.fixture(scope="module")
def one_rank(ranks):
    """The port's one-rank engine (``ParallelPlan(1, 1, 1)``) on (b)'s
    trace and (d)'s, on the same weights, by arch and trace."""
    runs = [r["one_rank"] for r in ranks[:len(ONE_RANK)]]
    return {(arch, run): got for arch, run, got in runs}


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
    assert run == ref[arch]


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


def test_prefix_cache_across_merges(ranks, one_rank):
    """(e): LIVE with the prefix cache on, merges 1 -> 2 -> 1, on tags
    the geometry can read across. The MoE engine at ``ep > 1`` is not
    ``live_readable`` (the dense one on the same tile is), so no request
    rides the merge-up in place and a prefix written under tag 1 is not
    attached at merge 2, either of which would run a live lane step; the
    requests are served with the one-rank engine's tokens, with hits on
    both sides."""
    for res in ranks:
        assert res[PHI]["live_readable"] is False
        assert res[LLAMA]["live_readable"] is True
        assert res[PHI]["prefix_live_readable"] == [True, True]
    run = _same_on_every_rank(ranks, PHI, "prefix")
    want = one_rank[(PHI, "prefix")]
    n = len(PREFIX_ARRIVALS)
    assert run["done"] == want["done"] == n
    assert run["toks"] == want["toks"]
    merges = [lay[0] for lay in run["layouts"]]
    assert [m for i, m in enumerate(merges)
            if i == 0 or m != merges[i - 1]] == [1, 2, 1]
    assert run["hits"] > 0 and want["hits"] > 0
    assert run["preempt"]["live_riders"] == 0 and run["preempt"]["paused"]


def test_refusals_name_their_roadmap_item(ranks):
    """With the experts over 'ed', an SP island (at rebind), a live lane
    step and a striped pool (at construction) raise
    ``NotImplementedError`` naming ROADMAP.md Queue 1 item 5."""
    for res in ranks:
        got = res[PHI]["refused"]
        assert set(got) == {"sp", "live", "striped"}
        for what, msg in got.items():
            assert msg is not None, what
            assert "ROADMAP.md Queue 1 item 5" in msg, msg


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
    reference_main(sys.argv[1])
