"""The port's LIVE cross-layout lanes, sequence-parallel islands and
quarantine against the JAX package's, on the CPU.

One process per rank, joined over gloo (``repro_torch.launch.ranks``),
one torch thread each, under ``PYTHONHASHSEED=0``; every spawn has its
own join deadline, so a missed collective fails the test instead of
hanging it. The JAX side runs in a subprocess, this file's ``__main__``,
with 8 forced host devices and the ``AbstractMesh`` shim of
``tests/test_torch_islands.py`` (no other patch: both packages' engines
report ``live_readable()`` True, so both schedulers take LIVE lanes).
Both sides run fp32 with the JAX package's weights (through
``convert.params_from_numpy``); on the CPU the port runs the plain
versions of K1, K2 and K4.

Two plans. ``ParallelPlan(1, 1, 8)``, 8 engines of one rank, is where
the reference scripts run their scenarios, with the reduced
stablelm-1.6b (4 heads, 4 KV heads: tags 1, 2 and 4 are readable):
``tests/md_scripts/check_live_switch.py``, ``check_seq_parallel.py``,
``check_fault_recovery.py`` and ``check_prefix_cache.py``, the JAX side
calling the scripts' own functions and the port a copy of them. There a
view group is its TP group. ``ParallelPlan(1, 2, 4)``, 4 engines of 2
ranks, splits each engine's ranks by storage rank, so a view group is
half its TP group: there the view axis's ``lse_merge``, the live
backends on random pools, a LIVE rebind with a decode and a
chunked-prefill rider, an SP2 island, a scheduler run under LIVE, and
the uniform-switch scripts ``check_context_attention.py``,
``check_prefill_attention.py`` and ``check_hotpath.py`` (the reduced
llama3-8b, as they run it) are held against the JAX package's.
"""
import json
import os
import subprocess
import sys
import time
import traceback
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import FlyingEngine
from repro_torch.core.faults import (DRAIN_CORRUPT, KILL, REBIND_FAIL,
                                     EngineFault, FaultInjector, FaultSpec,
                                     TransitionFault)
from repro_torch.core.kv_adaptor import PoolGeometry, PrefixCache
from repro_torch.core.modes import FleetLayout, ParallelPlan
from repro_torch.core.task_pool import Request, prompt_token_ids
from repro_torch.launch.ranks import spawn
from repro_torch.models.model import Model, build_model
from repro_torch.training import checkpoint as ckpt

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import FixedClock, ScriptedMerge  # noqa: E402

WIDE = (1, 1, 8)            # the reference scripts' plan: 8 engines
SPLIT = (1, 2, 4)           # 4 engines of 2 ranks
SPAWN_S = 240.0             # join deadline of each spawn
LSE_TOL = 1e-6              # lse_merge over the view axis
BACKEND_TOL = 1e-5          # the live backends on random pools


def _write_json(path, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=True)


def _read_json(path):
    with open(path) as f:
        return json.load(f)


def _key_text(keys) -> list:
    return sorted(repr(tuple(k)) for k in keys)


# ---------------------------------------------------------------------------
# scenarios both packages run (engine calls only; ``Req`` is the
# package's Request)
# ---------------------------------------------------------------------------

def _req(Req, g, rid, plen, **kw):
    r = Req(req_id=rid, arrival=0.0, prompt_len=plen, output_len=1 << 30,
            **kw)
    r.engine_group = g
    return r


def _start(eng, reqs, island):
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, r.prompt_len)
    eng.prefill(reqs, island, max(r.prompt_len for r in reqs))
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, 1)


def _decode(eng, reqs, island, steps=1):
    for _ in range(steps):
        eng.decode(reqs, island)
        for r in reqs:
            eng.adaptors[r.engine_group].append_slots(r.req_id, 1)


def _chunk(eng, r, island, lo, chunk):
    eng.adaptors[r.engine_group].append_slots_batch([r.req_id], [chunk])
    r.prefilled = lo
    eng.prefill([r], island, chunk)
    r.prefilled = lo + chunk


def live_split(eng, Req, switch: bool) -> dict:
    """A LIVE rebind at 4 engines of 2 ranks: ``[DP|DP|2xDP]`` -> ``[TP2 |
    2xDP]`` with a decode rider on engine 0 (tags 1, 2) and a chunked
    prefill on engine 1 whose prompt streams across it (tags 1, 2),
    while the DP island on engines 2-3 keeps decoding. ``switch=False``
    is the never-switched reference with the same launches. A fleet of
    2 engines runs it without the DP island (``[DP|DP]`` -> ``[TP2]``),
    and a fleet of one engine, never switched, serves both requests on
    engine 0."""
    def isl(e):
        return eng.layout.island_of(e)
    n = len(eng.adaptors)
    r0 = _req(Req, 0, "r0", 9)
    lp = _req(Req, min(1, n - 1), "lp", 12)
    g = lp.engine_group
    bg = [_req(Req, 2, "b2", 9), _req(Req, 3, "b3", 9)] if n >= 4 else []
    isl_bg = isl(2) if bg else None
    if bg:
        _start(eng, bg, isl_bg)
    _start(eng, [r0], isl(0))
    _chunk(eng, lp, isl(g), 0, 4)
    _decode(eng, [r0], isl(0), 2)
    if bg:
        _decode(eng, bg, isl_bg, 2)
    if switch:
        eng.rebind(eng.layout.carve(0, 2, 2))
        eng.adaptors[0].retag_tail("r0")
        assert not bg or isl(2) == isl_bg
    _chunk(eng, lp, isl(g), 4, 4)
    _decode(eng, [r0], isl(0), 2)
    if bg:
        _decode(eng, bg, isl_bg, 2)
    _chunk(eng, lp, isl(g), 8, 4)
    eng.adaptors[g].append_slots("lp", 1)
    if switch:
        _decode(eng, [r0, lp], isl(0), 3)
    else:
        _decode(eng, [r0], isl(0), 3)
        _decode(eng, [lp], isl(g), 3)
    if bg:
        _decode(eng, bg, isl_bg, 3)
    out = {"bg_drains": eng.island_sync_stats(isl_bg).drains if bg else 0,
           "toks": {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
                    for r in [r0, lp] + bg},
           "host_argmax": eng.sync_stats.host_argmax,
           "tags": {rid: list(eng.adaptors[e].table[rid].tags())
                    for rid, e in (("r0", 0), ("lp", g))},
           "keys": _key_text(eng.pool._runners)}
    return out


SP_PROMPT, SP_STEPS = 32, 12


def sp_split(eng, Req, sp: bool) -> dict:
    """One request on a pure-SP island ``Island(0, 2, 2, sp=2)`` whose
    context (45 tokens) exceeds one engine's pool (7 usable blocks of 4
    tokens), prefilled a block a chunk, beside a DP island on engines
    2-3 (none in a fleet of fewer than 4 engines); ``sp=False`` serves
    it at merge 1 from a big pool."""
    def isl(e):
        return eng.layout.island_of(e)
    ad = eng.adaptors[0]
    cap = eng.geom.capacity(1)
    r = _req(Req, 0, "long", SP_PROMPT)
    bg = [_req(Req, 2, "b2", 9), _req(Req, 3, "b3", 9)] \
        if len(eng.adaptors) >= 4 else []
    isl_bg = isl(2) if bg else None
    if bg:
        _start(eng, bg, isl_bg)
    for lo in range(0, SP_PROMPT, cap):
        ad.append_slots_batch(["long"], [cap])
        r.prefilled = lo
        eng.prefill([r], isl(0), cap)
    r.prefilled = SP_PROMPT
    ad.append_slots("long", 1)
    _decode(eng, [r], isl(0), SP_STEPS)
    if bg:
        _decode(eng, bg, isl_bg, SP_STEPS)
    out = {"bg_drains": eng.island_sync_stats(isl_bg).drains if bg else 0,
           "toks": {q.req_id: list(map(int, eng.generated_tokens(q.req_id)))
                    for q in [r] + bg},
           "host_argmax": eng.sync_stats.host_argmax,
           "context": SP_PROMPT + SP_STEPS + 1,
           "one_pool": ad.max_context_tokens(1)}
    if sp:
        out["shards"] = [[min(o.engine_id for o in s.owners), list(s.ids)]
                         for s in ad.table["long"].segments]
    return out


def sched_live(eng, make_sched, Req, arrivals=None) -> dict:
    """A scheduler trace under LIVE: 8 staggered requests (prompts of 8
    to 20 tokens in 8-token chunks, 6 tokens out) on a clock of 10 ms a
    step, the merge scripted 1 -> 2 at tick 4 while decodes and a
    chunked prefill are in flight. ``arrivals`` (8 times) replaces the
    arrivals 4 ms apart."""
    sched = make_sched(eng)
    for i in range(8):
        sched.submit(Req(req_id=f"r{i}", arrival=0.004 * i if arrivals
                         is None else arrivals[i],
                         prompt_len=8 + 4 * (i % 4), output_len=6))
    sched.run(max_steps=400)
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
            "keys": _key_text(eng.pool._runners),
            "adaptors": [[list(map(int, a.free)), sorted(a.table)]
                         for a in sched.adaptors],
            "host_argmax": eng.sync_stats.host_argmax}


# ---------------------------------------------------------------------------
# the live backends on random pools (numpy cases both packages read)
# ---------------------------------------------------------------------------

BB, NB, H_ST, KV_ST, HD, NROW, T_CHUNK = 2, 12, 8, 4, 16, 5, 3
BACKEND_CASES = (
    # (name, merge, sp, phase, lane tags)
    ("decode_m2", 2, 1, "decode", (1, 2)),
    ("decode_m4", 4, 1, "decode", (1, 2, 4)),
    ("decode_m4_one_tag", 4, 1, "decode", (4,)),
    ("prefill_m4", 4, 1, "prefill", (1, 2, 4)),
    ("prefill_m2", 2, 1, "prefill", (1, 2)),
    ("decode_sp2", 4, 2, "decode", (2, 2)),
    ("prefill_sp2", 4, 2, "prefill", (2, 2)),
    ("decode_sp4", 4, 4, "decode", (1, 1, 1, 1)),
)


def backend_case(name: str, world: int = 8) -> dict:
    """Random inputs of one case: per-rank pools and activations
    (``[world, ...]``), and the host-staged slots and lanes every rank
    of the one TP group shares. Lanes have random owner offsets (a
    multiple of their tag), random lengths with empty rows, and the
    last row is padding (every lane empty, slot -1)."""
    _, merge, sp, phase, tags = next(c for c in BACKEND_CASES
                                     if c[0] == name)
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    T = 1 if phase == "decode" else T_CHUNK
    elems = BB * KV_ST * HD
    c = {"merge": merge, "sp": sp, "phase": phase, "tags": list(tags),
         "kp": rng.standard_normal((world, NB, elems)).astype(np.float32),
         "vp": rng.standard_normal((world, NB, elems)).astype(np.float32),
         "q": rng.standard_normal((world, NROW, T, H_ST, HD))
         .astype(np.float32),
         "k": rng.standard_normal((world, NROW, T, KV_ST, HD))
         .astype(np.float32),
         "v": rng.standard_normal((world, NROW, T, KV_ST, HD))
         .astype(np.float32)}
    wt = merge // sp
    cap_w = BB * wt
    # distinct write slots outside the reserved block; the padding row
    # and a random row get -1
    n_slots = (NB - 1) * cap_w
    slots = rng.permutation(n_slots)[:NROW * T].reshape(NROW, T)
    if sp > 1:
        # an SP row's chunk stays within one block
        blk = rng.permutation(NB - 1)[:NROW]
        slots = blk[:, None] * cap_w + np.arange(T)[None] % cap_w
    slots = slots.astype(np.int32)
    slots[-1] = -1
    if phase == "decode":
        slots[rng.integers(0, NROW - 1), 0] = -1
    c["slots"] = slots[:, 0] if phase == "decode" else slots
    c["write_own"] = (rng.integers(0, sp, NROW) * wt).astype(np.int32)
    mb = 3
    for i, t in enumerate(tags):
        cap_t = BB * t
        bt = rng.integers(0, NB - 1, (NROW, mb)).astype(np.int32)
        ln = rng.integers(0, mb * cap_t + 1, NROW).astype(np.int32)
        ln[rng.integers(0, NROW - 1)] = 0          # an empty lane
        own = (rng.integers(0, merge // t, NROW) * t).astype(np.int32)
        ln[-1] = 0
        if sp > 1:
            own = np.full((NROW,), i * t, np.int32)
        c[f"lt{i}_bt"], c[f"lt{i}_len"], c[f"lt{i}_own"] = bt, ln, own
    return c


# ---------------------------------------------------------------------------
# the JAX side: ``python tests/test_torch_live.py OUT_DIR``
# ---------------------------------------------------------------------------

def reference_main(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO / "tests" / "md_scripts"))
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    class PairMesh(jax.sharding.AbstractMesh):
        def __init__(self, axis_sizes, axis_names=None, *a, **kw):
            if axis_names is None:
                axis_names = tuple(n for n, _ in axis_sizes)
                axis_sizes = tuple(s for _, s in axis_sizes)
            super().__init__(axis_sizes, axis_names, *a, **kw)
    jax.sharding.AbstractMesh = PairMesh

    import check_context_attention as cca
    import check_fault_recovery as cfr
    import check_hotpath as chp
    import check_live_switch as cls
    import check_prefill_attention as cpa
    import check_prefix_cache as cpc
    import check_seq_parallel as csp
    from repro.configs import get_config as jget
    from repro.core.engine import FlyingEngine as JEngine
    from repro.core.faults import FaultInjector as JInjector
    from repro.core.faults import FaultSpec as JSpec
    from repro.core.kv_adaptor import PoolGeometry as JGeometry
    from repro.core.modes import FleetLayout as JLayout
    from repro.core.modes import FlyingMode as JMode
    from repro.core.modes import ParallelPlan as JPlan
    from repro.core.modes import MODE_AXES, mode_mesh
    from repro.core.scheduler import DynamicScheduler as JScheduler
    from repro.core.scheduler import SchedulerConfig as JSConfig
    from repro.core.steps import _SM_KW, _shard_map
    from repro.core.task_pool import Request as JRequest
    from repro.core.views import make_serving_ctx as jctx
    from repro.models.cache import LiveDecodeBackend as JLiveDecode
    from repro.models.cache import LivePrefillBackend as JLivePrefill
    from repro.models.model import build_model as jbuild

    res = {}

    def save_params(name, params):
        np.savez(os.path.join(out, f"{name}.npz"),
                 *[np.asarray(a) for a in jax.tree.leaves(params)])

    # -- the view axis: lse_merge and the live backends -----------------
    split = JPlan(*SPLIT)
    lse = {}
    for merge in (2, 4):
        mesh = mode_mesh(JMode(split, merge))
        ctx = jctx(merge, 1, 2)
        acc, l, m = lse_inputs(merge)
        spec = P(MODE_AXES)

        def merged(a, b, c, ctx=ctx):
            return ctx.lse_merge(a[0], b[0], c[0], axes=ctx.view_axes)[None]
        fn = _shard_map(merged, mesh=mesh, in_specs=(spec, spec, spec),
                        out_specs=spec, **_SM_KW)
        lse[str(merge)] = np.asarray(jax.jit(fn)(acc, l, m))
    np.savez(os.path.join(out, "lse.npz"), **lse)
    backends = {}
    for name, *_ in BACKEND_CASES:
        c = backend_case(name)
        merge, sp = c["merge"], c["sp"]
        mesh = mode_mesh(JMode(split, merge))
        ctx = jctx(merge, 1, 2)
        dev = P(MODE_AXES)
        rep = P()
        lanes = [k for k in sorted(c) if k.startswith("lt")]
        kind = JLiveDecode if c["phase"] == "decode" else JLivePrefill
        tags = tuple(c["tags"])
        vs = tuple([NB, BB * merge, KV_ST // merge, HD])

        def run(kp, vp, q, k, v, slots, wown, *lane, ctx=ctx, kind=kind,
                merge=merge, sp=sp, tags=tags, vs=vs, c=c):
            lane = dict(zip(lanes, lane))
            segs = tuple((t, lane[f"lt{i}_bt"], lane[f"lt{i}_len"],
                          lane[f"lt{i}_own"]) for i, t in enumerate(tags))
            b = kind(ctx=ctx, slots=slots, segs=segs, merge=merge,
                     block_base=BB, sp=sp, write_own=wown)
            o, (kp2, vp2) = b.attend(
                (kp[0].reshape(vs), vp[0].reshape(vs)), q[0], k[0], v[0],
                positions=None)
            return (o[None], kp2.reshape(kp[0].shape)[None],
                    vp2.reshape(vp[0].shape)[None])
        fn = _shard_map(run, mesh=mesh,
                        in_specs=(dev,) * 5 + (rep,) * (2 + len(lanes)),
                        out_specs=(dev, dev, dev), **_SM_KW)
        o, kp, vp = jax.jit(fn)(c["kp"], c["vp"], c["q"], c["k"], c["v"],
                                c["slots"], c["write_own"],
                                *[c[k] for k in lanes])
        backends[f"{name}.out"] = np.asarray(o)
        backends[f"{name}.kp"] = np.asarray(kp)
        backends[f"{name}.vp"] = np.asarray(vp)
    np.savez(os.path.join(out, "backends.npz"), **backends)

    # -- weights first: the port's ranks start from them -----------------
    cfg = jget("stablelm-1.6b").reduced()
    model = jbuild(cfg, jnp.float32)
    params = model.init(jax.random.key(0))
    save_params("stablelm", params)
    lcfg = jget("llama3-8b").reduced()
    lmodel = jbuild(lcfg, jnp.float32)
    lparams = lmodel.init(jax.random.key(0))
    save_params("llama", lparams)
    Path(out, "params.ready").touch()

    # -- the reference scripts at 8 engines (reduced stablelm-1.6b) -----
    wide = JPlan(*WIDE)

    def geom(nb=64):
        return JGeometry(cfg, wide, num_blocks=nb, block_base=4)
    L1 = JLayout.of(wide, [(2, 1), (2, 1), (4, 1)])
    eng = JEngine(model, wide, geom(), params, batch_per_engine=2,
                  layout=L1, check_zero_copy=True)
    toks, b_stats = cls.run_live(eng, L1, L1.carve(0, 2, 2),
                                 L1.carve(0, 2, 2).carve(0, 4, 4))
    res["live"] = {"toks": toks, "bg_drains": b_stats.drains,
                   "host_argmax": eng.sync_stats.host_argmax,
                   "keys": _key_text(eng.pool._runners)}
    toks, info = csp.sp_serve(model, params, cfg, wide, None)
    res["sp"] = {"toks": toks, "blocks_per_shard": {
        str(k): v for k, v in info["blocks_per_shard"].items()}}
    inj = JInjector([JSpec(kind=KILL, tick=1, engines=(0,)),
                     JSpec(kind=REBIND_FAIL, tick=5),
                     JSpec(kind=DRAIN_CORRUPT, tick=7, engines=(3,))])
    eng = JEngine(model, wide, geom(), params, batch_per_engine=2,
                  layout=L1, injector=inj)
    toks, b_stats, kept = cfr.run_faulted(eng, inj)
    cfr.check_transition_faults(eng, inj)
    res["fault"] = {"toks": toks, "bg_drains": b_stats.drains,
                    "kept": kept, "layout": [
                        [i.start, i.n_engines, i.merge]
                        for i in eng.layout.islands]}
    res["prefix"] = cpc.drive(JEngine(
        model, wide, geom(), params, batch_per_engine=2,
        layout=JLayout.uniform(wide, 1), check_zero_copy=True),
        cfg.vocab_size, cache=True)

    # -- 4 engines of 2 ranks: stablelm's LIVE, SP and scheduler runs -----
    def geom_split(nb=64):
        return JGeometry(cfg, split, num_blocks=nb, block_base=4)
    res["live_split"] = live_split(JEngine(
        model, split, geom_split(), params, batch_per_engine=2,
        layout=JLayout.of(split, [(1, 1), (1, 1), (2, 1)]),
        check_zero_copy=True), JRequest, True)
    res["sp_split"] = sp_split(JEngine(
        model, split, geom_split(8), params, batch_per_engine=2,
        layout=JLayout.of(split, [(2, 2, 2), (2, 1)]),
        check_zero_copy=True), JRequest, True)
    gs = geom_split()
    res["sched_live"] = sched_live(
        JEngine(model, split, gs, params, batch_per_engine=2,
                max_blocks_per_req=16, prefill_len=8, check_zero_copy=True),
        lambda e: JScheduler(split, gs, FixedClock(e), JSConfig(
            strategy="live", max_batch_per_group=2, prefill_chunk=8),
            policy=ScriptedMerge(4, 1 << 30)), JRequest)

    # -- the uniform-switch scripts (reduced llama3-8b) -------------------
    lgeom = JGeometry(lcfg, split, num_blocks=64, block_base=4)

    def leng(**kw):
        return JEngine(lmodel, split, lgeom, lparams, batch_per_engine=2,
                       prefill_len=8, **kw)
    res["context"] = cca.run(leng(max_blocks_per_req=32, use_kernel=False))
    res["prefill"] = cpa.run(leng(max_blocks_per_req=32, use_kernel=False),
                             True)
    res["hotpath"] = chp.run(leng(check_zero_copy=True))
    _write_json(os.path.join(out, "ref.json"), res)


def lse_inputs(merge: int, world: int = 8):
    """Per-rank online-softmax partials [world, B, H, D] (acc), [world,
    B, H] (l, m) for the view-axis merge, some heads absent on some
    ranks (m = -inf-like, l = 0)."""
    rng = np.random.default_rng(100 + merge)
    acc = rng.standard_normal((world, 3, 4, 8)).astype(np.float32)
    l = rng.uniform(0.5, 2.0, (world, 3, 4)).astype(np.float32)
    m = rng.standard_normal((world, 3, 4)).astype(np.float32)
    gone = rng.random((world, 3, 4)) < 0.2
    m[gone] = -0.7 * np.finfo(np.float32).max
    l[gone] = 0.0
    acc[gone] = 0.0
    return acc, l, m


# ---------------------------------------------------------------------------
# the port's ranks (module-level: the spawned children import them)
# ---------------------------------------------------------------------------

def _port_params(ref_dir: str, name: str, cfg):
    like = Model(cfg, torch.float32, torch.device("meta")).init(
        torch.Generator(device="cpu"))
    with np.load(os.path.join(ref_dir, f"{name}.npz")) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return params_from_numpy(cfg, ckpt.tree_unflatten(like, leaves),
                             device="cpu")


def _stack(ref_dir, arch: str, name: str):
    cfg = get_config(arch).reduced()
    return cfg, build_model(cfg, torch.float32, "cpu"), \
        _port_params(ref_dir, name, cfg)


def _scenario(res: dict, key: str, fn) -> None:
    """Run one scenario into ``res[key]``, or its traceback: every rank
    runs the same host program, so a failure raises alike on each and
    the other scenarios still run."""
    try:
        res[key] = fn()
    except Exception:           # noqa: BLE001 (recorded, then asserted)
        res[key] = {"error": traceback.format_exc()}


def _live_wide(eng):
    """check_live_switch.run_live: two LIVE rebinds with riders of tags
    (1, 2, 4) and (1, 4) and a chunked prefill across both."""
    mk = _req
    r0, r2 = mk(Request, 0, "r0", 9), mk(Request, 2, "r2", 9)
    bg = [mk(Request, 4, "b4", 9), mk(Request, 6, "b6", 9)]
    lp = mk(Request, 1, "lp", 12)
    def isl(e):
        return eng.layout.island_of(e)
    L1 = eng.layout
    isl_bg = isl(4)
    _start(eng, bg, isl_bg)
    _start(eng, [r0], isl(0))
    _start(eng, [r2], isl(2))
    _chunk(eng, lp, isl(1), 0, 4)
    _decode(eng, [r0], isl(0), 2)
    _decode(eng, [r2], isl(2), 2)
    _decode(eng, bg, isl_bg, 2)
    eng.rebind(L1.carve(0, 2, 2))
    eng.adaptors[0].retag_tail("r0")
    assert isl(4) == isl_bg
    _chunk(eng, lp, isl(1), 4, 4)
    _decode(eng, [r0], isl(0), 2)
    _decode(eng, [r2], isl(2), 2)
    _decode(eng, bg, isl_bg, 2)
    eng.rebind(L1.carve(0, 2, 2).carve(0, 4, 4))
    for r in (r0, r2):
        eng.adaptors[r.engine_group].retag_tail(r.req_id)
    assert isl(4) == isl_bg
    _chunk(eng, lp, isl(1), 8, 4)
    eng.adaptors[1].append_slots("lp", 1)
    _decode(eng, [r0, r2, lp], isl(0), 3)
    _decode(eng, bg, isl_bg, 3)
    tags = {rid: list(eng.adaptors[g].table[rid].tags())
            for rid, g in (("r0", 0), ("r2", 2), ("lp", 1))}
    drains = eng.island_sync_stats(isl_bg).drains
    toks = {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
            for r in [r0, r2, lp] + bg}
    return {"toks": toks, "bg_drains": drains, "tags": tags,
            "host_argmax": eng.sync_stats.host_argmax,
            "keys": _key_text(eng.pool._runners)}


def _live_wide_ref(eng):
    """check_live_switch.run_reference: the same launches, all at merge
    1."""
    mk = _req
    r0, r2 = mk(Request, 0, "r0", 9), mk(Request, 2, "r2", 9)
    bg = [mk(Request, 4, "b4", 9), mk(Request, 6, "b6", 9)]
    lp = mk(Request, 1, "lp", 12)
    def isl(e):
        return eng.layout.island_of(e)
    _start(eng, bg, isl(4))
    _start(eng, [r0], isl(0))
    _start(eng, [r2], isl(2))
    for lo in (0, 4):
        _chunk(eng, lp, isl(1), lo, 4)
        _decode(eng, [r0], isl(0), 2)
        _decode(eng, [r2], isl(2), 2)
        _decode(eng, bg, isl(4), 2)
    _chunk(eng, lp, isl(1), 8, 4)
    eng.adaptors[1].append_slots("lp", 1)
    _decode(eng, [r0], isl(0), 3)
    _decode(eng, [r2], isl(2), 3)
    _decode(eng, [lp], isl(1), 3)
    _decode(eng, bg, isl(4), 3)
    return {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
            for r in [r0, r2, lp] + bg}


SP_WIDE_PROMPT, SP_WIDE_STEPS = 40, (6, 10)


def _sp_wide(eng, ref: bool):
    """check_seq_parallel.sp_serve (SP2 -> LIVE rebind -> SP4 over
    engines 0-3) and its big-pool merge-1 reference."""
    ad = eng.adaptors[0]
    cap = eng.geom.capacity(1)
    r = _req(Request, 0, "long", SP_WIDE_PROMPT)
    bg = [_req(Request, 4, "b4", 9), _req(Request, 6, "b6", 9)]
    def isl(e):
        return eng.layout.island_of(e)
    isl_bg = isl(4)
    _start(eng, bg, isl_bg)
    for lo in range(0, SP_WIDE_PROMPT, cap):
        ad.append_slots_batch(["long"], [cap])
        r.prefilled = lo
        eng.prefill([r], isl(0), cap)
    r.prefilled = SP_WIDE_PROMPT
    ad.append_slots("long", 1)
    _decode(eng, [r], isl(0), SP_WIDE_STEPS[0])
    _decode(eng, bg, isl_bg, SP_WIDE_STEPS[0])
    out = {}
    if not ref:
        out["shards2"] = sorted({min(o.engine_id for o in s.owners)
                                 for s in ad.table["long"].segments})
        eng.rebind(eng.layout.carve(0, 4, 4, sp=4))
        ad.retag_tail("long")
        assert isl(0).sp == 4 and isl(4) == isl_bg
    _decode(eng, [r], isl(0), SP_WIDE_STEPS[1])
    _decode(eng, bg, isl_bg, SP_WIDE_STEPS[1])
    if not ref:
        per = {}
        for s in ad.table["long"].segments:
            j = min(o.engine_id for o in s.owners)
            per[str(j)] = per.get(str(j), 0) + len(s.ids)
        out.update(blocks_per_shard=per,
                   bg_drains=eng.island_sync_stats(isl_bg).drains,
                   host_argmax=eng.sync_stats.host_argmax,
                   context=SP_WIDE_PROMPT + sum(SP_WIDE_STEPS) + 1,
                   one_pool=ad.max_context_tokens(1))
    out["toks"] = {q.req_id: list(map(int, eng.generated_tokens(q.req_id)))
                   for q in [r] + bg}
    return out


def _fault_ref(eng):
    """check_fault_recovery.run_reference."""
    v = _req(Request, 0, "v", 9)
    bg = [_req(Request, 4, "b4", 9), _req(Request, 6, "b6", 9)]
    isl_a, isl_b = eng.layout.island_of(0), eng.layout.island_of(4)
    _start(eng, [v], isl_a)
    _start(eng, bg, isl_b)
    _decode(eng, [v], isl_a, 8)
    _decode(eng, bg, isl_b, 9)
    return {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
            for r in [v] + bg}


def _fault_run(eng, inj):
    """check_fault_recovery.run_faulted, then check_transition_faults."""
    v = _req(Request, 0, "v", 9)
    bg = [_req(Request, 4, "b4", 9), _req(Request, 6, "b6", 9)]
    isl_a, isl_b = eng.layout.island_of(0), eng.layout.island_of(4)
    free0 = eng.adaptors[0].free_blocks()
    _start(eng, [v], isl_a)
    _start(eng, bg, isl_b)
    _decode(eng, [v], isl_a, 3)
    _decode(eng, bg, isl_b, 3)
    # harvest island A alone: 4 of v's tokens reach the host buffer, the
    # next 2 stay on the device and die with the engine
    eng._drain_island(eng._rt_of[isl_a])
    _decode(eng, [v], isl_a, 2)
    inj.advance(1)                       # KILL engine 0 arms
    fault = None
    try:
        eng.decode([v], isl_a)
    except EngineFault as ex:
        fault = sorted(ex.engines)
    kept = eng.recover_request(v)
    v.prompt_len = v.prompt_len - v.folded + kept
    v.folded = kept
    v.prefilled = 0
    eng.adaptors[0].drop_for_recompute("v")
    leaked = free0 - eng.adaptors[0].free_blocks()
    lq = eng.layout.quarantine({0})
    eng.rebind(lq)
    assert eng.layout.island_of(4) == isl_b
    v.engine_group = 5
    _start(eng, [v], isl_b)
    _decode(eng, [v], isl_b, 4)
    _decode(eng, bg, isl_b, 6)
    drains = eng.island_sync_stats(isl_b).drains
    toks = {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
            for r in [v] + bg}
    # transition faults fire before any state moves
    before = eng.layout
    target = before.carve(2, 2, 2)
    raised = []
    for tick in (5, 7):
        inj.advance(tick)
        try:
            eng.rebind(target)
        except TransitionFault as ex:
            raised.append([tick, sorted(ex.engines)])
        assert eng.layout == before
    inj.advance(8)
    eng.rebind(target)
    return {"toks": toks, "bg_drains": drains, "kept": kept,
            "fault": fault, "leaked": leaked, "transition": raised,
            "after": eng.layout == target,
            "layout": [[i.start, i.n_engines, i.merge]
                       for i in eng.layout.islands],
            "host_argmax": eng.sync_stats.host_argmax}


def _prefix(eng, cache: bool):
    """check_prefix_cache.drive: a prefix committed under DP on engine 0,
    attached across a LIVE DP -> TP4 rebind (uncached: the whole prompt
    prefilled under tag 4)."""
    vocab = eng.cfg.vocab_size
    pc = None
    if cache:
        pc = PrefixCache()
        for a in eng.adaptors:
            a.prefix_cache = pc
    ad0 = eng.adaptors[0]
    kw = dict(prefix_seed=1234, prefix_len=8)
    w, s = _req(Request, 0, "w", 12, **kw), _req(Request, 0, "s", 12, **kw)
    ad0.append_slots("w", 12)
    eng.prefill([w], eng.layout.island_of(0), 12)
    if cache:
        ad0.commit_prefix("w", prompt_token_ids(w, vocab), 12)
    ad0.append_slots("w", 1)
    _decode(eng, [w], eng.layout.island_of(0), 2)
    eng.rebind(eng.layout.carve(0, 4, 4))
    ad0.retag_tail("w")
    isl = eng.layout.island_of(0)
    out = {}
    if cache:
        out["attached"] = ad0.attach_prefix("s", prompt_token_ids(s, vocab),
                                            cross_tag_ok=True)
        ad0.append_slots_batch(["s"], [4])
        s.prefilled = 8
        eng.prefill([s], isl, 4)
        s.prefilled = 12
        out["tags"] = list(ad0.table["s"].tags())
    else:
        ad0.append_slots("s", 12)
        eng.prefill([s], isl, 12)
    ad0.append_slots("s", 1)
    _decode(eng, [w, s], isl, 4)
    out["toks"] = {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
                   for r in (w, s)}
    if cache:
        out["hits"] = [pc.stats["hit_requests"], pc.stats["hit_tokens"]]
    out["host_argmax"] = eng.sync_stats.host_argmax
    return out


def wide_rank(rank, world, ref_dir, out):
    """The reference scripts' scenarios at ParallelPlan(1, 1, 8)."""
    cfg, model, params = _stack(ref_dir, "stablelm-1.6b", "stablelm")
    plan = ParallelPlan(*WIDE)
    L1 = FleetLayout.of(plan, [(2, 1), (2, 1), (4, 1)])

    def eng(nb=64, **kw):
        return FlyingEngine(model, plan, PoolGeometry(
            cfg, plan, num_blocks=nb, block_base=4), params,
            batch_per_engine=2, device="cpu", **kw)
    res = {"readable": [PoolGeometry(cfg, plan, num_blocks=8, block_base=4)
                        .live_readable(m) for m in (1, 2, 4)]}
    _scenario(res, "live_ref", lambda: _live_wide_ref(eng(layout=L1)))
    _scenario(res, "live", lambda: _live_wide(eng(
        layout=L1, check_zero_copy=True)))
    L_sp = FleetLayout.of(plan, [(2, 2, 2), (2, 1), (4, 1)])
    _scenario(res, "sp_ref", lambda: _sp_wide(eng(layout=L1), True))
    _scenario(res, "sp", lambda: _sp_wide(eng(
        8, layout=L_sp, check_zero_copy=True), False))
    _scenario(res, "fault_ref", lambda: _fault_ref(eng(layout=L1)))

    def faulted():
        inj = FaultInjector([FaultSpec(kind=KILL, tick=1, engines=(0,)),
                             FaultSpec(kind=REBIND_FAIL, tick=5),
                             FaultSpec(kind=DRAIN_CORRUPT, tick=7,
                                       engines=(3,))])
        return _fault_run(eng(layout=L1, injector=inj), inj)
    _scenario(res, "fault", faulted)
    U1 = FleetLayout.uniform(plan, 1)
    _scenario(res, "prefix_ref", lambda: _prefix(eng(layout=U1), False))
    _scenario(res, "prefix", lambda: _prefix(eng(
        layout=U1, check_zero_copy=True), True))
    _write_json(f"{out}.{rank}.json", res)


def _lse_view(rank, plan, merge):
    """This rank's view group at ``merge`` and its lse_merge of the
    shared random partials."""
    from repro_torch.core.communicator_pool import CommunicatorPool
    from repro_torch.core.modes import FlyingMode, Island, mode_ranks
    from repro_torch.core.views import make_serving_ctx
    pool = _lse_view.pools.setdefault(
        plan, CommunicatorPool(None, plan, None))
    seat = pool.seat(Island(0, plan.dp_engines, merge))
    grid = mode_ranks(FlyingMode(plan, merge))
    pos = tuple(int(i) for i in np.argwhere(grid == rank)[0])
    want = grid[pos[0], pos[1], :, pos[3], pos[4]].tolist()
    ctx = make_serving_ctx(merge, plan.engine_rows, plan.tp_base,
                           group=seat.comm, view_group=seat.view)
    acc, l, m = (torch.from_numpy(a[rank]) for a in lse_inputs(merge))
    n0 = seat.view.stats.collectives
    got = ctx.lse_merge(acc, l, m, view=True)
    return {"view": list(seat.view.ranks), "want_view": want,
            "tp": list(seat.comm.ranks), "out": got.tolist(),
            "collectives": seat.view.stats.collectives - n0}


_lse_view.pools = {}


def _backend(rank, plan, name):
    """One backend case on this rank: its output and pools after."""
    from repro_torch.core.communicator_pool import CommunicatorPool
    from repro_torch.core.modes import Island
    from repro_torch.core.views import make_serving_ctx
    from repro_torch.models.cache import LiveDecodeBackend, LivePrefillBackend
    c = backend_case(name)
    merge, sp = c["merge"], c["sp"]
    pool = _lse_view.pools.setdefault(
        plan, CommunicatorPool(None, plan, None))
    seat = pool.seat(Island(0, plan.dp_engines, merge))
    ctx = make_serving_ctx(merge, plan.engine_rows, plan.tp_base,
                           group=seat.comm, view_group=seat.view)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in c.items() if isinstance(v, np.ndarray)}
    kind = LiveDecodeBackend if c["phase"] == "decode" \
        else LivePrefillBackend
    segs = tuple((tag, t[f"lt{i}_bt"], t[f"lt{i}_len"], t[f"lt{i}_own"])
                 for i, tag in enumerate(c["tags"]))
    backend = kind(ctx=ctx, slots=t["slots"], segs=segs, merge=merge,
                   block_base=BB, sp=sp, write_own=t["write_own"])
    vs = (NB, BB * merge, KV_ST // merge, HD)
    kp, vp = t["kp"][rank].clone(), t["vp"][rank].clone()
    ptr = kp.data_ptr()
    o, (kpv, vpv) = backend.attend((kp.view(vs), vp.view(vs)),
                                   t["q"][rank], t["k"][rank],
                                   t["v"][rank], positions=None)
    assert kpv.data_ptr() == ptr, "the backend wrote a copy of the pool"
    return {"out": o.numpy(), "kp": kp.numpy(), "vp": vp.numpy()}


def split_rank(rank, world, ref_dir, out):
    """The scenarios at ParallelPlan(1, 2, 4): the view axis, the live
    backends, stablelm's LIVE and SP runs and a scheduler run under
    LIVE, and llama3-8b's uniform-switch scripts."""
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    plan = ParallelPlan(*SPLIT)
    res = {}
    _scenario(res, "lse", lambda: {str(m): _lse_view(rank, plan, m)
                                   for m in (2, 4)})
    arrays = {}

    def backends():
        for name, *_ in BACKEND_CASES:
            for k, v in _backend(rank, plan, name).items():
                arrays[f"{name}.{k}"] = v
        return sorted(arrays)
    _scenario(res, "backends", backends)
    np.savez(f"{out}.{rank}.npz", **arrays)

    cfg, model, params = _stack(ref_dir, "stablelm-1.6b", "stablelm")

    def eng(nb=64, **kw):
        return FlyingEngine(model, plan, PoolGeometry(
            cfg, plan, num_blocks=nb, block_base=4), params,
            batch_per_engine=2, device="cpu", **kw)
    LS = FleetLayout.of(plan, [(1, 1), (1, 1), (2, 1)])
    _scenario(res, "live_split", lambda: live_split(eng(
        layout=LS, check_zero_copy=True), Request, True))
    _scenario(res, "live_split_ref", lambda: live_split(
        eng(layout=LS), Request, False))
    _scenario(res, "sp_split", lambda: sp_split(eng(
        8, layout=FleetLayout.of(plan, [(2, 2, 2), (2, 1)]),
        check_zero_copy=True), Request, True))
    _scenario(res, "sp_split_ref", lambda: sp_split(eng(
        layout=FleetLayout.of(plan, [(2, 1), (2, 1)])), Request, False))

    def sched():
        e = eng(max_blocks_per_req=16, check_zero_copy=True)
        run = sched_live(e, lambda x: DynamicScheduler(
            plan, e.geom, FixedClock(x), SchedulerConfig(
                strategy="live", max_batch_per_group=2, prefill_chunk=8),
            policy=ScriptedMerge(4, 1 << 30)), Request)
        run["collectives"] = e.pool.stats.collectives
        return run
    _scenario(res, "sched_live", sched)

    lcfg, lmodel, lparams = _stack(ref_dir, "llama3-8b", "llama")
    lgeom = PoolGeometry(lcfg, plan, num_blocks=64, block_base=4)

    def leng(**kw):
        return FlyingEngine(lmodel, plan, lgeom, lparams,
                            batch_per_engine=2, device="cpu", **kw)
    _scenario(res, "context", lambda: _uniform_switch(
        leng(max_blocks_per_req=32), "context"))
    _scenario(res, "prefill_mixed", lambda: _prefill_switch(
        leng(max_blocks_per_req=32), True))
    _scenario(res, "prefill_seq", lambda: _prefill_switch(
        leng(max_blocks_per_req=32), False))
    _scenario(res, "hotpath", lambda: _uniform_switch(
        leng(check_zero_copy=True), "hotpath"))
    _write_json(f"{out}.{rank}.json", res)


def _uniform_phase(eng, reqs, merge, steps):
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, r.prompt_len)
    eng.prefill(reqs, merge, r.prompt_len)
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, 1)
    _decode(eng, reqs, merge, steps)
    for r in reqs:
        eng.adaptors[r.engine_group].release(r.req_id)


def _uniform_switch(eng, what: str):
    """check_context_attention.run / check_hotpath.run: merge 1 -> 2 -> 1
    uniform switches, 8-token prompts, the requests released before each
    switch."""
    def reqs(tag, groups, per):
        return [_req(Request, g, f"{tag}{g}_{i}", 8) for g in groups
                for i in range(per)]
    n = eng.plan.dp_engines
    a = reqs("a", range(n), eng.bpe)
    _uniform_phase(eng, a, 1, 6)
    eng.switch(1, 2)
    b = reqs("b", range(0, n, 2), eng.bpe * 2)
    _uniform_phase(eng, b, 2, 6)
    eng.switch(2, 1)
    c = reqs("c", range(n), eng.bpe)
    _uniform_phase(eng, c, 1, 4)
    out = {"toks": {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
                    for r in a + b + c},
           "host_argmax": eng.sync_stats.host_argmax}
    if what == "context":
        out["mbs"] = sorted({(k[0], k[6]) for k in eng.pool._runners
                             if k[1] == "decode"})
    return out


def _prefill_switch(eng, use_mixed: bool):
    """check_prefill_attention.run: mixed (or sequential) prefill ticks
    at merge 1, a switch to 2, the same at merge 2, a switch back."""
    CH = 8

    def launch(pre, dec, merge):
        if use_mixed and pre and dec:
            eng.mixed(pre, dec, merge, CH)
            return
        if pre:
            eng.prefill(pre, merge, CH)
        if dec:
            eng.decode(dec, merge)

    def phase(merge, groups, steps=4):
        ad = eng.adaptors
        per = eng.bpe * merge // 2 or 1
        A = [_req(Request, g, f"a{merge}{g}_{i}", CH) for g in groups
             for i in range(per)]
        B = [_req(Request, g, f"b{merge}{g}_{i}", 2 * CH) for g in groups
             for i in range(per)]
        for r in A:
            ad[r.engine_group].append_slots(r.req_id, CH)
            ad[r.engine_group].append_slots(r.req_id, 1)
        launch(A, [], merge)
        for r in A:
            r.prefilled = CH
        for r in B:
            ad[r.engine_group].append_slots(r.req_id, CH)
        launch(B, A, merge)
        for r in B:
            r.prefilled = CH
        for r in A:
            ad[r.engine_group].append_slots(r.req_id, 1)
        for r in B:
            ad[r.engine_group].append_slots(r.req_id, CH)
            ad[r.engine_group].append_slots(r.req_id, 1)
        launch(B, A + B, merge)
        for r in B:
            r.prefilled = 2 * CH
        for r in A + B:
            ad[r.engine_group].append_slots(r.req_id, 1)
        _decode(eng, A + B, merge, steps)
        for r in A + B:
            ad[r.engine_group].release(r.req_id)
        return A + B
    n = eng.plan.dp_engines
    reqs = phase(1, range(n))
    eng.switch(1, 2)
    reqs += phase(2, range(0, n, 2))
    eng.switch(2, 1)
    return {"toks": {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
                     for r in reqs},
            "host_argmax": eng.sync_stats.host_argmax,
            "mixed_merges": sorted({k[0] for k in eng.pool._runners
                                    if k[1] == "mixed"})}


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The JAX side, started in the background: the port's ranks need
    only its weights, which it writes first, so the two sides run at
    once."""
    out = tmp_path_factory.mktemp("jax_live")
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
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
def port(jax_side, tmp_path_factory):
    """Both plans' ranks, once the JAX side has written the weights."""
    proc, ref_dir = jax_side
    deadline = time.monotonic() + 300
    while not (ref_dir / "params.ready").exists():
        assert proc.poll() is None, _jax_failed(proc, ref_dir)
        assert time.monotonic() < deadline, "no weights from the JAX side"
        time.sleep(0.2)
    d = tmp_path_factory.mktemp("port")
    _spawn(wide_rank, 8, str(ref_dir), str(d / "wide"))
    _spawn(split_rank, 8, str(ref_dir), str(d / "split"))
    return {"wide": _ranks(str(d / "wide")),
            "split": (_ranks(str(d / "split")), str(d / "split"))}


@pytest.fixture(scope="module")
def ref(jax_side):
    """The JAX side's results, once it has finished."""
    proc, out = jax_side
    proc.wait(timeout=900)
    assert proc.returncode == 0, _jax_failed(proc, out)
    return {"dir": str(out), **_read_json(out / "ref.json")}


@pytest.fixture(scope="module")
def wide(port):
    return port["wide"]


@pytest.fixture(scope="module")
def split(port):
    return port["split"]


def _spawn(fn, world, *args):
    spawn(fn, world, args, device_type="cpu", timeout=SPAWN_S,
          threads=1)


def _ranks(out, world=8):
    return [_read_json(f"{out}.{r}.json") for r in range(world)]


def _same_on_every_rank(runs, key):
    got = runs[0][key]
    assert "error" not in got, got["error"]
    for r, res in enumerate(runs[1:], 1):
        assert res[key] == got, (key, r)
    return got


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("merge", [2, 4])
def test_lse_merge_over_the_view_axis(split, ref, merge):
    """At ParallelPlan(1, 2, 4) a rank's view group is the half of its TP
    group at its storage rank (the JAX mode mesh's merge axis), built at
    construction; random partials, some heads absent on some ranks,
    merge over it to the JAX ``lse_merge(axes=view_axes)`` within 1e-6
    with 3 collectives."""
    runs, _ = split
    want = np.load(os.path.join(ref["dir"], "lse.npz"))[str(merge)]
    for rank, res in enumerate(runs):
        got = res["lse"]
        assert "error" not in got, got["error"]
        got = got[str(merge)]
        assert got["view"] == got["want_view"] and len(got["view"]) == merge
        assert set(got["view"]) < set(got["tp"]) and rank in got["view"]
        assert got["collectives"] == 3
        np.testing.assert_allclose(np.asarray(got["out"]), want[rank],
                                   rtol=LSE_TOL, atol=LSE_TOL)


@pytest.mark.parametrize("name", [c[0] for c in BACKEND_CASES])
def test_live_backends_match_jax(split, ref, name):
    """LiveDecodeBackend and LivePrefillBackend on random pools: segment
    tables of 1-3 tags (or 2-4 SP lanes), random owner offsets, empty
    lanes and a padding row, on every rank of one TP group of 8: the
    outputs within 1e-5 of the JAX backends', the pools after the write
    (the SP write with parking included) equal bit for bit outside the
    reserved block, written in place."""
    runs, out = split
    assert "error" not in runs[0]["backends"], runs[0]["backends"]["error"]
    want = np.load(os.path.join(ref["dir"], "backends.npz"))
    case = backend_case(name)
    for rank in range(8):
        got = np.load(f"{out}.{rank}.npz")
        np.testing.assert_allclose(got[f"{name}.out"], want[f"{name}.out"]
                                   [rank], rtol=BACKEND_TOL,
                                   atol=BACKEND_TOL)
        for pool in ("kp", "vp"):
            g, w = got[f"{name}.{pool}"], want[f"{name}.{pool}"][rank]
            assert np.array_equal(g[:NB - 1], w[:NB - 1]), (rank, pool)
            # the write landed: some block changed on some rank
            moved = not np.array_equal(g[:NB - 1], case[pool][rank][:NB - 1])
            if rank == 0:
                assert moved or case["sp"] > 1, (name, pool)


def test_live_switch_matches_jax(wide, ref):
    """check_live_switch.py at 8 engines: [2xDP|2xDP|4xDP] -> [TP2|2xDP|
    4xDP] -> [TP4|4xDP] with decode riders of tags (1, 2, 4) and (1, 4)
    and a chunked prefill across both rebinds: every stream equals the
    JAX run's and the port's never-switched reference, the untouched
    island never drains, no host argmax, runner keys the JAX run's."""
    live = _same_on_every_rank(wide, "live")
    plain = _same_on_every_rank(wide, "live_ref")
    assert wide[0]["readable"] == [True, True, True]
    assert live["tags"] == {"r0": [1, 2, 4], "r2": [1, 4], "lp": [1, 2, 4]}
    assert live["toks"] == plain == ref["live"]["toks"]
    assert live["bg_drains"] == 0 == ref["live"]["bg_drains"]
    assert live["host_argmax"] == 0
    assert live["keys"] == ref["live"]["keys"]
    assert any("(1, 2, 4)" in k for k in live["keys"])


def test_live_split_matches_jax(split, ref):
    """A LIVE DP -> TP2 rebind where each engine has two ranks (the view
    group half the TP group): a decode rider and a chunked-prefill rider
    of tags (1, 2), token-identical to the JAX run and to the
    never-switched reference; the DP island never drains."""
    runs, _ = split
    live = _same_on_every_rank(runs, "live_split")
    plain = _same_on_every_rank(runs, "live_split_ref")
    assert live["tags"] == {"r0": [1, 2], "lp": [1, 2]}
    assert live["toks"] == plain["toks"] == ref["live_split"]["toks"]
    assert live["bg_drains"] == 0 and live["host_argmax"] == 0
    assert live["keys"] == ref["live_split"]["keys"]


def test_seq_parallel_matches_jax(wide, ref):
    """check_seq_parallel.py at 8 engines: a 57-token context over pools
    of 28 tokens on a pure-SP island, a LIVE SP2 -> SP4 rebind
    mid-decode, blocks round-robin over the shards as the JAX adaptor
    places them, tokens equal to the JAX run's and to the big-pool
    merge-1 reference's; the untouched island never drains."""
    sp = _same_on_every_rank(wide, "sp")
    plain = _same_on_every_rank(wide, "sp_ref")
    assert sp["context"] > sp["one_pool"]
    assert sp["shards2"] == [0, 1]
    assert sp["blocks_per_shard"] == ref["sp"]["blocks_per_shard"]
    assert set(sp["blocks_per_shard"]) & {"2", "3"}
    assert max(sp["blocks_per_shard"].values()) < 8
    assert sp["toks"] == plain["toks"] == ref["sp"]["toks"]
    assert sp["bg_drains"] == 0 and sp["host_argmax"] == 0


def test_seq_parallel_split_matches_jax(split, ref):
    """An SP2 island where each engine has two ranks: a context over one
    engine's pool, blocks placed as the JAX adaptor places them, tokens
    equal to the JAX run's and the big-pool reference's."""
    runs, _ = split
    sp = _same_on_every_rank(runs, "sp_split")
    plain = _same_on_every_rank(runs, "sp_split_ref")
    assert sp["context"] > sp["one_pool"]
    assert sp["shards"] == ref["sp_split"]["shards"]
    assert {s for s, _ in sp["shards"]} == {0, 1}
    assert sp["toks"] == plain["toks"] == ref["sp_split"]["toks"]
    assert sp["bg_drains"] == 0 and sp["host_argmax"] == 0


def test_fault_recovery_matches_jax(wide, ref):
    """check_fault_recovery.py: KILL of engine 0 mid-decode raises
    EngineFault naming it, the request keeps the 4 harvested tokens, no
    block leaks, the quarantine rebind leaves the survivor island
    undrained; recovered and untouched streams equal the fault-free ones
    and the JAX run's; REBIND_FAIL and DRAIN_CORRUPT (naming engine 3)
    leave the layout unchanged and the next rebind succeeds."""
    got = _same_on_every_rank(wide, "fault")
    plain = _same_on_every_rank(wide, "fault_ref")
    assert got["fault"] == [0]
    assert got["kept"] == 4 == ref["fault"]["kept"]
    assert got["leaked"] == 0
    assert got["bg_drains"] == 0 == ref["fault"]["bg_drains"]
    assert got["toks"] == plain == ref["fault"]["toks"]
    assert got["transition"] == [[5, []], [7, [3]]]
    assert got["after"] and got["layout"] == ref["fault"]["layout"]
    assert got["host_argmax"] == 0


def test_prefix_cache_attached_across_a_live_rebind(wide, ref):
    """check_prefix_cache.py: a prefix committed under DP attached after
    a LIVE DP -> TP4 rebind (tags (1, 4), 8 tokens from shared blocks),
    token-identical to the uncached run and to the JAX runs."""
    got = _same_on_every_rank(wide, "prefix")
    plain = _same_on_every_rank(wide, "prefix_ref")
    assert got["attached"] == 8 and got["tags"] == [1, 4]
    assert got["hits"] == [1, 8]
    assert got["toks"] == plain["toks"] == ref["prefix"]
    assert got["host_argmax"] == 0


def test_scheduler_live_matches_jax(split, ref):
    """A scheduler trace under LIVE with the merge scripted 1 -> 2 while
    decodes and a chunked prefill are in flight (the reduced
    stablelm-1.6b, tags 1 and 2 readable at two ranks an engine): every
    request done, riders carried with nothing paused or recomputed, and
    streams, phase logs, layouts, preempt_stats and runner keys equal to
    the JAX package's, the same on every rank."""
    runs, _ = split
    got = runs[0]["sched_live"]
    assert "error" not in got, got["error"]
    assert all({**r["sched_live"], "collectives": 0} ==
               {**got, "collectives": 0} for r in runs[1:])
    want = ref["sched_live"]
    assert len(got["done"]) == 8
    for k in ("done", "toks", "phases", "layouts", "switches", "preempt",
              "keys", "host_argmax"):
        assert got[k] == want[k], k
    p = got["preempt"]
    assert p["live_riders"] > 0 and p["paused"] == 0 \
        and p["recomputed_tokens"] == 0, p
    assert any("(1, 2)" in k for k in got["keys"])


@pytest.mark.parametrize("what", ["context", "prefill_mixed",
                                  "prefill_seq", "hotpath"])
def test_uniform_switch_scripts_match_jax(split, ref, what):
    """check_context_attention.py, check_prefill_attention.py (mixed and
    sequential ticks) and check_hotpath.py with the reduced llama3-8b:
    tokens equal to the JAX package's across merge 1 -> 2 -> 1, the
    mixed and sequential runs equal, no host argmax; decode tables
    bucketed below the configured 32 blocks."""
    runs, _ = split
    got = _same_on_every_rank(runs, what)
    want = ref["prefill" if what.startswith("prefill") else what]
    assert got["toks"] == want
    assert all(len(v) >= 5 for v in got["toks"].values())
    assert got["host_argmax"] == 0
    if what == "context":
        assert {m for m, _ in got["mbs"]} == {1, 2}
        assert all(mb <= 4 for _, mb in got["mbs"])
    if what == "prefill_mixed":
        assert got["mixed_merges"] == [1, 2]



def test_launcher_serves_live_through_a_kill():
    """``launch.serve --ranks 8 --tp-base 2 --strategy live --fault
    kill@4:1`` on the CPU: every request done, engine 1 quarantined at
    tick 4 and its request recovered, the quarantine and the incidents
    printed by rank 0 alone, no host argmax.

    ``--step-seconds 0.01`` makes every step and rebind report 10 ms to
    the scheduler, so the schedule is a function of the trace alone and
    not of the host's speed. Without it the island clocks advance by the
    measured step times: each tick moves the scheduler's clock to the
    earliest island clock and launches only the islands due by then, so
    under load engine 1's island could be mid-step at tick 4 (the fault
    then surfaced at a later tick), and with the default phased arrivals
    a slow tick also lets later requests arrive before tick 4. With the
    fixed clock, req0 (a priority request of 12 prompt tokens and 4 out,
    arriving at 0.26 s, 0.37 s before req1, which is 37 ticks of 10 ms)
    is bound alone to a TP2 island over engines 0 and 1 and needs two
    prefill chunks and three decode steps, so at tick 4 it is on engine
    1 and still running however fast the host is."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--dtype", "float32", "--ranks", "8",
         "--tp-base", "2", "--strategy", "live", "--fault", "kill@4:1",
         "--requests", "8", "--num-blocks", "64", "--block-base", "4",
         "--batch-per-engine", "2", "--prompt-range", "8", "24",
         "--output-range", "4", "8", "--prefill-chunk", "8",
         "--max-blocks-per-req", "16", "--priority-frac", "0.25",
         "--step-seconds", "0.01"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout
    assert "strategy=live" in out
    assert out.count("requests done : 8/8") == 1
    assert "quarantined   : [1]" in out
    assert "tick=4 engine_fault: {'engines': [1]}" in out
    assert "tick=4 quarantine: {'engines': [1]}" in out
    assert "recover: {'req'" in out and "'why': 'quarantine'" in out
    assert "host_argmax=0" in out

if __name__ == "__main__":
    reference_main(sys.argv[1])
