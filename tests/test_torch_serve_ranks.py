"""``--serve`` on several ranks, on the CPU: rank 0's ``AsyncServeLoop``
leads and every other rank's ``lockstep.Follower`` replays its inputs.

One process per rank over gloo (``repro_torch.launch.ranks.spawn``, one
torch thread a rank, ``PYTHONHASHSEED=0``, a join deadline a spawn).

(a) Against the JAX package: its ``AsyncServeLoop(pace="virtual")`` over
its ``FlyingEngine`` at the geometry of ``src/repro/launch/serve.py``'s
``--real`` stack (``ParallelPlan(1, 2, 4)``, the reduced llama3-8b in
fp32, 64 blocks of base 4, batch 2 per engine, prefill chunks of 8,
``FlyingPolicy``, ``chip_smoke.FixedClock``'s 10 ms a step, tokens
harvested every 4 steps as ``--serve`` does), run as this file's
``__main__`` with 8 forced host devices (``AbstractMesh`` patched as in
``tests/test_torch_islands.py``, nothing else); the port on 8 ranks with
rank 0 leading in process. The same fixed trace (10 requests, 3 of them
priority, so that the policy carves a TP island and releases it; one
request cancelled by its client after its first streamed token:
``chip_smoke.LOCKSTEP_TRACE``, which phase 20 (a) serves on the card) under
HARD, LIVE and HARD with a scripted KILL. Held: every stream and
terminal state, and on every rank the phase log, layouts, switches,
``preempt_stats``, runner keys and the adaptors after the cancel and at
the end, equal to the JAX run's; every rank's digest rank 0's.

(b) The §D13 contract on 4 ranks: the virtual-pace loop's fingerprint
(schedule, request timestamps, tokens, TP collectives) equals
``replay(cfg, frontdoor=door)``'s of the same trace on the same ranks.
(d) In that loop the followers run with their serving layer's clocks
patched to raise, and rank 0 idles parked long enough to send
heartbeats.

(c) The launcher over sockets: ``python -m repro_torch.launch.serve
--serve --ranks 4`` on the CPU, driven by ``loadgen.drive_http``;
completed streams equal each request's greedy tokens served alone on
one rank; ``/metrics`` reports the fleet's layout; SIGINT stops every
rank with exit 0; a follower killed mid-run fails the launcher.

(e) mamba2-2.7b, reduced, over the loop on 2 ranks: each stream equals
the JAX package's step level for its request alone at batch 1. Then, on
the same ranks, a follower that drops one submission raises, naming its
rank and the tick of that submission.
"""
import asyncio
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.engine import FlyingEngine
from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import ParallelPlan
from repro_torch.core.policy import FlyingPolicy
from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
from repro_torch.core.task_pool import Request
from repro_torch.launch.ranks import spawn
from repro_torch.launch.serve import ServeConfig, build_door
from repro_torch.serving.asyncloop import AsyncServeLoop
from repro_torch.serving.lockstep import Follower, digest
from test_torch_islands import (FixedClock, _key_text, _read_json, _stack,
                                _write_json)
# phase 20 (a)'s trace: two priority requests among the first six carve a
# TP island, a burst of seven queues deep enough to dissolve it, a late
# priority request carves it again; the client of CANCEL leaves after
# its first token
from chip_smoke import LOCKSTEP_CANCEL as CANCEL  # noqa: E402
from chip_smoke import LOCKSTEP_TRACE as TRACE  # noqa: E402
from chip_smoke import adaptor_state as _adaptors  # noqa: E402
from chip_smoke import lockstep_drive as _drive  # noqa: E402
from chip_smoke import lockstep_requests as _trace  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PLAN = (1, 2, 4)            # engine_rows, tp_base, data_rows: 8 ranks
BPE, CHUNK, NUM_BLOCKS, BLOCK_BASE, MAX_BLOCKS, HARVEST = 2, 8, 64, 4, 16, 4
# (strategy, scripted KILL (tick, engine) or None) of each run
RUNS = {"hard": ("hard", None), "live": ("live", None),
        "kill": ("hard", (12, 3))}
SPAWN_S = 240.0


def _record(sched, eng, streams, snap):
    return {"streams": streams, "snap": snap, "end": _adaptors(sched),
            "phases": [l.phase for l in sched.log],
            "layouts": [[l.merge, l.switched, [list(i) for i in l.islands]]
                        for l in sched.log],
            "switches": sched.switches,
            "preempt": dict(sched.preempt_stats),
            "keys": _key_text(eng.pool._runners)}


# ---------------------------------------------------------------------------
# the JAX side: ``python tests/test_torch_serve_ranks.py OUT_DIR``
# ---------------------------------------------------------------------------

def reference_main(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.core.engine import FlyingEngine as JEngine
    from repro.core.faults import KILL, FaultInjector, FaultSpec
    from repro.core.kv_adaptor import PoolGeometry as JGeometry
    from repro.core.modes import ParallelPlan as JPlan
    from repro.core.policy import FlyingPolicy as JPolicy
    from repro.core.scheduler import DynamicScheduler as JScheduler
    from repro.core.scheduler import SchedulerConfig as JSConfig
    from repro.core.task_pool import Request as JRequest
    from repro.launch.serve import ServeConfig as JServeConfig
    from repro.launch.serve import build_door as jbuild_door
    from repro.models.model import build_model
    from repro.serving.asyncloop import AsyncServeLoop as JLoop

    class PairMesh(jax.sharding.AbstractMesh):
        def __init__(self, axis_sizes, axis_names=None, *a, **kw):
            if axis_names is None:
                axis_names = tuple(n for n, _ in axis_sizes)
                axis_sizes = tuple(s for _, s in axis_sizes)
            super().__init__(axis_sizes, axis_names, *a, **kw)
    jax.sharding.AbstractMesh = PairMesh

    cfg = jget("llama3-8b").reduced()
    model = build_model(cfg, jnp.float32)
    params = model.init(jax.random.key(0))
    # written first, whole, for the port's ranks to start from
    np.savez(os.path.join(out, "params.part.npz"),
             *[np.asarray(a) for a in jax.tree.leaves(params)])
    os.replace(os.path.join(out, "params.part.npz"),
               os.path.join(out, "params.npz"))
    plan = JPlan(*PLAN)
    geom = JGeometry(cfg, plan, num_blocks=NUM_BLOCKS, block_base=BLOCK_BASE)
    runners = _Runners()
    runs = {}
    for name, (strategy, kill) in RUNS.items():
        inj = FaultInjector([FaultSpec(kind=KILL, tick=kill[0],
                                       engines=(kill[1],))]) \
            if kill else None
        eng = JEngine(model, plan, geom, params, batch_per_engine=BPE,
                      max_blocks_per_req=MAX_BLOCKS, prefill_len=CHUNK,
                      harvest_limit=HARVEST, injector=inj)
        # the runs share their jitted steps (keyed by island shape,
        # traced over an AbstractMesh): each compiles once
        runners.used = set()
        eng.pool._runners = runners
        sched = JScheduler(plan, geom, FixedClock(eng), JSConfig(
            strategy=strategy, max_batch_per_group=BPE,
            prefill_chunk=CHUNK), policy=JPolicy())
        door = jbuild_door(JServeConfig(), sched)
        loop = JLoop(door, pace="virtual")
        snap = {}
        streams = asyncio.run(_drive(loop, _trace(JRequest), snap))
        door.shutdown()
        runs[name] = {**_record(sched, eng, streams, snap),
                      "keys": _key_text(runners.used)}
    _write_json(os.path.join(out, "loop.json"), runs)


class _Runners(dict):
    """A runner cache that records the keys each run looks up."""

    used: set

    def __contains__(self, key):
        self.used.add(key)
        return super().__contains__(key)


# ---------------------------------------------------------------------------
# the port's ranks (module-level: the spawned children import them)
# ---------------------------------------------------------------------------

class _Follower(Follower):
    """A follower that takes the adaptors right after it applies
    CANCEL's abort, as rank 0's client does."""

    def __init__(self, door, pool):
        super().__init__(door, pool)
        self.snap = {}

    def _apply(self, ev):
        super()._apply(ev)
        if ev[0] == "cancel" and ev[1] == CANCEL:
            self.snap["cancel"] = _adaptors(self.door.sched)


def fleet_rank(rank, world, ref_dir, out):
    """(a): each run of RUNS through the leader (rank 0) or a follower."""
    from repro_torch.core.faults import KILL, FaultInjector, FaultSpec
    cfg, model, params, plan = _stack(ref_dir, PLAN)
    geom = PoolGeometry(cfg, plan, num_blocks=NUM_BLOCKS,
                        block_base=BLOCK_BASE)
    res = {}
    for name, (strategy, kill) in RUNS.items():
        inj = FaultInjector([FaultSpec(kind=KILL, tick=kill[0],
                                       engines=(kill[1],))]) \
            if kill else None
        eng = FlyingEngine(model, plan, geom, params, batch_per_engine=BPE,
                           max_blocks_per_req=MAX_BLOCKS, device="cpu",
                           harvest_limit=HARVEST, injector=inj)
        sched = DynamicScheduler(plan, geom, FixedClock(eng),
                                 SchedulerConfig(
            strategy=strategy, max_batch_per_group=BPE,
            prefill_chunk=CHUNK), policy=FlyingPolicy())
        door = build_door(ServeConfig(), sched)
        if rank == 0:
            loop = AsyncServeLoop(door, pace="virtual", pool=eng.pool)
            snap = {}
            streams = asyncio.run(_drive(loop, _trace(Request), snap))
            loop.shutdown()
            ticks = loop.ticks
        else:
            f = _Follower(door, eng.pool)
            f.run()
            snap, ticks = f.snap, f.ticks
            streams = {rid: [list(map(int, eng.generated_tokens(rid))),
                             r.state] for rid, r in door.requests.items()}
        res[name] = {**_record(sched, eng, streams, snap),
                     "digest": digest(door, ticks)}
    _write_json(f"{out}.{rank}.json", res)


def _no_clocks():
    """Make every clock the serving layer could read raise in this
    process: ``time.perf_counter``, ``time.monotonic`` and ``time.time``
    when called from a ``repro_torch.serving`` module (the engine's step
    timer, whose readings every rank agrees on through ``host_max``,
    and the pool's own statistics keep theirs), and the event loop's
    clock everywhere. Returns a probe that must raise."""
    import asyncio.base_events

    def guard(fn, name):
        def clock():
            caller = sys._getframe(1).f_globals.get("__name__", "")
            if caller.startswith("repro_torch.serving"):
                raise AssertionError(f"{caller} read time.{name}")
            return fn()
        return clock

    for name in ("perf_counter", "monotonic", "time"):
        setattr(time, name, guard(getattr(time, name), name))

    def loop_time(self):
        raise AssertionError("a follower read the event loop's clock")
    asyncio.base_events.BaseEventLoop.time = loop_time
    probe = {"__name__": "repro_torch.serving.probe", "time": time}
    exec("def probe():\n    return time.perf_counter()\n", probe)
    return probe["probe"]


def _fingerprint(door, tokens):
    sched, eng = door.sched, door.sched.backend
    return {"phases": [l.phase for l in sched.log],
            "layouts": [[l.merge, [list(i) for i in l.islands]]
                        for l in sched.log],
            "switches": sched.switches,
            "preempt": dict(sched.preempt_stats),
            "lifecycle": dict(sched.lifecycle),
            "requests": {rid: [r.state, r.generated, r.arrival,
                               r.first_token_t, r.finish_t]
                         for rid, r in door.requests.items()},
            "tokens": tokens,
            "tp_collectives": eng.pool.stats.collectives,
            "keys": _key_text(eng.pool._runners)}


def contract_cfg():
    return ServeConfig(
        reduced=True, device="cpu", dtype="float32", ranks=4, tp_base=2,
        requests=10, num_blocks=NUM_BLOCKS, block_base=BLOCK_BASE,
        batch_per_engine=BPE, max_blocks_per_req=MAX_BLOCKS,
        prefill_chunk=CHUNK, prompt_range=(8, 24), output_range=(4, 8),
        priority_frac=0.25, arrival="poisson", rate=50.0,
        step_seconds=0.01, serve=True, pace="virtual")


def contract_rank(rank, world, out):
    """(b) and (d): the loop over the launcher's stack (the followers'
    clocks patched to raise; rank 0 parked for 0.5 s of heartbeats at
    20 a second once the trace is done), then the trace replayed
    through a fresh stack's front door."""
    import copy

    from repro_torch.launch.serve import build_loop, build_stack, replay
    from repro_torch.serving.loadgen import drive_inprocess
    from repro_torch.serving.workload import generate
    cfg = contract_cfg()
    sched, spec, _ = build_stack(cfg)
    door = build_door(cfg, sched)
    res = {}
    if rank == 0:
        loop = build_loop(cfg, door)
        loop.heartbeat_s = 0.05

        async def run():
            await loop.start()
            got = await drive_inprocess(
                loop, [copy.deepcopy(r) for r in generate(spec)],
                collect_tokens=True, start=False)
            await asyncio.sleep(0.5)
            await loop.stop()
            return got

        got = asyncio.run(run())
        loop.shutdown()
        tokens = {rec["req_id"]: rec["tokens"] for rec in got["records"]}
        res["broadcasts"] = sched.backend.pool.stats.broadcasts
    else:
        probe = _no_clocks()
        try:
            probe()
            res["probe"] = "did not raise"
        except AssertionError as e:
            res["probe"] = str(e)
        f = Follower(door, sched.backend.pool)
        f.run()
        res["actions"] = f.actions
        tokens = {rid: list(map(int, sched.backend.generated_tokens(rid)))
                  for rid in door.requests}
    res["loop"] = _fingerprint(door, tokens)
    stack = build_stack(cfg)
    rdoor = build_door(cfg, stack[0])
    replay(cfg, stack, rdoor)
    res["replay"] = _fingerprint(rdoor, {
        rid: list(map(int, stack[0].backend.generated_tokens(rid)))
        for rid in rdoor.requests})
    _write_json(f"{out}.{rank}.json", res)


# (e): (prompt, output) of the mamba2-2.7b requests, chunks of 32
RECURRENT = ((24, 6), (56, 9), (40, 5), (72, 7))


class _Dropping(Follower):
    """A follower whose input diverges: it drops the submission of
    ``late``."""

    def _apply(self, ev):
        if ev[0] == "submit" and ev[1].req_id == "late":
            return
        super()._apply(ev)


def recurrent_rank(rank, world, params_path, out):
    """(e): mamba2-2.7b's requests through the loop at ParallelPlan(1, 1,
    2); then a run whose follower drops the request ``late``, which
    rank 0 submits once the first token of ``m0`` streams (the tick of
    that submission written to ``{out}.late``)."""
    from repro_torch.core.task_pool import prompt_token_ids
    from repro_torch.models.model import Model
    cfg, params = torch.load(params_path, weights_only=False)
    model = Model(cfg, torch.float32, torch.device("cpu"))
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    geom = PoolGeometry(cfg, plan, num_blocks=128, block_base=BLOCK_BASE)

    def stack():
        eng = FlyingEngine(model, plan, geom, params, batch_per_engine=BPE,
                           max_blocks_per_req=32, device="cpu",
                           harvest_limit=HARVEST)
        sched = DynamicScheduler(plan, geom, FixedClock(eng),
                                 SchedulerConfig(
            strategy="hard", max_batch_per_group=BPE, prefill_chunk=32),
            policy=FlyingPolicy())
        return eng, build_door(ServeConfig(), sched)

    reqs = [Request(req_id=f"m{i}", arrival=0.0, prompt_len=p, output_len=o)
            for i, (p, o) in enumerate(RECURRENT)]
    eng, door = stack()
    if rank == 0:
        loop = AsyncServeLoop(door, pace="virtual", pool=eng.pool)
        streams = asyncio.run(_drive(loop, reqs, {}))
        loop.shutdown()
        _write_json(f"{out}.json", {
            "streams": streams,
            "prompts": {r.req_id: prompt_token_ids(
                r, cfg.vocab_size).tolist() for r in reqs}})
    else:
        Follower(door, eng.pool).run()

    eng, door = stack()
    if rank == 0:
        loop = AsyncServeLoop(door, pace="virtual", pool=eng.pool)

        async def run():
            await loop.start()
            st = loop.submit(Request(req_id="m0", arrival=0.0,
                                     prompt_len=24, output_len=8))
            late = None
            async for _ in st:
                if late is None:
                    Path(f"{out}.late").write_text(str(loop.ticks))
                    late = loop.submit(Request(
                        req_id="late", arrival=0.0, prompt_len=16,
                        output_len=4))
            await late.collect()
            await loop.stop()

        asyncio.run(run())
        loop.shutdown()
    else:
        _Dropping(door, eng.pool).run()


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _spawn(fn, world, *args):
    spawn(fn, world, args, device_type="cpu", timeout=SPAWN_S, threads=1)


def _env(**kw):
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests"),
         os.environ.get("PYTHONPATH", "")]), **kw)


@pytest.fixture(scope="module", autouse=True)
def jax_side(tmp_path_factory):
    """The JAX side (one subprocess), started with the module so that it
    runs beside the port's spawns; (a)'s tests come last."""
    out = tmp_path_factory.mktemp("jax_serve")
    err = open(out / "stderr.txt", "w")
    proc = subprocess.Popen([sys.executable, __file__, str(out)],
                            env=_env(PYTHONHASHSEED="0",
                                     JAX_PLATFORMS="cpu"),
                            stdout=subprocess.DEVNULL, stderr=err)
    yield out, proc
    proc.kill()
    proc.wait()
    err.close()


def _jax_failed(out, proc):
    return f"the JAX side exited {proc.returncode}: " \
        f"{(out / 'stderr.txt').read_text()[-4000:]}"


@pytest.fixture(scope="module")
def fleet(jax_side, tmp_path_factory):
    """The port's 8 ranks, from the JAX side's parameters as soon as it
    has written them."""
    out, proc = jax_side
    t_end = time.monotonic() + 300
    while not (out / "params.npz").exists():
        assert proc.poll() is None and time.monotonic() < t_end, \
            _jax_failed(out, proc)
        time.sleep(0.2)
    res = str(tmp_path_factory.mktemp("fleet") / "fleet")
    _spawn(fleet_rank, 8, str(out), res)
    return [_read_json(f"{res}.{r}.json") for r in range(8)]


@pytest.fixture(scope="module")
def ref_dir(jax_side, fleet):
    out, proc = jax_side
    assert proc.wait(timeout=600) == 0, _jax_failed(out, proc)
    return str(out)


@pytest.fixture(scope="module")
def contract(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("contract") / "contract")
    _spawn(contract_rank, 4, out)
    return [_read_json(f"{out}.{r}.json") for r in range(4)]


# ---------------------------------------------------------------------------
# (b) the §D13 contract on ranks, (d) followers read no clock
# ---------------------------------------------------------------------------

def test_loop_fingerprint_equals_the_replay_on_ranks(contract):
    """On each of 4 ranks the virtual-pace loop schedules, stamps and
    streams exactly as ``replay(cfg, frontdoor=door)``; the loop adds
    its broadcasts (and the stream pump), nothing else."""
    for rank, res in enumerate(contract):
        assert res["loop"] == res["replay"], rank
        assert res["loop"] == contract[0]["loop"] or \
            {**res["loop"], "tp_collectives": 0} == \
            {**contract[0]["loop"], "tp_collectives": 0}
    fp = contract[0]["loop"]
    assert all(s == "done" for s, *_ in fp["requests"].values())
    assert fp["switches"] > 0
    assert contract[0]["broadcasts"] == sum(contract[1]["actions"].values())


def test_followers_read_no_clock_and_survive_idle(contract):
    """Each follower ran its whole trace with its serving layer's clocks
    patched to raise (the probe shows the patch live), and took the
    heartbeats that rank 0 sent while parked."""
    for res in contract[1:]:
        assert res["probe"].endswith("read time.perf_counter")
        assert res["actions"]["beat"] >= 2
        assert res["actions"]["tick"] > 0 and res["actions"]["end"] == 1


# ---------------------------------------------------------------------------
# (c) the launcher over sockets
# ---------------------------------------------------------------------------

LAUNCH = ["--serve", "--ranks", "4", "--tp-base", "2", "--device", "cpu",
          "--reduced", "--dtype", "float32", "--port", "0", "--pace",
          "wall", "--num-blocks", "64", "--block-base", "4",
          "--batch-per-engine", "2", "--prefill-chunk", "8",
          "--max-blocks-per-req", "16"]
DEADLINE = 60.0


def _launch():
    """The launcher on 4 CPU ranks; returns (process, rank pids, port)."""
    import tempfile
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH],
        env=_env(PYTHONHASHSEED="0"), stdout=subprocess.PIPE, stderr=err,
        text=True)
    pids = port = None
    t_end = time.monotonic() + 120
    while port is None:
        line = proc.stdout.readline()
        if not line or time.monotonic() > t_end:
            proc.kill()
            err.seek(0)
            raise AssertionError(err.read()[-3000:])
        if line.startswith("rank pids"):
            pids = json.loads(line.split("rank pids", 1)[1])
        elif line.startswith("serving on http://127.0.0.1:"):
            port = int(line.split(":")[2].split()[0])
    return proc, pids, port


async def _leaver(port):
    """A client that reads its first token and disconnects."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    body = json.dumps({"prompt_tokens": 10, "max_tokens": 40,
                       "stream": True}).encode()
    writer.write(b"POST /v1/completions HTTP/1.1\r\nHost: t\r\n"
                 + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    await writer.drain()
    while b'"token"' not in await reader.readline():
        pass
    writer.close()


async def _get(port, path):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])


def alone_rank(rank, world, reqs, out):
    """Each request served alone on one rank, greedy."""
    from repro_torch.launch.serve import build_stack, parse_config
    cfg = parse_config(LAUNCH[5:])          # --serve --ranks 4 --tp-base 2
    sched, _, _ = build_stack(cfg)
    toks = {}
    for rid, p, o in reqs:
        sched.submit(Request(req_id=rid, arrival=sched.now, prompt_len=p,
                             output_len=o))
        sched.run()
        toks[rid] = list(map(int, sched.backend.generated_tokens(rid)))
    _write_json(out, toks)


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """One launcher run: 8 requests over drive_http (3 priority) beside a
    client that leaves after its first token, then /metrics, then
    SIGINT; and a second launcher whose follower is killed mid-run."""
    from repro_torch.serving.loadgen import drive_http
    proc, pids, port = _launch()
    reqs = [Request(req_id=f"h{i}", arrival=0.05 * i, prompt_len=8 + 2 * i,
                    output_len=4 + i % 4,
                    tier="priority" if i % 3 == 1 else "standard")
            for i in range(8)]

    async def clients():
        got = await asyncio.gather(
            drive_http("127.0.0.1", port, reqs, collect_tokens=True),
            _leaver(port))
        return got[0], await _get(port, "/metrics")

    try:
        got, metrics = asyncio.run(clients())
        t0 = time.monotonic()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=DEADLINE)
        stop_s = time.monotonic() - t0
        out = proc.stdout.read()
    finally:
        proc.kill()
    # the second launcher: a follower killed while a stream is open
    proc2, pids2, port2 = _launch()
    try:
        async def doomed():
            task = asyncio.ensure_future(_leaver(port2))
            await task
            os.kill(pids2[2], signal.SIGKILL)
        asyncio.run(doomed())
        t0 = time.monotonic()
        rc2 = proc2.wait(timeout=DEADLINE)
        dead_s = time.monotonic() - t0
    finally:
        proc2.kill()
    d = tmp_path_factory.mktemp("alone")
    done = [rec for rec in got["records"] if rec["state"] == "done"]
    _spawn(alone_rank, 1, [(rec["id"], rec_req.prompt_len,
                            rec_req.output_len)
                           for rec, rec_req in zip(got["records"], reqs)
                           if rec["state"] == "done"], str(d / "alone.json"))
    return dict(got=got, reqs=reqs, metrics=metrics, rc=rc, stop_s=stop_s,
                out=out, rc2=rc2, dead_s=dead_s, done=done,
                alone=_read_json(d / "alone.json"))


def test_launcher_streams_equal_one_rank_greedy(launched):
    """Every request over the sockets done, its stream the greedy tokens
    of that request served alone on one rank under the launcher's hash
    seed; /metrics reports the 4-rank fleet's layout (its two engines)
    and every request."""
    got, alone = launched["got"], launched["alone"]
    assert len(launched["done"]) == len(launched["reqs"])
    for rec, r in zip(got["records"], launched["reqs"]):
        assert rec["tokens"] == alone[rec["id"]], rec["id"]
        assert len(rec["tokens"]) == r.output_len
    m = launched["metrics"]
    assert m["layout"] in ("[2xDP]", "[DP | DP]", "[TP2]"), m["layout"]
    assert m["counters"]["submitted"] == len(launched["reqs"]) + 1


def test_launcher_sigint_stops_every_rank(launched):
    """SIGINT to the launcher: rank 0 drains the fleet and every rank
    exits 0 within the deadline; rank 0 printed the lockstep's count."""
    assert launched["rc"] == 0
    assert launched["stop_s"] < DEADLINE
    assert "lockstep:" in launched["out"]


def test_launcher_fails_when_a_follower_dies(launched):
    """A follower killed mid-run: the launcher exits non-zero within the
    deadline, never hangs."""
    assert launched["rc2"] not in (0, None)
    assert launched["dead_s"] < DEADLINE


def test_launcher_refuses_sim_on_ranks():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.parse_config(["--ranks", "4", "--tp-base", "2", "--serve",
                            "--sim"])
    serve.parse_config(["--ranks", "4", "--tp-base", "2", "--serve"])


# ---------------------------------------------------------------------------
# (e) the recurrent case, and a follower that diverges
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def recurrent(tmp_path_factory):
    """The JAX package's mamba2-2.7b (reduced, init(key(0)) with
    ``SLOW_DECAY``) converted for the ranks; the spawn; and each
    request's step-level reference tokens."""
    import jax
    import jax.numpy as jnp

    from repro.core.kv_adaptor import PoolGeometry as JaxGeometry
    from repro.core.modes import FlyingMode as JaxMode
    from repro.core.modes import ParallelPlan as JaxPlan
    from repro.core.steps import build_serve_step as jax_serve_step
    from repro.models.model import build_model as jax_build
    from repro_torch.convert import params_from_numpy
    from test_torch_recurrent import _configs, slow_decay
    from test_torch_recurrent_engine import jax_reference
    d = tmp_path_factory.mktemp("recurrent_serve")
    jcfg, cfg = _configs("mamba2-2.7b")
    jm = jax_build(jcfg, jnp.float32)
    jp = slow_decay(jm.init(jax.random.key(0)))
    torch.save((cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                       device="cpu")), d / "params.pt")
    err = None
    try:
        _spawn(recurrent_rank, 2, str(d / "params.pt"), str(d / "out"))
    except Exception as e:          # the diverging follower's raise
        err = str(e)
    res = _read_json(d / "out.json")
    jmode = JaxMode(JaxPlan(1, 1, 1), 1)
    jgeom = JaxGeometry(jm.cfg, JaxPlan(1, 1, 1), num_blocks=64,
                        block_base=BLOCK_BASE)
    steps = (jax.jit(jax_serve_step(jm, jmode, jgeom, phase="prefill",
                                    chunked=True)[0]),
             jax.jit(jax_serve_step(jm, jmode, jgeom, phase="decode")[0]))
    refs = {rid: jax_reference(jm, jp, steps, prompt, o)
            for (rid, prompt), (_, o) in zip(res["prompts"].items(),
                                             RECURRENT)}
    return res, refs, err, (d / "out.late").read_text()


def test_recurrent_streams_equal_the_step_level(recurrent):
    """mamba2-2.7b over the loop on 2 ranks: every stream done and equal
    to the JAX package's step level for its request alone at batch 1."""
    res, refs, _, _ = recurrent
    for rid, (toks, state) in res["streams"].items():
        assert state == "done" and toks == refs[rid], rid


def test_diverging_follower_raises_at_its_tick(recurrent):
    """The follower that dropped ``late`` raises at the tick of its
    submission, naming its rank."""
    _, _, err, tick = recurrent
    assert err is not None
    assert f"rank 1 diverged from rank 0 at tick {tick}: requests" in err


# ---------------------------------------------------------------------------
# (a) against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("run", list(RUNS))
def test_streams_equal_the_jax_loop(ref_dir, fleet, run):
    """Every stream's tokens and terminal state equal the JAX package's
    loop's; each follower's engine holds the tokens of every request
    that finished."""
    want = _read_json(os.path.join(ref_dir, "loop.json"))[run]
    got = fleet[0][run]
    assert got["streams"] == want["streams"]
    states = {rid: s for rid, (_, s) in want["streams"].items()}
    assert states[CANCEL] == "aborted"
    assert sum(s == "done" for s in states.values()) == len(TRACE) - 1
    for res in fleet[1:]:
        for rid, (toks, state) in res[run]["streams"].items():
            assert state == states[rid], rid
            if state == "done":
                assert toks == want["streams"][rid][0], rid


@pytest.mark.parametrize("run", list(RUNS))
def test_every_rank_schedules_as_the_jax_loop(ref_dir, fleet, run):
    """On every rank: phase log, layouts, switches, preempt_stats and
    runner keys equal the JAX run's; the policy carved a TP island and
    released it; the KILL run quarantined and recovered; every digest
    equals rank 0's."""
    want = _read_json(os.path.join(ref_dir, "loop.json"))[run]
    for k in ("phases", "layouts", "switches", "preempt", "keys"):
        for rank, res in enumerate(fleet):
            assert res[run][k] == want[k], (k, rank)
    merges = [m for m, _, _ in want["layouts"]]
    assert 1 in merges[merges.index(2):]          # carved, then released
    if run == "kill":
        assert want["preempt"]["recovered"] > 0
    for res in fleet[1:]:
        assert res[run]["digest"] == fleet[0][run]["digest"]


@pytest.mark.parametrize("run", list(RUNS))
def test_cancel_releases_on_every_rank(ref_dir, fleet, run):
    """Right after CANCEL's abort (rank 0: in its client; a follower:
    as it applies the abort) no adaptor holds a block of it, and the
    adaptors equal the JAX fleet's at that point; at the end every
    block is free, as in a fleet that never admitted it, and the
    adaptors equal the JAX fleet's (after the KILL both keep an empty
    record of a recovered request)."""
    want = _read_json(os.path.join(ref_dir, "loop.json"))[run]
    for res in fleet:
        snap = res[run]["snap"]["cancel"]
        assert snap == want["snap"]["cancel"]
        assert all(CANCEL not in held for _, held in snap)
        assert res[run]["end"] == want["end"]
        assert all(free == NUM_BLOCKS - 1 and CANCEL not in held
                   for free, held in res[run]["end"])



if __name__ == "__main__":
    reference_main(sys.argv[1])
