"""Serving launcher of the port.

Modes:
  --real (default): actual execution: ``FlyingEngine`` (a paged pool,
         fused sampling, chunked prefill with mixed steps), weights
         random from ``--seed``. With ``--ranks 1`` (the default) one
         process on one CUDA card at ``ParallelPlan(1, 1, 1)``; with
         ``--ranks N --tp-base T`` the launcher spawns N rank processes,
         one per device (``launch/ranks.py``: NCCL when each has a card
         of its own, gloo when they share one or run on the CPU), at
         ``ParallelPlan(1, T, N // T)``: N // T engines of T ranks, which
         the layout policy merges into TP islands and dissolves again.
         Every rank runs the same scheduler (SPMD) under one
         ``PYTHONHASHSEED`` (the launcher's own, else 0); rank 0 alone
         prints. Without a card and without ``--device cpu`` it raises
         instead of falling back to the CPU.
  --sim: full-scale discrete-event run on the roofline cost model: the
         production mesh geometry, any arch, paper workloads. Its cost
         model is the TPU v5e's (``serving/hardware.py``), as in the JAX
         package, so its times are simulated, not measured on a device;
         its summary is the JAX package's launcher's, byte for byte.
  --serve: boot the async serving core, the OpenAI-style HTTP/SSE
         endpoint (``serving/server.py``) over the event-driven
         continuous-batching loop, instead of replaying a trace. Tokens
         reach the streams every ``STREAM_HARVEST`` engine steps. On
         ``--ranks N`` rank 0 owns the socket and the clock and leads:
         before each action of its loop it broadcasts the inputs that
         reached it alone (requests, aborts, the wall clock) with a
         digest of its state, and ranks 1..N-1 replay them through the
         same calls (``serving/lockstep.py``), so every rank's scheduler
         stays rank 0's and a rank whose digest differs raises. A
         parked rank 0 sends a heartbeat every 10 s. SIGINT or SIGTERM
         to the launcher reaches rank 0, which stops the loop and drains
         every rank through ``FrontDoor.shutdown``; every rank then
         exits 0, and a rank that dies fails the launcher.

Every knob lives on the :class:`ServeConfig` dataclass and can come
from a JSON file (``--config serve.json``) with CLI flags as overrides:

  PYTHONPATH=src python -m repro_torch.launch.serve --sim --requests 500
  # full width on the card (llama3-8b in bf16: ~16 GB of weights)
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 \\
      --arrival poisson --rate 20
  # the reduced config on the CPU (the plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --device cpu --dtype float32 --requests 4 --num-blocks 256 \\
      --prompt-range 16 96 --output-range 4 12 --prefill-chunk 32 \\
      --max-blocks-per-req 16
  # ... on 8 CPU ranks, the JAX package's --real plan ParallelPlan(1, 2, 4)
  PYTHONPATH=src python -m repro_torch.launch.serve --reduced \\
      --device cpu --dtype float32 --ranks 8 --tp-base 2 --requests 8 \\
      --num-blocks 64 --block-base 4 --batch-per-engine 2 \\
      --prompt-range 8 24 --output-range 4 8 --prefill-chunk 8 \\
      --max-blocks-per-req 16 --priority-frac 0.25
  PYTHONPATH=src python -m repro_torch.launch.serve --sim --serve \\
      --port 8000 --pace virtual --forecast
  # ... over HTTP on 4 CPU ranks (--port 0: the port it prints)
  PYTHONPATH=src python -m repro_torch.launch.serve --serve --ranks 4 \\
      --tp-base 2 --device cpu --reduced --dtype float32 --port 0 \\
      --num-blocks 64 --block-base 4 --batch-per-engine 2 \\
      --prefill-chunk 8 --max-blocks-per-req 16
  curl -N localhost:8000/v1/completions -d \\
      '{"prompt": "hello", "max_tokens": 16, "stream": true}'
  # Mamba-2 and RecurrentGemma (their recurrent rows stay with each
  # request; no mixed step; --prefix-cache refused: a prefix cache
  # shares KV blocks, never a recurrent state)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-2.7b \\
      --reduced --device cpu --dtype float32 --requests 4 \\
      --num-blocks 256 --prompt-range 16 96 --output-range 4 12 \\
      --prefill-chunk 32 --max-blocks-per-req 16

At one engine the layout policy has nothing to merge: a one-rank run
never rebinds, and the scheduler refuses a ``--fixed-merge`` other than 1
(a merge wider than its one engine). ``--sim`` runs one process.
whisper-base and internvl2-1b do not serve on the real path (the engine
stages no frontend embeddings; ROADMAP.md Queue 1 item 3).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from dataclasses import dataclass, field, fields, replace
from typing import Tuple


@dataclass
class ServeConfig:
    """Every launcher knob in one place: the JAX package's whole set,
    then the port's real-execution fields. JSON-loadable; unknown keys
    are errors so a typo'd config fails loudly, not silently as a
    default. Unlike the JAX package's, ``real`` defaults to True: the
    port runs on the card unless the simulator is asked for."""
    arch: str = "llama3-8b"                  # model config name
    real: bool = True                        # real engine vs sim backend
    requests: int = 500                      # trace length (offline)
    strategy: str = "hard"                   # hard|soft|sequential|live
    fixed_merge: int = 0                     # pin the mode; 0 = dynamic
    switch: str = "flying"                   # flying|restart|none
    priority_frac: float = 0.0
    prefix_cache: bool = False               # content-addressed KV
    prefix_pool: int = 4
    prefix_hit: float = 0.6
    seed: int = 0
    fault: Tuple[str, ...] = field(default_factory=tuple)
    # front door
    frontdoor: bool = False
    no_shed: bool = False
    queue_cap: int = 512
    ttft_deadline: float = 0.0               # priority TTFT SLO (0=none)
    tpot_deadline: float = 0.0               # priority TPOT SLO (0=none)
    arrival: str = "phased"                  # phased|poisson|bursty
    rate: float = 10.0
    background_frac: float = 0.0
    cancel_frac: float = 0.0
    diagnostic: str = ""                     # diagnostic JSON path
    # async serving core
    serve: bool = False                      # boot the HTTP server
    host: str = "127.0.0.1"
    port: int = 8000
    pace: str = "wall"                       # wall|virtual serve clock
    forecast: bool = False                   # predictive rebind policy
    stream_buf: int = 256                    # per-stream token buffer
    wall_dilation: float = 1.0               # virtual s per wall s
    metrics_window: float = 60.0             # rolling /metrics window
    # --real: the port's engine, one process per device
    ranks: int = 1                           # rank processes (devices)
    tp_base: int = 1                         # ranks per engine tile
    reduced: bool = False                    # the config's smoke variant
    device: str = ""                         # "" = the CUDA card
    dtype: str = "bfloat16"                  # bfloat16|float32
    num_blocks: int = 4096
    block_base: int = 16
    batch_per_engine: int = 8
    max_blocks_per_req: int = 256
    prefill_chunk: int = 512
    prompt_range: Tuple[int, int] = (256, 2048)
    output_range: Tuple[int, int] = (32, 64)
    # the scheduler's clock: 0 advances it by each step's and rebind's
    # measured wall time; > 0 by this many seconds each, so the schedule
    # is a function of the trace alone (for tests; the JAX launcher has
    # no such knob)
    step_seconds: float = 0.0

    _CHOICES = {"strategy": ("hard", "soft", "sequential", "live"),
                "switch": ("flying", "restart", "none"),
                "arrival": ("phased", "poisson", "bursty"),
                "pace": ("wall", "virtual"),
                "dtype": ("bfloat16", "float32")}
    _TUPLES = ("fault", "prompt_range", "output_range")

    @classmethod
    def load(cls, path: str) -> "ServeConfig":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in fields(cls)}
        bad = set(raw) - known
        if bad:
            raise SystemExit(f"unknown config keys in {path}: "
                             f"{sorted(bad)}")
        for k in cls._TUPLES:
            if k in raw:
                raw[k] = tuple(raw[k])
        cfg = cls(**raw)
        cfg.validate()
        return cfg

    def validate(self) -> None:
        for name, opts in self._CHOICES.items():
            v = getattr(self, name)
            if v not in opts:
                raise SystemExit(f"config: {name}={v!r} not in {opts}")
        engines = self.ranks // max(self.tp_base, 1)
        if self.tp_base < 1 or self.ranks % self.tp_base \
                or engines & (engines - 1):
            raise SystemExit(f"config: ranks={self.ranks} must be a "
                             f"power-of-two count of tp_base="
                             f"{self.tp_base}-rank engines")
        if self.ranks > 1 and not self.real:
            raise SystemExit("config: --ranks > 1 runs the real engine "
                             "(not --sim)")

    def policy(self):
        """The layout policy this config asks for (None = pinned)."""
        from repro_torch.core.policy import FlyingPolicy, ForecastPolicy
        if self.fixed_merge:
            return None
        inner = FlyingPolicy()
        return ForecastPolicy(inner=inner) if self.forecast else inner


def _build_parser() -> argparse.ArgumentParser:
    """argparse view over ServeConfig: every field is a flag whose
    DEFAULT is the `unset` sentinel, so only flags the user actually
    passed override a --config file."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="", metavar="serve.json",
                    help="load a ServeConfig JSON; flags override it")
    ap.add_argument("--sim", dest="real", action="store_false",
                    default=None, help="the simulator (TPU v5e cost "
                                       "model) instead of the card")
    for f in fields(ServeConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.name == "fault":
            ap.add_argument("--fault", action="append", default=None,
                            metavar="KIND@TICK[:eng,eng...]",
                            help="scripted fault, e.g. kill@40:3 "
                                 "(repeatable)")
        elif f.name in ServeConfig._TUPLES:
            ap.add_argument(flag, type=int, nargs=2, default=None)
        elif f.type == "bool" or f.default is False:
            ap.add_argument(flag, action="store_true", default=None)
        else:
            ap.add_argument(flag, type=type(f.default), default=None,
                            choices=ServeConfig._CHOICES.get(f.name))
    return ap


def parse_config(argv=None) -> ServeConfig:
    args = _build_parser().parse_args(argv)
    cfg = ServeConfig.load(args.config) if args.config else ServeConfig()
    over = {f.name: getattr(args, f.name) for f in fields(ServeConfig)
            if getattr(args, f.name) is not None}
    for k in ServeConfig._TUPLES:
        if k in over:
            over[k] = tuple(over[k])
    cfg = replace(cfg, **over)
    cfg.validate()
    return cfg


# ---------------------------------------------------------------------------
# stack construction
# ---------------------------------------------------------------------------

# steps between token harvests when ``--serve`` streams: a token reaches
# its stream at most this many steps after it was drawn (the engine's
# default, 512, holds tokens until a request's terminal flush)
STREAM_HARVEST = 4


class FixedStepClock:
    """Engine proxy whose steps and rebinds report ``seconds`` each in
    place of their measured wall time (``--step-seconds``): the
    scheduler's island clocks, and with them which islands launch in a
    tick, then follow the trace alone. Everything else is the engine's."""

    def __init__(self, eng, seconds: float):
        self.eng = eng
        self.seconds = seconds

    def __getattr__(self, k):
        return getattr(self.eng, k)

    def prefill(self, *a):
        self.eng.prefill(*a)
        return self.seconds

    def decode(self, *a):
        self.eng.decode(*a)
        return self.seconds

    def mixed(self, *a):
        self.eng.mixed(*a)
        return self.seconds

    def rebind(self, layout):
        self.eng.rebind(layout)
        return self.seconds


def build_stack(cfg: ServeConfig, weights=None, **engine):
    """Scheduler + workload spec + fault injector for this config (sim or
    real). A real run's engine is ``sched.backend``; ``weights`` (a built
    ``(model, params)``) lets several engines share one set, and
    ``engine`` passes further ``FlyingEngine`` keywords (its sampling
    knobs: ``temperature``, ``top_k``, ``seed_mode``)."""
    from repro_torch.configs import get_config
    from repro_torch.core.faults import FaultInjector, FaultSpec
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.serving.workload import WorkloadSpec

    def parse_fault(s: str) -> FaultSpec:
        kind, _, rest = s.partition("@")
        tick, _, engs = rest.partition(":")
        engines = tuple(int(e) for e in engs.split(",")) if engs else ()
        return FaultSpec(kind=kind, tick=int(tick), engines=engines)

    injector = FaultInjector([parse_fault(s) for s in cfg.fault]) \
        if cfg.fault else None

    if cfg.real:
        import torch

        from repro_torch.core.engine import FlyingEngine
        from repro_torch.device import resolve_device
        from repro_torch.models.model import build_model
        # plain ``cuda``: the engine resolves it to the rank's card
        device = resolve_device(cfg.device or None)
        mcfg = get_config(cfg.arch)
        if cfg.reduced:
            mcfg = mcfg.reduced()
        if weights is None:
            model = build_model(mcfg, getattr(torch, cfg.dtype), device)
            params = model.init(
                torch.Generator(device=device).manual_seed(cfg.seed))
        else:
            model, params = weights
        plan = ParallelPlan(engine_rows=1, tp_base=cfg.tp_base,
                            data_rows=cfg.ranks // cfg.tp_base)
        geom = PoolGeometry(mcfg, plan, num_blocks=cfg.num_blocks,
                            block_base=cfg.block_base)
        backend = FlyingEngine(
            model, plan, geom, params,
            batch_per_engine=cfg.batch_per_engine,
            max_blocks_per_req=cfg.max_blocks_per_req,
            injector=injector, device=device,
            **({"harvest_limit": STREAM_HARVEST} if cfg.serve else {}),
            **engine)
        if cfg.step_seconds > 0:
            backend = FixedStepClock(backend, cfg.step_seconds)
        sched = DynamicScheduler(
            plan, geom, backend,
            SchedulerConfig(strategy=cfg.strategy,
                            max_batch_per_group=cfg.batch_per_engine,
                            prefill_chunk=cfg.prefill_chunk,
                            prefix_cache=cfg.prefix_cache,
                            fixed_merge=cfg.fixed_merge or None),
            policy=cfg.policy())
        spec = real_spec(cfg)
    else:
        mcfg = get_config(cfg.arch)
        plan = ParallelPlan(engine_rows=mcfg.engine_rows, tp_base=16,
                            data_rows=16)
        from repro_torch.serving.simulator import CostModel, SimBackend
        kv_per_tok = mcfg.kv_cache_dims_per_token * mcfg.num_layers * 2 \
            / (plan.engine_rows * plan.tp_base)
        budget = 16e9 - mcfg.num_params() * 2 / (plan.engine_rows * 16) \
            - 2e9
        blocks = max(int(budget / max(kv_per_tok, 1) / 16), 1024)
        geom = PoolGeometry(mcfg, plan, num_blocks=blocks, block_base=16)
        backend = SimBackend(CostModel(mcfg, plan),
                             switch_mode=cfg.switch, injector=injector)
        sched = DynamicScheduler(
            plan, geom, backend,
            SchedulerConfig(strategy=cfg.strategy,
                            prefix_cache=cfg.prefix_cache,
                            fixed_merge=cfg.fixed_merge or None),
            policy=cfg.policy())
        spec = WorkloadSpec(n_requests=cfg.requests, seed=cfg.seed,
                            phase_seconds=30.0,
                            priority_frac=cfg.priority_frac)
        if cfg.prefix_cache:
            spec.prefix_pool = cfg.prefix_pool
            spec.prefix_hit = cfg.prefix_hit
            spec.prefix_range = (512, 2048)
        _traffic(cfg, spec)
    return sched, spec, injector


def _traffic(cfg: ServeConfig, spec) -> None:
    spec.arrival = cfg.arrival
    spec.rate = cfg.rate
    spec.background_frac = cfg.background_frac
    spec.cancel_frac = cfg.cancel_frac


def real_spec(cfg: ServeConfig):
    """The trace a real-engine run of ``cfg`` replays (``build_stack``'s
    spec, built without the model: a client of ``--serve`` draws its
    requests from it)."""
    from repro_torch.serving.workload import WorkloadSpec
    spec = WorkloadSpec(n_requests=cfg.requests, seed=cfg.seed,
                        prompt_range=cfg.prompt_range,
                        output_range=cfg.output_range,
                        priority_frac=cfg.priority_frac)
    if cfg.prefix_cache:
        lo = cfg.prompt_range[0]
        spec.prefix_pool = cfg.prefix_pool
        spec.prefix_hit = cfg.prefix_hit
        spec.prefix_range = (max(lo // 2, 1), lo)
    _traffic(cfg, spec)
    return spec


def build_door(cfg: ServeConfig, sched):
    from repro_torch.serving.frontdoor import (FrontDoor, FrontDoorConfig,
                                               SLOClass)
    tiers = (SLOClass("priority", priority=1,
                      deadline_ttft=cfg.ttft_deadline or None,
                      deadline_tpot=cfg.tpot_deadline or None),
             SLOClass("standard"),
             SLOClass("background", sheddable=True))
    return FrontDoor(sched, FrontDoorConfig(
        queue_cap=cfg.queue_cap, shed=not cfg.no_shed,
        enforce_deadlines=not cfg.no_shed, tiers=tiers))


def build_loop(cfg: ServeConfig, door):
    """The async serving loop over ``door``, as ``--serve`` runs it; on
    ranks it leads the others through the engine's communicator pool."""
    from repro_torch.serving.asyncloop import AsyncServeLoop
    from repro_torch.serving.metrics import RollingTierMetrics
    return AsyncServeLoop(
        door, pace=cfg.pace, stream_buf=cfg.stream_buf,
        wall_dilation=cfg.wall_dilation,
        rolling=RollingTierMetrics(window_s=cfg.metrics_window),
        pool=getattr(door.sched.backend, "pool", None))


# ---------------------------------------------------------------------------
# --serve: the always-on HTTP server
# ---------------------------------------------------------------------------

def serve_http(cfg: ServeConfig, ready=None):
    """The HTTP server until SIGINT, then a graceful drain (on every rank
    when it leads ranks). ``ready(port)`` is called once it listens.
    Returns the loop."""
    import asyncio

    from repro_torch.serving.server import ServeHTTP

    sched, _spec, _inj = build_stack(cfg)
    door = build_door(cfg, sched)
    loop = build_loop(cfg, door)

    async def main():
        srv = await ServeHTTP(loop).start(cfg.host, cfg.port)
        ranks = f", {cfg.ranks} ranks" if cfg.ranks > 1 else ""
        print(f"serving on http://{cfg.host}:{srv.port}  "
              f"(pace={cfg.pace}, forecast={cfg.forecast}, "
              f"arch={cfg.arch}, backend="
              f"{'real' if cfg.real else 'sim: TPU v5e cost model'}"
              f"{ranks})", flush=True)
        print("  POST /v1/completions | /v1/chat/completions   "
              "GET /metrics /healthz", flush=True)
        if ready is not None:
            ready(srv.port)
        try:
            await srv.serve_forever()
        except asyncio.CancelledError:
            pass
        finally:
            await srv.stop()
            loop.shutdown(cfg.diagnostic or None)

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        print("\nshutdown")
    if loop.pool is not None:
        st = loop.pool.stats
        ms = sorted(loop.broadcast_ms)
        print(f"lockstep: {st.broadcasts} broadcasts over {loop.ticks} "
              f"ticks, {ms[len(ms) // 2]:.3f} ms median; "
              f"{st.host_collectives} host collectives", flush=True)
    return loop


def serve_follow(cfg: ServeConfig):
    """Ranks 1..N-1 of ``--serve --ranks N``: the same stack, driven by
    rank 0's broadcasts until its shutdown has drained here too. SIGINT
    is ignored: rank 0 stops the fleet. Returns the follower."""
    import signal

    from repro_torch.serving.lockstep import Follower

    signal.signal(signal.SIGINT, signal.SIG_IGN)
    sched, _spec, _inj = build_stack(cfg)
    follower = Follower(build_door(cfg, sched), sched.backend.pool)
    follower.run()
    return follower


# ---------------------------------------------------------------------------
# offline trace replay
# ---------------------------------------------------------------------------

def replay(cfg: ServeConfig, stack=None, frontdoor=None):
    """Replay the config's trace to completion through the scheduler, or
    through ``frontdoor`` when one is given. Returns ``(sched, wall
    seconds)``; ``stack`` reuses a built ``build_stack`` triple.
    ``SchedulerWedged`` propagates."""
    from repro_torch.serving.workload import generate

    sched, spec, _ = stack or build_stack(cfg)
    reqs = [copy.deepcopy(r) for r in generate(spec)]
    t0 = time.perf_counter()
    if frontdoor is not None:
        for r in reqs:
            frontdoor.submit(r)
        frontdoor.run()
    else:
        for r in reqs:
            sched.submit(r)
        sched.run()
    dev = getattr(sched.backend, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)
    return sched, time.perf_counter() - t0


def run_offline(cfg: ServeConfig) -> None:
    from repro_torch.core.scheduler import SchedulerWedged
    from repro_torch.serving.metrics import summarize, tier_report

    stack = build_stack(cfg)
    sched, _, injector = stack
    frontdoor = build_door(cfg, sched) if cfg.frontdoor else None

    def write_diag(diag: dict):
        if cfg.diagnostic:
            with open(cfg.diagnostic, "w") as f:
                json.dump(diag, f, indent=2, sort_keys=True, default=str)
                f.write("\n")
            print(f"  diagnostic    : {cfg.diagnostic}")

    try:
        sched, wall = replay(cfg, stack, frontdoor)
    except SchedulerWedged as w:
        print(f"WEDGED: {w.args[0]}")
        if frontdoor is not None:
            write_diag(frontdoor.diagnostic("wedged"))
        else:
            write_diag(w.diagnostic.to_dict()
                       if w.diagnostic is not None else {})
        raise
    m = summarize(sched.pool.all.values())
    if not cfg.real:
        print("sim backend: the times below are the simulated TPU v5e "
              "cost model's (serving/hardware.py), not measured on a "
              "device", file=sys.stderr)
    print(f"arch={cfg.arch} strategy={cfg.strategy} "
          f"fixed_merge={cfg.fixed_merge or 'dynamic'}")
    print(f"  requests done : "
          f"{sum(1 for r in sched.pool.all.values() if r.state == 'done')}"
          f"/{len(sched.pool.all)}")
    print(f"  mean TTFT     : {m.mean_ttft * 1e3:9.1f} ms")
    print(f"  P90 TTFT      : {m.p90_ttft * 1e3:9.1f} ms")
    print(f"  P90 queue     : {m.p90_queue * 1e3:9.1f} ms")
    print(f"  median TPOT   : {m.median_tpot * 1e3:9.2f} ms")
    print(f"  peak tput     : {m.peak_throughput:9.0f} tok/s")
    print(f"  mode switches : {sched.switches}")
    print(f"  preempts      : {sched.preempt_stats}")
    if cfg.prefix_cache and sched.prefix_cache is not None:
        s = sched.prefix_cache.stats
        tot = s["hit_requests"] + s["miss_requests"]
        print(f"  prefix cache  : {s['hit_requests']}/{tot} hits "
              f"({s['hit_tokens']} tokens), "
              f"{s['inserted_blocks']} blocks inserted, "
              f"{s['evictions']} evicted")
    if injector is not None or sched.quarantined or sched.incidents:
        print(f"  quarantined   : {sorted(sched.quarantined)}")
        print(f"  recovered     : {sched.preempt_stats['recovered']} reqs, "
              f"{sched.preempt_stats['recomputed_tokens']} tokens "
              f"recomputed")
        print(f"  degraded ticks: {sched.preempt_stats['degraded_ticks']}"
              f"  rollbacks: {sched.preempt_stats['rollbacks']}")
        for inc in sched.incidents:
            extra = {k: v for k, v in inc.items()
                     if k not in ("t", "tick", "kind", "snapshot")}
            print(f"    incident t={inc['t']:.3f} tick={inc['tick']} "
                  f"{inc['kind']}: {extra}")
    if cfg.real:
        eng = sched.backend
        done = [r for r in sched.pool.all.values() if r.state == "done"]
        toks = sum(len(eng.generated_tokens(r.req_id)) for r in done)
        print(f"  device        : {eng.device} {cfg.dtype} "
              f"{cfg.arch}{'-reduced' if cfg.reduced else ''}")
        print(f"  tokens out    : {toks} in {wall:.3f} s wall "
              f"({toks / max(wall, 1e-9):.1f} tok/s; the times above are "
              f"the scheduler's host clock)")
        print(f"  sync stats    : {eng.sync_stats}")
        if eng.world > 1:
            st = eng.pool.stats
            print(f"  ranks         : {eng.pool.describe()}; "
                  f"{len(eng.switch_log)} rebinds; "
                  f"{st.collectives} TP collectives on rank 0, "
                  f"{st.host_collectives} host collectives")
    if frontdoor is not None:
        print(f"  lifecycle     : {sched.lifecycle} "
              f"rejected={frontdoor.counters['rejected']}")
        for tier, row in tier_report(
                list(frontdoor.requests.values())).items():
            print(f"  tier {tier:<10}: n={row['n']} done={row['done']} "
                  f"shed={row['shed']} expired={row['expired']} "
                  f"p99_ttft={row['p99_ttft_s'] * 1e3:.1f}ms "
                  f"goodput={row['goodput']:.2f}")
        # graceful drain: admission is already empty here, so this just
        # emits the structured shutdown artifact
        frontdoor.shutdown(cfg.diagnostic or None)
        if cfg.diagnostic:
            print(f"  diagnostic    : {cfg.diagnostic}")
    elif cfg.diagnostic:
        write_diag(sched._diagnostic().to_dict())


def _rank_main(rank: int, world: int, cfg: ServeConfig, ready=None):
    """One rank of a ``--ranks N`` run: the whole offline replay, as
    every other rank runs it, or under ``--serve`` the HTTP server on
    rank 0 (``ready`` as ``serve_http``'s) and a follower on every other
    rank (returned); rank 0 alone prints."""
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        if cfg.serve:
            return serve_http(cfg, ready) if rank == 0 \
                else serve_follow(cfg)
        run_offline(cfg)
    finally:
        if rank:
            sys.stdout.close()
            sys.stdout = sys.__stdout__


def main(argv=None):
    cfg = parse_config(argv)
    if cfg.ranks > 1:
        from repro_torch.launch.ranks import spawn
        cpu = cfg.device == "cpu"
        # CPU ranks split the cores: oversubscribed OpenMP threads spin
        # while their rank waits in a collective
        spawn(_rank_main, cfg.ranks, (cfg,),
              device_type="cpu" if cpu else "cuda", timeout=None,
              hash_seed=os.environ.get("PYTHONHASHSEED", "0"),
              threads=max((os.cpu_count() or 1) // cfg.ranks, 1)
              if cpu else None, forward_signals=cfg.serve,
              on_start=(lambda pids: print(f"rank pids {pids}",
                                           flush=True))
              if cfg.serve else None)
    elif cfg.serve:
        serve_http(cfg)
    else:
        run_offline(cfg)


if __name__ == "__main__":
    main()
