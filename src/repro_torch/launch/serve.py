"""Serving launcher of the port: real execution on one CUDA card.

Builds ``DynamicScheduler`` over a ``FlyingEngine`` serving
``ParallelPlan(1, 1, 1)`` (one engine, merge 1, a paged pool, greedy
fused sampling, chunked prefill with mixed steps) and replays a seeded
synthetic trace through it. Weights are random, drawn from ``--seed``.

  # full width on the card (llama3-8b in bf16: ~16 GB of weights)
  PYTHONPATH=src python -m repro_torch.launch.serve --real --requests 8
  # the reduced config on the CPU (the plain PyTorch path; for tests)
  PYTHONPATH=src python -m repro_torch.launch.serve --real --reduced \
      --device cpu --dtype float32 --requests 4 --num-blocks 256 \
      --prompt-range 16 96 --output-range 4 12 --prefill-chunk 32 \
      --max-blocks-per-req 16

Real execution is the only backend: the simulation backend, the front
door and the HTTP server are not ported, and ``--real`` is accepted for
the JAX launcher's command lines but changes nothing. Without a card and
without ``--device cpu`` the launcher raises instead of falling back to
the CPU.
"""
from __future__ import annotations

import argparse
import copy
import time
from dataclasses import dataclass, fields
from typing import Tuple

import torch


@dataclass
class ServeConfig:
    """Every launcher knob of the port's real-execution path."""
    arch: str = "llama3-8b"
    reduced: bool = False            # the config's smoke-test variant
    device: str = ""                 # "" = the CUDA card
    dtype: str = "bfloat16"          # bfloat16 | float32
    requests: int = 8
    seed: int = 0
    # pool and engine geometry
    num_blocks: int = 4096
    block_base: int = 16
    batch_per_engine: int = 8
    max_blocks_per_req: int = 256
    prefill_chunk: int = 512
    # trace
    prompt_range: Tuple[int, int] = (256, 2048)
    output_range: Tuple[int, int] = (32, 64)
    rate: float = 20.0               # poisson arrivals per second

    def validate(self) -> None:
        if self.dtype not in ("bfloat16", "float32"):
            raise SystemExit(f"dtype {self.dtype!r}: bfloat16 or float32")


def parse_config(argv=None) -> ServeConfig:
    ap = argparse.ArgumentParser()
    ap.add_argument("--real", action="store_true",
                    help="accepted for the JAX launcher's command lines; "
                         "real execution is the port's only backend")
    for f in fields(ServeConfig):
        flag = "--" + f.name.replace("_", "-")
        if f.default is False:
            ap.add_argument(flag, action="store_true")
        elif isinstance(f.default, tuple):
            ap.add_argument(flag, type=int, nargs=2, default=f.default)
        else:
            ap.add_argument(flag, type=type(f.default), default=f.default)
    args = ap.parse_args(argv)
    cfg = ServeConfig(**{f.name: (tuple(getattr(args, f.name))
                                  if isinstance(f.default, tuple)
                                  else getattr(args, f.name))
                         for f in fields(ServeConfig)})
    cfg.validate()
    return cfg


def build_stack(cfg: ServeConfig):
    """(scheduler, engine, workload spec) for this config."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.serving.workload import WorkloadSpec

    cfg.validate()
    device = resolve_device(cfg.device or None)
    mcfg = get_config(cfg.arch)
    if cfg.reduced:
        mcfg = mcfg.reduced()
    dtype = getattr(torch, cfg.dtype)
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    geom = PoolGeometry(mcfg, plan, num_blocks=cfg.num_blocks,
                        block_base=cfg.block_base)
    model = build_model(mcfg, dtype, device)
    params = model.init(torch.Generator(device=device).manual_seed(cfg.seed))
    engine = FlyingEngine(model, plan, geom, params,
                          batch_per_engine=cfg.batch_per_engine,
                          max_blocks_per_req=cfg.max_blocks_per_req,
                          device=device)
    sched = DynamicScheduler(
        plan, geom, engine,
        SchedulerConfig(strategy="hard",
                        max_batch_per_group=cfg.batch_per_engine,
                        prefill_chunk=cfg.prefill_chunk, fixed_merge=1))
    spec = WorkloadSpec(n_requests=cfg.requests, seed=cfg.seed,
                        prompt_range=cfg.prompt_range,
                        output_range=cfg.output_range, rate=cfg.rate)
    return sched, engine, spec


def run_offline(cfg: ServeConfig, stack=None):
    """Replay the trace to completion; returns (scheduler, engine,
    summary, wall seconds). ``stack`` reuses a built (scheduler, engine,
    spec)."""
    from repro_torch.serving.metrics import summarize
    from repro_torch.serving.workload import generate

    sched, engine, spec = stack or build_stack(cfg)
    for r in generate(spec):
        sched.submit(copy.deepcopy(r))
    t0 = time.perf_counter()
    sched.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    wall = time.perf_counter() - t0
    return sched, engine, summarize(sched.pool.all.values()), wall


def main(argv=None) -> None:
    cfg = parse_config(argv)
    sched, engine, m, wall = run_offline(cfg)
    done = [r for r in sched.pool.all.values() if r.state == "done"]
    toks = sum(len(engine.generated_tokens(r.req_id)) for r in done)
    print(f"arch={cfg.arch}{'-reduced' if cfg.reduced else ''} "
          f"device={engine.device} dtype={cfg.dtype}")
    print(f"  requests done : {len(done)}/{len(sched.pool.all)}")
    print(f"  steps         : {engine.sync_stats.steps} "
          f"({sum(1 for l in sched.log if l.phase == 'mixed')} mixed)")
    print(f"  tokens out    : {toks} in {wall:.3f} s wall "
          f"({toks / max(wall, 1e-9):.1f} tok/s)")
    print(f"  mean TTFT     : {m.mean_ttft * 1e3:9.1f} ms (scheduler clock)")
    print(f"  sync stats    : {engine.sync_stats}")


if __name__ == "__main__":
    main()
