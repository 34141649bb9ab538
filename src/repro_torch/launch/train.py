"""Training launcher of the port: trains a (reduced or full) config on one
CUDA card, or on the CPU when asked, with synthetic LM data, AdamW and
periodic checkpoints.

  # the reduced config on the CPU (the plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --device cpu --steps 20 --batch 4 --seq 64
  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --steps 200 --batch 8 --seq 128

As in the JAX launcher, a reduced config trains in fp32 and a full one
in bf16 (fp32 AdamW moments either way), weights are drawn from a fixed
seed, and the run fails unless the last logged loss is below the first.
``train`` is the loop itself, for callers that bring their own config.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field
from typing import Any, List, Optional

import torch

from repro_torch.configs.base import ArchConfig


@dataclass
class TrainResult:
    losses: List[float] = field(default_factory=list)   # one per step
    step_s: List[float] = field(default_factory=list)   # wall per step
    tokens_per_step: int = 0
    params: Any = None                                  # after the last step


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          lr: float = 1e-3, device: Optional[str] = None,
          dtype: torch.dtype = torch.bfloat16, params=None, ckpt: str = "",
          ckpt_every: int = 100, log_every: int = 10, seed: int = 0,
          log=print) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens and
    return the per-step losses and wall times (each step ends in a device
    synchronisation). ``dtype`` is the parameters' (the moments are
    fp32); ``params`` (a tree on ``device``, updated in place) replaces
    the initialisation from ``seed``, which the data stream uses too."""
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training.data import DataConfig, batches
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import build_train_step

    dev = resolve_device(device)
    model = build_model(cfg, dtype, dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    opt = AdamW(lr=lr, warmup=min(50, steps // 4 or 1))
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    step = build_train_step(model, plan, opt=opt)
    carry = (params, opt.init(params))
    it = batches(DataConfig(cfg.vocab_size, seq, batch, seed=seed))
    res = TrainResult(tokens_per_step=batch * seq)
    t_start = time.perf_counter()
    for i in range(steps):
        b = next(it)
        t0 = time.perf_counter()
        carry, mets = step(carry, b)
        loss = float(mets["loss"])           # waits for the step
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res.step_s.append(time.perf_counter() - t0)
        res.losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            tok_s = res.tokens_per_step * (i + 1) / (
                time.perf_counter() - t_start)
            log(f"step {i:5d} loss {loss:7.4f} ({tok_s:,.0f} tok/s, "
                f"{res.step_s[-1] * 1e3:.1f} ms/step)")
        if ckpt and (i + 1) % ckpt_every == 0:
            ckpt_mod.save(ckpt, carry[0], step=i + 1)
            log(f"  checkpoint @ {i + 1} -> {ckpt}")
    res.params = carry[0]
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="",
                    help="cpu to run on the CPU; default the CUDA card")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, device=args.device or None,
                dtype=torch.float32 if args.reduced else torch.bfloat16,
                ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                log_every=args.log_every)
    logged = [l for i, l in enumerate(res.losses)
              if i % args.log_every == 0 or i == args.steps - 1]
    if len(logged) >= 2:
        if not logged[-1] < logged[0]:
            raise SystemExit(f"loss did not decrease: {logged[0]:.4f} -> "
                             f"{logged[-1]:.4f}")
        print(f"final loss {logged[-1]:.4f} (from {logged[0]:.4f}) — OK")


if __name__ == "__main__":
    main()
