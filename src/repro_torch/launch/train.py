"""Training launcher of the port: trains a (reduced or full) config on one
CUDA card, on ranks, or on the CPU when asked, with synthetic LM data,
AdamW and periodic checkpoints.

  # the reduced config on the CPU (the plain PyTorch path)
  PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
      --device cpu --steps 20 --batch 4 --seq 64
  # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --reduced --steps 200 --batch 8 --seq 128
  # sharded over 4 CPU ranks (ParallelPlan(1, 2, 2): TP2 x DP2)
  PYTHONPATH=src python -m repro_torch.launch.train --ranks 4 \\
      --reduced --device cpu --steps 20 --batch 8 --seq 64

As in the JAX launcher, a reduced config trains in fp32 and a full one
in bf16 (fp32 AdamW moments either way), weights are drawn from a fixed
seed, and the run fails unless the last logged loss is below the first.
``--ranks N`` spawns N rank processes (``launch/ranks.py``: NCCL when
each has a card, gloo when they share one or run on the CPU) and trains
on them as the JAX launcher trains on its N local devices: 'model' is 2
from 4 ranks up, else 1, and 'data' takes the rest (``plan_for_ranks``).
Every rank draws the same logical weights from the seed and keeps its
shards, draws the same global batch and takes its rows; rank 0 prints
and writes the checkpoints (the logical tree). ``train`` is the loop
itself, for callers that bring their own config and plan.
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
    totals: List[float] = field(default_factory=list)   # loss + aux term
    step_s: List[float] = field(default_factory=list)   # wall per step
    tokens_per_step: int = 0
    params: Any = None          # after the last step (this rank's shards)
    mesh: Any = None            # this rank's train_step.TrainMesh


def frontend_embeds(cfg: ArchConfig, batch: int, seed: int,
                    dtype: torch.dtype, device) -> Optional[torch.Tensor]:
    """The stub frontend's embeddings a training run feeds every step:
    N(0, 1) x 0.1 [batch, num_embeds, width] from a CPU generator seeded
    by ``seed`` (the same on every device), in ``dtype`` on ``device``
    (None without a frontend)."""
    if cfg.frontend is None:
        return None
    width = cfg.frontend.embed_width or cfg.d_model
    gen = torch.Generator().manual_seed(seed)
    fe = torch.randn((batch, cfg.frontend.num_embeds, width), generator=gen)
    return (fe * 0.1).to(device=device, dtype=dtype)


def plan_for_ranks(n: int):
    """The JAX launcher's plan for n devices: the largest (data, model)
    grid, 'model' 2 from 4 up."""
    from repro_torch.core.modes import ParallelPlan
    model_axis = min(2 if n >= 4 else 1, n)
    return ParallelPlan(engine_rows=1, tp_base=model_axis,
                        data_rows=n // model_axis)


def train(cfg: ArchConfig, *, steps: int, batch: int, seq: int,
          lr: float = 1e-3, device: Optional[str] = None,
          dtype: torch.dtype = torch.bfloat16, params=None, ckpt: str = "",
          ckpt_every: int = 100, log_every: int = 10, seed: int = 0,
          plan=None, log=print) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps of ``batch`` x ``seq`` tokens and
    return the per-step losses and wall times (each step ends in a device
    synchronisation). ``dtype`` is the parameters' (the moments are
    fp32); ``params`` (a logical tree on ``device``; on one rank updated
    in place) replaces the initialisation from ``seed``, which the data
    stream uses too. ``plan`` (default ``ParallelPlan(1, 1, 1)``) must
    span the process group's world; each rank trains its shards of the
    logical tree, and ``TrainResult.params`` holds this rank's shards
    after the last step. The losses are the global batch's."""
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.device import resolve_device
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint as ckpt_mod
    from repro_torch.training.data import DataConfig, batches
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import build_train_step, train_mesh

    dev = resolve_device(device)
    if cfg.enc_dec is not None and seq > cfg.max_decode_context:
        raise ValueError(f"{cfg.name}'s decoder takes at most "
                         f"{cfg.max_decode_context} positions, not {seq}")
    plan = plan or ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    mesh = train_mesh(plan)
    model = build_model(cfg, dtype, dev)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed))
    if mesh.world > 1:
        params = WeightsManager(cfg, plan).train_shard(
            params, mesh.pod, mesh.data, mesh.model)
    opt = AdamW(lr=lr, warmup=min(50, steps // 4 or 1))
    step = build_train_step(model, plan, opt=opt, mesh=mesh)
    carry = (params, opt.init(params))
    it = batches(DataConfig(cfg.vocab_size, seq, batch, seed=seed))
    fe = frontend_embeds(cfg, batch, seed, dtype, dev)
    res = TrainResult(tokens_per_step=batch * seq)
    t_start = time.perf_counter()
    for i in range(steps):
        b = next(it)
        if fe is not None:
            b["frontend_embeds"] = fe
        t0 = time.perf_counter()
        carry, mets = step(carry, b)
        loss = float(mets["loss"])           # waits for the step
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        res.step_s.append(time.perf_counter() - t0)
        res.losses.append(loss)
        res.totals.append(float(mets["total"]))
        if i % log_every == 0 or i == steps - 1:
            tok_s = res.tokens_per_step * (i + 1) / (
                time.perf_counter() - t_start)
            log(f"step {i:5d} loss {loss:7.4f} ({tok_s:,.0f} tok/s, "
                f"{res.step_s[-1] * 1e3:.1f} ms/step)")
        if ckpt and (i + 1) % ckpt_every == 0:
            ckpt_mod.save_sharded(ckpt, carry[0], mesh, model, step=i + 1)
            log(f"  checkpoint @ {i + 1} -> {ckpt}")
    res.params, res.mesh = carry[0], mesh
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
    ap.add_argument("--ranks", type=int, default=1,
                    help="rank processes to train on (the JAX launcher's "
                         "local devices)")
    args = ap.parse_args(argv)
    if args.ranks > 1:
        import os
        from repro_torch.launch.ranks import spawn
        cpu = args.device == "cpu"
        # CPU ranks split the cores: oversubscribed OpenMP threads spin
        # while their rank waits in a collective
        spawn(_rank_main, args.ranks, (args,),
              device_type="cpu" if cpu else "cuda", timeout=None,
              threads=max((os.cpu_count() or 1) // args.ranks, 1)
              if cpu else None)
    else:
        _run(args)


def _rank_main(rank: int, world: int, args) -> None:
    """One rank of ``--ranks N``: the whole run; rank 0 alone prints."""
    import os
    import sys
    if rank:
        sys.stdout = open(os.devnull, "w")
    try:
        _run(args, plan_for_ranks(world))
    finally:
        if rank:
            sys.stdout.close()
            sys.stdout = sys.__stdout__


def _run(args, plan=None) -> None:
    from repro_torch.configs import get_config
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if plan is not None:
        print(f"{plan.pods * plan.data_rows * plan.tp_base} ranks: "
              f"tp_base {plan.tp_base} x data_rows {plan.data_rows}",
              flush=True)
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, device=args.device or None,
                dtype=torch.float32 if args.reduced else torch.bfloat16,
                ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                log_every=args.log_every, plan=plan)
    logged = [l for i, l in enumerate(res.losses)
              if i % args.log_every == 0 or i == args.steps - 1]
    if len(logged) >= 2:
        if not logged[-1] < logged[0]:
            raise SystemExit(f"loss did not decrease: {logged[0]:.4f} -> "
                             f"{logged[-1]:.4f}")
        print(f"final loss {logged[-1]:.4f} (from {logged[0]:.4f}) — OK")


if __name__ == "__main__":
    main()
