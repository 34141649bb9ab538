"""Trains full-width, full-depth mamba2-2.7b on one CUDA card several
ways from the same set-up as ``chip_smoke.py``'s phase 10 (batch 4 x 2048
tokens, 20 steps, AdamW at lr 1e-3 with 5 warm-up steps, bf16 parameters
and fp32 moments) and prints each run's loss and global gradient norm
(before clipping) at every step. A loss spike that follows the learning
rate or the seed, and that the plain SSD scan reproduces, comes from the
optimiser's dynamics, not from K6 or the bf16 path.

  python3 tools/mamba2_loss_witness.py                 # every run
  python3 tools/mamba2_loss_witness.py --runs k6 plain

Runs:
  k6       phase 10 itself: seed 0, lr 1e-3, bf16, through K6
  plain    as k6, the SSD scan computed by its plain version on the card
           (the same weights and batches; K6 is not launched)
  lr3e-4   as k6 at lr 3e-4
  seed1    as k6 with weights and data drawn from seed 1
  fp32     as k6 with fp32 parameters (45 GB of parameters, gradients
           and moments; reported, not fatal, if it does not fit)
"""
from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RUNS = ("k6", "plain", "lr3e-4", "seed1", "fp32")


def use_plain_ssd_scan():
    """Route the SSD op's CUDA branch through the plain versions."""
    from repro_torch.kernels.ssd_scan import ops, ref

    def bwd(x, dt, A, B, C, states, dy, *, chunk):
        return ref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk=chunk)
    kernels = ops.K
    ops.K = types.SimpleNamespace(ssd_scan_kernel=ref.ssd_scan_fwd_ref,
                                  ssd_scan_bwd_kernel=bwd)
    return lambda: setattr(ops, "K", kernels)


def record_grad_norms(torch, norms):
    """Wrap AdamW.update to append the global gradient norm it clips by."""
    from repro_torch.training import optimizer
    from repro_torch.training.checkpoint import tree_leaves
    update = optimizer.AdamW.update

    def recording(self, params, grads, state):
        norms.append(float(torch.stack(
            [g.float().square().sum() for g in tree_leaves(grads)])
            .sum().sqrt()))
        return update(self, params, grads, state)
    optimizer.AdamW.update = recording
    return lambda: setattr(optimizer.AdamW, "update", update)


def run(torch, name: str, steps: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train

    kw = dict(steps=steps, batch=4, seq=2048, device="cuda", lr=1e-3,
              seed=0, dtype=torch.bfloat16, log=lambda s: None)
    if name == "lr3e-4":
        kw["lr"] = 3e-4
    elif name == "seed1":
        kw["seed"] = 1
    elif name == "fp32":
        kw["dtype"] = torch.float32
    norms: list = []
    undo = [record_grad_norms(torch, norms)]
    if name == "plain":
        undo.append(use_plain_ssd_scan())
    _lib.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        res = train(get_config("mamba2-2.7b"), **kw)
    finally:
        for u in undo:
            u()
    out = dict(run=name, lr=kw["lr"], seed=kw["seed"],
               dtype=str(kw["dtype"]).removeprefix("torch."),
               losses=res.losses, grad_norms=norms,
               step_ms=sorted(res.step_s[1:])[(steps - 1) // 2] * 1e3,
               peak_gib=torch.cuda.max_memory_allocated() / 2**30,
               launches={k: _lib.LAUNCHES[k]
                         for k in ("ssd_scan", "ssd_scan_bwd")})
    del res
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", nargs="+", choices=RUNS, default=list(RUNS))
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failed = []
    for name in args.runs:
        try:
            out = run(torch, name, args.steps)
        except torch.OutOfMemoryError as e:
            print(f"run {name}: out of device memory ({e})")
            failed.append(name)
            continue
        finally:
            gc.collect()
            torch.cuda.empty_cache()
        print(f"run {name} (lr {out['lr']:g}, seed {out['seed']}, "
              f"{out['dtype']}): median step {out['step_ms']:.1f} ms, peak "
              f"{out['peak_gib']:.2f} GiB, launches {out['launches']}")
        for i, (l, g) in enumerate(zip(out["losses"], out["grad_norms"])):
            print(f"  step {i + 1:2d} loss {l:.4f} grad norm {g:.4f}")
        print(json.dumps(out))
        if not all(math.isfinite(x) for x in out["losses"]):
            failed.append(name)
    if failed:
        print(f"runs that failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
