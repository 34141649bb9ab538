#!/usr/bin/env python3
"""Which collectives gloo takes on CUDA tensors, and what an all_reduce
costs, for two ranks that share one card.

    python3 tools/gloo_collectives.py [--ranks 2]

NCCL refuses two ranks on one card, so the port joins co-located ranks
with gloo (``communicator_pool.world_backend``). This spawns the ranks
as the launcher does (``launch/ranks.py``), each on ``cuda:(rank %
device_count)``, and on rank 0 prints, for fp32, bf16, int32 and int64
CUDA tensors, whether all_reduce SUM, MAX and MIN, broadcast and
all_gather give the right values; then the host-clock time of an
all_reduce of bf16 activations (a decode row of llama3-8b, 16 rows, and
a 256-row prefill chunk) and of an all_gather of one rank's K or V
heads at a striped merge-2 island (4 of llama3-8b's 8 KV heads of 128:
16 decode rows, and a 16-row prefill chunk of 2048 tokens),
synchronised with the card. The last line is one JSON object. The
times measure gloo staging through the host, not TP on separate cards.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SIZES = (4096, 16 * 4096, 256 * 4096)     # bf16 elements a call
GATHERS = (16 * 4 * 128, 16 * 2048 * 4 * 128)    # bf16 elements a rank


def rank_main(rank: int, world: int, out: str) -> None:
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    checks = {}
    for dtype in (torch.float32, torch.bfloat16, torch.int32, torch.int64):
        ranks = [torch.arange(8, device=dev).to(dtype) + r
                 for r in range(world)]
        want = {"sum": sum(ranks), "max": ranks[-1], "min": ranks[0],
                "broadcast": ranks[0]}
        for name, op in (("sum", dist.ReduceOp.SUM),
                         ("max", dist.ReduceOp.MAX),
                         ("min", dist.ReduceOp.MIN), ("broadcast", None)):
            t = ranks[rank].clone()
            if op is None:
                dist.broadcast(t, src=0)
            else:
                dist.all_reduce(t, op=op)
            checks[f"{dtype} {name}"] = bool(torch.equal(t, want[name]))
        got = [torch.empty_like(ranks[0]) for _ in range(world)]
        dist.all_gather(got, ranks[rank])
        checks[f"{dtype} all_gather"] = all(
            torch.equal(g, w) for g, w in zip(got, ranks))
    times = {}
    for n in SIZES:
        t = torch.randn(n, device=dev).to(torch.bfloat16)
        for _ in range(3):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        times[n] = (time.perf_counter() - t0) / 20 * 1e3
    gathers = {}
    for n in GATHERS:
        t = torch.randn(n, device=dev).to(torch.bfloat16)
        parts = [torch.empty_like(t) for _ in range(world)]
        for _ in range(2):
            dist.all_gather(parts, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            dist.all_gather(parts, t)
        torch.cuda.synchronize()
        gathers[n] = (time.perf_counter() - t0) / 5 * 1e3
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"checks": checks, "all_reduce_ms": times,
                       "all_gather_ms": gathers}, f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args(argv)
    import subprocess
    import tempfile

    import torch
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.ranks import spawn
    if not torch.cuda.is_available():
        print("gloo_collectives: no CUDA device is visible", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "gloo.json")
        spawn(rank_main, args.ranks, (out,), device_type="cuda", timeout=300)
        with open(out) as f:
            res = json.load(f)
    for k, ok in res["checks"].items():
        print(f"  {k}: {'ok' if ok else 'WRONG'}")
    for n, ms in res["all_reduce_ms"].items():
        print(f"  all_reduce bf16 {n} elements: {ms:.3f} ms")
    for n, ms in res["all_gather_ms"].items():
        print(f"  all_gather bf16 {n} elements a rank: {ms:.3f} ms")
    print(f"{smi}; {args.ranks} ranks on {torch.cuda.device_count()} "
          f"card(s), torch {torch.__version__}")
    res.update(device=smi, ranks=args.ranks)
    print(json.dumps(res))
    return 0 if all(res["checks"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
