#!/usr/bin/env python3
"""Time the serving path's attention kernels, K2 (paged decode) and K4
(paged chunked prefill), at chip_smoke.py's phase 3 shapes on one card.

    python3 tools/paged_kernels_bench.py [--src DIR] [--tag NAME]
                                         [--k2-splits N ...]

``--src`` is the ``src`` directory whose ``repro_torch`` to import (by
default this checkout's), so that two trees can be timed in one run on
one card: unpack the other tree with ``git archive`` into a directory
that .gitignore lists and call the script once per tree, in turns. Each
kernel is timed two ways: CUDA events around 20 back-to-back calls of
the wrapper (what chip_smoke.py reports; it includes the host's launch
overhead where the kernel is shorter than that), and the device time
per launch that torch.profiler records for the kernel alone. The last
line is one JSON object. ``--k2-splits`` also times K2 at each given
split count instead of the one its wrapper picks. Needs a CUDA card; the shapes are those of
llama3-8b (H 32, KV 8, hd 128, page 16, 256-block tables): decode B 8
over contexts 1 to 4096, prefill B 4 x T 512 over priors 0, 1024, 2560
and 3584, bf16.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def event_ms(torch, fn, iters=20, warm=3, windows=5) -> float:
    """The median over ``windows`` of the mean time of ``iters`` calls
    (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize()
        means.append(a.elapsed_time(b) / iters)
    return sorted(means)[windows // 2]


def device_ms(torch, fn, pattern: str, iters=20) -> float:
    """Mean device time of one launch of the kernels whose names hold
    ``pattern``, over ``iters`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if pattern in e.key:
            us += getattr(e, "self_device_time_total", 0) \
                or getattr(e, "self_cuda_time_total", 0)
            n += e.count
    return us / 1e3 / n if n else float("nan")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--k2-splits", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("paged_kernels_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.paged_attention import kernel as pk

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)
    H, KV, hd, page, nblk, MB = 32, 8, 128, 16, 4096, 256
    bf16 = torch.bfloat16
    kp, vp = (torch.randn((nblk, page, KV, hd), generator=gen,
                          device=dev).to(bf16) for _ in range(2))

    def table(B):
        return torch.from_numpy(rng.permutation(nblk - 1)[:B * MB].reshape(
            B, MB).astype(np.int32)).to(dev)
    B = 8
    ctx = torch.from_numpy(np.concatenate([[1, MB * page], rng.integers(
        2, MB * page, size=B - 2)]).astype(np.int32)).to(dev)
    bt = table(B)
    q = torch.randn((B, H, hd), generator=gen, device=dev).to(bf16)

    def k2():
        return pk.paged_attention_kernel(q, kp, vp, bt, ctx)
    B, T = 4, 512
    prior = torch.tensor([0, 1024, 2560, MB * page - T], dtype=torch.int32,
                         device=dev)
    bt4 = table(B)
    q4 = torch.randn((B, T, H, hd), generator=gen, device=dev).to(bf16)

    def k4():
        return fk.paged_flash_prefill_kernel(q4, kp, vp, bt4, prior)
    res = {"tree": args.tag, "device": smi, "kernels": {}}
    runs = [("paged_attention", k2, "decode_kernel"),
            ("paged_flash_prefill", k4, "prefill")]
    for n in args.k2_splits:
        runs.append((f"paged_attention splits={n}",
                     lambda n=n: pk.paged_attention_kernel(q, kp, vp, bt, ctx,
                                                           splits=n),
                     "decode_kernel"))
    for name, fn, pat in runs:
        res["kernels"][name] = {"event_ms": event_ms(torch, fn),
                                "device_ms": device_ms(torch, fn, pat)}
        print(f"{args.tag}: {name} {res['kernels'][name]['event_ms']:.4f} "
              f"ms by events, {res['kernels'][name]['device_ms']:.4f} ms "
              f"on the device ({smi})")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
