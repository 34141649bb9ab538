#!/usr/bin/env python3
"""Time K6's forward and backward (bf16, mamba2-2.7b's training shape)
and K1's paged append (llama3-8b's decode shape) on one card, two ways
each.

    python3 tools/k6_k1_bench.py [--src DIR] [--tag NAME] [--skip-k6]

``--src`` is the ``src`` directory whose ``repro_torch`` to import (by
default this checkout's), so that two trees can be timed in one run on
one card: unpack the other tree with ``git archive`` into a directory
that .gitignore lists and call the script once per tree, in turns.
Times: CUDA events around back-to-back calls of the wrapper (what
chip_smoke.py reports; for K1 it includes the host's launch path, which
is longer than the kernel), and the device time of every kernel one call
launches, summed, from torch.profiler. Beside K1: ``index_copy_`` on the
K and V pools (two calls), and the host time of the two ways to read the
current stream's handle. Shapes: K6 backward Bs 4, T 2048, H 80, hd 64,
S 128, chunk 128, bf16 x, B, C, fp32 dy holding bf16 values (as in
training); K1 B 8 rows of KV 8 x hd 128 into a 4096 x 16 bf16 pool, two
rows parked; K6 forward the backward's inputs. The last line is one
JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
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


def device_ms(torch, fn, iters=10):
    """(device ms per call summed over every kernel it launches, {kernel
    name: device ms per call}) over ``iters`` calls under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) \
            or getattr(e, "self_cuda_time_total", 0)
        if us and not e.key.startswith("cuda"):
            per[e.key[:40]] = per.get(e.key[:40], 0.0) + us / 1e3 / iters
    return sum(per.values()), per


def host_us(fn, n=20000) -> float:
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--skip-k6", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import _lib
    from repro_torch.kernels.paged_attention import kernel as pk
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda")
    _lib.build_all()
    gen = torch.Generator(device=dev).manual_seed(0)
    out: dict = {"tag": args.tag}

    # K1: decode append
    KV, hd, nblk, page, B = 8, 128, 4096, 16, 8
    pools = tuple(torch.randn((nblk, page, KV, hd), generator=gen,
                              device=dev).to(torch.bfloat16)
                  for _ in range(2))
    vals = tuple(torch.randn((B, KV, hd), generator=gen, device=dev)
                 .to(torch.bfloat16) for _ in range(2))
    slots = torch.randperm((nblk - 1) * page, generator=gen,
                           device=dev)[:B].to(torch.int32)
    slots[[2, 5]] = -1
    flat = tuple(p.view(-1, KV * hd) for p in pools)
    idx = torch.where(slots >= 0, slots.long(), nblk * page - 1)
    rows = tuple(v.reshape(B, KV * hd) for v in vals)

    def k1():
        pk.paged_append_token_kernel(pools, vals, slots)

    def lib():
        for f, v in zip(flat, rows):
            f.index_copy_(0, idx, v)
    out["k1_events_ms"] = event_ms(torch, k1)
    out["index_copy_x2_events_ms"] = event_ms(torch, lib)
    out["k1_device_ms"], out["k1_kernels"] = device_ms(torch, k1)
    out["index_copy_x2_device_ms"], _ = device_ms(torch, lib)
    out["current_stream_us"] = host_us(
        lambda: torch.cuda.current_stream(dev).cuda_stream)
    if hasattr(torch._C, "_cuda_getCurrentRawStream"):
        out["raw_stream_us"] = host_us(
            lambda: torch._C._cuda_getCurrentRawStream(0))
    del pools, flat

    if not args.skip_k6:
        from repro_torch.kernels.ssd_scan import kernel as sk
        Bs, T, H, hd, S, ch = 4, 2048, 80, 64, 128, 128

        def rnd(shape):
            return torch.randn(shape, generator=gen, device=dev)
        ins = (F.silu(rnd((Bs, T, H, hd))).to(torch.bfloat16),
               F.softplus(rnd((Bs, T, H))),
               -torch.linspace(1.0, 16.0, H, device=dev),
               F.silu(rnd((Bs, T, S))).to(torch.bfloat16),
               F.silu(rnd((Bs, T, S))).to(torch.bfloat16))
        dy = rnd((Bs, T, H, hd)).to(torch.bfloat16).float()

        def k6f():
            sk.ssd_scan_kernel(*ins, chunk=ch)
        out["k6_fwd_events_ms"] = event_ms(torch, k6f, iters=5)
        out["k6_fwd_device_ms"], out["k6_fwd_kernels"] = device_ms(
            torch, k6f, iters=3)
        _, _, st = sk.ssd_scan_kernel(*ins, chunk=ch)

        def k6b():
            sk.ssd_scan_bwd_kernel(*ins, st, dy, chunk=ch)
        out["k6_bwd_events_ms"] = event_ms(torch, k6b, iters=5)
        out["k6_bwd_device_ms"], out["k6_bwd_kernels"] = device_ms(
            torch, k6b, iters=3)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k6b()
        torch.cuda.synchronize()
        out["k6_bwd_transient_mib"] = (torch.cuda.max_memory_allocated()
                                       - base) / 2 ** 20
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
