#!/usr/bin/env python3
"""Time K2 at MLA width (``mla_decode``) at DeepSeek-V2's decode shape on
one card: B 8, H 128, W 576, R 512, page 16, 256-block tables, contexts
1 to 4096, fp32 q over a bf16 pool (the tensor-core route) and over an
fp32 pool (the CUDA-core route).

    python3 tools/mla_decode_bench.py [--src DIR] [--tag NAME] [--lse]
                                      [--splits N ...]
                                      [--case B CTX SPLITS ...]

``--src`` is the ``src`` directory whose ``repro_torch`` to import (by
default this checkout's), so that two trees can be timed in one run on
one card: unpack the other tree with ``git archive`` into a directory
that .gitignore lists and call the script once per tree, in turns. Each
route is timed two ways: CUDA events around 20 back-to-back calls of the
wrapper (what chip_smoke.py reports), and the device time per launch
that torch.profiler records for the kernel alone. ``--splits`` also
times the bf16 route at each given split count instead of the one its
wrapper picks; ``--case B CTX SPLITS`` (repeatable) at other batches
and contexts (B at most 8: the first B requests' queries and pages);
``--lse`` also times both routes returning the LSE (a tree whose wrapper
takes ``return_lse``). Each result's largest difference from the plain version is printed
beside its times. The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))

from paged_kernels_bench import device_ms, event_ms  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--tag", default="this tree")
    ap.add_argument("--splits", type=int, nargs="*", default=[])
    ap.add_argument("--case", type=int, nargs=3, action="append",
                    default=[], metavar=("B", "CTX", "SPLITS"),
                    help="also time the bf16 route over B requests of CTX "
                         "keys each in SPLITS splits (0: the wrapper's)")
    ap.add_argument("--lse", action="store_true",
                    help="also time both routes with return_lse=True")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("mla_decode_bench: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, args.src)
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ref as pr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    B, H, W, R, page, nblk, MB = 8, 128, 576, 512, 16, 4096, 256
    ctx_np = np.concatenate([[1, MB * page], rng.integers(
        2, MB * page, size=B - 2)]).astype(np.int32)
    q = torch.from_numpy(rng.standard_normal((B, H, W)) * W ** -0.5).to(
        dev, torch.float32)
    pool = torch.from_numpy(rng.standard_normal((nblk, page, W))).to(
        dev, torch.bfloat16)
    pool32 = pool.float()
    bt = torch.from_numpy(rng.permutation(nblk - 1)[:B * MB].reshape(
        B, MB).astype(np.int32)).to(dev)
    ctx = torch.from_numpy(ctx_np).to(dev)

    res = {"tree": args.tag, "device": smi, "kernels": {}}
    runs = [("mla_decode bf16 pool", pool, None),
            ("mla_decode fp32 pool", pool32, None)]
    runs += [(f"mla_decode bf16 pool splits={n}", pool, n)
             for n in args.splits]
    runs = [(name, p, n, q, bt, ctx, False) for name, p, n in runs]
    if args.lse:
        runs += [(f"mla_decode {d} pool, with its LSE", p, None, q, bt, ctx,
                  True) for d, p in (("bf16", pool), ("fp32", pool32))]
    for b_, c_, n in args.case:
        if not 0 < b_ <= B or not 0 <= c_ <= MB * page:
            ap.error(f"--case takes B 1-{B} and CTX 0-{MB * page}")
        runs.append((f"mla_decode bf16 pool B {b_} ctx {c_} splits={n}",
                     pool, n or None, q[:b_], bt[:b_],
                     torch.full((b_,), c_, dtype=torch.int32, device=dev),
                     False))
    for name, p, n, q_, bt_, ctx_, lse in runs:
        def fn(p=p, n=n, q_=q_, bt_=bt_, ctx_=ctx_, lse=lse):
            kw = {"return_lse": True} if lse else {}
            out = pk.paged_mla_attention_kernel(q_, p, bt_, ctx_, R=R,
                                                splits=n, **kw)
            return out[0] if lse else out
        err = float((fn() - pr.paged_mla_attention_ref(
            q_, p, bt_, ctx_, R=R)).abs().max())
        r = res["kernels"][name] = {"event_ms": event_ms(torch, fn),
                                    "device_ms": device_ms(torch, fn, "mla"),
                                    "max_abs_err": err}
        print(f"{args.tag}: {name} {r['event_ms']:.4f} ms by events, "
              f"{r['device_ms']:.4f} ms on the device, max |err| {err:.3g} "
              f"against the plain version ({smi})")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
