#!/usr/bin/env python3
"""Serving over HTTP at full width on one card, with enough requests for
a tail: llama3-8b in bf16 (random weights from seed 0) behind FrontDoor
-> AsyncServeLoop(pace="wall") -> ServeHTTP on 127.0.0.1, as ``python
-m repro_torch.launch.serve --serve`` builds them, at ``chip_smoke.py``
phase 5's geometry and request lengths (prompts 256-2048, outputs
32-64). The requests come from ``loadgen.drive_http`` in a process of
their own, with Poisson arrivals at each ``--rates`` value.

Each run uses ``chip_smoke.http_wall_run`` (every stream must end done
with its full output in the vocab, K1-K4 must launch) and prints:

- the client's TTFT (send to first streamed token) p50, p90 and p99;
- the server's TTFT (the request's submission to the async loop to its
  first token, on the scheduler's clock) p50 and p99;
- the server's TPOT median (its clock tracks the wall at wall pace) and
  the wall tok/s;
- the server's share of the client's TTFT on the host's monotonic clock,
  p50 and p99 of each part: from a connection's accept
  (``ServeHTTP._handle``; accepts and submissions matched in time order)
  to its ``AsyncServeLoop.submit``, from there to the first token pushed
  into its stream, and from that push to the stream's consumer (the SSE
  writer) taking it.

An 8-request warm-up run comes first (phase 5's trace). Run from the
root of a checkout on a machine with the card:

    python3 tools/http_bench.py [--requests 200] [--rates 20 1] [--out F]

``--out`` also writes the readings to the JSON file ``F``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def mark_streams() -> dict:
    """Patch the serving classes to log, per request id, the monotonic
    times of its submission to the async loop, of its first token pushed
    into its stream and of that token taken by the stream's consumer,
    and under "accepts" each connection's accept time."""
    from repro_torch.serving.asyncloop import AsyncServeLoop, TokenStream
    from repro_torch.serving.server import ServeHTTP
    marks: dict = {}
    submit, push = AsyncServeLoop.submit, TokenStream.push
    handle, anext = ServeHTTP._handle, TokenStream.__anext__

    async def marked_handle(self, reader, writer):
        marks.setdefault("accepts", []).append(time.monotonic())
        await handle(self, reader, writer)

    async def marked_anext(self):
        ev = await anext(self)
        marks[self.req_id].setdefault("taken", time.monotonic())
        return ev

    def marked_submit(self, req, tier=None):
        marks[req.req_id] = {"submit": time.monotonic()}
        return submit(self, req, tier)

    def marked_push(self, ev):
        ok = push(self, ev)
        if ok:
            marks[self.req_id].setdefault("first", time.monotonic())
        return ok
    AsyncServeLoop.submit = marked_submit
    TokenStream.push = marked_push
    ServeHTTP._handle = marked_handle
    TokenStream.__anext__ = marked_anext
    return marks


def pct(np, xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--rates", type=float, nargs="+", default=[20.0, 1.0],
                    help="Poisson arrival rates (requests/s), one run each")
    ap.add_argument("--out", default="", help="JSON file for the readings")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("http_bench: no CUDA device is visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import _lib
    from repro_torch.serving.metrics import summarize

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    _lib.build_all()
    marks = mark_streams()
    print("bench: warm-up, phase 5's 8 requests")
    weights, _ = chip_smoke.http_wall_run(torch, smi,
                                          chip_smoke.serve_config())
    results = []
    for rate in args.rates:
        chip_smoke.gc_collect(torch)
        marks.clear()
        cfg = chip_smoke.serve_config(requests=args.requests, rate=rate)
        print(f"bench: {args.requests} requests, Poisson {rate}/s")
        _, run = chip_smoke.http_wall_run(torch, smi, cfg, weights)
        accepts = sorted(marks.pop("accepts"))
        reqs = sorted(marks.values(), key=lambda m: m["submit"])
        for m, t in zip(reqs, accepts):
            m["accept"] = t
        split = {}
        for a, z in (("accept", "submit"), ("submit", "first"),
                     ("first", "taken")):
            lag = [m[z] - m[a] for m in reqs]
            split[f"{a}_to_{z}_ms"] = {"p50": pct(np, lag, 50),
                                       "p99": pct(np, lag, 99)}
        done = [r for r in run["requests"] if r.state == "done"]
        server_ttft = [r.first_token_t - r.arrival for r in done]
        m = summarize(run["requests"])
        row = dict(
            rate=rate, requests=args.requests, wall_s=run["wall_s"],
            tokens=run["tokens"], steps=run["steps"],
            tok_per_s=run["tokens"] / run["wall_s"],
            client_ttft_ms={q: pct(np, run["ttft"], q)
                            for q in (50, 90, 99)},
            server_ttft_ms={q: pct(np, server_ttft, q) for q in (50, 99)},
            tpot_median_ms=m.median_tpot * 1e3, split=split, device=smi)
        results.append(row)
        print(f"bench: rate {rate}/s: client TTFT p50 "
              f"{row['client_ttft_ms'][50]:.1f} p90 "
              f"{row['client_ttft_ms'][90]:.1f} p99 "
              f"{row['client_ttft_ms'][99]:.1f} ms; server TTFT p50 "
              f"{row['server_ttft_ms'][50]:.1f} p99 "
              f"{row['server_ttft_ms'][99]:.1f} ms; TPOT median "
              f"{row['tpot_median_ms']:.2f} ms; {row['tok_per_s']:.1f} "
              f"tok/s over {row['wall_s']:.3f} s; {smi}")
        print("bench: server split " + "; ".join(
            f"{k} p50 {v['p50']:.1f} p99 {v['p99']:.1f}"
            for k, v in split.items()))
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=1) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
