#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, on a machine with the card and the CUDA
toolkit:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # build + kernel checks only

Phases, each of which fails the run (non-zero exit) if anything is off:

1. print the card's name and power limit (nvidia-smi); turn TF32 off;
2. build every CUDA kernel from ``src/repro_torch/kernels/csrc`` with
   nvcc (one process per source, all at once) and print each kernel's
   registers and spills (``-Xptxas -v``);
3. hold each kernel against its plain PyTorch version at its path's
   shapes (serving for K1-K4; training, batch 4 x 2048 tokens of
   llama3-8b, for K5 and its backward), in fp32 (atol 1e-4) and bf16
   (atol 1e-3, rtol 1e-2: both sides accumulate in fp32 and round once,
   so they may differ by one bf16 unit, a relative 2^-8 to 2^-7; K5's
   bf16 kernels keep P and dS to 16 bits as bf16 hi + lo halves; the
   appends bit-exact), and time kernel, plain version and one PyTorch
   library call computing the same function (CUDA events, warm, the
   median of five windows, three for the slowest calls); K6 and its
   backward (training, batch 4 x 2048 tokens of mamba2-2.7b, and a
   ragged T through the autograd op) at rtol 1e-4 with an atol of 1e-4
   times each output's largest entry (dA and dt sum thousands of terms
   that cancel), 1e-2 of both for bf16 gradients (one bf16 unit), with
   no library call to time (no single PyTorch call computes the scan);
   K7 and its backward (training, batch 4 x 2048 tokens of
   recurrentgemma-9b's 4096 channels, in fp32, with a drawn as a
   sigmoid and within 1e-3 of 1, and a ragged shape through the autograd
   op) at K6's tolerance, with no library call either; K5 and its
   backward at recurrentgemma-9b's attention shape (hd 256, 16 query
   heads on one kv head, window 2048) at batch 4 x 2048 and at batch
   2 x 4096, where the window masks keys, timed against SDPA; K2 and K4
   also at rep = H/KV of 7 (H 14, KV 2, hd 64) and 12 (H 96, KV 8, hd
   128), with K2's split count and K4's blocks printed; K1's and K3's
   device time a launch (torch.profiler) printed beside their events
   time and ``index_copy_``'s, and so is the device time a call of each
   of K6's three bf16 forward kernels (chunk_state_tc, state_pass,
   chunk_scan_tc) beside the forward's events time; K4's bf16 kernel and
   K6's bf16 tensor-core kernels (forward chunk_state_tc and
   chunk_scan_tc, backward dc_tc and dxb_tc) must show HGMMA
   instructions in the SASS of every instance; K2 at MLA width
   (``mla_decode``: fp32 q over the one compressed bf16 pool, KV 1) at
   DeepSeek-V2's decode shape (B 8, H 128, W 576, R 512, page 16,
   contexts 1 to 4096) with and without a window, and at W 80 / R 64 and
   W 48 / R 32, in fp32 (atol 1e-4), timed against SDPA over the
   gathered context (one kv head whose 128 query heads are SDPA's query
   rows), and the one-pool K1 and K3 forms at width 576, bit-exact,
   timed against ``index_copy_``;
4. serve a small request trace with the reduced llama3-8b in fp32 on the
   card and on the CPU (plain versions): the greedy tokens and the phase
   log must be identical; then four requests over a 12-block pool, where
   decode growth finds the pool full and the scheduler evicts and
   recovers a request: tokens, phases and the recovered count (> 0)
   must be identical;
5. serve 8 seeded requests at the full width of llama3-8b in bf16
   through ``repro_torch.launch.serve`` (its real path: DynamicScheduler
   over FlyingEngine under the layout policy), each step's duration
   logged for phase 13, with every kernel's launch count reset just
   before and
   read just after: every request must finish with its full output,
   every token must be in the vocab, K1-K4 must have launched,
   and no token may have been read back one at a time;
6. serve the same trace again under torch.profiler and print the device
   time by kernel class, the device's busy share of the wall time, and
   K2's, K4's and the appends' launches and mean time a launch;
13. (run right after phase 6, on phase 5's trace) serve llama3-8b at
   full width in bf16 over HTTP: ``FrontDoor`` -> ``AsyncServeLoop``
   (wall pace, tokens harvested as ``--serve`` harvests them) ->
   ``ServeHTTP`` on 127.0.0.1, the trace replayed by
   ``loadgen.drive_http``: every stream must end done with exactly its
   output length in the vocab, K1-K4 must have launched and ``GET
   /metrics`` must serve the rolling tier report; client-side TTFT p50
   and p99, the TPOT median (the server's clock, which tracks the wall
   at wall pace) and the wall tok/s are printed beside the card's name
   and power limit, as smoke readings of 8 requests (their p99 is in
   effect their maximum; ``tools/http_bench.py`` serves a few hundred
   requests for a tail). Then the trace in
   process at virtual pace, with phase 5's step durations replayed so
   the schedule (and bf16 batching) is phase 5's: the streamed greedy
   tokens must equal phase 5's; and at temperature 0.8, top-k 50,
   per-request seeds, the streamed tokens must equal an offline run's
   on the same schedule;
7. train the reduced llama3-8b three fp32 steps on the card (K5 forward
   and backward) and on the CPU (their plain versions) from the same
   weights and batches: the losses must agree (rtol 1e-4); then three
   bf16 steps from the same bf16 weights, whose losses must agree within
   twice the CPU's own relative bf16-vs-fp32 drift over those steps;
8. train llama3-8b at full width, 4 of its 32 layers, in bf16 (fp32
   AdamW moments), batch 4 x 2048 tokens, 20 steps, through
   ``repro_torch.launch.train.train``, with the launch counts reset
   just before and read just after: every loss must be finite, the last
   below the first, and K5 must have launched 8 times forward (twice per
   layer: the forward pass and its recomputation under remat) and 4
   times backward per step; then two more steps under torch.profiler
   for the device time by kernel class;
9. train the reduced mamba2-2.7b three fp32 steps on the card (K6
   forward and backward) and on the CPU from the same weights and
   batches: the losses must agree (rtol 1e-4);
10. train mamba2-2.7b at full width and all 64 layers in bf16 (fp32
   AdamW moments), batch 4 x 2048 tokens, 20 steps, as phase 8: finite
   losses, the last below the first, and K6 launched 128 times forward
   and 64 times backward per step; then two profiled steps (the bf16
   forward's three kernels and the bf16 backward's four by name);
11. train the 4-layer RecurrentGemma test config (reduced
   recurrentgemma-9b with one whole super-layer and one more RG-LRU
   layer) three fp32 steps of 128 tokens on the card (K7, K5) and on
   the CPU from the same weights and batches: the losses must agree
   (rtol 1e-4); then three bf16 steps as in phase 7;
12. train recurrentgemma-9b at full width, 6 of its 38 layers (two
   super-layers), in bf16 (fp32 AdamW moments), batch 4 x 2048 tokens,
   20 steps, as phase 8: finite losses, the last below the first, K7
   launched 8 times forward and 4 times backward per step (four RG-LRU
   layers), K5 4 and 2 (two local-attention layers); then two profiled
   steps;
14. (run after phase 12, with this process's card memory freed) two
   rank processes share the one card, joined over gloo (NCCL refuses two
   ranks on one card; the backend is printed, and no time here measures
   TP on two cards): (a) the reduced llama3-8b in fp32 at
   ``ParallelPlan(1, 1, 2)``, 8 requests with the merge scripted DP ->
   TP2 -> DP, on the card and on the CPU in each rank: streams and
   schedules equal, on both ranks; (c) K2's ``return_lse`` partials over
   two halves of each request's pages, one half a rank, merged by
   ``TPContext.lse_merge`` across the ranks, against one whole K2 call
   (fp32 tolerance); (b) llama3-8b at full width and depth in bf16
   serving phase 5's 8 requests with the merge scripted 1 -> 2 -> 1:
   every request done with its full output in the vocab, every rebind's
   weight and pool ``data_ptr``s unchanged; then fleet decode ticks of 16
   requests at merge 1 and at merge 2, with K1-K4's launches at the
   merge-2 view (pages of 32 tokens, 4 of the 8 KV heads a rank) counted
   from zero and required, and every greedy token of both ticks held
   against a dense one-rank forward of the whole model fed the same
   tokens (K5, the full vocab, no pool and no collective): its argmax, or
   a near-tie (a margin of at most NEAR_TIE_SD of the row's deviation),
   whose margin is printed; rebind ms,
   the pool's group build ms against its lookup us, TP collectives a
   step and each rank's peak memory are printed; (d) the reduced
   llama3-8b with 2 KV heads (its one KV head is readable at no merge
   above 1) in fp32, card against CPU in each rank: 8 requests under
   LIVE with the merge scripted DP -> TP2 while decodes and a chunked
   prefill are in flight (riders carried, nothing paused or
   recomputed), a pure-SP island ``Island(0, 2, 2, sp=2)`` serving a
   context over one engine's pool (tokens equal to a big pool's), and a
   KILL of engine 1 mid-decode recovered onto engine 0 (the fault-free
   stream, no block leaked): streams and schedules equal, on both ranks;
   (e) llama3-8b at full width and depth in bf16 over the same weights:
   phase 5's 8 requests under LIVE with the merge scripted 1 -> 2 while
   decodes and a chunked prefill are in flight (every request done,
   nothing paused or recomputed, ``data_ptr``s unchanged, K2's and K4's
   LSE launches, the live lanes' sweeps, counted from zero and
   required, the riders' greedy tokens held against the dense one-rank
   forward), a decode tick of 16 tag-1 riders at merge 2 timed beside
   (b)'s plain merge-2 tick (lanes and collectives a tick printed), and
   one 3072-token request on a pure-SP island whose pool is cut to 24
   blocks of 128 tokens a rank (its greedy tokens held the same way).
15. (run after phase 14) MLA and MoE: (a) the reduced deepseek-v2-236b
   (MLA + MoE) and phi3.5-moe-42b-a6.6b (GQA + MoE) in fp32 through a
   scheduler run of six requests with prefill, mixed and decode steps,
   on the card (K1, K3 and mla_decode; K1-K4) and on the CPU: greedy
   tokens and phase logs equal; (b) deepseek-v2-236b at full width, 4 of
   its 60 layers (the dense MLA+MLP layer and three MLA+MoE layers;
   13.3 B parameters in bf16, seed 0), at ParallelPlan(1, 1, 1) over a
   4096 x 16-token pool, 8 requests of 256-1024 prompt tokens and 32
   out through the launcher's real path: every request done, every
   sampled row's logits finite, mla_decode and K1 launched 4 times in
   every step with decode rows and K3 4 times in every step with
   prefill rows; tok/s, the median decode tick and the peak memory
   printed; the MoE entries its capacity factor (1.25) drops counted;
   then the same trace in prefill chunks of 1 (no step over 8 tokens,
   so no entry drops, counted), whose greedy tokens are held against a
   dense forward (no pool, naive MLA, every token through its top-k
   experts): its argmax, or a near-tie within NEAR_TIE_SD; then a
   profiled rerun's device time by kernel class (GEMMs, MoE dispatch,
   mla_decode, elementwise) and busy share.

Each kernel's launch count in the JSON record comes from the path that
runs it: K1-K4 from phase 5, K5 and its backward at hd 128 from phase 8
and at hd 256 from phase 12, K6 and its backward from phase 10, K7 and
its backward from phase 12, mla_decode and the one-pool K1 and K3 from
phase 15 (b)'s first run (phase 14 prints its own K1-K4 counts, and
K2's and K4's LSE launches, in its rank processes). The line
before the last is the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
F32_TOL = dict(atol=1e-4, rtol=0.0)
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
# phase 14 (b): the largest logit margin, in standard deviations of the
# row over the vocab, at which a greedy token may differ from a dense
# one-rank forward's argmax (a near-tie)
NEAR_TIE_SD = 0.25
SERVE_KERNELS = ("paged_append_token", "paged_attention",
                 "paged_append_chunk", "paged_flash_prefill")
TRAIN_KERNELS = ("flash_prefill", "flash_prefill_bwd")
MAMBA_KERNELS = ("ssd_scan", "ssd_scan_bwd")
# K6's bf16 forward kernels, in launch order
SSD_FWD_TC = ("chunk_state_tc", "state_pass", "chunk_scan_tc")
MAMBA_STEPS = 20
# the bf16 K5 kernels' classes in the profiled breakdowns
FLASH_CLASSES = (("flash_prefill_bwd dq", "dq_tc"),
                 ("flash_prefill_bwd dkdv", "dkdv_tc"),
                 ("flash_prefill_bwd sum", "sum_parts"),
                 ("flash_prefill", "fwd_tc"))
# phase 12's kernels: the JSON rows of K5 at hd 256 take its launches
HYBRID_ROWS = {"rglru_scan": "rglru_scan",
               "rglru_scan_bwd": "rglru_scan_bwd",
               "flash_prefill_hd256": "flash_prefill",
               "flash_prefill_bwd_hd256": "flash_prefill_bwd"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def time_ms(torch, fn, iters: int = 20, warm: int = 3,
            windows: int = 5) -> float:
    """Time of one ``fn()`` on the card's timeline (CUDA events): the
    median over ``windows`` windows of the mean over ``iters`` calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return sorted(means)[windows // 2]


def launch_device_ms(torch, fn, pattern: str, iters: int = 20) -> float:
    """Mean device time of one launch of the kernels whose names hold
    ``pattern``, over ``iters`` calls of ``fn`` under torch.profiler;
    NaN where the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0) \
            or getattr(e, "self_cuda_time_total", 0)
        if t and pattern in e.key:
            us += t
            n += e.count
    return us / n / 1e3 if n else float("nan")


def bound(nbytes: float, flops: float):
    """The card's least time (ms) for ``nbytes`` moved and ``flops``
    done, at the H100's data-sheet HBM rate and dense bf16 peak."""
    from repro_torch.serving.hardware import H100
    t_b = nbytes / H100.hbm_bw * 1e3
    t_f = flops / H100.peak_flops_bf16 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_checks(torch, np):
    import torch.nn.functional as F

    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ref as pr
    from repro_torch.models.cache import paged_gather

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    # serving shapes of llama3-8b: H=32, KV=8, hd=128, page 16, a 4096-
    # block pool, 256-block tables, decode batch 8, prefill chunk 512
    H, KV, hd, page, nblk, MB = 32, 8, 128, 16, 4096, 256
    w = KV * hd
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    gen = torch.Generator(device=dev).manual_seed(0)

    def pools(dtype):
        return tuple(torch.randn((nblk, page, KV, hd), generator=gen,
                                 device=dev).to(dtype) for _ in range(2))

    def tables(B):
        perm = rng.permutation(nblk - 1)[:B * MB]
        return t(perm.reshape(B, MB), torch.int32)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def close(a, b, dtype, what):
        e = err(a, b)
        ok = torch.allclose(a.float(), b.float(),
                            **(F32_TOL if dtype == f32 else BF16_TOL))
        print(f"  {what}: max_abs_err={e:.3e}")
        check(ok, f"{what} disagrees with its plain version (max {e:.3e})")
        return e

    # -- K1 / K3: appends (bit-exact, scratch row excluded) --------------
    def append_case(kind, B, T, dtype):
        shape = (B,) if kind == "token" else (B, T)
        n = int(np.prod(shape))
        s = rng.choice((nblk - 1) * page, size=n, replace=False)
        s[rng.random(n) < 0.25] = -1                      # parked rows
        slots = t(s.reshape(shape), torch.int32)
        vals = tuple(t(rng.standard_normal(shape + (KV, hd)), dtype)
                     for _ in range(2))
        kern = pk.paged_append_token_kernel if kind == "token" \
            else pk.paged_append_chunk_kernel
        plain = pr.paged_append_token_ref if kind == "token" \
            else pr.paged_append_chunk_ref
        base = pools(dtype)
        got = kern(tuple(p.clone() for p in base), vals, slots)
        want = plain(tuple(p.clone() for p in base), vals, slots)
        torch.cuda.synchronize()
        for g, wnt in zip(got, want):
            g, wnt = g.view(-1, w), wnt.view(-1, w)
            check(torch.equal(g[:-1], wnt[:-1]),
                  f"paged_append_{kind} {dtype} is not bit-exact")
        print(f"  paged_append_{kind} {dtype} {tuple(shape)}: bit-exact")
        return base, vals, slots, kern, plain, n

    def append_row(kind, name, replaces, B, T):
        append_case(kind, B, T, f32)
        base, vals, slots, kern, plain, n = append_case(kind, B, T, bf16)
        flat = tuple(p.view(-1, w) for p in base)
        idx = torch.where(slots.reshape(-1) >= 0, slots.reshape(-1).long(),
                          nblk * page - 1)
        rows_v = tuple(v.reshape(n, w) for v in vals)

        def library():
            for f, v in zip(flat, rows_v):
                f.index_copy_(0, idx, v)
        nbytes = 2 * n * w * (2 + 2) + 4 * n
        bms, by = bound(nbytes, 0.0)
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_append.cu",
            replaces=replaces, max_abs_err=0.0,
            ms=time_ms(torch, lambda: kern(base, vals, slots)),
            plain_ms=time_ms(torch, lambda: plain(base, vals, slots)),
            bound_ms=bms, bound_by=by, library_ms=time_ms(torch, library))
        rows.append(row)
        dev_ms = launch_device_ms(torch, lambda: kern(base, vals, slots),
                                  "append_rows")
        lib_dev = launch_device_ms(torch, library, "index")
        print(f"  {name} ({n} rows): events {row['ms']:.4f} ms a call, "
              f"device {dev_ms:.4f} ms a launch (profiler); index_copy_ "
              f"x2 events {row['library_ms']:.4f} ms, device "
              f"{2 * lib_dev:.4f} ms")

    print("kernels against their plain versions:")
    append_row("token", "paged_append_token",
               "src/repro/kernels/paged_attention/kernel.py:165", 8, 1)

    # -- K2: paged decode attention --------------------------------------
    B = 8
    ctx_np = np.concatenate([[1, MB * page], rng.integers(
        2, MB * page, size=B - 2)]).astype(np.int32)
    ctx = t(ctx_np, torch.int32)
    bt = tables(B)
    errs = []
    for dtype in (f32, bf16):
        kp_, vp_ = pools(dtype)
        q = t(rng.standard_normal((B, H, hd)), dtype)
        for window, lse in ((None, False), (1024, False), (None, True)):
            tag = f"paged_attention {dtype} window={window} lse={lse}"
            if lse:
                c0 = ctx.clone()
                c0[2] = 0                      # a row with no live key
                g, gl = pk.paged_attention_kernel(
                    q.float(), kp_, vp_, bt, c0, return_lse=True)
                wnt, wl = pr.paged_attention_with_lse_ref(
                    q.float(), kp_, vp_, bt, c0)
                close(gl, wl, f32, tag + " (lse)")
            else:
                g = pk.paged_attention_kernel(q, kp_, vp_, bt, ctx,
                                              window=window)
                wnt = pr.paged_attention_ref(q, kp_, vp_, bt, ctx,
                                             window=window)
            e = close(g, wnt, dtype, tag)
            if dtype == bf16:
                errs.append(e)
    live = np.minimum(ctx_np, MB * page)
    nbytes = 2 * B * H * hd * 2 + int(live.sum()) * KV * hd * 2 * 2 \
        + int(np.ceil(live / page).sum()) * 4 + B * 4
    flops = 4.0 * H * hd * int(live.sum())
    bms, by = bound(nbytes, flops)
    kg = paged_gather(kp_, bt).transpose(1, 2).repeat_interleave(H // KV, 1)
    vg = paged_gather(vp_, bt).transpose(1, 2).repeat_interleave(H // KV, 1)
    mask = (torch.arange(MB * page, device=dev)[None, :]
            < ctx[:, None].long())[:, None, None, :]
    q4 = q[:, :, None, :]
    n_split, split_len = pk.decode_splits(B, KV, H // KV, MB * page, dev)
    print(f"  paged_attention: {n_split} splits of {split_len} keys, "
          f"{n_split * B * KV} blocks ({int(np.ceil(live / split_len).sum()) * KV}"
          f" with live keys)")
    rows.append(dict(
        name="paged_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:97",
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: pk.paged_attention_kernel(
            q, kp_, vp_, bt, ctx)),
        plain_ms=time_ms(torch, lambda: pr.paged_attention_ref(
            q, kp_, vp_, bt, ctx), iters=5, windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kg, vg, attn_mask=mask))))
    del kg, vg

    append_row("chunk", "paged_append_chunk",
               "src/repro/kernels/paged_attention/kernel.py:224", 8, 512)

    # -- K4: paged flash prefill -----------------------------------------
    B, T = 4, 512
    prior_np = np.array([0, 1024, 2560, MB * page - T], np.int32)
    prior = t(prior_np, torch.int32)
    bt = tables(B)
    errs = []
    for dtype in (f32, bf16):
        kp_, vp_ = pools(dtype)
        q = t(rng.standard_normal((B, T, H, hd)), dtype)
        for window, prior_only in ((None, False), (1024, False),
                                   (None, True)):
            tag = f"paged_flash_prefill {dtype} window={window} " \
                  f"prior_only={prior_only}"
            if prior_only:
                g, gl = fk.paged_flash_prefill_kernel(
                    q.float(), kp_, vp_, bt, prior, prior_only=True,
                    return_lse=True)
                wnt, wl = fr.paged_prefill_sweep_with_lse_ref(
                    q.float(), kp_, vp_, bt, prior, prior_only=True)
                close(gl, wl, f32, tag + " (lse)")
            else:
                g = fk.paged_flash_prefill_kernel(q, kp_, vp_, bt, prior,
                                                  window=window)
                wnt = fr.paged_flash_prefill_ref(q, kp_, vp_, bt, prior,
                                                 window=window)
            e = close(g, wnt, dtype, tag)
            if dtype == bf16:
                errs.append(e)
    print(f"  paged_flash_prefill: {fk.prefill_blocks(B, T, H, KV)} blocks "
          f"of 64 packed rows")
    keys = prior_np.astype(np.int64) + T                 # keys per request
    pairs = int(sum(T * int(p) + T * (T + 1) // 2 for p in prior_np))
    nbytes = 2 * B * T * H * hd * 2 + int(keys.sum()) * KV * hd * 2 * 2 \
        + int(np.ceil(keys / page).sum()) * 4 + B * 4
    flops = 4.0 * H * hd * pairs
    bms, by = bound(nbytes, flops)
    kg = paged_gather(kp_, bt).transpose(1, 2).repeat_interleave(H // KV, 1)
    vg = paged_gather(vp_, bt).transpose(1, 2).repeat_interleave(H // KV, 1)
    qpos = prior[:, None].long() + torch.arange(T, device=dev)[None, :]
    mask = (torch.arange(MB * page, device=dev)[None, None, :]
            <= qpos[:, :, None])[:, None]
    qt = q.transpose(1, 2)
    rows.append(dict(
        name="paged_flash_prefill", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/kernel.py:204",
        max_abs_err=max(errs),
        ms=time_ms(torch, lambda: fk.paged_flash_prefill_kernel(
            q, kp_, vp_, bt, prior)),
        plain_ms=time_ms(torch, lambda: fr.paged_flash_prefill_ref(
            q, kp_, vp_, bt, prior), iters=3, warm=1, windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=mask), iters=5, windows=3)))
    del kg, vg, mask, q, kp_, vp_
    paged_rep_checks(torch, np, rng, gen, close)
    rows.extend(mla_rows(torch, np, rng, close))

    # -- K5: dense causal flash attention, forward and backward ----------
    tile_checks(torch, rng)
    print_hgmma()
    # the training shape of llama3-8b: batch 4 x 2048 tokens
    rows.extend(flash_rows(torch, gen, close, "", H, KV, hd, [(4, 2048)],
                           (None, 1024)))
    torch.cuda.empty_cache()
    rows.extend(ssd_rows(torch, gen))
    torch.cuda.empty_cache()
    rows.extend(rglru_rows(torch, gen))
    torch.cuda.empty_cache()
    # recurrentgemma-9b's attention: hd 256, 16 query heads on one kv
    # head, window 2048, at 2 x 4096 (where the window masks keys) and at
    # its training shape, 4 x 2048 (where it masks nothing)
    rows.extend(flash_rows(torch, gen, close, "_hd256", 16, 1, 256,
                           [(2, 4096), (4, 2048)], (2048,)))
    _lib.reset_launches()
    torch.cuda.empty_cache()
    return rows


def paged_rep_checks(torch, np, rng, gen, close) -> None:
    """K2 and K4 at rep = H/KV of 7 (internvl2-1b's language model: H 14,
    KV 2, hd 64) and 12 (mistral-large-123b: H 96, KV 8, hd 128), and at
    the view one rank of a merge-2 llama3-8b island reads (H 16, KV 4,
    hd 128, pages of 32 tokens; K1 and K3 there too, bit-exact), against
    their plain versions, at phase 3's decode shape (B 8, contexts 1 to
    4096) and prefill shape (B 4, T 512; T 256 at rep 12, where the plain
    version's scores take 1.6 GB a copy): bf16 q over bf16 pools (K4 on
    the tensor cores) and fp32 q over bf16 pools with lse (K4 on the CUDA
    cores); the bf16 kernels' times are printed."""
    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr
    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ref as pr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    nblk, MB = 4096, 256

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    for H, KV, hd, Tp, page in ((14, 2, 64, 512, 16), (96, 8, 128, 256, 16),
                                (16, 4, 128, 512, 32)):
        rep = H // KV
        kp_, vp_ = (torch.randn((nblk, page, KV, hd), generator=gen,
                                device=dev).to(bf16) for _ in range(2))
        if page != 16:
            for kern, plain, shape in (
                    (pk.paged_append_token_kernel, pr.paged_append_token_ref,
                     (8,)),
                    (pk.paged_append_chunk_kernel, pr.paged_append_chunk_ref,
                     (4, Tp))):
                n = int(np.prod(shape))
                s = rng.choice((nblk - 1) * page, size=n, replace=False)
                slots = t(s.reshape(shape), torch.int32)
                vals = tuple(torch.randn(shape + (KV, hd), generator=gen,
                                         device=dev).to(bf16)
                             for _ in range(2))
                got = kern((kp_.clone(), vp_.clone()), vals, slots)
                want = plain((kp_.clone(), vp_.clone()), vals, slots)
                check(all(torch.equal(g, w) for g, w in zip(got, want)),
                      f"{kern.__name__} at page {page}, KV {KV} is not "
                      f"bit-exact")
                print(f"  {kern.__name__} page {page} KV {KV} "
                      f"{tuple(shape)}: bit-exact")
        B = 8
        ctx = t(np.concatenate([[1, MB * page], rng.integers(
            2, MB * page, size=B - 2)]), torch.int32)
        bt = t(rng.permutation(nblk - 1)[:B * MB].reshape(B, MB),
               torch.int32)
        q = torch.randn((B, H, hd), generator=gen, device=dev)
        n_split, split_len = pk.decode_splits(B, KV, rep, MB * page, dev)
        tag = f"paged_attention rep {rep} hd {hd} page {page}"
        close(pk.paged_attention_kernel(q.to(bf16), kp_, vp_, bt, ctx),
              pr.paged_attention_ref(q.to(bf16), kp_, vp_, bt, ctx), bf16,
              f"{tag} bf16")
        o, lse = pk.paged_attention_kernel(q, kp_, vp_, bt, ctx,
                                           return_lse=True)
        wo, wl = pr.paged_attention_with_lse_ref(q, kp_, vp_, bt, ctx)
        close(lse, wl, f32, f"{tag} fp32 q (lse)")
        close(o, wo, f32, f"{tag} fp32 q")
        ms = time_ms(torch, lambda: pk.paged_attention_kernel(
            q.to(bf16), kp_, vp_, bt, ctx))
        print(f"  {tag}: {n_split} splits of {split_len} keys, "
              f"{ms:.4f} ms (bf16)")
        B = 4
        prior = t(np.array([0, 1024, 2560, MB * page - Tp]), torch.int32)
        bt = t(rng.permutation(nblk - 1)[:B * MB].reshape(B, MB),
               torch.int32)
        q = torch.randn((B, Tp, H, hd), generator=gen, device=dev)
        tag = f"paged_flash_prefill rep {rep} hd {hd} T {Tp} page {page}"
        for window in (None, 1024):
            close(fk.paged_flash_prefill_kernel(q.to(bf16), kp_, vp_, bt,
                                                prior, window=window),
                  fr.paged_flash_prefill_ref(q.to(bf16), kp_, vp_, bt,
                                             prior, window=window),
                  bf16, f"{tag} bf16 window={window}")
        o, lse = fk.paged_flash_prefill_kernel(q, kp_, vp_, bt, prior,
                                               prior_only=True,
                                               return_lse=True)
        wo, wl = fr.paged_prefill_sweep_with_lse_ref(q, kp_, vp_, bt, prior,
                                                     prior_only=True)
        close(lse, wl, f32, f"{tag} fp32 q prior_only (lse)")
        close(o, wo, f32, f"{tag} fp32 q prior_only")
        ms = time_ms(torch, lambda: fk.paged_flash_prefill_kernel(
            q.to(bf16), kp_, vp_, bt, prior))
        print(f"  {tag}: {fk.prefill_blocks(B, Tp, H, KV)} blocks, "
              f"{ms:.4f} ms (bf16)")
        del kp_, vp_, q, o, wo
        torch.cuda.empty_cache()


def mla_rows(torch, np, rng, close):
    """K2 at MLA width (``mla_decode``) against its plain version at
    DeepSeek-V2's decode shape (B 8, H 128, W 576, R 512, page 16,
    contexts 1 to 4096, fp32 q over a bf16 pool), with and without a
    window, and at the reduced W 80 / R 64 and the Pallas test's W 48 /
    R 32; the one-pool K1 and K3 forms (the compressed cache) bit-exact.
    Times the kernels, the plain versions and one PyTorch call each:
    SDPA over the context gathered (and cast to fp32) beforehand, one
    kv head whose 128 query heads are SDPA's query rows, the key mask
    of each request's context; ``index_copy_`` for the appends."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as pk
    from repro_torch.kernels.paged_attention import ref as pr
    from repro_torch.models.cache import paged_gather

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    B, H, W, R, page, nblk, MB = 8, 128, 576, 512, 16, 4096, 256
    rows = []

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    def case(B_, H_, W_, nblk_, MB_, page_, full_ctx):
        ctx = np.concatenate([[1, full_ctx], rng.integers(
            2, full_ctx, size=B_ - 2)]).astype(np.int32)
        return (t(rng.standard_normal((B_, H_, W_)) * W_ ** -0.5, f32),
                t(rng.standard_normal((nblk_, page_, W_)), bf16),
                t(rng.permutation(nblk_ - 1)[:B_ * MB_].reshape(B_, MB_),
                  torch.int32), t(ctx, torch.int32), ctx)

    q, pool, bt, ctx, ctx_np = case(B, H, W, nblk, MB, page, MB * page)
    err = 0.0
    for window in (None, 1024):
        err = max(err, close(
            pk.paged_mla_attention_kernel(q, pool, bt, ctx, R=R,
                                          window=window),
            pr.paged_mla_attention_ref(q, pool, bt, ctx, R=R, window=window),
            f32, f"mla_decode B {B} H {H} W {W} R {R} window={window}"))
    for H_, W_, R_, page_ in ((4, 80, 64, 16), (8, 48, 32, 8)):
        q2, pool2, bt2, ctx2, _ = case(B, H_, W_, 512, 32, page_,
                                       32 * page_)
        close(pk.paged_mla_attention_kernel(q2, pool2, bt2, ctx2, R=R_),
              pr.paged_mla_attention_ref(q2, pool2, bt2, ctx2, R=R_), f32,
              f"mla_decode B {B} H {H_} W {W_} R {R_} page {page_}")
    n_split, split_len = pk.mla_splits(B, H, MB * page, dev)
    live = ctx_np.astype(np.int64)
    nbytes = int(live.sum()) * W * 2 + B * H * (W + R) * 4 \
        + int(np.ceil(live / page).sum()) * 4 + B * 4
    flops = 2.0 * (W + R) * H * int(live.sum())
    bms, by = bound(nbytes, flops)
    kg = paged_gather(pool, bt).float()[:, None]          # [B,1,Tk,W]
    vg = kg[..., :R]
    mask = (torch.arange(MB * page, device=dev)[None, :]
            < ctx[:, None].long())[:, None, None, :]
    qs = q[:, None]                                       # [B,1,H,W]
    print(f"  mla_decode: {n_split} splits of {split_len} keys, "
          f"{n_split * B * -(-H // pk.MLA_HEADS)} blocks "
          f"({int(np.ceil(live / split_len).sum()) * -(-H // pk.MLA_HEADS)}"
          f" with live keys)")
    row = dict(
        name="mla_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_attention.cu",
        replaces="src/repro/kernels/paged_attention/kernel.py:97",
        max_abs_err=err,
        ms=time_ms(torch, lambda: pk.paged_mla_attention_kernel(
            q, pool, bt, ctx, R=R)),
        plain_ms=time_ms(torch, lambda: pr.paged_mla_attention_ref(
            q, pool, bt, ctx, R=R), iters=5, windows=3),
        bound_ms=bms, bound_by=by,
        library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kg, vg, attn_mask=mask, scale=1.0)))
    rows.append(row)
    dev_ms = launch_device_ms(torch, lambda: pk.paged_mla_attention_kernel(
        q, pool, bt, ctx, R=R), "decode")
    print(f"  mla_decode: events {row['ms']:.4f} ms a call, device "
          f"{dev_ms:.4f} ms a launch (profiler); bound {bms:.4f} ms "
          f"({by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP); at the "
          f"fp32 CUDA cores' 67 TFLOP/s the operations alone take "
          f"{flops / 67e12 * 1e3:.4f} ms")
    del kg, vg, mask, qs

    # the one-pool appends: DeepSeek-V2's entries of 576 bf16
    flat = pool.view(-1, W)
    for kind, shape, name, replaces in (
            ("token", (B,), "paged_append_token_mla",
             "src/repro/kernels/paged_attention/kernel.py:165"),
            ("chunk", (B, 512), "paged_append_chunk_mla",
             "src/repro/kernels/paged_attention/kernel.py:224")):
        kern = pk.paged_append_token_kernel if kind == "token" \
            else pk.paged_append_chunk_kernel
        plain = pr.paged_append_token_ref if kind == "token" \
            else pr.paged_append_chunk_ref
        n = int(np.prod(shape))
        s = rng.choice((nblk - 1) * page, size=n, replace=False)
        s[rng.random(n) < 0.25] = -1                      # parked rows
        slots = t(s.reshape(shape), torch.int32)
        for dtype in (f32, bf16):
            vals = (t(rng.standard_normal(shape + (W,)), dtype),)
            (got,) = kern((pool.clone(),), vals, slots)
            (want,) = plain((pool.clone(),), vals, slots)
            torch.cuda.synchronize()
            check(torch.equal(got.view(-1, W)[:-1], want.view(-1, W)[:-1]),
                  f"{name} ({dtype} values) is not bit-exact")
        print(f"  {name} {tuple(shape)}: bit-exact")
        idx = torch.where(slots.reshape(-1) >= 0, slots.reshape(-1).long(),
                          nblk * page - 1)
        rows_v = vals[0].reshape(n, W)
        nbytes = n * W * (2 + 2) + 4 * n
        bms, by = bound(nbytes, 0.0)
        row = dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/paged_append.cu",
            replaces=replaces, max_abs_err=0.0,
            ms=time_ms(torch, lambda: kern((pool,), vals, slots)),
            plain_ms=time_ms(torch, lambda: plain((pool,), vals, slots)),
            bound_ms=bms, bound_by=by,
            library_ms=time_ms(torch, lambda: flat.index_copy_(0, idx,
                                                               rows_v)))
        rows.append(row)
        dev_ms = launch_device_ms(torch, lambda: kern((pool,), vals, slots),
                                  "append_rows")
        print(f"  {name} ({n} rows of {W}): events {row['ms']:.4f} ms a "
              f"call, device {dev_ms:.4f} ms a launch (profiler)")
    del pool
    torch.cuda.empty_cache()
    return rows


def tile_checks(torch, rng):
    """The bf16 K5 kernels' tile machinery on one tile pair of each
    operand layout, against torch.matmul in fp32 (TF32 off), each entry
    held to a bound on its rounding: a b^T (both bf16 operands K-major in
    swizzled shared memory) by fp32 summation, hd units of 2^-24 of
    sum |a||b|; a b (a fp32 as bf16 hi + lo register fragments, b
    N-major) by 2^-16 of sum |a||b|."""
    from repro_torch.kernels.flash_prefill import kernel as fk

    dev = torch.device("cuda")

    def t(shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
    for hd in (64, 128, 256):
        a, b = t((64, hd)), t((64, hd))
        got = fk.flash_tile_check(a, b, 0)
        want = a.float() @ b.float().T
        lim = (a.float().abs() @ b.float().abs().T) * hd * 2.0 ** -24
        e0 = float((got - want).abs().max())
        check(bool(((got - want).abs() <= lim).all()),
              f"tile product a b^T at hd {hd} off by {e0:.3e}")
        a = t((64, 64), torch.float32)
        got = fk.flash_tile_check(a, b, 1)
        want = a @ b.float()
        lim = (a.abs() @ b.float().abs()) * 2.0 ** -16
        e1 = float((got - want).abs().max())
        check(bool(((got - want).abs() <= lim).all()),
              f"tile product a b at hd {hd} off by {e1:.3e}")
        print(f"  tile products at hd {hd} against torch.matmul: a b^T "
              f"(SS, K-major) max_abs_err={e0:.3e}, a b (RS hi + lo, "
              f"N-major) max_abs_err={e1:.3e}")


def print_hgmma() -> None:
    """HGMMA instructions in the SASS of each kernel of the flash_prefill,
    paged_prefill and ssd_scan libraries (cuobjdump), where cuobjdump
    exists; printed, and K4's bf16 kernel (prefill_tc) and K6's bf16
    tensor-core kernels (forward chunk_state_tc, chunk_scan_tc; backward
    dc_tc, dxb_tc) must have some in every instance."""
    import re
    import shutil

    from repro_torch.kernels import _lib

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(exe).exists():
        print("  HGMMA count: not measured (no cuobjdump)")
        return
    counts: dict = {}
    for name in ("flash_prefill", "paged_prefill", "ssd_scan"):
        sass = subprocess.run([exe, "-sass", str(_lib.build_all()[name])],
                              capture_output=True, text=True).stdout
        fn = None
        for line in sass.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                fn = kernel_label(m.group(1))
                counts[fn] = 0
            elif fn and "HGMMA" in line:
                counts[fn] += 1
    print("  HGMMA instructions in SASS: " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))
    for hd in (64, 128):
        check(counts.get(f"prefill_tc<{hd}>", 0) > 0,
              f"K4's bf16 kernel prefill_tc<{hd}> has no HGMMA")
    for k in ("chunk_state_tc", "chunk_scan_tc", "dc_tc", "dxb_tc"):
        for hd in (32, 64):
            for S in (32, 128):
                check(counts.get(f"{k}<{hd}, {S}>", 0) > 0,
                      f"K6's bf16 kernel {k}<{hd}, {S}> has no HGMMA")


def ssd_close(torch, got, want, what):
    """K6's tolerance: an atol of 1e-4 times the largest entry of the
    plain output (dA and dt sum thousands of terms that cancel, so fp32
    error scales with the terms, not the result), and rtol 1e-4 in fp32.
    For bf16 outputs (dx, dB, dC with bf16 inputs) both sides compute in
    fp32 and round once, so they differ by that fp32 error plus at most
    one bf16 unit of the entry, which is at most 2**-7 of it: rtol
    2**-7."""
    got = got.detach()
    rtol = 1e-4 if got.dtype == torch.float32 else 2.0 ** -7
    scale = float(want.float().abs().max())
    e = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), rtol=rtol,
                        atol=1e-4 * scale)
    print(f"  {what}: max_abs_err={e:.3e} (largest entry {scale:.3e})")
    check(ok, f"{what} disagrees with its plain version (max {e:.3e})")
    return e


def ssd_rows(torch, gen):
    """K6 forward and backward against their plain versions at the
    training shape of mamba2-2.7b (batch 4 x 2048 tokens, 80 heads of
    64, d_state 128, chunk 128) and at a small ragged shape through the
    autograd op, in fp32 and with bf16 x, B and C (the tensor-core
    routes; the backward is fed the forward's states); then timed in
    bf16 at the training shape, with each bf16 forward kernel's device
    time a call."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan import kernel as sk
    from repro_torch.kernels.ssd_scan import ops as so
    from repro_torch.kernels.ssd_scan import ref as sr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(shape, dtype=f32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev)
                * scale).to(dtype)

    def inputs(Bs, T, H, hd, S, dtype):
        # the model's ranges: A = -exp(log(linspace(1, 16))), dt a
        # softplus, x and B/C after the SiLU'd convolution
        return (F.silu(rnd((Bs, T, H, hd))).to(dtype),
                F.softplus(rnd((Bs, T, H))),
                -torch.linspace(1.0, 16.0, H, device=dev),
                F.silu(rnd((Bs, T, S))).to(dtype),
                F.silu(rnd((Bs, T, S))).to(dtype))
    errs = {"fwd": [], "bwd": []}
    Bs, T, H, hd, S, ch = 4, 2048, 80, 64, 128, 128
    for dtype in (f32, bf16):
        ins = inputs(Bs, T, H, hd, S, dtype)
        dy = rnd((Bs, T, H, hd))
        tag = f"ssd_scan {dtype} [{Bs},{T},{H},{hd}] S={S}"
        y, hT, st = sk.ssd_scan_kernel(*ins, chunk=ch)
        wy, wh, wst = sr.ssd_scan_fwd_ref(*ins, chunk=ch)
        e = max(ssd_close(torch, g, w, f"{tag} {n}")
                for n, g, w in (("y", y, wy), ("hT", hT, wh),
                                ("states", st, wst)))
        del wy, wh, wst
        grads = sk.ssd_scan_bwd_kernel(*ins, st, dy, chunk=ch)
        wants = sr.ssd_scan_bwd_ref(*ins, dy, chunk=ch)
        eb = max(ssd_close(torch, g, w, f"ssd_scan_bwd {dtype} d{n}")
                 for n, g, w in zip(("x", "dt", "A", "B", "C"), grads,
                                    wants))
        errs["fwd"].append(e)
        errs["bwd"].append(eb)
        del grads, wants, y, hT, st
        torch.cuda.empty_cache()
    # a ragged T through the autograd op (padded to a multiple of 32)
    for dtype in (f32, bf16):
        ins = inputs(2, 100, 3, 32, 32, dtype)
        leaves = [t.clone().requires_grad_(True) for t in ins]
        dy = rnd((2, 100, 3, 32))
        y, _ = so.ssd_scan(*leaves, chunk=32)
        grads = torch.autograd.grad(y, leaves, dy)
        pad = [F.pad(t, (0, 0) * (t.dim() - 2) + (0, 28))
               if t.dim() > 1 else t for t in ins]
        wy, _, _ = sr.ssd_scan_fwd_ref(*pad, chunk=32)
        wants = sr.ssd_scan_bwd_ref(*pad, F.pad(dy, (0, 0, 0, 0, 0, 28)),
                                    chunk=32)
        ssd_close(torch, y, wy[:, :100], f"ssd_scan op {dtype} T=100 y")
        for n, g, w in zip(("x", "dt", "A", "B", "C"), grads, wants):
            ssd_close(torch, g, w[:, :100] if w.dim() > 1 else w,
                      f"ssd_scan op {dtype} T=100 d{n}")

    # timed in bf16 at the training shape
    ins = inputs(Bs, T, H, hd, S, bf16)
    dy = rnd((Bs, T, H, hd))
    y, hT, st = sk.ssd_scan_kernel(*ins, chunk=ch)
    # the bounds count the function's own inputs and outputs, not the
    # per-chunk states this design passes from its forward to its backward
    xb, yb = Bs * T * H * hd * 2, Bs * T * H * hd * 4
    bcb, dtb = 2 * Bs * T * S * 2, Bs * T * H * 4
    htb = Bs * H * hd * S * 4
    per = Bs * H * (T // ch)            # (row, head, chunk) blocks of work
    # operations as the TPU kernel counts them: C.B^T, the intra-chunk
    # product, the inter-chunk term and the state update
    fwd_f = per * (2 * ch * ch * S + 2 * ch * ch * hd + 4 * ch * hd * S)
    # the backward's products, each counted once: C.B^T and dy.xd^T, the
    # three chunk products with them (dxd, dB, dC), and five terms
    # against a state-sized matrix (R twice, the R update, h twice)
    bwd_f = per * (2 * ch * ch * (3 * S + 2 * hd) + 10 * ch * hd * S)
    # forward: x, dt, A, B, C in, y and hT out; backward: the same five
    # and dy (fp32) in, their five gradients out
    fwd_b = bound(xb + dtb + H * 4 + bcb + yb + htb, fwd_f)
    bwd_b = bound(2 * (xb + dtb + H * 4 + bcb) + yb, bwd_f)

    def fwd():
        sk.ssd_scan_kernel(*ins, chunk=ch)
    rows = [dict(
        name="ssd_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:67",
        max_abs_err=max(errs["fwd"]),
        ms=time_ms(torch, fwd, iters=5),
        plain_ms=time_ms(torch, lambda: sr.ssd_scan_fwd_ref(*ins, chunk=ch),
                         iters=3, warm=1, windows=3),
        bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=None), dict(
        name="ssd_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/ssd_scan.cu",
        replaces="src/repro/kernels/ssd_scan/kernel.py:67",
        max_abs_err=max(errs["bwd"]),
        ms=time_ms(torch, lambda: sk.ssd_scan_bwd_kernel(
            *ins, st, dy, chunk=ch), iters=5),
        plain_ms=time_ms(torch, lambda: sr.ssd_scan_bwd_ref(
            *ins, dy, chunk=ch), iters=2, warm=1, windows=3),
        bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=None)]
    dev = {k: launch_device_ms(torch, fwd, k, iters=5) for k in SSD_FWD_TC}
    print(f"  ssd_scan bf16 [{Bs},{T},{H},{hd}] S={S}: events "
          f"{rows[0]['ms']:.4f} ms a call; device a call (profiler): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in dev.items())
          + f" (sum {sum(dev.values()):.4f} ms)")
    del ins, dy, y, hT, st
    return rows


def rglru_rows(torch, gen):
    """K7 forward and backward against their plain versions at the
    training shape of recurrentgemma-9b (batch 4 x 2048 tokens, 4096
    channels, fp32, as the RG-LRU block passes them) with two draws of
    a, and at a ragged shape through the autograd op in fp32 and bf16;
    then timed at the training shape."""
    from repro_torch.kernels.rglru_scan import kernel as rk
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.rglru_scan import ref as rr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def inputs(B, T, C, draw, dtype=f32):
        # a as test_rglru_scan draws it, or within 1e-3 of 1 so that the
        # carry over all of T matters; g = 0.5 N(0, 1)
        a = torch.sigmoid(rnd((B, T, C))) if draw == "sigmoid" else \
            1.0 - 1e-3 * torch.rand((B, T, C), generator=gen, device=dev)
        return a.to(dtype), (0.5 * rnd((B, T, C))).to(dtype)
    errs = {"fwd": [], "bwd": []}
    B, T, C = 4, 2048, 4096
    for draw in ("sigmoid", "near 1"):
        a, g = inputs(B, T, C, draw)
        dy = rnd((B, T, C))
        tag = f"rglru_scan fp32 [{B},{T},{C}] a {draw}"
        y, hT = rk.rglru_scan_kernel(a, g)
        wy, wh = rr.rglru_scan_ref(a, g)
        errs["fwd"].append(max(ssd_close(torch, got, want, f"{tag} {n}")
                               for n, got, want in (("y", y, wy),
                                                    ("hT", hT, wh))))
        grads = rk.rglru_scan_bwd_kernel(a, y, dy)
        wants = rr.rglru_scan_bwd_ref(a, y, dy)
        errs["bwd"].append(max(
            ssd_close(torch, got, want, f"rglru_scan_bwd {tag} d{n}")
            for n, got, want in zip("ag", grads, wants)))
        del grads, wants, wy, wh, y, hT, dy
    for dtype in (f32, bf16):
        a, g = inputs(1, 100, 96, "near 1", dtype)
        leaves = [a.clone().requires_grad_(True),
                  g.clone().requires_grad_(True)]
        dy = rnd((1, 100, 96))
        y, _ = ro.rglru_scan(*leaves)
        grads = torch.autograd.grad(y, leaves, dy)
        wy, _ = rr.rglru_scan_ref(a, g)
        ssd_close(torch, y, wy, f"rglru_scan op {dtype} (1,100,96) y")
        for n, got, want in zip("ag", grads,
                                rr.rglru_scan_bwd_ref(a, wy, dy)):
            ssd_close(torch, got, want, f"rglru_scan op {dtype} (1,100,96) "
                                        f"d{n}")

    a, g = inputs(B, T, C, "sigmoid")
    dy = rnd((B, T, C))
    y, _ = rk.rglru_scan_kernel(a, g)
    n = B * T * C
    # forward: a and g in, y and hT out; backward: a, y, dy in, da and dg
    # out; all fp32. Two and three flops an element.
    fwd_b = bound(3 * n * 4 + B * C * 4, 2.0 * n)
    bwd_b = bound(5 * n * 4, 3.0 * n)
    rows = [dict(
        name="rglru_scan", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan/kernel.py:53",
        max_abs_err=max(errs["fwd"]),
        ms=time_ms(torch, lambda: rk.rglru_scan_kernel(a, g)),
        plain_ms=time_ms(torch, lambda: rr.rglru_scan_ref(a, g), iters=2,
                         warm=1, windows=3),
        bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=None), dict(
        name="rglru_scan_bwd", route="cuda",
        source="src/repro_torch/kernels/csrc/rglru_scan.cu",
        replaces="src/repro/kernels/rglru_scan/kernel.py:53",
        max_abs_err=max(errs["bwd"]),
        ms=time_ms(torch, lambda: rk.rglru_scan_bwd_kernel(a, y, dy)),
        plain_ms=time_ms(torch, lambda: rr.rglru_scan_bwd_ref(a, y, dy),
                         iters=2, warm=1, windows=3),
        bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=None)]
    del a, g, y, dy
    return rows


def flash_rows(torch, gen, close, suffix: str, H: int, KV: int, hd: int,
               shapes, windows):
    """K5 forward and backward against their plain versions at each
    (batch, tokens) of ``shapes`` and each window, in fp32 and bf16; then
    timed in bf16 at the last shape and the first window against SDPA,
    causal with GQA (the same function there: the timed window is None
    or no shorter than T). Rows ``flash_prefill{suffix}`` and
    ``flash_prefill_bwd{suffix}``."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill import kernel as fk
    from repro_torch.kernels.flash_prefill import ref as fr

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)
    errs = {"fwd": [], "bwd": []}
    for B, T in shapes:
        for dtype in (f32, bf16):
            q, do = rnd((B, T, H, hd), dtype), rnd((B, T, H, hd), dtype)
            k, v = rnd((B, T, KV, hd), dtype), rnd((B, T, KV, hd), dtype)
            for window in windows:
                tag = f"hd {hd} {dtype} [{B},{T}] window={window}"
                o, lse = fk.flash_prefill_kernel(q, k, v, window=window)
                wo, wl = fr.flash_prefill_fwd_ref(q, k, v, window=window)
                close(lse, wl, f32, f"flash_prefill {tag} (lse)")
                e = close(o, wo, dtype, f"flash_prefill {tag}")
                grads = fk.flash_prefill_bwd_kernel(q, k, v, o, lse, do,
                                                    window=window)
                wants = fr.flash_prefill_bwd_ref(q, k, v, o, lse, do,
                                                 window=window)
                eb = max(close(g, w_, dtype,
                               f"flash_prefill_bwd {tag} d{n}")
                         for n, g, w_ in zip("qkv", grads, wants))
                if dtype == bf16:
                    errs["fwd"].append(e)
                    errs["bwd"].append(eb)
                del grads, wants, wo, wl, o, lse
            torch.cuda.empty_cache()

    # timed on the last shape's bf16 inputs
    (B, T), window = shapes[-1], windows[0]
    o, lse = fk.flash_prefill_kernel(q, k, v, window=window)
    # live (query row, key) pairs under the causal mask and the window
    pairs = B * H * sum(min(t + 1, window or T) for t in range(T))
    qbytes, kbytes = B * T * H * hd * 2, B * T * KV * hd * 2
    stat = B * H * T * 4                        # the fp32 lse
    fwd_b = bound(2 * qbytes + 2 * kbytes + stat, 4.0 * hd * pairs)
    bwd_b = bound(4 * qbytes + 4 * kbytes + stat, 10.0 * hd * pairs)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in leaves), is_causal=True,
        enable_gqa=True)
    dot = do.transpose(1, 2)
    # SDPA's own bf16 error against the same plain version: the yardstick
    # of what bf16 rounding costs
    wo, wl = fr.flash_prefill_fwd_ref(q, k, v, window=window)
    sdpa_fwd = float((lo.detach().transpose(1, 2).float() - wo.float())
                     .abs().max())
    wants = fr.flash_prefill_bwd_ref(q, k, v, wo, wl, do, window=window)
    sdpa_bwd = max(float((g.float() - w_.float()).abs().max())
                   for g, w_ in zip(torch.autograd.grad(
                       lo, leaves, dot, retain_graph=True), wants))
    del wo, wl, wants
    ms = time_ms(torch, lambda: fk.flash_prefill_kernel(
        q, k, v, window=window))
    lib_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    bwd_ms = time_ms(torch, lambda: fk.flash_prefill_bwd_kernel(
        q, k, v, o, lse, do, window=window), iters=5, windows=3)
    bwd_lib_ms = time_ms(torch, lambda: torch.autograd.grad(
        lo, leaves, dot, retain_graph=True))
    for name, t_ms, flops, b, e, sd in (
            ("flash_prefill", ms, 4.0 * hd * pairs, fwd_b,
             max(errs["fwd"]), sdpa_fwd),
            ("flash_prefill_bwd", bwd_ms, 10.0 * hd * pairs, bwd_b,
             max(errs["bwd"]), sdpa_bwd)):
        print(f"  {name}{suffix} bf16 [{B},{T}] hd {hd}: {t_ms:.4f} ms = "
              f"{flops / t_ms / 1e9:.1f} TFLOP/s ({flops / 1e9:.1f} GFLOP "
              f"on live pairs), {b[0] / t_ms:.1%} of its bound; max_abs_err "
              f"{e:.3e} against the plain version, SDPA's {sd:.3e}")
    rows = [dict(
        name="flash_prefill" + suffix, route="cuda",
        source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/kernel.py:74",
        max_abs_err=max(errs["fwd"]), ms=ms,
        plain_ms=time_ms(torch, lambda: fr.flash_prefill_fwd_ref(
            q, k, v, window=window), iters=3, warm=1, windows=3),
        bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=lib_ms), dict(
        name="flash_prefill_bwd" + suffix, route="cuda",
        source="src/repro_torch/kernels/csrc/flash_prefill.cu",
        replaces="src/repro/kernels/flash_prefill/kernel.py:74",
        max_abs_err=max(errs["bwd"]), ms=bwd_ms,
        plain_ms=time_ms(torch, lambda: fr.flash_prefill_bwd_ref(
            q, k, v, o, lse, do, window=window), iters=3, warm=1,
            windows=3),
        bound_ms=bwd_b[0], bound_by=bwd_b[1], library_ms=bwd_lib_ms)]
    del lo, leaves, o, lse, q, k, v, do
    return rows


# ---------------------------------------------------------------------------
# phase 4: the whole path on the card against the plain path on the CPU
# ---------------------------------------------------------------------------

class FixedClock:
    """Backend proxy whose steps and rebinds report a fixed duration, so
    two runs see the same scheduler clock."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, k):
        return getattr(self.eng, k)

    def prefill(self, *a):
        self.eng.prefill(*a)
        return 0.01

    def decode(self, *a):
        self.eng.decode(*a)
        return 0.01

    def mixed(self, *a):
        self.eng.mixed(*a)
        return 0.01

    def rebind(self, layout):
        self.eng.rebind(layout)
        return 0.01


def reference_check(torch):
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model

    cfg = get_config("llama3-8b").reduced()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))

    def serve(device, num_blocks, reqs):
        geom = PoolGeometry(cfg, plan, num_blocks=num_blocks, block_base=4)
        eng = FlyingEngine(build_model(cfg, torch.float32, device), plan,
                           geom, params, batch_per_engine=2,
                           max_blocks_per_req=16, device=device)
        sched = DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
            strategy="hard", max_batch_per_group=2, prefill_chunk=8))
        for r in reqs:
            sched.submit(Request(**r))
        sched.run(max_steps=400)
        return ({r["req_id"]: eng.generated_tokens(r["req_id"])
                 for r in reqs}, [l.phase for l in sched.log],
                sched.preempt_stats["recovered"])

    two = [dict(req_id="a", arrival=0.0, prompt_len=24, output_len=6),
           dict(req_id="b", arrival=0.001, prompt_len=8, output_len=8)]
    toks_gpu, ph_gpu, _ = serve("cuda", 64, two)
    toks_cpu, ph_cpu, _ = serve("cpu", 64, two)
    print(f"reduced llama3-8b fp32, card vs CPU: tokens {toks_gpu} "
          f"phases {ph_gpu}")
    check(toks_gpu == toks_cpu, f"card tokens {toks_gpu} != CPU {toks_cpu}")
    check(ph_gpu == ph_cpu and "mixed" in ph_gpu,
          f"phase logs differ: {ph_gpu} vs {ph_cpu}")
    # a 12-block pool: decode growth finds it full, and the scheduler
    # evicts a resident and recovers it (its tokens pinned into its prompt)
    four = [dict(req_id=f"r{i}", arrival=0.001 * i, prompt_len=12 + 4 * i,
                 output_len=10) for i in range(4)]
    toks_gpu, ph_gpu, rec_gpu = serve("cuda", 12, four)
    toks_cpu, ph_cpu, rec_cpu = serve("cpu", 12, four)
    print(f"reduced llama3-8b fp32, 12-block pool, card vs CPU: recovered "
          f"{rec_gpu} and {rec_cpu}, tokens {toks_gpu}")
    check(rec_gpu == rec_cpu > 0, f"recovered {rec_gpu} on the card, "
                                  f"{rec_cpu} on the CPU")
    check(toks_gpu == toks_cpu and ph_gpu == ph_cpu,
          f"small-pool run: card tokens {toks_gpu} != CPU {toks_cpu} or "
          f"phases differ")
    check(all(len(v) == 10 for v in toks_gpu.values()),
          f"small-pool run left a request short: {toks_gpu}")


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------

def serve_config(**kw):
    from repro_torch.launch.serve import ServeConfig
    return ServeConfig(**{**dict(
        arch="llama3-8b", real=True, requests=8, seed=0, num_blocks=4096,
        block_base=16, batch_per_engine=8, max_blocks_per_req=256,
        prefill_chunk=512, prompt_range=(256, 2048), output_range=(32, 64),
        arrival="poisson", rate=20.0), **kw})


class StepClock:
    """Backend proxy that logs each step (kind, request ids, the
    duration the engine measured) and returns that duration: the
    scheduler, and so its batching, runs as it would without it."""

    def __init__(self, eng):
        self.eng = eng
        self.log = []

    def __getattr__(self, k):
        return getattr(self.eng, k)

    def _step(self, kind, reqs, *a):
        dt = getattr(self.eng, kind)(*a)
        self.log.append((kind, reqs, dt))
        return dt

    def prefill(self, reqs, *a):
        return self._step("prefill", [r.req_id for r in reqs], reqs, *a)

    def decode(self, reqs, *a):
        return self._step("decode", [r.req_id for r in reqs], reqs, *a)

    def mixed(self, pre, dec, *a):
        return self._step("mixed", [[r.req_id for r in pre],
                                    [r.req_id for r in dec]], pre, dec, *a)


class ReplayClock(StepClock):
    """Backend proxy that reports a logged run's step durations in
    order, so that a second run over the same trace (the async loop in
    virtual pace) schedules exactly as the logged one; it fails the
    phase as soon as a step differs from the log's."""

    def __init__(self, eng, log):
        super().__init__(eng)
        self.want = list(log)

    def _step(self, kind, reqs, *a):
        i = len(self.log)
        super()._step(kind, reqs, *a)
        check(i < len(self.want) and self.want[i][:2] == (kind, reqs),
              f"replayed step {i} is {kind} {reqs}, the log has "
              f"{self.want[i][:2] if i < len(self.want) else 'no step'}")
        return self.want[i][2]


def serve_full_width(torch):
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_stack, replay

    cfg = serve_config()
    t0 = time.perf_counter()
    stack = build_stack(cfg)
    torch.cuda.synchronize()
    print(f"serve: built llama3-8b (bf16, 32 layers) and a "
          f"{cfg.num_blocks}x{cfg.block_base}-token pool in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = stack[0].backend
    clock = StepClock(engine)
    stack[0].backend = clock
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    sched, wall = replay(cfg, stack)
    launches = dict(_lib.LAUNCHES)
    reqs = list(sched.pool.all.values())
    vocab = engine.cfg.vocab_size
    n_tok = 0
    for r in reqs:
        toks = engine.generated_tokens(r.req_id)
        check(r.state == "done" and len(toks) == r.output_len,
              f"{r.req_id}: state {r.state}, {len(toks)}/{r.output_len} "
              f"tokens")
        check(all(0 <= x < vocab for x in toks),
              f"{r.req_id}: token outside the vocab")
        n_tok += len(toks)
    phases = [l.phase for l in sched.log]
    stats = engine.sync_stats
    print(f"serve: {len(reqs)} requests, prompts "
          f"{sorted(r.prompt_len for r in reqs)}, outputs "
          f"{sorted(r.output_len for r in reqs)}")
    print(f"serve: {stats.steps} steps ({phases.count('mixed')} mixed, "
          f"{phases.count('prefill')} prefill, {phases.count('decode')} "
          f"decode), {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tok/s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"serve: sync stats {stats}")
    print(f"serve: kernel launches {launches}")
    check(stats.host_argmax == 0, "tokens were read back one at a time")
    check(phases.count("mixed") > 0, "no mixed step occurred")
    for k in SERVE_KERNELS:
        check(launches[k] > 0, f"kernel {k} never launched on the serving "
                               f"path")
    offline = dict(tokens={r.req_id: engine.generated_tokens(r.req_id)
                           for r in reqs}, log=clock.log)
    return {k: launches[k] for k in SERVE_KERNELS}, offline


def serve_breakdown(torch):
    """Device time by kernel class over a second, profiled run of the
    same trace (the first run's wall time stays unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import build_stack, replay

    cfg = serve_config()
    stack = build_stack(cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = replay(cfg, stack)
    print_breakdown("breakdown", prof, wall, (
        ("paged_flash_prefill", "prefill_tc"),
        ("paged_flash_prefill fp32", "prefill_kernel"),
        ("paged_attention", "decode_kernel"),
        ("paged_append", "append_rows")))


# ---------------------------------------------------------------------------
# phase 13: the HTTP server at full width
# ---------------------------------------------------------------------------

def http_wall_run(torch, smi: str, base, weights=None):
    """The trace of config ``base`` (phase 5's, here) over HTTP at wall
    pace: the engine behind FrontDoor -> AsyncServeLoop -> ServeHTTP on
    127.0.0.1, as ``--serve`` builds them, the requests sent by
    ``loadgen.drive_http`` from a process of their own. Every stream
    must end done with exactly its output length in the vocab, K1-K4
    must launch, ``/metrics`` must serve the rolling tier report; prints
    client TTFT, TPOT and tok/s. Builds the weights from ``base.seed``
    unless ``weights`` gives them. Returns the weights and the run's
    readings (client TTFTs, the front door's requests, wall seconds,
    tokens, steps)."""
    import asyncio
    import copy
    import dataclasses
    import multiprocessing

    import numpy as np

    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_door, build_loop, build_stack
    from repro_torch.serving.metrics import summarize
    from repro_torch.serving.server import ServeHTTP
    from repro_torch.serving.workload import generate

    wall = dataclasses.replace(base, pace="wall", serve=True)
    t0 = time.perf_counter()
    sched, spec, _ = build_stack(wall, weights)
    eng = sched.backend
    vocab = eng.cfg.vocab_size
    torch.cuda.synchronize()
    print(f"http: built {base.arch} ({base.dtype}) and a "
          f"{base.num_blocks}x{base.block_base}-token pool in "
          f"{time.perf_counter() - t0:.1f} s")
    door = build_door(wall, sched)
    loop = build_loop(wall, door)
    reqs = [copy.deepcopy(r) for r in generate(spec)]

    async def over_http():
        srv = await ServeHTTP(loop).start("127.0.0.1", 0)   # starts loop
        _lib.reset_launches()
        # the client runs in a process of its own, as a remote client
        # would: on the server's loop (or a thread sharing its
        # interpreter lock) each engine step would hold its clock too
        ctx = multiprocessing.get_context("spawn")
        recv, send = ctx.Pipe(duplex=False)
        client = ctx.Process(target=http_client, args=(srv.port, reqs, send))
        client.start()
        send.close()
        try:
            while client.is_alive() and not recv.poll():
                await asyncio.sleep(0.005)
            check(recv.poll(), "http: the client process failed")
            box = {"out": recv.recv()}
        finally:
            client.join(timeout=60)
            if client.is_alive():
                client.terminate()
                client.join()
        torch.cuda.synchronize()
        launches = dict(_lib.LAUNCHES)
        r, w = await asyncio.open_connection("127.0.0.1", srv.port)
        w.write(b"GET /metrics HTTP/1.1\r\nHost: smoke\r\n\r\n")
        await w.drain()
        raw = await r.read()
        w.close()
        await srv.stop()
        return box["out"], launches, raw

    out, launches, raw = asyncio.run(over_http())
    recs = {rec["req_id"]: rec for rec in out["records"]}
    for q in reqs:
        rec = recs[q.req_id]
        check(rec["state"] == "done" and rec["n_tokens"] == q.output_len,
              f"http {q.req_id}: state {rec['state']}, {rec['n_tokens']}"
              f"/{q.output_len} tokens")
        check(all(0 <= t < vocab for t in rec["tokens"]),
              f"http {q.req_id}: token outside the vocab")
    for k in SERVE_KERNELS:
        check(launches.get(k, 0) > 0, f"http: kernel {k} never launched")
    check(eng.sync_stats.host_argmax == 0,
          "http: tokens were read back one at a time")
    metrics = json.loads(raw.split(b"\r\n\r\n", 1)[1])
    row = metrics.get("tiers", {}).get("standard", {})
    check(row.get("done") == len(reqs) and "p99_ttft_s" in row,
          f"http: /metrics tier report {metrics.get('tiers')}")
    ttft = np.array([recs[q.req_id]["ttft_wall_s"] for q in reqs])
    n_tok = sum(rec["n_tokens"] for rec in recs.values())
    m = summarize(list(door.requests.values()))
    print(f"http: {len(reqs)} streams over 127.0.0.1 at wall pace "
          f"(Poisson {base.rate}/s), harvests every {eng.harvest_limit} "
          f"steps, {n_tok} tokens in {eng.sync_stats.steps} steps, "
          f"launches { {k: launches[k] for k in SERVE_KERNELS} }")
    print(f"http: client TTFT p50 {np.percentile(ttft, 50) * 1e3:.1f} ms, "
          f"p99 {np.percentile(ttft, 99) * 1e3:.1f} ms over {len(ttft)} "
          f"requests (server clock: mean {m.mean_ttft * 1e3:.1f} ms); "
          f"TPOT median {m.median_tpot * 1e3:.2f} ms (server clock at "
          f"wall pace); {n_tok / out['wall_s']:.1f} tok/s over "
          f"{out['wall_s']:.3f} s wall, {loop.ticks} loop ticks; {smi}")
    print(f"http: /metrics standard tier {json.dumps(row, sort_keys=True)}")
    return (eng.model, eng.params), dict(
        ttft=ttft, requests=list(door.requests.values()),
        wall_s=out["wall_s"], tokens=n_tok, steps=eng.sync_stats.steps)


def http_client(port: int, reqs, conn) -> None:
    """``loadgen.drive_http`` of ``reqs`` against 127.0.0.1:``port``,
    its result sent over ``conn`` (run in a process of its own)."""
    import asyncio

    from repro_torch.serving.loadgen import drive_http
    conn.send(asyncio.run(drive_http("127.0.0.1", port, reqs,
                                     collect_tokens=True)))
    conn.close()


def serve_http_full_width(torch, smi: str, offline):
    """llama3-8b at full width in bf16 (seed 0, phase 5's geometry): phase
    5's trace over HTTP at wall pace (``http_wall_run``), then streamed
    in process at virtual pace with phase 5's step durations replayed
    (the offline schedule): greedy tokens equal to phase 5's, and at
    temperature 0.8, top-k 50, per-request seeds equal to an offline
    run's. ``offline`` is phase 5's tokens and step log."""
    import asyncio
    import copy
    import dataclasses

    from repro_torch.launch.serve import (build_door, build_loop,
                                          build_stack, replay)
    from repro_torch.serving.loadgen import drive_inprocess
    from repro_torch.serving.workload import generate

    base = serve_config()
    hot = dict(temperature=0.8, top_k=50, seed_mode="request")
    t_phase = time.perf_counter()
    gc_collect(torch)
    weights, _ = http_wall_run(torch, smi, base)
    print("http: the readings above are smoke readings of 8 requests "
          "(their p99 is in effect their maximum); tools/http_bench.py "
          "serves a few hundred for a tail")
    vocab = weights[0].cfg.vocab_size
    gc_collect(torch)

    def stream_virtual(c, log, **engine):
        """``c``'s trace through the async loop at virtual pace, with
        ``log``'s step durations replayed, the engine built with the
        ``engine`` keywords; the streamed tokens."""
        st, sp, _ = build_stack(c, weights, **engine)
        e = st.backend
        st.backend = ReplayClock(e, log)
        lp = build_loop(dataclasses.replace(c, pace="virtual"),
                        build_door(c, st))
        res = asyncio.run(drive_inprocess(
            lp, [copy.deepcopy(r) for r in generate(sp)],
            collect_tokens=True))
        check(len(st.backend.log) == len(log),
              f"virtual pace ran {len(st.backend.log)} steps, the log "
              f"{len(log)}")
        check(e.sync_stats.host_argmax == 0,
              "virtual pace: tokens were read back one at a time")
        return {rec["req_id"]: rec["tokens"] for rec in res["records"]}

    # virtual pace, greedy: phase 5's schedule, phase 5's tokens
    got = stream_virtual(base, offline["log"])
    check(got == offline["tokens"],
          f"virtual-pace greedy streams differ from phase 5's offline "
          f"tokens: {got} vs {offline['tokens']}")
    print(f"http: virtual-pace greedy streams equal phase 5's offline "
          f"tokens ({sum(map(len, got.values()))} tokens, "
          f"{len(offline['log'])} steps replayed)")
    gc_collect(torch)

    # temperature 0.8, top-k 50, per-request seeds: offline vs streamed
    stack = build_stack(base, weights, **hot)
    clock = StepClock(stack[0].backend)
    stack[0].backend = clock
    sched, _ = replay(base, stack)
    check(all(r.state == "done" for r in sched.pool.all.values()),
          "temperature run: a request did not finish")
    want = {r.req_id: clock.eng.generated_tokens(r.req_id)
            for r in sched.pool.all.values()}
    del sched, stack
    gc_collect(torch)
    got = stream_virtual(base, clock.log, **hot)
    check(got == want, f"temperature 0.8 streams differ from the offline "
                       f"run: {got} vs {want}")
    check(all(0 <= t < vocab for v in got.values() for t in v),
          "temperature run: token outside the vocab")
    check(got != offline["tokens"],
          "temperature 0.8 drew the greedy tokens")
    print(f"http: temperature 0.8, top-k 50, request seeds: virtual-pace "
          f"streams equal the offline run ({sum(map(len, got.values()))} "
          f"tokens, {len(clock.log)} steps replayed)")
    del weights, clock
    gc_collect(torch)
    print(f"http: phase 13 took {time.perf_counter() - t_phase:.1f} s")


def print_breakdown(tag: str, prof, wall: float, classes) -> None:
    """Device time by kernel class (``classes``: (class, name pattern)
    pairs, GEMM patterns added), the device's busy share of ``wall``
    seconds, and each of ``classes``' launches and mean time a launch."""
    named = list(dict.fromkeys(c for c, _ in classes))
    classes = tuple(classes) + (("gemm", "gemm"), ("gemm", "nvjet"),
                                ("gemm", "cutlass"), ("gemm", "xmma"))
    by: dict = {}
    calls: dict = {}
    other: dict = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) \
            or getattr(e, "self_cuda_time_total", 0)
        if us:
            name = next((c for c, pat in classes if pat in e.key.lower()),
                        "other")
            by[name] = by.get(name, 0.0) + us / 1e3
            calls[name] = calls.get(name, 0) + e.count
            if name == "other":
                k = e.key[:60]
                other[k] = other.get(k, 0.0) + us / 1e3
    busy = sum(by.values())
    if not busy:
        print(f"{tag}: not measured (the profiler saw no device time)")
        return
    parts = ", ".join(f"{k} {v:.1f} ms ({v / busy:.1%})"
                      for k, v in sorted(by.items(), key=lambda kv: -kv[1]))
    top = sorted(other.items(), key=lambda kv: -kv[1])[:6]
    print(f"{tag} (profiled rerun, {wall * 1e3:.1f} ms wall): device "
          f"busy {busy:.1f} ms = {busy / (wall * 1e3):.1%} of wall; {parts}")
    print(f"{tag}: largest 'other' kernels: " + "; ".join(
        f"{k} {v:.1f} ms" for k, v in top))
    print(f"{tag}: per kernel class: " + "; ".join(
        f"{k} {by[k]:.2f} ms over {calls[k]} launches, "
        f"{by[k] / calls[k]:.4f} ms a launch"
        for k in named if calls.get(k)))


# ---------------------------------------------------------------------------
# phases 7 and 8: training
# ---------------------------------------------------------------------------

def train_reference_check(torch, np, arch: str, layers: int = 0,
                          bf16: bool = False):
    """The reduced config (with ``layers`` layers, if given) trained in
    fp32 on the card and on the CPU from the same weights and batches;
    with ``bf16``, then in bf16 from the same bf16 weights, the card's
    losses within twice the CPU's own largest relative bf16-vs-fp32
    drift over the same steps (the card and the CPU round at different
    places, each by about as much as bf16 moves a run from fp32)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map

    cfg = get_config(arch).reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    kw = dict(steps=3, batch=4, seq=128, dtype=torch.float32,
              log=lambda s: None)
    card = train(cfg, device="cuda",
                 params=tree_map(lambda t: t.to("cuda"), params), **kw)
    cpu = train(cfg, device="cpu", params=params, **kw)
    print(f"train reduced {arch} ({cfg.num_layers} layers) fp32: card "
          f"losses {card.losses}, CPU losses {cpu.losses}")
    check(np.allclose(card.losses, cpu.losses, rtol=1e-4, atol=0.0),
          "card and CPU training losses differ")
    if not bf16:
        return
    pb = build_model(cfg, torch.bfloat16, "cpu").init(
        torch.Generator().manual_seed(0))
    kw = dict(steps=3, batch=4, seq=128, log=lambda s: None)
    card = train(cfg, device="cuda", dtype=torch.bfloat16,
                 params=tree_map(lambda t: t.to("cuda"), pb), **kw)
    cpu = train(cfg, device="cpu", dtype=torch.bfloat16,
                params=tree_map(lambda t: t.clone(), pb), **kw)
    f32 = train(cfg, device="cpu", dtype=torch.float32,
                params=tree_map(lambda t: t.float(), pb), **kw)
    drift = max(abs(b - f) / abs(f) for b, f in zip(cpu.losses, f32.losses))
    diff = max(abs(c - b) / abs(b) for c, b in zip(card.losses, cpu.losses))
    print(f"train reduced {arch} bf16: card losses {card.losses}, CPU "
          f"{cpu.losses} (fp32 {f32.losses}); largest relative difference "
          f"{diff:.3e}, limit 2 x the CPU's bf16 drift {drift:.3e}")
    check(diff <= 2 * drift, "card and CPU bf16 training losses differ by "
                             "more than twice the CPU's bf16 drift")


def train_full_width(torch):
    import dataclasses
    import math

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train
    from repro_torch.training.checkpoint import tree_leaves

    # full width, depth cut to 4 of 32 layers: bf16 params and grads plus
    # fp32 moments take 12 bytes a parameter, 96 GB at full depth
    cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=4)
    steps, batch, seq = 20, 4, 2048
    kw = dict(batch=batch, seq=seq, device="cuda", dtype=torch.bfloat16)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    res = train(cfg, steps=steps, log_every=5,
                log=lambda s: print(f"train: {s}"), **kw)
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    del res.params
    steady = sorted(res.step_s[1:])
    med = steady[len(steady) // 2]
    print(f"train: llama3-8b at full width, {cfg.num_layers} of 32 layers "
          f"({n_params / 1e9:.3f} B parameters), bf16 parameters, fp32 "
          f"AdamW moments, batch {batch} x {seq} tokens, {steps} steps")
    print("train: losses " + " ".join(f"{x:.4f}" for x in res.losses))
    print(f"train: step time median {med * 1e3:.1f} ms over steps 2-{steps} "
          f"(min {steady[0] * 1e3:.1f}, max {steady[-1] * 1e3:.1f}; first "
          f"{res.step_s[0] * 1e3:.1f} ms) = "
          f"{res.tokens_per_step / med:.1f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"train: kernel launches {launches}")
    check(all(math.isfinite(x) for x in res.losses), "a loss is not finite")
    check(res.losses[-1] < res.losses[0],
          f"loss did not decrease: {res.losses[0]} -> {res.losses[-1]}")
    want = {"flash_prefill": 2 * cfg.num_layers * steps,
            "flash_prefill_bwd": cfg.num_layers * steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times on the "
                                f"training path, not {n}")
    gc_collect(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(cfg, steps=2, log=lambda s: None, **kw)
        wall = time.perf_counter() - t0
    print_breakdown("train breakdown", prof, wall, FLASH_CLASSES + (
        ("elementwise", "elementwise"), ("reduction", "reduce_kernel")))
    gc_collect(torch)
    return {k: launches[k] for k in TRAIN_KERNELS}


def train_mamba2(torch):
    """mamba2-2.7b at full width and all 64 layers, bf16 parameters, fp32
    AdamW moments, batch 4 x 2048 tokens, through
    ``repro_torch.launch.train.train``."""
    import math

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train
    from repro_torch.training.checkpoint import tree_leaves

    cfg = get_config("mamba2-2.7b")
    steps, batch, seq = MAMBA_STEPS, 4, 2048
    kw = dict(batch=batch, seq=seq, device="cuda", dtype=torch.bfloat16)
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    res = train(cfg, steps=steps, log_every=5,
                log=lambda s: print(f"mamba2: {s}"), **kw)
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in tree_leaves(res.params))
    del res.params
    steady = sorted(res.step_s[1:])
    med = steady[len(steady) // 2]
    print(f"mamba2: mamba2-2.7b at full width and depth, {cfg.num_layers} "
          f"layers ({n_params / 1e9:.3f} B parameters), bf16 parameters, "
          f"fp32 AdamW moments, batch {batch} x {seq} tokens, {steps} steps")
    print("mamba2: losses " + " ".join(f"{x:.4f}" for x in res.losses))
    print(f"mamba2: step time median {med * 1e3:.1f} ms over steps "
          f"2-{steps} (min {steady[0] * 1e3:.1f}, max "
          f"{steady[-1] * 1e3:.1f}; first {res.step_s[0] * 1e3:.1f} ms) = "
          f"{res.tokens_per_step / med:.1f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"mamba2: kernel launches {launches}")
    check(all(math.isfinite(x) for x in res.losses), "a loss is not finite")
    check(res.losses[-1] < res.losses[0],
          f"loss did not decrease: {res.losses[0]} -> {res.losses[-1]}")
    # per step: the forward pass and its recomputation under remat, then
    # one backward, in each of the 64 layers
    want = {"ssd_scan": 2 * cfg.num_layers * steps,
            "ssd_scan_bwd": cfg.num_layers * steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times on the "
                                f"training path, not {n}")
    gc_collect(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(cfg, steps=2, log=lambda s: None, **kw)
        wall = time.perf_counter() - t0
    print_breakdown("mamba2 breakdown", prof, wall, (
        ("ssd_scan states (bf16)", "chunk_state_tc"),
        ("ssd_scan pass (bf16)", "state_pass"),
        ("ssd_scan y (bf16)", "chunk_scan_tc"),
        ("ssd_scan (fp32)", "fwd_kernel"),
        ("ssd_scan_bwd dC (bf16)", "dc_tc"),
        ("ssd_scan_bwd carry (bf16)", "carry_kernel"),
        ("ssd_scan_bwd dx dB (bf16)", "dxb_tc"),
        ("ssd_scan_bwd group sums (bf16)", "sum_groups"),
        ("ssd_scan_bwd dC (fp32)", "dc_kernel"),
        ("ssd_scan_bwd scan (fp32)", "bwd_scan_kernel"),
        ("elementwise", "elementwise"),
        ("reduction", "reduce_kernel")))
    gc_collect(torch)
    return {k: launches[k] for k in MAMBA_KERNELS}


def train_recurrentgemma(torch):
    """recurrentgemma-9b at full width, 6 of its 38 layers (two whole
    super-layers: four RG-LRU layers, two local-attention layers), bf16
    parameters (the RG-LRU's decay and gate leaves fp32), fp32 AdamW
    moments, batch 4 x 2048 tokens, through
    ``repro_torch.launch.train.train``."""
    import dataclasses
    import math

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels import _lib
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import stack_plan
    from repro_torch.training.checkpoint import tree_leaves

    # at 12 bytes a parameter the full 7.66 B need 92 GB; two super-layers
    # (2.97 B) leave room for the fp32 logits over the 256000-word vocab
    cfg = dataclasses.replace(get_config("recurrentgemma-9b"), num_layers=6)
    steps, batch, seq = 20, 4, 2048
    kw = dict(batch=batch, seq=seq, device="cuda", dtype=torch.bfloat16)
    kinds = [k[0] for seq_, n in stack_plan(cfg) for _ in range(n)
             for k in seq_]
    n_rec, n_attn = kinds.count("rglru"), kinds.count("gqa_win")
    gc_collect(torch)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    res = train(cfg, steps=steps, log_every=5,
                log=lambda s: print(f"hybrid: {s}"), **kw)
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    leaves = tree_leaves(res.params)
    n_params = sum(t.numel() for t in leaves)
    n_f32 = sum(t.numel() for t in leaves if t.dtype == torch.float32)
    del res.params, leaves
    steady = sorted(res.step_s[1:])
    med = steady[len(steady) // 2]
    print(f"hybrid: recurrentgemma-9b at full width, {cfg.num_layers} of 38 "
          f"layers ({n_rec} RG-LRU, {n_attn} local attention; "
          f"{n_params / 1e9:.3f} B parameters, {n_f32} of them fp32), bf16 "
          f"parameters, fp32 AdamW moments, batch {batch} x {seq} tokens, "
          f"{steps} steps")
    print("hybrid: losses " + " ".join(f"{x:.4f}" for x in res.losses))
    print(f"hybrid: step time median {med * 1e3:.1f} ms over steps "
          f"2-{steps} (min {steady[0] * 1e3:.1f}, max "
          f"{steady[-1] * 1e3:.1f}; first {res.step_s[0] * 1e3:.1f} ms) = "
          f"{res.tokens_per_step / med:.1f} tok/s; peak memory "
          f"{peak / 2**30:.2f} GiB")
    print(f"hybrid: kernel launches {launches}")
    check(all(math.isfinite(x) for x in res.losses), "a loss is not finite")
    check(res.losses[-1] < res.losses[0],
          f"loss did not decrease: {res.losses[0]} -> {res.losses[-1]}")
    # per step: each layer's kernel forward, its recomputation under remat
    # and one backward
    want = {"rglru_scan": 2 * n_rec * steps, "rglru_scan_bwd": n_rec * steps,
            "flash_prefill": 2 * n_attn * steps,
            "flash_prefill_bwd": n_attn * steps}
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times on the "
                                f"training path, not {n}")
    gc_collect(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train(cfg, steps=2, log=lambda s: None, **kw)
        wall = time.perf_counter() - t0
    print_breakdown("hybrid breakdown", prof, wall, (
        ("rglru_scan", "rglru_fwd_kernel"),
        ("rglru_scan_bwd", "rglru_bwd_kernel"),
        *FLASH_CLASSES,
        ("elementwise", "elementwise"),
        ("reduction", "reduce_kernel")))
    gc_collect(torch)
    return {row: launches[k] for row, k in HYBRID_ROWS.items()}


# ---------------------------------------------------------------------------
# phase 14: two ranks on the one card over gloo
# ---------------------------------------------------------------------------

class ScriptedMerge:
    """Layout policy that binds both engines into one TP2 island once, at
    the first tick from ``bind`` on, and dissolves any TP island once,
    at the first tick from ``release`` on; on every other tick it keeps
    the layout the scheduler holds (the scheduler itself restores the
    DP groups of the requests a HARD bind paused once their engines are
    idle)."""

    def __init__(self, bind: int, release: int):
        self.bind, self.release = bind, release
        self.bound = self.released = False

    def decide(self, sched):
        tick = len(sched.log)
        if not self.bound and tick >= self.bind:
            self.bound = True
            return 2
        if not self.released and tick >= self.release:
            self.released = True
            return 1
        return sched.layout


def islands_trace(torch, device) -> dict:
    """Phase 14 (a): the reduced llama3-8b in fp32 (weights seeded on the
    CPU) at ``ParallelPlan(1, 1, 2)`` on ``device``, 8 staggered
    requests under HARD with the merge scripted 1 -> 2 -> 1 and a fixed
    clock; every rebind zero-copy checked. Returns the streams and the
    schedule."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model

    cfg = get_config("llama3-8b").reduced()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    eng = FlyingEngine(build_model(cfg, torch.float32, device), plan, geom,
                       params, batch_per_engine=2, max_blocks_per_req=16,
                       device=device, check_zero_copy=True)
    sched = DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
        strategy="hard", max_batch_per_group=2, prefill_chunk=8),
        policy=ScriptedMerge(4, 24))
    for i in range(8):
        sched.submit(Request(req_id=f"r{i}", arrival=0.004 * i,
                             prompt_len=8 + 4 * (i % 4), output_len=6))
    sched.run(max_steps=400)
    reqs = sorted(sched.pool.all.values(), key=lambda r: r.req_id)
    return {"toks": {r.req_id: list(map(int, eng.generated_tokens(
                r.req_id))) for r in reqs},
            "done": sum(r.state == "done" for r in reqs),
            "phases": [l.phase for l in sched.log],
            "merges": [l.merge for l in sched.log],
            "switches": sched.switches, "rebinds": len(eng.switch_log),
            "backend": eng.pool.describe()}


def islands_trace_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 14 (a): the trace on the card, then on the
    CPU; writes ``{out}.{rank}.json``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    res = {dev: islands_trace(torch, dev) for dev in ("cuda", "cpu")}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def check_islands_trace(runs) -> dict:
    """Phase 14 (a)'s verdict over every rank's result: the card's streams
    and schedule equal the CPU's, the same on each rank, through both
    rebinds, every request done."""
    def run(x):
        return {k: v for k, v in x.items() if k != "backend"}
    got = runs[0]["cuda"]
    for r, res in enumerate(runs):
        check(run(res["cuda"]) == run(res["cpu"]),
              f"rank {r}: card streams {res['cuda']['toks']} != CPU "
              f"{res['cpu']['toks']}")
        check(run(res["cuda"]) == run(got),
              f"rank {r} ran another schedule than rank 0")
    check(got["done"] == 8 and all(len(t) == 6 for t in got["toks"].values()),
          f"islands trace: {got['done']}/8 done")
    check(2 in got["merges"] and got["merges"][-1] == 1 and
          got["rebinds"] == 2,
          f"islands trace did not go DP -> TP2 -> DP: merges "
          f"{got['merges']}, {got['rebinds']} rebinds")
    return got


def lse_merge_check(torch, eng) -> float:
    """Phase 14 (c): K2's ``return_lse`` partials over two halves of each
    request's pages, one half on each rank (llama3-8b's per-rank shape at
    merge 2: H 16, KV 4, hd 128, page 32; fp32 q over bf16 pools), merged
    by ``TPContext.lse_merge`` over the two ranks, against one whole K2
    call. Returns the max abs error."""
    from repro_torch.core.views import make_serving_ctx
    from repro_torch.kernels.paged_attention import kernel as pk
    ctx = make_serving_ctx(2, 1, 1, group=eng.pool.seat(
        eng.layout.islands[0]).comm)
    dev = eng.device
    gen = torch.Generator(device=dev).manual_seed(14)
    Bq, H, KV, hd, page, nblk, mb = 8, 16, 4, 128, 32, 1024, 64
    kp, vp = (torch.randn((nblk, page, KV, hd), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    q = torch.randn((Bq, H, hd), generator=gen, device=dev)
    bt = torch.randperm(nblk - 1, generator=gen, device=dev)[
        :Bq * mb].reshape(Bq, mb).to(torch.int32)
    half = mb // 2
    ctxl = torch.randint(half * page + 1, mb * page + 1, (Bq,),
                         generator=gen, device=dev).to(torch.int32)
    r = ctx.view_rank()
    part_bt = bt[:, r * half:(r + 1) * half].contiguous()
    part_len = ctxl.clamp(max=half * page) if r == 0 \
        else ctxl - half * page
    o, lse = pk.paged_attention_kernel(q, kp, vp, part_bt, part_len,
                                       return_lse=True)
    merged = ctx.lse_merge(o, torch.ones_like(lse), lse)
    whole = pk.paged_attention_kernel(q, kp, vp, bt, ctxl)
    torch.cuda.synchronize()
    err = float((merged - whole.float()).abs().max())
    check(torch.allclose(merged, whole.float(), **F32_TOL),
          f"lse_merge of split K2 partials is off one K2 call by {err:.3e}")
    return err


def decode_tick_ms(torch, eng, merge: int, steps: int = 10,
                   prompt: int = 512) -> dict:
    """Fleet decode ticks at one uniform merge: 2 x bpe requests of
    ``prompt`` tokens prefilled, two warm ticks, then ``steps`` ticks
    timed on the host clock to the end of a drain (which syncs every
    rank): the mean ms a tick, the slowest rank's. Returns the tick ms,
    the K1-K4 launches and the TP collectives of this rank over the
    prefill and the ticks."""
    from repro_torch.core.task_pool import Request
    from repro_torch.kernels import _lib
    eng.rebind(merge)
    isl = eng.layout.islands[0]
    reqs = []
    for i in range(2 * eng.bpe):
        r = Request(req_id=f"m{merge}_{i}", arrival=0.0, prompt_len=prompt,
                    output_len=1 << 30)
        r.engine_group = 0 if merge == 2 else i % 2
        reqs.append(r)
    _lib.reset_launches()
    coll0 = eng.pool.stats.collectives
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, prompt)
    eng.prefill(reqs, isl, prompt)
    t0 = 0.0
    for k in range(steps + 2):
        if k == 2:
            eng.drain()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        for r in reqs:
            eng.adaptors[r.engine_group].append_slots(r.req_id, 1)
        eng.decode(reqs, isl)
    eng.drain()
    torch.cuda.synchronize()
    ms = eng.pool.host_max((time.perf_counter() - t0) * 1e3 / steps)
    launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
    for r in reqs:
        check(len(eng.generated_tokens(r.req_id)) == steps + 3,
              f"merge {merge}: {r.req_id} short of tokens")
    greedy = greedy_margins(torch, eng, reqs)
    for r in reqs:
        eng.adaptors[r.engine_group].release(r.req_id)
    return {"ms": ms, "launches": launches,
            "collectives": eng.pool.stats.collectives - coll0,
            "steps": steps + 3, "greedy": greedy}


def greedy_margins(torch, eng, reqs, dense=None) -> dict:
    """Holds every greedy token the engine streamed for ``reqs`` against
    one dense forward of the whole model on this rank (K5 and the full
    vocab, no pool, no collective), fed the prompt and the streamed
    tokens: each token must be the dense argmax, or a near-tie whose
    margin (dense top logit less the streamed token's) is at most
    NEAR_TIE_SD of the row's standard deviation over the vocab. bf16
    rounding moves a logit by a few hundredths of that; a token read
    from a wrong head or vocab slice lies some 4 deviations below the
    top. ``dense`` (tokens [T] -> fp32 logits [T, V]) replaces that
    forward. Returns the token count, the flips, their margins and the
    largest margin / bound."""
    import numpy as np

    from repro_torch.core.views import SINGLE
    from repro_torch.models.cache import TrainBackend
    n = flips = 0
    worst = 0.0
    margins = []
    for r in reqs:
        gen = eng.generated_tokens(r.req_id)
        seq = np.concatenate([np.asarray(eng.prompt_tokens(r)[:r.prompt_len],
                                         dtype=np.int64),
                              np.asarray(gen[:-1], dtype=np.int64)])
        seq_t = torch.as_tensor(seq, device=eng.device)
        if dense is not None:
            logits = dense(seq_t)[None]
        else:
            with torch.no_grad():
                logits, _, _ = eng.model.forward(
                    eng.params, SINGLE, mode="train", backend=TrainBackend(),
                    tokens=seq_t[None])
        rows = logits[0, r.prompt_len - 1:].float()
        got = torch.as_tensor(gen, device=eng.device)
        top = rows.max(-1).values
        margin = top - rows.gather(1, got[:, None])[:, 0]
        bound = NEAR_TIE_SD * rows.std(-1)
        n += len(gen)
        flips += int((margin > 0).sum())
        worst = max(worst, float((margin / bound).max()))
        margins += [float(m) for m in margin[margin > 0]]
    return {"tokens": n, "flips": flips, "worst": worst,
            "margins": margins}


class MergeWhenMixed:
    """Layout policy for the LIVE traces: binds both engines into one TP2
    island once, at the first tick where a request decodes while another
    is part-way through its chunked prefill, and records the riders (the
    requests decoding then); on every other tick it keeps the layout."""

    def __init__(self):
        self.riders = None

    def decide(self, sched):
        if self.riders is None and sched.running and any(
                0 < r.prefilled < r.prompt_len for r in sched.waiting):
            self.riders = sorted(r.req_id for r in sched.running)
            return 2
        return sched.layout


def live_config():
    """The reduced llama3-8b with 2 KV heads (rep 2). The reduced config
    has one KV head, which no merge above 1 can read in place
    (``PoolGeometry.live_readable``: MQA never qualifies), so its LIVE
    merge-up would pause instead of ride."""
    import dataclasses

    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("llama3-8b").reduced(),
                               num_kv_heads=2)


def _lane_keys(eng) -> list:
    """The lane tuples of the live steps the engine ran (runner keys)."""
    return sorted({str(k[8]) for k in eng.pool._runners if k[8]})


def _start(eng, reqs, island):
    """Prefill each request's whole prompt in one step and allocate its
    first decode slot (the scheduler's cadence)."""
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, r.prompt_len)
    eng.prefill(reqs, island, max(r.prompt_len for r in reqs))
    for r in reqs:
        eng.adaptors[r.engine_group].append_slots(r.req_id, 1)


def _decode_steps(eng, reqs, island, steps: int) -> None:
    for _ in range(steps):
        eng.decode(reqs, island)
        for r in reqs:
            eng.adaptors[r.engine_group].append_slots(r.req_id, 1)


def _request(rid: str, group: int, prompt: int):
    from repro_torch.core.task_pool import Request
    r = Request(req_id=rid, arrival=0.0, prompt_len=prompt,
                output_len=1 << 30)
    r.engine_group = group
    return r


def _sp_serve(eng, prompt: int, steps: int, rid: str = "long") -> dict:
    """One request on engine 0's island, prefilled a block a chunk (an SP
    island's chunk stays within one block), then ``steps`` decodes."""
    ad = eng.adaptors[0]
    cap = eng.geom.capacity(1)
    r = _request(rid, 0, prompt)
    isl = eng.layout.island_of(0)
    for lo in range(0, prompt, cap):
        ad.append_slots_batch([rid], [min(cap, prompt - lo)])
        r.prefilled = lo
        eng.prefill([r], isl, cap)
    r.prefilled = prompt
    ad.append_slots(rid, 1)
    _decode_steps(eng, [r], isl, steps)
    shards = sorted({min(o.engine_id for o in s.owners)
                     for s in ad.table[rid].segments})
    return {"req": r, "toks": list(map(int, eng.generated_tokens(rid))),
            "shards": shards, "one_pool": ad.max_context_tokens(1),
            "context": prompt + steps + 1}


def live_runs(torch, device) -> dict:
    """Phase 14 (d) on ``device``: live_config() in fp32 (weights seeded
    on the CPU) at ``ParallelPlan(1, 1, 2)``, every rebind and step
    zero-copy checked. (1) 8 staggered requests under LIVE on a fixed
    clock, the merge scripted 1 -> 2 while decodes and a chunked prefill
    are in flight (``MergeWhenMixed``); (2) a pure-SP island
    ``Island(0, 2, 2, sp=2)`` serving a 45-token context over pools of 28
    usable tokens, beside the same request at merge 1 from a big pool;
    (3) engine 1 killed mid-decode: its launch raises ``EngineFault``, the
    request is recovered from its harvested tokens onto engine 0, beside
    the fault-free run. Returns what the check compares."""
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.faults import (KILL, EngineFault, FaultInjector,
                                         FaultSpec)
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import FleetLayout, Island, ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model

    cfg = live_config()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    model = build_model(cfg, torch.float32, device)

    def engine(nb=64, **kw):
        return FlyingEngine(model, plan, PoolGeometry(
            cfg, plan, num_blocks=nb, block_base=4), params,
            batch_per_engine=2, max_blocks_per_req=16, device=device,
            check_zero_copy=True, **kw)

    out = {}
    eng = engine()
    policy = MergeWhenMixed()
    sched = DynamicScheduler(plan, eng.geom, FixedClock(eng), SchedulerConfig(
        strategy="live", max_batch_per_group=2, prefill_chunk=8),
        policy=policy)
    for i in range(8):
        sched.submit(Request(req_id=f"r{i}", arrival=0.004 * i,
                             prompt_len=8 + 4 * (i % 4), output_len=6))
    sched.run(max_steps=400)
    reqs = sorted(sched.pool.all.values(), key=lambda r: r.req_id)
    out["live"] = {
        "toks": {r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
                 for r in reqs},
        "done": sum(r.state == "done" for r in reqs),
        "phases": [l.phase for l in sched.log],
        "merges": [l.merge for l in sched.log],
        "riders": policy.riders, "preempt": dict(sched.preempt_stats),
        "lanes": _lane_keys(eng), "host_argmax": eng.sync_stats.host_argmax}

    sp_eng = engine(8, layout=FleetLayout(plan, (Island(0, 2, 2, sp=2),)))
    sp = _sp_serve(sp_eng, 32, 12)
    big = _sp_serve(engine(layout=FleetLayout.uniform(plan, 1)), 32, 12)
    out["sp"] = {k: sp[k] for k in ("toks", "shards", "one_pool",
                                    "context")}
    out["sp"]["lanes"] = _lane_keys(sp_eng)
    out["sp_big"] = big["toks"]

    dp = FleetLayout.of(plan, [(1, 1), (1, 1)])

    def kill_run(inj):
        eng = engine(layout=dp, injector=inj)
        v, bg = _request("v", 1, 9), _request("b", 0, 9)
        isl_v, isl_b = dp.island_of(1), dp.island_of(0)
        free = eng.adaptors[1].free_blocks()
        _start(eng, [v], isl_v)
        _start(eng, [bg], isl_b)
        _decode_steps(eng, [v], isl_v, 3)
        _decode_steps(eng, [bg], isl_b, 3)
        if inj is None:
            _decode_steps(eng, [v], isl_v, 5)
            _decode_steps(eng, [bg], isl_b, 6)
            return {r.req_id: list(map(int, eng.generated_tokens(
                r.req_id))) for r in (v, bg)}
        # harvest v's island: 4 tokens reach the host; the next 2 stay on
        # the card and die with engine 1
        eng._drain_island(eng._rt_of[isl_v])
        _decode_steps(eng, [v], isl_v, 2)
        inj.advance(1)
        fault = None
        try:
            eng.decode([v], isl_v)
        except EngineFault as ex:
            fault = sorted(ex.engines)
        kept = eng.recover_request(v)
        v.prompt_len = v.prompt_len - v.folded + kept
        v.folded = kept
        v.prefilled = 0
        eng.adaptors[1].drop_for_recompute("v")
        leaked = free - eng.adaptors[1].free_blocks()
        eng.rebind(eng.layout.quarantine({1}))
        v.engine_group = 0
        _start(eng, [v], isl_b)
        _decode_steps(eng, [v], isl_b, 4)
        _decode_steps(eng, [bg], isl_b, 6)
        drains = eng.island_sync_stats(isl_b).drains
        return {"toks": {r.req_id: list(map(int, eng.generated_tokens(
                    r.req_id))) for r in (v, bg)},
                "fault": fault, "kept": kept, "leaked": leaked,
                "b_drains": drains,
                "layout": eng.layout.describe()}

    out["kill"] = kill_run(FaultInjector(
        [FaultSpec(kind=KILL, tick=1, engines=(1,))]))
    out["kill_free"] = kill_run(None)
    return out


def live_runs_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 14 (d): the runs on the card, then on the CPU;
    writes ``{out}.{rank}.json``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    res = {dev: live_runs(torch, dev) for dev in ("cuda", "cpu")}
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def check_live_runs(runs) -> dict:
    """Phase 14 (d)'s verdict over every rank's result: the card's streams
    and schedules equal the CPU's, the same on each rank; the LIVE
    merge-up rode its riders with nothing paused or recomputed; the SP
    island served a context over one engine's pool as the big pool did;
    the killed engine's request recovered to the fault-free stream with
    no block leaked."""
    got = runs[0]["cuda"]
    for r, res in enumerate(runs):
        check(res["cuda"] == res["cpu"],
              f"rank {r}: card runs differ from the CPU's: "
              f"{ {k: (res['cuda'][k], res['cpu'][k]) for k in res['cuda'] if res['cuda'][k] != res['cpu'][k]} }")
        check(res["cuda"] == got, f"rank {r} ran another schedule than "
              f"rank 0")
    live, sp, kill = got["live"], got["sp"], got["kill"]
    p = live["preempt"]
    check(live["done"] == 8 and all(len(t) == 6
                                    for t in live["toks"].values()),
          f"live trace: {live['done']}/8 done")
    check(2 in live["merges"] and bool(live["riders"]) and
          p["live_riders"] > 0 and p["paused"] == 0 and
          p["recomputed_tokens"] == 0 and live["host_argmax"] == 0,
          f"live trace did not ride its merge-up: riders {live['riders']}, "
          f"{p}")
    check(any("1, 2" in k for k in live["lanes"]),
          f"live trace ran no lanes of tags (1, 2): {live['lanes']}")
    check(sp["context"] > sp["one_pool"] and sp["shards"] == [0, 1] and
          sp["toks"] == got["sp_big"] and sp["lanes"] == ["(1, 1)"],
          f"SP island: shards {sp['shards']}, lanes {sp['lanes']}, tokens "
          f"{sp['toks']} vs the big pool's {got['sp_big']}")
    check(kill["fault"] == [1] and kill["kept"] == 4 and
          kill["leaked"] == 0 and kill["toks"] == got["kill_free"] and
          kill["b_drains"] == 0,
          f"kill: {kill} vs fault-free {got['kill_free']}")
    return got


def live_full_width(torch, stack, cfg) -> dict:
    """Phase 14 (e)'s LIVE trace: phase 5's 8 requests replayed through
    ``stack`` (llama3-8b in bf16 at ``ParallelPlan(1, 1, 2)``, every
    rebind and step zero-copy checked) under LIVE, the merge scripted 1
    -> 2 while decodes and a chunked prefill are in flight, K1-K4's
    launches and K2's and K4's LSE launches (the live lanes' sweeps)
    counted from zero; the riders' greedy tokens held against the dense
    one-rank forward."""
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import replay
    sched, eng = stack[0], stack[0].backend
    policy = MergeWhenMixed()
    sched.policy = policy
    _lib.reset_launches()
    coll0 = eng.pool.stats.collectives
    sched, wall = replay(cfg, stack)
    launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
    lse = dict(_lib.LSE_LAUNCHES)
    reqs = list(sched.pool.all.values())
    riders = [r for r in reqs if r.req_id in (policy.riders or ())]
    return {
        "done": sum(r.state == "done" and len(eng.generated_tokens(
            r.req_id)) == r.output_len for r in reqs),
        "n": len(reqs), "riders": policy.riders,
        "preempt": dict(sched.preempt_stats), "wall_s": wall,
        "merges": [l.merge for l in sched.log],
        "phases": [l.phase for l in sched.log],
        "launches": launches, "lse": lse, "lanes": _lane_keys(eng),
        "steps": eng.sync_stats.steps,
        "collectives": eng.pool.stats.collectives - coll0,
        "host_argmax": eng.sync_stats.host_argmax,
        "greedy": greedy_margins(torch, eng, riders)}


def live_tick_ms(torch, eng, steps: int = 10, prompt: int = 512) -> dict:
    """Phase 14 (e): a fleet decode tick of 16 rows at merge 2 whose KV is
    tag 1: 2 x bpe requests of ``prompt`` tokens prefilled and decoded
    twice at merge 1 (each rank's 8 rows), a LIVE rebind to merge 2
    (their pending slots retagged), two warm ticks, then ``steps`` ticks
    timed as ``decode_tick_ms`` times them. Returns the tick ms, K1-K4's
    launches and K2's LSE launches over the 12 live ticks (one a lane a
    layer a tick), their lanes, the TP collectives a tick and the greedy
    check of every token."""
    from repro_torch.kernels import _lib
    eng.rebind(1)
    reqs = [_request(f"tick{i}", i % 2, prompt) for i in range(2 * eng.bpe)]
    _start(eng, reqs, eng.layout.islands[0])
    _decode_steps(eng, reqs, eng.layout.islands[0], 2)
    eng.rebind(2)
    for r in reqs:
        eng.adaptors[r.engine_group].retag_tail(r.req_id)
    isl = eng.layout.islands[0]
    _lib.reset_launches()
    coll0 = eng.pool.stats.collectives
    t0 = 0.0
    for k in range(steps + 2):
        if k == 2:
            eng.drain()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        _decode_steps(eng, reqs, isl, 1)
    eng.drain()
    torch.cuda.synchronize()
    ms = eng.pool.host_max((time.perf_counter() - t0) * 1e3 / steps)
    launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
    lse = dict(_lib.LSE_LAUNCHES)
    for r in reqs:
        check(len(eng.generated_tokens(r.req_id)) == steps + 5,
              f"live tick: {r.req_id} short of tokens")
    greedy = greedy_margins(torch, eng, reqs)
    for r in reqs:
        eng.adaptors[r.engine_group].release(r.req_id)
    return {"ms": ms, "launches": launches, "lse": lse,
            "lanes": _lane_keys(eng),
            "collectives": (eng.pool.stats.collectives - coll0)
            / (steps + 2), "steps": steps + 2, "greedy": greedy}


SP_BLOCKS, SP_PAGE, SP_PROMPT, SP_STEPS = 24, 128, 3072, 16


def sp_full_width(torch, weights) -> dict:
    """Phase 14 (e)'s SP run: llama3-8b in bf16 sharing ``weights`` (the
    (b) engine's model and parameters), a pool cut to SP_BLOCKS blocks
    of SP_PAGE tokens a rank (2944 usable), one SP_PROMPT-token request
    on a pure-SP island ``Island(0, 2, 2, sp=2)``, prefilled a block a
    chunk, then SP_STEPS decodes: its context exceeds one rank's pool;
    its greedy tokens held against the dense one-rank forward."""
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import FleetLayout, Island, ParallelPlan
    from repro_torch.kernels import _lib
    model, params = weights
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=2)
    geom = PoolGeometry(model.cfg, plan, num_blocks=SP_BLOCKS,
                        block_base=SP_PAGE)
    eng = FlyingEngine(model, plan, geom, params, batch_per_engine=1,
                       max_blocks_per_req=16, device=model.device,
                       check_zero_copy=True,
                       layout=FleetLayout(plan, (Island(0, 2, 2, sp=2),)))
    _lib.reset_launches()
    t0 = time.perf_counter()
    res = _sp_serve(eng, SP_PROMPT, SP_STEPS)
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lse = dict(_lib.LSE_LAUNCHES)
    return {"context": res["context"], "one_pool": res["one_pool"],
            "shards": res["shards"], "tokens": len(res["toks"]),
            "wall_s": wall, "lse": lse, "lanes": _lane_keys(eng),
            "greedy": greedy_margins(torch, eng, [res["req"]])}


def islands_rank(rank: int, world: int, out: str) -> None:
    """One rank of phase 14: (a) the reduced trace on the card and the
    CPU, (d) the LIVE, SP and KILL runs on the card and the CPU, (b)
    llama3-8b at full width and depth in bf16 serving phase 5's 8
    requests at ``ParallelPlan(1, 1, 2)`` with the merge scripted 1 -> 2
    -> 1, every rebind zero-copy checked, then fleet decode ticks at
    merge 1 and at merge 2, (c) the lse_merge of split K2 partials, (e)
    phase 5's requests under LIVE with the merge scripted 1 -> 2, a
    decode tick of tag-1 riders at merge 2 and a context over one rank's
    pool on an SP island. Writes ``{out}.{rank}.json``."""
    import gc

    import torch

    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_stack, replay
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(4)
    t0 = time.perf_counter()
    res = {"a": {dev: islands_trace(torch, dev) for dev in ("cuda", "cpu")}}
    t1 = time.perf_counter()
    res["d"] = {dev: live_runs(torch, dev) for dev in ("cuda", "cpu")}
    res["d_s"] = time.perf_counter() - t1

    cfg = serve_config(num_blocks=2048, ranks=2)
    t1 = time.perf_counter()
    stack = build_stack(cfg, check_zero_copy=True)
    sched, eng = stack[0], stack[0].backend
    sched.policy = ScriptedMerge(2, 400)
    torch.cuda.synchronize()
    res["build_s"] = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    sched, wall = replay(cfg, stack)
    trace_launches = {k: _lib.LAUNCHES[k] for k in SERVE_KERNELS}
    reqs = list(sched.pool.all.values())
    res["b"] = {
        "done": sum(r.state == "done" and len(eng.generated_tokens(
            r.req_id)) == r.output_len for r in reqs),
        "n": len(reqs),
        "tokens": sum(len(eng.generated_tokens(r.req_id)) for r in reqs),
        "in_vocab": all(0 <= x < eng.cfg.vocab_size for r in reqs
                        for x in eng.generated_tokens(r.req_id)),
        "wall_s": wall, "merges": [l.merge for l in sched.log],
        "phases": [l.phase for l in sched.log],
        "rebind_ms": [dt * 1e3 for dt in eng.switch_log],
        "launches": trace_launches,
        "host_argmax": eng.sync_stats.host_argmax,
        "sync": str(eng.sync_stats),
        "collectives": [eng.pool.stats.collectives,
                        eng.pool.stats.host_collectives]}
    res["tick1"] = decode_tick_ms(torch, eng, 1)
    res["tick2"] = decode_tick_ms(torch, eng, 2)
    res["c_err"] = lse_merge_check(torch, eng)
    st = eng.pool.stats
    res["pool"] = {"describe": eng.pool.describe(),
                   "build_ms": st.group_build_s * 1e3,
                   "lookup_us": st.lookup_s / max(st.lookups, 1) * 1e6,
                   "lookups": st.lookups}
    res["rebind_ms"] = [dt * 1e3 for dt in eng.switch_log]
    weights = (eng.model, eng.params)

    # (e): a fresh engine over the same weights (its own pools and token
    # buffers: phase 5's request ids again), then the SP engine
    del stack, sched, eng, reqs
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    live_cfg = serve_config(num_blocks=2048, ranks=2, strategy="live")
    stack = build_stack(live_cfg, weights, check_zero_copy=True)
    res["e"] = live_full_width(torch, stack, live_cfg)
    res["e_tick"] = live_tick_ms(torch, stack[0].backend)
    del stack
    gc.collect()
    torch.cuda.empty_cache()
    res["e_sp"] = sp_full_width(torch, weights)
    res["e_s"] = time.perf_counter() - t1
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["rank_s"] = time.perf_counter() - t0
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)


def check_live_full_width(runs, smi: str) -> None:
    """Phase 14 (e)'s verdict and readings: every request of the LIVE
    trace done, its merge-up riding its riders with nothing paused or
    recomputed, K2's and K4's LSE launches (the live lanes) counted and
    required, every greedy token of the riders, the live tick and the SP
    run a dense argmax or a near-tie; the SP context over one rank's
    pool."""
    e = runs[0]["e"]
    for r, res in enumerate(runs):
        x, tick, sp = res["e"], res["e_tick"], res["e_sp"]
        p = x["preempt"]
        check(x["done"] == x["n"] == 8 and x["host_argmax"] == 0,
              f"rank {r}: live trace {x['done']}/{x['n']} done")
        check(2 in x["merges"] and bool(x["riders"]) and
              p["live_riders"] > 0 and p["paused"] == 0 and
              p["recomputed_tokens"] == 0,
              f"rank {r}: the LIVE merge-up did not ride: riders "
              f"{x['riders']}, {p}")
        check(x["merges"] == e["merges"] and x["preempt"] == e["preempt"],
              f"rank {r} scheduled another live trace than rank 0")
        for what, lse in (("trace", x["lse"]), ("SP run", sp["lse"])):
            check(all(lse[k] > 0 for k in lse),
                  f"rank {r}: the {what}'s live lanes never launched "
                  f"K2 and K4 with their LSE: {lse}")
        check(tick["lse"]["paged_attention"] ==
              tick["launches"]["paged_attention"] > 0,
              f"rank {r}: live tick K2 launches {tick['launches']}, LSE "
              f"{tick['lse']}")
        check(sp["context"] > sp["one_pool"] and sp["shards"] == [0, 1],
              f"rank {r}: SP run {sp['context']} tokens over pools of "
              f"{sp['one_pool']}, shards {sp['shards']}")
        for what, g in (("rider", x["greedy"]), ("live tick", tick["greedy"]),
                        ("SP", sp["greedy"])):
            check(g["tokens"] > 0 and g["worst"] <= 1.0,
                  f"rank {r}: a {what} greedy token is off the dense "
                  f"one-rank forward's argmax by {g['worst']:.2f}x the "
                  f"near-tie bound (margins {g['margins']})")
    tick, sp = runs[0]["e_tick"], runs[0]["e_sp"]
    plain = runs[0]["tick2"]
    print(f"islands (e): llama3-8b bf16, 32 layers, phase 5's 8 requests "
          f"under LIVE, merge 1 -> 2 while {len(e['riders'])} requests "
          f"decode and a chunked prefill is in flight: {e['done']}/8 done "
          f"in {e['wall_s']:.3f} s, preempt_stats {e['preempt']}, lanes "
          f"{e['lanes']}, weight and pool data_ptrs unchanged over every "
          f"rebind and step; K1-K4 launches a rank "
          f"{[res['e']['launches'] for res in runs]}, of them returning "
          f"the LSE (the live lanes) {[res['e']['lse'] for res in runs]}; "
          f"{e['collectives'] / max(e['steps'], 1):.1f} TP collectives a "
          f"step on rank 0; riders' greedy tokens against a dense one-rank "
          f"forward: {e['greedy']['flips']} of {e['greedy']['tokens']} "
          f"near-ties off its argmax (at most {e['greedy']['worst']:.2f}x "
          f"the bound)")
    print(f"islands (e): {smi}; decode tick of 16 tag-1 riders at merge 2 "
          f"(prompts of 512): {tick['ms']:.2f} ms (the slower rank's) "
          f"beside (b)'s plain merge-2 tick {plain['ms']:.2f} ms; lanes "
          f"{tick['lanes']}; {tick['collectives']:.1f} TP collectives a "
          f"tick on rank 0 (plain: {plain['collectives'] / plain['steps']:.1f}"
          f"); K1-K4 launches over its {tick['steps']} live ticks "
          f"{[res['e_tick']['launches'] for res in runs]}, K2 with its LSE "
          f"{[res['e_tick']['lse']['paged_attention'] for res in runs]}; "
          f"greedy {tick['greedy']['flips']} of {tick['greedy']['tokens']} "
          f"near-ties (at most {tick['greedy']['worst']:.2f}x the bound)")
    print(f"islands (e): {smi}; SP island Island(0, 2, 2, sp=2) served a "
          f"{sp['context']}-token context over pools of {sp['one_pool']} "
          f"tokens a rank (shards {sp['shards']}, lanes {sp['lanes']}) in "
          f"{sp['wall_s']:.3f} s; K2/K4 LSE launches "
          f"{[res['e_sp']['lse'] for res in runs]}; greedy "
          f"{sp['greedy']['flips']} of {sp['greedy']['tokens']} near-ties "
          f"(at most {sp['greedy']['worst']:.2f}x the bound); (d) "
          f"{max(res['d_s'] for res in runs):.1f} s and (e) "
          f"{max(res['e_s'] for res in runs):.1f} s of the phase")


def serve_islands(torch, smi: str) -> None:
    """Phase 14: spawn two rank processes on the one card (gloo), run
    ``islands_rank`` in each, and check and print what they found."""
    import tempfile

    from repro_torch.launch.ranks import spawn
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        out = str(Path(d) / "isl")
        spawn(islands_rank, 2, (out,), device_type="cuda",
              timeout=900)
        runs = []
        for r in range(2):
            with open(f"{out}.{r}.json") as f:
                runs.append(json.load(f))
    a = check_islands_trace([res["a"] for res in runs])
    print(f"islands: {a['backend']}; two ranks share this card over gloo, "
          f"host-staged: no number here measures TP on two cards")
    print(f"islands (a): reduced llama3-8b fp32, DP -> TP2 -> DP "
          f"({a['rebinds']} rebinds, merges by tick {a['merges']}): card "
          f"streams equal the CPU ranks', {a['done']}/8 done")
    d = check_live_runs([res["d"] for res in runs])
    live, sp, kill = d["live"], d["sp"], d["kill"]
    print(f"islands (d): reduced llama3-8b with 2 KV heads, fp32, card "
          f"runs equal the CPU ranks' on both ranks "
          f"({max(res['d_s'] for res in runs):.1f} s): LIVE DP -> TP2 "
          f"with {len(live['riders'])} riders and a chunked prefill in "
          f"flight, {live['done']}/8 done, preempt_stats {live['preempt']},"
          f" lanes {live['lanes']}; SP island Island(0, 2, 2, sp=2) "
          f"served a {sp['context']}-token context over pools of "
          f"{sp['one_pool']} tokens (shards {sp['shards']}, lanes "
          f"{sp['lanes']}), tokens equal to the big pool's; KILL of "
          f"engine 1 mid-decode: EngineFault on {kill['fault']}, "
          f"{kill['kept']} tokens kept, {kill['leaked']} blocks leaked, "
          f"the recovered stream equals the fault-free one")
    b = runs[0]["b"]
    for r, res in enumerate(runs):
        check(res["b"]["done"] == res["b"]["n"] == 8 and res["b"]["in_vocab"]
              and res["b"]["host_argmax"] == 0,
              f"rank {r}: full-width trace {res['b']['done']}/"
              f"{res['b']['n']} done")
        check(res["b"]["merges"] == b["merges"],
              f"rank {r} scheduled another merge sequence")
        for k in SERVE_KERNELS:
            check(res["tick2"]["launches"][k] > 0,
                  f"rank {r}: {k} never launched at merge 2")
        for m in (1, 2):
            g = res[f"tick{m}"]["greedy"]
            check(g["worst"] <= 1.0,
                  f"rank {r}: a merge-{m} greedy token is off the dense "
                  f"one-rank forward's argmax by {g['worst']:.2f}x the "
                  f"near-tie bound (margins {g['margins']})")
    check(2 in b["merges"] and b["merges"][-1] == 1,
          f"full-width trace did not go 1 -> 2 -> 1: {b['merges']}")
    print(f"islands (b): llama3-8b bf16, 32 layers, phase 5's 8 "
          f"requests at ParallelPlan(1, 1, 2) with merge 1 -> 2 -> 1: "
          f"{b['done']}/8 done, {b['tokens']} tokens in {b['wall_s']:.3f} s "
          f"({b['phases'].count('mixed')} mixed, {b['phases'].count('decode')}"
          f" decode ticks, {sum(m == 2 for m in b['merges'])} of "
          f"{len(b['merges'])} ticks at merge 2); weight and pool "
          f"data_ptrs unchanged over every rebind")
    print(f"islands (b): {b['sync']}; {b['collectives'][0]} TP and "
          f"{b['collectives'][1]} host collectives on rank 0 (each gloo "
          f"collective also waits for the card)")
    for r, res in enumerate(runs):
        print(f"islands (b) rank {r}: rebinds "
              f"{', '.join(f'{x:.2f}' for x in res['rebind_ms'])} ms; "
              f"pool {res['pool']['build_ms']:.1f} ms to build its groups, "
              f"{res['pool']['lookup_us']:.2f} us a lookup "
              f"({res['pool']['lookups']} lookups); trace launches "
              f"{res['b']['launches']}; peak memory {res['peak_gib']:.2f} "
              f"GiB; weights built in {res['build_s']:.1f} s")
    for m in (1, 2):
        t = runs[0][f"tick{m}"]
        g = t["greedy"]
        print(f"islands (b): decode tick at merge {m} (16 requests of 512 "
              f"tokens): {t['ms']:.2f} ms (the slower rank's), "
              f"{t['collectives'] / t['steps']:.1f} TP collectives a step "
              f"on rank 0; K1-K4 launches "
              f"{[res[f'tick{m}']['launches'] for res in runs]}; greedy "
              f"tokens against a dense one-rank forward: {g['flips']} of "
              f"{g['tokens']} are near-ties off its argmax (margins "
              f"{[f'{x:.3g}' for x in g['margins']]}, at most "
              f"{g['worst']:.2f}x the bound of {NEAR_TIE_SD} row "
              f"deviations)")
    print(f"islands (c): lse_merge of K2's split partials vs one K2 call: "
          f"max_abs_err {max(res['c_err'] for res in runs):.3e}")
    check_live_full_width(runs, smi)
    print(f"islands: {smi}; phase 14 took {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 15: MLA and MoE (DeepSeek-V2, Phi-3.5-MoE)
# ---------------------------------------------------------------------------

MLA_ARCH, MOE_ARCH = "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b"
# phase 15 (a)'s trace: prompts in chunks of 8 (the first, of 24,
# prefills alone), request 3 at priority 1
MOE_TRACE = [dict(req_id=f"r{i}", arrival=i * 0.01,
                  prompt_len=(24, 8, 12, 16, 20, 28)[i], output_len=3 + i,
                  priority=1 if i == 3 else 0) for i in range(6)]


def moe_reference_check(torch):
    """Phase 15 (a): the reduced DeepSeek-V2 (MLA + MoE) and Phi-3.5-MoE
    (GQA + MoE) in fp32 through a scheduler run with prefill, mixed and
    decode steps, on the card (K1-K4 and mla_decode) and on the CPU
    (their plain versions): greedy tokens and phase logs equal."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.kernels import _lib
    from repro_torch.models.model import build_model

    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    for arch in (MLA_ARCH, MOE_ARCH):
        cfg = get_config(arch).reduced()
        params = build_model(cfg, torch.float32, "cpu").init(
            torch.Generator().manual_seed(0))

        def serve(device):
            geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
            eng = FlyingEngine(build_model(cfg, torch.float32, device), plan,
                               geom, params, batch_per_engine=2,
                               max_blocks_per_req=16, device=device)
            sched = DynamicScheduler(plan, geom, FixedClock(eng),
                                     SchedulerConfig(strategy="hard",
                                                     max_batch_per_group=2,
                                                     prefill_chunk=8))
            for r in MOE_TRACE:
                sched.submit(Request(**r))
            sched.run(max_steps=400)
            return ({r["req_id"]: eng.generated_tokens(r["req_id"])
                     for r in MOE_TRACE}, [l.phase for l in sched.log])

        _lib.reset_launches()
        toks_gpu, ph_gpu = serve("cuda")
        launches = dict(_lib.LAUNCHES)
        toks_cpu, ph_cpu = serve("cpu")
        print(f"moe (a): reduced {arch} fp32, card vs CPU: tokens {toks_gpu}"
              f" phases {ph_gpu}; card launches {launches}")
        check(toks_gpu == toks_cpu, f"{arch}: card tokens {toks_gpu} != CPU "
                                    f"{toks_cpu}")
        check(ph_gpu == ph_cpu and {"prefill", "mixed", "decode"}
              <= set(ph_gpu), f"{arch}: phase logs {ph_gpu} vs {ph_cpu}")
        check(all(len(v) == r["output_len"] for v, r in
                  zip(toks_gpu.values(), MOE_TRACE)),
              f"{arch}: a request is short of tokens")
        kernels = ("paged_append_token", "paged_append_chunk", "mla_decode") \
            if arch == MLA_ARCH else SERVE_KERNELS
        for k in kernels:
            check(launches[k] > 0, f"{arch}: {k} never launched")


def dense_mla_logits(model, params):
    """The dense reference of phase 15 (b): tokens [T] -> fp32 logits
    [T, V] of one forward over the whole sequence, with no pool and no
    absorbed decode (each MLA layer expands its in-line compressed
    entries naively, causal by position: ``TrainBackend.append_ctx``)
    and no capacity (each MoE layer sends every token through its top-k
    experts: ``dense_moe_ref``)."""
    from repro_torch.core.views import SINGLE
    from repro_torch.models import moe
    from repro_torch.models.cache import TrainBackend

    def forward(seq):
        dispatch = moe.moe_ffn
        moe.moe_ffn = lambda cfg, p, x, ctx: moe.dense_moe_ref(cfg, p, x)
        try:
            # decode mode keeps every position's logits (prefill keeps
            # the last); TrainBackend makes the attention in-line
            logits, _, _ = model.forward(params, SINGLE, mode="decode",
                                         backend=TrainBackend(),
                                         tokens=seq[None])
        finally:
            moe.moe_ffn = dispatch
        return logits[0]
    return forward


class FiniteLogits:
    """Wraps ``steps.sample_tokens``: every sampled row's logits feed a
    device flag that stays True while all are finite (no host read in
    the serving loop)."""

    def __init__(self, torch, steps):
        self.steps, self.inner = steps, steps.sample_tokens
        self.ok = torch.ones((), dtype=torch.bool, device="cuda")
        self.rows = 0

        def sample(cfg, logits, ctx, **kw):
            self.ok &= torch.isfinite(logits).all()
            self.rows += logits.shape[0]
            return self.inner(cfg, logits, ctx, **kw)
        steps.sample_tokens = sample

    def restore(self) -> bool:
        self.steps.sample_tokens = self.inner
        return bool(self.ok)


class MoEDrops:
    """Wraps ``moe.moe_ffn``: counts, on the card, the (token, choice)
    entries that a call's capacity drops (padding rows included, as
    they take capacity in serving) beside the entries routed."""

    def __init__(self, torch, moe):
        self.moe, self.inner = moe, moe.moe_ffn
        self.dropped = torch.zeros((), dtype=torch.long, device="cuda")
        self.entries = 0

        def ffn(cfg, p, x, ctx):
            n = x.shape[0] * x.shape[1]
            e, _, _ = moe.route(p["router"], x.reshape(n, -1),
                                cfg.moe.top_k)
            pos = moe._positions_in_expert(e.reshape(-1),
                                           cfg.moe.num_experts)
            self.dropped += (pos >= moe.capacity(cfg, n)).sum()
            self.entries += n * cfg.moe.top_k
            return self.inner(cfg, p, x, ctx)
        moe.moe_ffn = ffn

    def restore(self) -> int:
        self.moe.moe_ffn = self.inner
        return int(self.dropped)


def serve_mla_full_width(torch, smi: str) -> dict:
    """Phase 15 (b): deepseek-v2-236b at full width, 4 of its 60 layers
    (the dense MLA+MLP layer and three MLA+MoE layers), bf16, seed-0
    weights, at ParallelPlan(1, 1, 1) over a 4096 x 16-token pool: 8
    requests (prompts 256-1024, 32 tokens out) through the launcher's
    real path (DynamicScheduler over FlyingEngine under the layout
    policy), launch counts reset just before and read just after. Every
    request done with finite logits and in-vocab tokens; K1 and
    mla_decode launched once a layer in every step that carries decode
    rows, K3 once a layer in every step that carries prefill rows. The
    config's capacity factor (1.25) drops entries, and which ones
    depends on how the batch was cut (with random weights most tokens
    pick the same experts), which no single-sequence forward
    reproduces; so the greedy tokens are held on a second run of the
    same trace in steps of at most 8 tokens (prefill chunks of 1),
    where an expert's capacity (at least 8) drops nothing (counted):
    each must be the dense forward's argmax or a near-tie
    (NEAR_TIE_SD); the first run's drops and its distance from the
    dense forward are printed. Prints
    tok/s, the median decode tick, the peak memory, and a profiled
    rerun's device time by kernel class."""
    import dataclasses
    import math

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import steps as steps_mod
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_stack, replay
    from repro_torch.models import moe
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_leaves

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(MLA_ARCH), num_layers=4)
    sc = serve_config(arch=MLA_ARCH, prompt_range=(256, 1024),
                      output_range=(32, 32))
    gc_collect(torch)
    t0 = time.perf_counter()
    model = build_model(cfg, torch.bfloat16, "cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    print(f"mla (b): built {MLA_ARCH} at full width, {cfg.num_layers} of 60 "
          f"layers ({n_params / 1e9:.3f} B parameters, bf16) in "
          f"{time.perf_counter() - t0:.1f} s")
    stack = build_stack(sc, weights=(model, params))
    engine = stack[0].backend
    clock = StepClock(engine)
    stack[0].backend = clock
    finite = FiniteLogits(torch, steps_mod)
    drops = MoEDrops(torch, moe)
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    try:
        sched, wall = replay(sc, stack)
    finally:
        ok = finite.restore()
        dropped = drops.restore()
    launches = dict(_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    reqs = list(sched.pool.all.values())
    vocab = cfg.vocab_size
    n_tok = 0
    for r in reqs:
        toks = engine.generated_tokens(r.req_id)
        check(r.state == "done" and len(toks) == r.output_len,
              f"{r.req_id}: state {r.state}, {len(toks)}/{r.output_len} "
              f"tokens")
        check(all(0 <= x < vocab for x in toks),
              f"{r.req_id}: token outside the vocab")
        n_tok += len(toks)
    check(len(reqs) == 8, f"{len(reqs)} requests served, not 8")
    check(ok, "a sampled row's logits are not finite")
    kinds = [k for k, _, _ in clock.log]
    with_dec = sum(1 for k, ids, _ in clock.log
                   if k == "decode" or (k == "mixed" and ids[1]))
    with_pre = sum(1 for k, ids, _ in clock.log
                   if k == "prefill" or (k == "mixed" and ids[0]))
    L = cfg.num_layers
    want = {"mla_decode": L * with_dec, "paged_append_token": L * with_dec,
            "paged_append_chunk": L * with_pre}
    print(f"mla (b): {len(reqs)} requests, prompts "
          f"{sorted(r.prompt_len for r in reqs)}, outputs "
          f"{sorted(r.output_len for r in reqs)}; {len(kinds)} steps "
          f"({kinds.count('prefill')} prefill, {kinds.count('mixed')} mixed,"
          f" {kinds.count('decode')} decode; {with_dec} with decode rows); "
          f"{finite.rows} sampled rows, all logits finite")
    print(f"mla (b): kernel launches {launches}")
    for k, n in want.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times, not "
                                f"{L} layers x the steps that run it = {n}")
    check(engine.sync_stats.host_argmax == 0,
          "tokens were read back one at a time")
    ticks = sorted(dt for k, _, dt in clock.log if k == "decode")
    tick = ticks[len(ticks) // 2] if ticks else float("nan")
    print(f"mla (b): {n_tok} tokens in {wall:.3f} s = {n_tok / wall:.1f} "
          f"tok/s; median decode tick {tick * 1e3:.2f} ms over "
          f"{len(ticks)} decode steps (min {ticks[0] * 1e3:.2f}, max "
          f"{ticks[-1] * 1e3:.2f}); peak memory {peak / 2**30:.2f} GiB; "
          f"{smi}")
    dense = dense_mla_logits(model, params)
    g = greedy_margins(torch, engine, reqs, dense=dense)
    print(f"mla (b): capacity factor {cfg.moe.capacity_factor}: "
          f"{dropped} of {drops.entries} routed entries dropped; greedy "
          f"tokens against a dense forward (no pool, naive MLA, no MoE "
          f"capacity): {g['flips']} of {g['tokens']} off its argmax, at "
          f"most {g['worst']:.2f}x the bound of {NEAR_TIE_SD} row "
          f"deviations")
    # the hold: the same trace in steps of at most 8 tokens (prefill
    # chunks of 1, 8 rows), which capacity (at least 8) never cuts
    sc1 = dataclasses.replace(sc, prefill_chunk=1)
    stack = build_stack(sc1, weights=(model, params))
    drops = MoEDrops(torch, moe)
    t0 = time.perf_counter()
    try:
        sched1, _ = replay(sc1, stack)
    finally:
        dropped1 = drops.restore()
    reqs1 = list(sched1.pool.all.values())
    check(dropped1 == 0 and all(r.state == "done" for r in reqs1),
          f"prefill chunks of 1: {dropped1} entries dropped")
    greedy = greedy_margins(torch, stack[0].backend, reqs1, dense=dense)
    print(f"mla (b): the trace in prefill chunks of 1 ({len(sched1.log)} "
          f"steps, {time.perf_counter() - t0:.1f} s; 0 of {drops.entries} "
          f"entries dropped): {greedy['flips']} of {greedy['tokens']} "
          f"greedy tokens are near-ties off the dense forward's argmax "
          f"(margins {[f'{x:.3g}' for x in greedy['margins']]}, at most "
          f"{greedy['worst']:.2f}x the bound)")
    check(greedy["worst"] <= 1.0 and math.isfinite(greedy["worst"]),
          f"a greedy token is off the dense forward's argmax by "
          f"{greedy['worst']:.2f}x the near-tie bound")
    del stack, sched1, reqs1
    # the breakdown: the same trace again, under the profiler
    stack = build_stack(sc, weights=(model, params))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall2 = replay(sc, stack)
    print_breakdown("mla (b) breakdown", prof, wall2, (
        ("mla_decode", "mla::decode"), ("mla_decode", "mla6decode"),
        ("paged_append", "append_rows"),
        ("moe dispatch, pool gather", "index"),
        ("moe dispatch, pool gather", "sort"),
        ("moe dispatch, pool gather", "scatter"),
        ("moe dispatch, pool gather", "gather"),
        ("moe dispatch, pool gather", "cat"),
        ("elementwise", "elementwise"), ("reduction", "reduce"),
        ("softmax", "softmax")))
    del stack, engine, clock, sched, model, params, dense
    gc_collect(torch)
    print(f"mla (b): phase 15 (b) took {time.perf_counter() - t_phase:.1f} s")
    return {"mla_decode": launches["mla_decode"],
            "paged_append_token_mla": launches["paged_append_token"],
            "paged_append_chunk_mla": launches["paged_append_chunk"]}


def gc_collect(torch) -> None:
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def kernel_label(mangled: str) -> str:
    """``fwd_kernel<bf16, 256>`` from an Itanium-mangled kernel name in an
    (anonymous) namespace; the name itself if it is not one."""
    import re
    m = re.match(r"_ZN(\d+)", mangled)
    if not m:
        return mangled[:48]
    rest = mangled[m.end() + int(m.group(1)):]
    name = None
    while True:                          # nested names: keep the last
        m = re.match(r"(\d+)", rest)
        if not m:
            break
        n = int(m.group(1))
        name, rest = rest[m.end():m.end() + n], rest[m.end() + n:]
    if name is None:
        return mangled[:48]
    args = []
    i = 1 if rest.startswith("I") else len(rest)
    while i < len(rest) and rest[i] != "E":
        m = re.match(r"(\d+)|Li(-?\d+)E", rest[i:])
        if m and m.group(1):             # a named type
            k = int(m.group(1))
            j = i + m.end()
            args.append(rest[j:j + k].replace("__nv_bfloat16", "bf16"))
            i = j + k
        elif m:                          # an int
            args.append(m.group(2))
            i += m.end()
        else:                            # a builtin type
            args.append({"f": "f32"}.get(rest[i], rest[i]))
            i += 1
    return f"{name}<{', '.join(args)}>" if args else name


def print_ptxas(source: str, log: str) -> None:
    """One line per compiled kernel from nvcc's ``-Xptxas -v`` report:
    its name, registers, shared memory and spills."""
    import re
    fn, spill = "?", ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = kernel_label(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            used = line.split(":", 1)[-1].strip()
            print(f"  {source}.cu {fn}: {used}; {spill}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device is visible")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("src/repro_torch is missing: run from a checkout of the repo")
    sys.path.insert(0, str(ROOT / "src"))

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)}")

    from repro_torch.kernels import _lib
    t0 = time.perf_counter()
    _lib.build_all(force=True)
    print(f"built {len(_lib.SOURCES)} kernel sources in "
          f"{time.perf_counter() - t0:.1f} s")
    for name in _lib.SOURCES:
        print_ptxas(name, _lib.BUILD_LOG.get(name, ""))
    smem = _lib.func("flash_tc_smem")
    print("  flash_prefill.cu, dynamic shared memory of the bf16 kernels: "
          + ", ".join(f"{k}<{hd}> {smem(hd, i)} bytes"
                      for hd in (64, 128, 256)
                      for i, k in enumerate(("fwd_tc", "dq_tc", "dkdv_tc"))))
    smem = _lib.func("paged_prefill_tc_smem")
    print("  paged_prefill.cu, dynamic shared memory of the bf16 kernel: "
          + ", ".join(f"prefill_tc<{hd}> {smem(hd)} bytes"
                      for hd in (64, 128)))
    rows = kernel_checks(torch, np)
    for r in rows:
        lib_ms = "none" if r["library_ms"] is None \
            else f"{r['library_ms']:.4f} ms"
        print(f"  {r['name']:<20} {r['ms']:.4f} ms   plain {r['plain_ms']:.4f} "
              f"ms   library {lib_ms}   bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    if args.kernels_only:
        # the paths did not run: their launch counts are unknown
        launches = {r["name"]: None for r in rows}
    else:
        reference_check(torch)
        launches, offline = serve_full_width(torch)
        serve_breakdown(torch)
        gc_collect(torch)
        serve_http_full_width(torch, smi, offline)
        del offline
        train_reference_check(torch, np, "llama3-8b", bf16=True)
        launches.update(train_full_width(torch))
        train_reference_check(torch, np, "mamba2-2.7b")
        launches.update(train_mamba2(torch))
        train_reference_check(torch, np, "recurrentgemma-9b", layers=4,
                              bf16=True)
        launches.update(train_recurrentgemma(torch))
        gc_collect(torch)
        serve_islands(torch, smi)
        moe_reference_check(torch)
        launches.update(serve_mla_full_width(torch, smi))
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(f"device: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
