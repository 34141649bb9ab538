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
   instructions in the SASS of every instance;
4. serve a small request trace with the reduced llama3-8b in fp32 on the
   card and on the CPU (plain versions): the greedy tokens and the phase
   log must be identical; then four requests over a 12-block pool, where
   decode growth finds the pool full and the scheduler evicts and
   recovers a request: tokens, phases and the recovered count (> 0)
   must be identical;
5. serve 8 seeded requests at the full width of llama3-8b in bf16
   through ``repro_torch.launch.serve`` (DynamicScheduler over
   FlyingEngine), with every kernel's launch count reset just before and
   read just after: every request must finish with its full output,
   every token must be in the vocab, K1-K4 must have launched,
   and no token may have been read back one at a time;
6. serve the same trace again under torch.profiler and print the device
   time by kernel class, the device's busy share of the wall time, and
   K2's, K4's and the appends' launches and mean time a launch;
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
   steps.

Each kernel's launch count in the JSON record comes from the path that
runs it: K1-K4 from phase 5, K5 and its backward at hd 128 from phase 8
and at hd 256 from phase 12, K6 and its backward from phase 10, K7 and
its backward from phase 12. The line
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
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16, NVIDIA data sheet
F32_TOL = dict(atol=1e-4, rtol=0.0)
BF16_TOL = dict(atol=1e-3, rtol=1e-2)
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
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / BF16_FLOPS_PER_S * 1e3
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
    KV 2, hd 64) and 12 (mistral-large-123b: H 96, KV 8, hd 128) against
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
    page, nblk, MB = 16, 4096, 256

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)
    for H, KV, hd, Tp in ((14, 2, 64, 512), (96, 8, 128, 256)):
        rep = H // KV
        kp_, vp_ = (torch.randn((nblk, page, KV, hd), generator=gen,
                                device=dev).to(bf16) for _ in range(2))
        B = 8
        ctx = t(np.concatenate([[1, MB * page], rng.integers(
            2, MB * page, size=B - 2)]), torch.int32)
        bt = t(rng.permutation(nblk - 1)[:B * MB].reshape(B, MB),
               torch.int32)
        q = torch.randn((B, H, hd), generator=gen, device=dev)
        n_split, split_len = pk.decode_splits(B, KV, rep, MB * page, dev)
        tag = f"paged_attention rep {rep} hd {hd}"
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
        tag = f"paged_flash_prefill rep {rep} hd {hd} T {Tp}"
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

    class FixedClock:
        """Backend proxy whose steps report a fixed duration, so both
        runs see the same scheduler clock."""
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

def serve_config():
    from repro_torch.launch.serve import ServeConfig
    return ServeConfig(arch="llama3-8b", requests=8, seed=0,
                       num_blocks=4096, block_base=16, batch_per_engine=8,
                       max_blocks_per_req=256, prefill_chunk=512,
                       prompt_range=(256, 2048), output_range=(32, 64),
                       rate=20.0)


def serve_full_width(torch):
    from repro_torch.kernels import _lib
    from repro_torch.launch.serve import build_stack, run_offline

    cfg = serve_config()
    t0 = time.perf_counter()
    stack = build_stack(cfg)
    torch.cuda.synchronize()
    print(f"serve: built llama3-8b (bf16, 32 layers) and a "
          f"{cfg.num_blocks}x{cfg.block_base}-token pool in "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.reset_peak_memory_stats()
    _lib.reset_launches()
    sched, engine, summary, wall = run_offline(cfg, stack)
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
    return {k: launches[k] for k in SERVE_KERNELS}


def serve_breakdown(torch):
    """Device time by kernel class over a second, profiled run of the
    same trace (the first run's wall time stays unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.serve import build_stack, run_offline

    cfg = serve_config()
    stack = build_stack(cfg)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = run_offline(cfg, stack)
    print_breakdown("breakdown", prof, wall, (
        ("paged_flash_prefill", "prefill_tc"),
        ("paged_flash_prefill fp32", "prefill_kernel"),
        ("paged_attention", "decode_kernel"),
        ("paged_append", "append_rows")))


def print_breakdown(tag: str, prof, wall: float, classes) -> None:
    """Device time by kernel class (``classes``: (class, name pattern)
    pairs, GEMM patterns added), the device's busy share of ``wall``
    seconds, and each of ``classes``' launches and mean time a launch."""
    named = [c for c, _ in classes]
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
        launches = serve_full_width(torch)
        serve_breakdown(torch)
        gc_collect(torch)
        train_reference_check(torch, np, "llama3-8b", bf16=True)
        launches.update(train_full_width(torch))
        train_reference_check(torch, np, "mamba2-2.7b")
        launches.update(train_mamba2(torch))
        train_reference_check(torch, np, "recurrentgemma-9b", layers=4,
                              bf16=True)
        launches.update(train_recurrentgemma(torch))
    for r in rows:
        r["launches"] = launches[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(f"device: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
