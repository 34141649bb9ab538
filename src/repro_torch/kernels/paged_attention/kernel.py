"""CUDA wrappers of the paged decode kernels (csrc/paged_append.cu,
csrc/paged_attention.cu): validate, allocate outputs, launch on the
current stream, count the launch, raise on a launch error. They take
CUDA tensors only; ``ops`` routes CPU tensors to the plain versions."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _lib


def _append_rows(pools, vals, slots, n_rows: int, what: str):
    kp, vp = pools
    kv, vv = vals[0].contiguous(), vals[1].contiguous()
    if slots.dtype != torch.int32:
        slots = slots.to(torch.int32)
    slots = slots.contiguous()
    _lib.require_cuda(kp, vp, kv, vv, slots)
    shape = kp.shape
    rows = shape[0] * shape[1]
    w = kp.numel() // rows
    if vp.shape != shape or kv.shape != vv.shape \
            or kv.numel() != n_rows * w or vp.dtype != kp.dtype:
        raise ValueError(f"{what}: pools {tuple(shape)} vs values "
                         f"{tuple(kv.shape)}")
    rc = _lib.func("paged_append_rows")(
        kv.data_ptr(), vv.data_ptr(), kp.data_ptr(), vp.data_ptr(),
        slots.data_ptr(), n_rows, rows - 1, w, _lib.dtype_code(kv),
        _lib.dtype_code(kp), _lib.stream_of(kp))
    _lib.LAUNCHES[what] += 1
    _lib.check(rc, what)
    return pools


def paged_append_token_kernel(pools, vals, slots):
    """In-place single-token append: pools (k, v) [nblk,page,*w] (views
    of the engine's flat pools, written in place), vals (k, v) [B,*w],
    slots [B] (negative: parked on the scratch row)."""
    return _append_rows(pools, vals, slots, slots.shape[0],
                        "paged_append_token")


def paged_append_chunk_kernel(pools, vals, slots):
    """In-place chunk append: vals (k, v) [B,T,*w], slots [B,T]."""
    return _append_rows(pools, vals, slots, slots.numel(),
                        "paged_append_chunk")


MAX_GROUP = 8       # query heads of a kv head one block serves
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def decode_splits(B: int, KV: int, rep: int, keys: int, device,
                  splits: Optional[int] = None) -> Tuple[int, int]:
    """(splits, split_len) of the decode kernel over ``keys`` = MB * page
    key positions: split lengths are multiples of 64 keys, and the
    fewest splits whose B * KV * groups * splits blocks fill the card's
    SMs four times over (or ``splits``, if given: a test's choice)."""
    groups = -(-rep // MAX_GROUP)
    if splits is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        splits = -(-4 * sms // (B * KV * groups))
    splits = max(1, min(int(splits), -(-keys // 64)))
    split_len = -(-keys // splits)
    split_len = -(-split_len // 64) * 64
    return -(-keys // split_len), split_len


def _counters(device, n: int) -> torch.Tensor:
    """The per-device int32 ticket counters of the decode kernel's split
    merge: zero between launches (each launch leaves them zero)."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def paged_attention_kernel(q, k_pool, v_pool, block_table, context_len, *,
                           window: Optional[int] = None,
                           softmax_scale: Optional[float] = None,
                           return_lse: bool = False,
                           splits: Optional[int] = None):
    """q [B,H,hd]; pools [nblk,page,KV,hd]; block_table [B,MB];
    context_len [B] -> [B,H,hd] in q's dtype (+ lse [B,H] fp32). Any
    H/KV; hd 64 or 128. ``splits`` overrides the split count that
    ``decode_splits`` picks from the card (tests only)."""
    q = q.contiguous()
    k_pool, v_pool = _lib.aligned(k_pool), _lib.aligned(v_pool)
    bt = block_table.to(torch.int32).contiguous()
    ctx = context_len.to(torch.int32).contiguous()
    _lib.require_cuda(q, k_pool, v_pool, bt, ctx)
    B, H, hd = q.shape
    nblk, page, KV, hd_k = k_pool.shape
    if hd_k != hd or v_pool.shape != k_pool.shape or H % KV:
        raise ValueError(f"paged_attention: q {tuple(q.shape)} vs pools "
                         f"{tuple(k_pool.shape)}")
    if hd not in (64, 128):
        raise ValueError(f"paged_attention kernel takes hd 64 or 128, not "
                         f"{hd}")
    MB = bt.shape[1]
    rep = H // KV
    n, split_len = decode_splits(B, KV, rep, MB * page, q.device, splits)
    groups = -(-rep // MAX_GROUP)
    part = count = None
    if n > 1:
        # fp32 partial per (request, kv head, group, split): max and sum
        # of 8 heads, and their [8, hd] outputs
        part = torch.empty((B * KV * groups * n, 2 + hd, MAX_GROUP),
                           dtype=torch.float32, device=q.device)
        count = _counters(q.device, B * KV * groups)
    out = torch.empty_like(q)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    rc = _lib.func("paged_attention_decode")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
        ctx.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        part.data_ptr() if part is not None else None,
        count.data_ptr() if count is not None else None,
        B, H, KV, hd, page, MB, window or 0, scale, n, split_len,
        _lib.dtype_code(q), _lib.dtype_code(k_pool), _lib.stream_of(q))
    _lib.LAUNCHES["paged_attention"] += 1
    _lib.check(rc, "paged_attention")
    return (out, lse) if return_lse else out
