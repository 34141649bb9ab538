"""CUDA wrappers of the paged decode kernels (csrc/paged_append.cu,
csrc/paged_attention.cu): validate, allocate outputs, launch on the
current stream, count the launch, raise on a launch error. They take
CUDA tensors only; ``ops`` routes CPU tensors to the plain versions.
The appends take a (k, v) pool pair or one pool (the compressed MLA
cache)."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _lib


def _append_rows(pools, vals, slots, n_rows: int, what: str):
    if len(pools) not in (1, 2) or len(vals) != len(pools):
        raise ValueError(f"{what}: {len(pools)} pools, {len(vals)} values")
    kp, vp = pools[0], pools[-1]
    kv, vv = vals[0].contiguous(), vals[-1].contiguous()
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
    two = len(pools) == 2
    rc = _lib.func("paged_append_rows")(
        kv.data_ptr(), vv.data_ptr() if two else None, kp.data_ptr(),
        vp.data_ptr() if two else None, slots.data_ptr(), n_rows, rows - 1,
        w, _lib.dtype_code(kv), _lib.dtype_code(kp), _lib.stream_of(kp))
    _lib.LAUNCHES[what] += 1
    _lib.check(rc, what)
    return pools


def paged_append_token_kernel(pools, vals, slots):
    """In-place single-token append: pools (k, v) or (pool,)
    [nblk,page,*w] (views of the engine's flat pools, written in place),
    vals of the same count [B,*w], slots [B] (negative: parked on the
    scratch row)."""
    return _append_rows(pools, vals, slots, slots.shape[0],
                        "paged_append_token")


def paged_append_chunk_kernel(pools, vals, slots):
    """In-place chunk append: vals (k, v) or (entry,) [B,T,*w], slots
    [B,T]."""
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
    H/KV; hd 64, 128 or 256. ``splits`` overrides the split count that
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
    if hd not in (64, 128, 256):
        raise ValueError(f"paged_attention kernel takes hd 64, 128 or 256, "
                         f"not {hd}")
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
    if return_lse:
        _lib.LSE_LAUNCHES["paged_attention"] += 1
    _lib.check(rc, "paged_attention")
    return (out, lse) if return_lse else out


MLA_HEADS = 64      # query heads a block of the bf16 (tensor-core) route
MLA_HEADS_FP32 = 32  # ... of the fp32 pools' CUDA-core route
MLA_MAX_W = 576     # widest compressed entry it takes (DeepSeek-V2's)


def mla_heads(pool_dtype: torch.dtype) -> int:
    """Query heads one block of the MLA decode kernel serves over a pool
    of ``pool_dtype``: 64 (the wgmma M) on the bf16 route, 32 on the
    fp32 CUDA-core route."""
    return MLA_HEADS if pool_dtype == torch.bfloat16 else MLA_HEADS_FP32


def mla_splits(B: int, H: int, keys: int, device,
               splits: Optional[int] = None,
               heads: int = MLA_HEADS) -> Tuple[int, int]:
    """(splits, split_len) of the MLA decode kernel over ``keys`` = MB *
    page key positions, in blocks of ``heads`` query heads: split
    lengths are multiples of 64 keys, and the fewest splits whose B *
    groups * splits blocks (one an SM: each takes ~225 KB of shared
    memory on the bf16 route, ~150 KB on the fp32 one, at W 576) fill
    the card's SMs twice (or ``splits``, if given: a test's choice; the
    bf16 route takes at most 288)."""
    groups = -(-H // heads)
    if splits is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        splits = -(-2 * sms // (B * groups))
    splits = max(1, min(int(splits), -(-keys // 64)))
    split_len = -(-keys // splits)
    split_len = -(-split_len // 64) * 64
    return -(-keys // split_len), split_len


def paged_mla_attention_kernel(q_cat, pool, block_table, context_len, *,
                               R: int, window: Optional[int] = None,
                               softmax_scale: float = 1.0,
                               return_lse: bool = False,
                               splits: Optional[int] = None):
    """Absorbed MLA decode over the compressed paged cache: q_cat [B,H,W]
    fp32 (pre-scaled [q_nope W_uk ++ q_pe]); pool [nblk,page,W] fp32 or
    bf16; block_table [B,MB]; context_len [B] -> [B,H,R] fp32, the
    softmax over q_cat . entry read over each entry's first R lanes (+
    ``return_lse``: lse [B,H] fp32, ``NEG_INF`` and out 0 for a row with
    no live key). W
    and R multiples of 8, R <= W <= 576, any H and page. A bf16 pool runs
    the tensor-core kernel (``decode_tc``), an fp32 pool the CUDA-core
    one (``decode``). ``splits`` overrides the split count that
    ``mla_splits`` picks (tests only)."""
    q = _lib.aligned(q_cat.contiguous())
    pool = _lib.aligned(pool)
    bt = block_table.to(torch.int32).contiguous()
    ctx = context_len.to(torch.int32).contiguous()
    _lib.require_cuda(q, pool, bt, ctx)
    if q.dtype != torch.float32:
        raise TypeError(f"mla_decode takes fp32 queries, not {q.dtype}")
    B, H, W = q.shape
    if pool.dim() != 3 or pool.shape[2] != W:
        raise ValueError(f"mla_decode: q {tuple(q.shape)} vs pool "
                         f"{tuple(pool.shape)}")
    if W % 8 or W > MLA_MAX_W or R % 8 or not 0 < R <= W:
        raise ValueError(f"mla_decode takes W and R multiples of 8 with R "
                         f"<= W <= {MLA_MAX_W}, not W {W}, R {R}")
    page, MB = pool.shape[1], bt.shape[1]
    heads = mla_heads(pool.dtype)
    n, split_len = mla_splits(B, H, MB * page, q.device, splits, heads)
    groups = -(-H // heads)
    part = count = None
    if n > 1:
        part = torch.empty((B * groups * n, 2 + R, heads),
                           dtype=torch.float32, device=q.device)
        count = _counters(q.device, B * groups)
    out = torch.empty((B, H, R), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, H), dtype=torch.float32, device=q.device) \
        if return_lse else None
    rc = _lib.func("mla_decode")(
        q.data_ptr(), pool.data_ptr(), bt.data_ptr(), ctx.data_ptr(),
        out.data_ptr(), lse.data_ptr() if lse is not None else None,
        part.data_ptr() if part is not None else None,
        count.data_ptr() if count is not None else None,
        B, H, W, R, page, MB, window or 0, softmax_scale, n, split_len,
        _lib.dtype_code(pool), _lib.stream_of(q))
    _lib.LAUNCHES["mla_decode"] += 1
    if return_lse:
        _lib.LSE_LAUNCHES["mla_decode"] += 1
    _lib.check(rc, "mla_decode")
    return (out, lse) if return_lse else out
