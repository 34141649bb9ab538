"""CUDA wrappers of the flash-prefill kernels: the paged chunked-prefill
sweep (csrc/paged_prefill.cu) and the dense causal attention of the
training path, forward and backward (csrc/flash_prefill.cu: bf16 on the
tensor cores, fp32 on the CUDA cores). Each validates, allocates outputs
and scratch, launches on the current stream, counts the launch and
raises on a launch error. CUDA tensors only; ``ops`` routes CPU tensors
to the plain versions."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _lib


def paged_flash_prefill_kernel(q, k_pool, v_pool, block_table, prior_len, *,
                               window: Optional[int] = None,
                               softmax_scale: Optional[float] = None,
                               prior_only: bool = False,
                               return_lse: bool = False):
    """q [B,T,H,hd] (row i at absolute position prior_len[b] + i; any T,
    the ragged last tile is masked in the kernel); pools
    [nblk,page,KV,hd] already holding the chunk's rows; block_table
    [B,MB]; prior_len [B] -> out [B,T,H,hd] in q's dtype (+ lse [B,H,T]
    fp32). Any H/KV; hd 64, 128 or 256. bf16 q over bf16 pools runs on the
    tensor cores, every other dtype pair on the CUDA cores in fp32."""
    q = _lib.aligned(q.contiguous())
    k_pool, v_pool = _lib.aligned(k_pool), _lib.aligned(v_pool)
    bt = block_table.to(torch.int32).contiguous()
    prior = prior_len.to(torch.int32).contiguous()
    _lib.require_cuda(q, k_pool, v_pool, bt, prior)
    B, T, H, hd = q.shape
    nblk, page, KV, hd_k = k_pool.shape
    if hd_k != hd or v_pool.shape != k_pool.shape or H % KV:
        raise ValueError(f"paged_flash_prefill: q {tuple(q.shape)} vs "
                         f"pools {tuple(k_pool.shape)}")
    if hd not in (64, 128, 256):
        raise ValueError(f"paged_flash_prefill kernel takes hd 64, 128 or "
                         f"256, not {hd}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) \
        if return_lse else None
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    rc = _lib.func("paged_flash_prefill")(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
        prior.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, T, H, KV, hd, page, bt.shape[1], window or 0, scale,
        int(prior_only), _lib.dtype_code(q), _lib.dtype_code(k_pool),
        _lib.stream_of(q))
    _lib.LAUNCHES["paged_flash_prefill"] += 1
    if return_lse:
        _lib.LSE_LAUNCHES["paged_flash_prefill"] += 1
    _lib.check(rc, "paged_flash_prefill")
    return (out, lse) if return_lse else out


def prefill_blocks(B: int, T: int, H: int, KV: int) -> int:
    """Blocks of the paged prefill kernel: one per 64 rows of each
    (request, kv head)'s T * H/KV packed query rows."""
    return B * KV * -(-T * (H // KV) // 64)


def _dense_args(q, k, v):
    """Validate the dense kernels' q [B,T,H,hd], k/v [B,T,KV,hd]."""
    _lib.require_cuda(q, k, v)
    B, T, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != (B, T, KV, hd) or v.shape != k.shape or H % KV:
        raise ValueError(f"flash_prefill: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_prefill: q, k, v of one dtype, not "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in (64, 128, 256):
        raise ValueError(f"flash_prefill kernels take hd 64, 128 or 256, "
                         f"not {hd}")
    rows = 32 if hd == 256 else 64          # query rows of an fp32 block
    if q.dtype == torch.float32 and H // KV > rows:
        raise ValueError(f"flash_prefill's fp32 kernels hold the {H // KV} "
                         f"query heads of a kv head in one block of {rows} "
                         f"rows at hd {hd}: at most {rows}")
    return B, T, H, KV, hd


def dkdv_groups(B: int, T: int, KV: int, rep: int, device) -> int:
    """Head groups of the bf16 dK/dV kernel: the rep query heads of a kv
    head are halved into groups until its blocks (one per batch row, kv
    head, 64-key tile and group) fill the card's SMs four times over or
    each group holds one head. Each group adds an fp32 partial sum."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = B * KV * -(-T // 64)
    g = 1
    while blocks * g < 4 * sms and rep % (2 * g) == 0:
        g *= 2
    return g


def flash_prefill_kernel(q, k, v, *, window: Optional[int] = None):
    """Dense causal attention: q [B,T,H,hd], k/v [B,T,KV,hd] (heads not
    repeated; any T) -> (out [B,T,H,hd] in q's dtype, lse [B,H,T]
    fp32)."""
    q, k, v = (_lib.aligned(x.contiguous()) for x in (q, k, v))
    B, T, H, KV, hd = _dense_args(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    rc = _lib.func("flash_prefill_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, T, H, KV, hd, window or 0, hd ** -0.5,
        _lib.dtype_code(q), _lib.stream_of(q))
    _lib.LAUNCHES["flash_prefill"] += 1
    _lib.check(rc, "flash_prefill")
    return out, lse


def flash_prefill_bwd_kernel(q, k, v, out, lse, dout, *,
                             window: Optional[int] = None):
    """Backward of ``flash_prefill_kernel``: the forward's inputs, its
    (out, lse) and dout [B,T,H,hd] -> (dq, dk, dv) in the inputs'
    dtype."""
    q, k, v, out, dout = (_lib.aligned(x.contiguous())
                          for x in (q, k, v, out, dout))
    lse = lse.contiguous()
    B, T, H, KV, hd = _dense_args(q, k, v)
    _lib.require_cuda(q, out, lse, dout)
    if any(t.shape != q.shape or t.dtype != q.dtype for t in (out, dout)) \
            or lse.shape != (B, H, T) or lse.dtype != torch.float32:
        raise ValueError("flash_prefill_bwd: out and dout must match q, "
                         "lse be [B,H,T] fp32")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    delta = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    groups = dkdv_groups(B, T, KV, H // KV, q.device) \
        if q.dtype == torch.bfloat16 else 1
    part = torch.empty((2, groups, B, T, KV, hd), dtype=torch.float32,
                       device=q.device) if groups > 1 else None
    rc = _lib.func("flash_prefill_bwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(),
        part.data_ptr() if part is not None else None, B, T, H, KV, hd,
        window or 0, groups, hd ** -0.5, _lib.dtype_code(q),
        _lib.stream_of(q))
    _lib.LAUNCHES["flash_prefill_bwd"] += 1
    _lib.check(rc, "flash_prefill_bwd")
    return dq, dk, dv


def flash_tile_check(a, b, mode: int):
    """The bf16 kernels' tile machinery (csrc/hopper.cuh) alone, one
    warpgroup on one tile pair: mode 0, a and b [64,hd] bf16 -> a b^T
    [64,64] fp32 (both operands K-major in shared memory, as S = Q K^T);
    mode 1, a [64,64] fp32 and b [64,hd] bf16 -> a b [64,hd] fp32 (a as
    hi + lo register fragments, b N-major, as P V). For tests and
    chip_smoke.py: no path calls it."""
    a, b = _lib.aligned(a.contiguous()), _lib.aligned(b.contiguous())
    _lib.require_cuda(a, b)
    hd = b.shape[-1]
    want_a = (torch.bfloat16, (64, hd)) if mode == 0 \
        else (torch.float32, (64, 64))
    if mode not in (0, 1) or b.dtype != torch.bfloat16 or \
            b.shape != (64, hd) or hd not in (64, 128, 256) or \
            (a.dtype, tuple(a.shape)) != want_a:
        raise ValueError(f"flash_tile_check mode {mode}: a {a.dtype} "
                         f"{tuple(a.shape)}, b {b.dtype} {tuple(b.shape)}")
    c = torch.empty((64, 64 if mode == 0 else hd), dtype=torch.float32,
                    device=a.device)
    rc = _lib.func("flash_tile_check")(
        a.data_ptr(), b.data_ptr(), c.data_ptr(), hd, mode,
        _lib.stream_of(a))
    _lib.check(rc, "flash_tile_check")
    return c
