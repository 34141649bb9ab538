"""CUDA wrapper of the paged flash-prefill kernel (csrc/paged_prefill.cu):
validate, allocate outputs, launch on the current stream, count the
launch, raise on a launch error. CUDA tensors only; ``ops`` routes CPU
tensors to the plain version."""
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
    fp32)."""
    q = q.contiguous()
    bt = block_table.to(torch.int32).contiguous()
    prior = prior_len.to(torch.int32).contiguous()
    _lib.require_cuda(q, k_pool, v_pool, bt, prior)
    B, T, H, hd = q.shape
    nblk, page, KV, hd_k = k_pool.shape
    if hd_k != hd or v_pool.shape != k_pool.shape or H % KV:
        raise ValueError(f"paged_flash_prefill: q {tuple(q.shape)} vs "
                         f"pools {tuple(k_pool.shape)}")
    if hd not in (64, 128) or 64 % (H // KV):
        raise ValueError(f"paged_flash_prefill kernel takes hd 64 or 128 "
                         f"and H/KV dividing 64, not hd={hd}, "
                         f"H/KV={H // KV}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) \
        if return_lse else None
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    rc = _lib.lib("paged_prefill").paged_flash_prefill(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), bt.data_ptr(),
        prior.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, T, H, KV, hd, page, bt.shape[1], window or 0, scale,
        int(prior_only), _lib.dtype_code(q), _lib.dtype_code(k_pool),
        _lib.stream_of(q))
    _lib.LAUNCHES["paged_flash_prefill"] += 1
    _lib.check(rc, "paged_flash_prefill")
    return (out, lse) if return_lse else out
