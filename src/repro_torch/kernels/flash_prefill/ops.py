"""Flash-prefill dispatch layer: the dense causal op of the training path
and the paged chunked-prefill op of serving.

``flash_prefill`` is full-sequence causal attention, optionally
windowed, as a ``torch.autograd.Function`` whose backward is a kernel
too. ``paged_flash_prefill`` is the serving chunked-prefill step: the
chunk's K/V rows are appended in place, then one paged flash sweep over
the block table covers in-chunk causal attention and attention over
prior pages alike. As in ``kernels/paged_attention/ops``, the tensors'
device picks the implementation: the CUDA kernels on the card, the plain
versions on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_prefill import kernel as K
from repro_torch.kernels.flash_prefill import ref as R
from repro_torch.kernels.paged_attention.ops import (on_cuda,
                                                     paged_append_chunk)


class _FlashPrefill(torch.autograd.Function):
    """Causal attention whose forward saves (out, lse) and whose backward
    recomputes the probabilities from them (FlashAttention-2)."""

    @staticmethod
    def forward(fctx, q, k, v, window):
        if on_cuda(q):
            out, lse = K.flash_prefill_kernel(q, k, v, window=window)
        else:
            out, lse = R.flash_prefill_fwd_ref(q, k, v, window=window)
        fctx.save_for_backward(q, k, v, out, lse)
        fctx.window = window
        return out

    @staticmethod
    def backward(fctx, dout):
        q, k, v, out, lse = fctx.saved_tensors
        bwd = K.flash_prefill_bwd_kernel if on_cuda(q) \
            else R.flash_prefill_bwd_ref
        dq, dk, dv = bwd(q, k, v, out, lse, dout, window=fctx.window)
        return dq, dk, dv, None


def flash_prefill(q, k, v, *, window: Optional[int] = None):
    """q [B,T,H,hd]; k/v [B,T,KV,hd] -> [B,T,H,hd] in q's dtype, causal
    (+ window), scaled by hd^-0.5; differentiable in q, k and v."""
    return _FlashPrefill.apply(q, k, v, window)


def paged_flash_prefill(q, k_new, v_new, k_pool, v_pool, slots, block_table,
                        prior_len, *, window: Optional[int] = None,
                        softmax_scale: Optional[float] = None):
    """Chunk append + paged flash-prefill attention.

    q [B,T,H,hd] (row i at absolute position prior_len[b] + i);
    k_new/v_new [B,T,KV,hd] the chunk's fresh K/V, written at ``slots``
    [B,T] (negative: parked) before attending; pools [nblk,page,KV,hd]
    (mode-viewed, written in place); block_table [B,MB] covers prior
    pages AND the chunk's own pages; prior_len [B]. Returns out
    [B,T,H,hd]."""
    paged_append_chunk((k_pool, v_pool), (k_new, v_new), slots)
    if on_cuda(q):
        return K.paged_flash_prefill_kernel(
            q, k_pool, v_pool, block_table, prior_len, window=window,
            softmax_scale=softmax_scale)
    return R.paged_flash_prefill_ref(q, k_pool, v_pool, block_table,
                                     prior_len, window=window,
                                     softmax_scale=softmax_scale)


def paged_prefill_sweep_with_lse(q, k_pool, v_pool, block_table, prior_len,
                                 *, prior_only: bool = False,
                                 window: Optional[int] = None,
                                 softmax_scale: Optional[float] = None):
    """Partial chunked-prefill attention over ONE block segment with its
    LSE. q [B,T,H,hd]; ``prior_len`` [B] = the segment's tokens each
    chunk row may attend (``prior_only``: all of them, no causal term;
    otherwise the causal current-segment sweep). Returns (out [B,T,H,hd]
    fp32, lse [B,H,T] fp32); rows with nothing to attend get lse
    ``NEG_INF``. No append."""
    if on_cuda(q):
        return K.paged_flash_prefill_kernel(
            q.float(), k_pool, v_pool, block_table, prior_len,
            window=window, softmax_scale=softmax_scale,
            prior_only=prior_only, return_lse=True)
    return R.paged_prefill_sweep_with_lse_ref(
        q, k_pool, v_pool, block_table, prior_len, prior_only=prior_only,
        window=window, softmax_scale=softmax_scale)
