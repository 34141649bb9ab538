"""Dispatch layer for paged decode attention (serving hot path).

The implementation follows the tensors: CUDA tensors launch the CUDA
kernels (``kernel.py``), CPU tensors run the plain PyTorch versions
(``ref.py``), any other device raises. There is no fallback from one to
the other and no switch to choose: a kernel that cannot launch on the
card raises.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ref as R


def on_cuda(t) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no paged-attention implementation for {t.device}")


def paged_append_token(pools, vals, slots):
    """Single-token append into pools (k, v) [nblk,page,*w], in place."""
    if on_cuda(pools[0]):
        return K.paged_append_token_kernel(pools, vals, slots)
    return R.paged_append_token_ref(pools, vals, slots)


def paged_append_chunk(pools, vals, slots):
    """Chunk append (vals [B,T,*w], slots [B,T]) into pools, in place."""
    if on_cuda(pools[0]):
        return K.paged_append_chunk_kernel(pools, vals, slots)
    return R.paged_append_chunk_ref(pools, vals, slots)


def paged_attention(q, k_pool, v_pool, block_table, context_len, *,
                    window: Optional[int] = None,
                    softmax_scale: Optional[float] = None):
    """q [B,H,hd]; pools [nblk,page,KV,hd] (mode-viewed); block_table
    [B,MB]; context_len [B] -> [B,H,hd]."""
    if on_cuda(q):
        return K.paged_attention_kernel(
            q, k_pool, v_pool, block_table, context_len, window=window,
            softmax_scale=softmax_scale)
    return R.paged_attention_ref(q, k_pool, v_pool, block_table,
                                 context_len, window=window,
                                 softmax_scale=softmax_scale)


def paged_attention_with_lse(q, k_pool, v_pool, block_table, context_len, *,
                             window: Optional[int] = None,
                             softmax_scale: Optional[float] = None):
    """Partial paged decode attention over ONE block segment: (out
    [B,H,hd] fp32, lse [B,H] fp32), for LSE-merging with partials over
    other segments. Rows with ``context_len == 0`` contribute nothing
    (lse ``NEG_INF``, out 0)."""
    if on_cuda(q):
        out, lse = K.paged_attention_kernel(
            q.float(), k_pool, v_pool, block_table, context_len,
            window=window, softmax_scale=softmax_scale, return_lse=True)
        return out, lse
    return R.paged_attention_with_lse_ref(
        q, k_pool, v_pool, block_table, context_len, window=window,
        softmax_scale=softmax_scale)


def paged_attention_decode(q, k_new, v_new, k_pool, v_pool, slots,
                           block_table, context_len, *,
                           window: Optional[int] = None,
                           softmax_scale: Optional[float] = None):
    """Single-token KV append + paged decode attention.

    q [B,H,hd]; k_new/v_new [B,KV,hd] (the step's new token, written at
    ``slots`` [B] before attending); pools [nblk,page,KV,hd], written in
    place. Returns (out [B,H,hd], k_pool, v_pool)."""
    paged_append_token((k_pool, v_pool), (k_new, v_new), slots)
    out = paged_attention(q, k_pool, v_pool, block_table, context_len,
                          window=window, softmax_scale=softmax_scale)
    return out, k_pool, v_pool
