"""Plain PyTorch versions of the paged decode kernels: what the wrappers
run for CPU tensors, and what the CUDA kernels are held against.

The appends write the pools IN PLACE (the kernels do too) and return
them; negative slots park on the reserved scratch row, the last row of
the last block."""
from __future__ import annotations

from repro_torch.models.cache import paged_append, paged_attention_ref


def paged_append_token_ref(pools, vals, slots):
    """pools: tuple of [nblk,page,*w]; vals: matching tuple of [B,*w]
    new-token rows; slots [B]."""
    return tuple(paged_append(p, v[:, None], slots[:, None])
                 for p, v in zip(pools, vals))


def paged_append_chunk_ref(pools, vals, slots):
    """pools: tuple of [nblk,page,*w]; vals: tuple of [B,T,*w] chunk
    rows; slots [B,T]."""
    return tuple(paged_append(p, v, slots) for p, v in zip(pools, vals))


def paged_attention_with_lse_ref(q, k_pool, v_pool, block_table,
                                 context_len, **kw):
    """(out [B,H,hd] fp32, lse [B,H] fp32); rows with no live key get out
    0 and lse ``NEG_INF``."""
    return paged_attention_ref(q, k_pool, v_pool, block_table, context_len,
                               return_lse=True, **kw)


__all__ = ["paged_append_chunk_ref", "paged_append_token_ref",
           "paged_attention_ref", "paged_attention_with_lse_ref"]
