"""Plain PyTorch versions of the paged decode kernels: what the wrappers
run for CPU tensors, and what the CUDA kernels are held against.

The appends write the pools IN PLACE (the kernels do too) and return
them; negative slots park on the reserved scratch row, the last row of
the last block."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.cache import (NEG_INF, paged_append,
                                      paged_attention_ref, paged_gather)


def paged_append_token_ref(pools, vals, slots):
    """pools: tuple of [nblk,page,*w] (a (k, v) pair, or the one
    compressed MLA pool); vals: matching tuple of [B,*w] new-token rows;
    slots [B]."""
    return tuple(paged_append(p, v[:, None], slots[:, None])
                 for p, v in zip(pools, vals))


def paged_append_chunk_ref(pools, vals, slots):
    """pools: tuple of [nblk,page,*w]; vals: tuple of [B,T,*w] chunk
    rows; slots [B,T]."""
    return tuple(paged_append(p, v, slots) for p, v in zip(pools, vals))


def paged_mla_attention_ref(q_cat, pool, block_table, context_len, *,
                            R: int, window: Optional[int] = None,
                            softmax_scale: float = 1.0,
                            return_lse: bool = False):
    """Absorbed MLA decode over the compressed paged cache: q_cat
    [B,H,W] = [q_nope W_uk ++ q_pe] (pre-scaled by the caller); pool
    [nblk,page,W] of [c_kv ++ k_pe] entries. Scores are q_cat . entry,
    the value read is the entry's first R lanes (the compressed context
    vector), so nothing of shape [B,Tk,H,.] exists. Returns [B,H,R]
    fp32; a row with no live key gets 0. ``return_lse`` also returns
    each head's log-sum-exp [B,H] fp32 (``NEG_INF`` with no live key)."""
    ctx = paged_gather(pool, block_table).float()          # [B,Tk,W]
    s = torch.einsum("bhw,btw->bht", q_cat.float(), ctx) * softmax_scale
    pos = torch.arange(ctx.shape[1], device=ctx.device)[None, None, :]
    cl = context_len.long()[:, None, None]
    mask = pos < cl
    if window is not None:
        mask &= pos >= cl - window
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    den = e.sum(dim=-1, keepdim=True)
    p = e / den.clamp_min(1e-30)
    out = torch.einsum("bht,btr->bhr", p, ctx[..., :R])
    if not return_lse:
        return out
    lse = torch.where(den > 0.0, m + torch.log(den.clamp_min(1e-30)),
                      NEG_INF)[..., 0]
    return out, lse


def paged_attention_with_lse_ref(q, k_pool, v_pool, block_table,
                                 context_len, **kw):
    """(out [B,H,hd] fp32, lse [B,H] fp32); rows with no live key get out
    0 and lse ``NEG_INF``."""
    return paged_attention_ref(q, k_pool, v_pool, block_table, context_len,
                               return_lse=True, **kw)


__all__ = ["paged_append_chunk_ref", "paged_append_token_ref",
           "paged_attention_ref", "paged_attention_with_lse_ref",
           "paged_mla_attention_ref"]
