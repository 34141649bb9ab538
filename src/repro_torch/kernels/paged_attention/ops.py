"""Dispatch layer for paged decode attention (serving hot path).

The implementation follows the tensors: CUDA tensors launch the CUDA
kernels (``kernel.py``), CPU tensors run the plain PyTorch versions
(``ref.py``), meta tensors (the dry run) take the meta route, any other
device raises. There is no fallback from one to the other and no switch
to choose: a kernel that cannot launch on the card raises.

The meta route returns outputs of the plain version's shapes and dtypes
on the meta device, writes nothing, and records the call's bytes and
operations with ``kernels/cost.py``. Meta tensors carry no lengths, so
it counts every block of the table as live (within a window, the
window's keys), as the JAX package's refs attend over the whole gathered
table.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import cost
from repro_torch.kernels.paged_attention import kernel as K
from repro_torch.kernels.paged_attention import ref as REF


def route(t) -> str:
    """``"cuda"``, ``"cpu"`` or ``"meta"`` by ``t``'s device; raise for
    any other."""
    if t.device.type in ("cuda", "cpu", "meta"):
        return t.device.type
    raise ValueError(f"no kernel implementation for {t.device}")


def meta_keys(B: int, block_table, page: int,
              window: Optional[int] = None):
    """(keys, pages) the meta route counts: every block of each row's
    table live, each row cut to ``window`` keys."""
    per = block_table.shape[1] * page
    if window is not None:
        per = min(per, window)
    return B * per, B * math.ceil(per / page)


def _append_meta(name, pools, vals, slots, lead: int):
    width = math.prod(vals[0].shape[lead:])
    cost.record(name, cost.append(
        slots.numel(), width, len(pools), vals[0].element_size(),
        pools[0].element_size()), *pools, *vals, slots)
    return tuple(pools)


def paged_append_token(pools, vals, slots):
    """Single-token append into pools (k, v) or (pool,) [nblk,page,*w],
    in place."""
    r = route(pools[0])
    if r == "cuda":
        return K.paged_append_token_kernel(pools, vals, slots)
    if r == "meta":
        return _append_meta("paged_append_token", pools, vals, slots, 1)
    return REF.paged_append_token_ref(pools, vals, slots)


def paged_append_chunk(pools, vals, slots):
    """Chunk append (vals [B,T,*w], slots [B,T]) into pools, in place."""
    r = route(pools[0])
    if r == "cuda":
        return K.paged_append_chunk_kernel(pools, vals, slots)
    if r == "meta":
        return _append_meta("paged_append_chunk", pools, vals, slots, 2)
    return REF.paged_append_chunk_ref(pools, vals, slots)


def _decode_meta(q, k_pool, v_pool, block_table, context_len, window,
                 lse: bool):
    B, H, hd = q.shape
    _, page, KV, _ = k_pool.shape
    keys, pages = meta_keys(B, block_table, page, window)
    out_dtype = torch.float32 if lse else q.dtype
    cost.record("paged_attention", cost.paged_decode(
        B, H, KV, hd, keys, pages, 4 if lse else q.element_size(),
        4 if lse else q.element_size(), k_pool.element_size(), lse=lse),
        q, k_pool, v_pool, block_table, context_len)
    out = torch.empty((B, H, hd), dtype=out_dtype, device="meta")
    if lse:
        return out, torch.empty((B, H), dtype=torch.float32, device="meta")
    return out


def paged_attention(q, k_pool, v_pool, block_table, context_len, *,
                    window: Optional[int] = None,
                    softmax_scale: Optional[float] = None):
    """q [B,H,hd]; pools [nblk,page,KV,hd] (mode-viewed); block_table
    [B,MB]; context_len [B] -> [B,H,hd]."""
    r = route(q)
    if r == "cuda":
        return K.paged_attention_kernel(
            q, k_pool, v_pool, block_table, context_len, window=window,
            softmax_scale=softmax_scale)
    if r == "meta":
        return _decode_meta(q, k_pool, v_pool, block_table, context_len,
                            window, False)
    return REF.paged_attention_ref(q, k_pool, v_pool, block_table,
                                 context_len, window=window,
                                 softmax_scale=softmax_scale)


def paged_attention_with_lse(q, k_pool, v_pool, block_table, context_len, *,
                             window: Optional[int] = None,
                             softmax_scale: Optional[float] = None):
    """Partial paged decode attention over ONE block segment: (out
    [B,H,hd] fp32, lse [B,H] fp32), for LSE-merging with partials over
    other segments. Rows with ``context_len == 0`` contribute nothing
    (lse ``NEG_INF``, out 0)."""
    r = route(q)
    if r == "cuda":
        out, lse = K.paged_attention_kernel(
            q.float(), k_pool, v_pool, block_table, context_len,
            window=window, softmax_scale=softmax_scale, return_lse=True)
        return out, lse
    if r == "meta":
        return _decode_meta(q, k_pool, v_pool, block_table, context_len,
                            window, True)
    return REF.paged_attention_with_lse_ref(
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


def paged_mla_attention_decode(q_cat, entry_new, pool, slots, block_table,
                               context_len, *, R: int,
                               window: Optional[int] = None,
                               softmax_scale: float = 1.0):
    """Absorbed MLA decode over the compressed paged cache.

    q_cat [B,H,W] = [q_nope W_uk ++ q_pe] (pre-scaled by the caller, so
    ``softmax_scale`` defaults to 1); entry_new [B,W] the new token's
    [c_kv ++ k_pe], written at ``slots`` [B] before attending; pool
    [nblk,page,W], written in place. Returns (out_c [B,H,R] fp32, pool):
    the softmax over q_cat . entry read over each entry's first R lanes,
    for the caller to up-project with W_uv. On the card: the one-pool
    append, then the MLA decode kernel."""
    paged_append_token((pool,), (entry_new,), slots)
    r = route(q_cat)
    if r == "cuda":
        out = K.paged_mla_attention_kernel(
            q_cat.float(), pool, block_table, context_len, R=R,
            window=window, softmax_scale=softmax_scale)
    elif r == "meta":
        out = _mla_meta(q_cat, pool, block_table, context_len, R, window,
                        False)
    else:
        out = REF.paged_mla_attention_ref(
            q_cat, pool, block_table, context_len, R=R, window=window,
            softmax_scale=softmax_scale)
    return out, pool


def paged_mla_attention_with_lse(q_cat, pool, block_table, context_len, *,
                                 R: int, softmax_scale: float = 1.0):
    """Partial absorbed MLA decode over ONE set of the compressed pool's
    pages (no append): (out_c [B,H,R] fp32, lse [B,H] fp32), for
    LSE-merging with partials over other pages (the striped pools'
    stripes). Rows with ``context_len == 0`` contribute nothing (lse
    ``NEG_INF``, out 0)."""
    r = route(q_cat)
    if r == "cuda":
        return K.paged_mla_attention_kernel(
            q_cat.float(), pool, block_table, context_len, R=R,
            softmax_scale=softmax_scale, return_lse=True)
    if r == "meta":
        return _mla_meta(q_cat, pool, block_table, context_len, R, None,
                         True)
    return REF.paged_mla_attention_ref(
        q_cat, pool, block_table, context_len, R=R,
        softmax_scale=softmax_scale, return_lse=True)


def _mla_meta(q_cat, pool, block_table, context_len, R: int, window,
              lse: bool):
    B, H, W = q_cat.shape
    keys, pages = meta_keys(B, block_table, pool.shape[1], window)
    cost.record("mla_decode", cost.mla_decode(B, H, W, R, keys, pages, 4,
                                              pool.element_size(), lse=lse),
                q_cat, pool, block_table, context_len)
    out = torch.empty((B, H, R), dtype=torch.float32, device="meta")
    if lse:
        return out, torch.empty((B, H), dtype=torch.float32, device="meta")
    return out
