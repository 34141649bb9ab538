"""Attention cache backends over the paged KV pool.

The model code is cache-agnostic: each layer calls ``backend.attend(...)``
with its per-layer state, the mode-viewed ``(k_pool, v_pool)`` pair
``[num_blocks, page, kvh_local, hd]`` (core/kv_adaptor.py). Physical pool
bytes are mode-invariant; only this view changes (paper §4.2).

Where the JAX package donated the state pytree so XLA could update the
pools in place, the port writes the pools in place: ``attend`` returns
the same tensors it was given, their storage (``data_ptr()``) unchanged.

- ``PrefillBackend`` — chunked prefill: the chunk's K/V rows are appended
  to the pool, then one paged sweep covers prior context and the causal
  chunk prefix (kernels/flash_prefill).
- ``DecodeBackend``  — single-token append + paged decode attention
  (kernels/paged_attention).
- ``TrainBackend``   — no cache: full-sequence causal attention,
  optionally windowed, differentiable (kernels/flash_prefill).

Which implementation runs is decided by where the tensors lie: the CUDA
kernels for tensors on the card, their plain PyTorch versions for
tensors on the CPU. The plain attention math the plain versions share
lives here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)


# ---------------------------------------------------------------------------
# plain attention math
# ---------------------------------------------------------------------------

def attention_with_lse(q, k, v, mask, softmax_scale):
    """Returns (out [B,Tq,H,hd] fp32, lse [B,H,Tq] fp32); q [B,Tq,H,hd],
    k/v [B,Tk,KV,hd], mask [B,1|H,Tq,Tk] (or broadcastable).

    GQA is computed grouped (q as [KV, rep] against unrepeated K/V).
    Masked keys get probability exactly 0, so a row with no live key
    gets a zero output and lse ``NEG_INF``."""
    B, Tq, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.float().reshape(B, Tq, KV, rep, hd)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, k.float()) * softmax_scale
    s = s.reshape(B, H, Tq, s.shape[-1])
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(s - m), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    p = (e / denom.clamp_min(1e-30)).reshape(B, KV, rep, Tq, -1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    out = out.reshape(B, Tq, H, hd)
    lse = torch.where(denom > 0.0, m + torch.log(denom.clamp_min(1e-30)),
                      NEG_INF)[..., 0]
    return out, lse


def causal_mask(T: int, *, window: Optional[int] = None, device=None):
    """[T, T] bool: key j is live for query i when j <= i and, with a
    window, j > i - window."""
    qpos = torch.arange(T, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    return mask


def causal_attention(q, k, v, *, window: Optional[int] = None):
    """q [B,T,H,hd], k/v [B,T,KV,hd]; causal with an optional sliding
    window, scaled by hd^-0.5 -> [B,T,H,hd] in q's dtype (the JAX
    package's ``causal_attention`` at its defaults, q_offset 0)."""
    T, hd = q.shape[1], q.shape[-1]
    mask = causal_mask(T, window=window, device=q.device)
    out, _ = attention_with_lse(q, k, v, mask[None, None], hd ** -0.5)
    return out.to(q.dtype)


def merge_attention(outs_lses):
    """Combine partial attentions over disjoint key sets via their LSEs.
    outs: [B,Tq,H,hd] fp32; lses: [B,H,Tq]."""
    ms = torch.stack([l for _, l in outs_lses])          # [P,B,H,Tq]
    m = ms.amax(dim=0)
    ws = torch.exp(ms - m[None])                          # [P,B,H,Tq]
    num = sum(o * w.transpose(1, 2)[..., None]
              for (o, _), w in zip(outs_lses, ws))
    den = ws.sum(dim=0).transpose(1, 2)[..., None]
    return num / den.clamp_min(1e-30)


# ---------------------------------------------------------------------------
# paged pool primitives (plain PyTorch; serving goes through the kernels)
# ---------------------------------------------------------------------------

def paged_append(pool: torch.Tensor, vals: torch.Tensor,
                 slots: torch.Tensor) -> torch.Tensor:
    """Write rows into ``pool`` [nblk, page, *w] IN PLACE. vals
    [B,T,*w]; slots [B,T] flat token slots (= block_id*page + offset).
    Negative slots park on the reserved scratch row: the last row of the
    last block, which the adaptor never allocates. Returns ``pool``."""
    nblk, page = pool.shape[0], pool.shape[1]
    flat = pool.view(nblk * page, *pool.shape[2:])
    s = slots.reshape(-1).long()
    safe = torch.where(s >= 0, s, nblk * page - 1)
    flat[safe] = vals.reshape(-1, *vals.shape[2:]).to(pool.dtype)
    return pool


def paged_gather(pool: torch.Tensor, block_table: torch.Tensor):
    """pool [nblk, page, ...]; block_table [B, max_blocks] -> [B,
    max_blocks*page, ...] (unmasked; caller masks by context length)."""
    g = pool[block_table.clamp_min(0).long()]      # [B, mb, page, ...]
    B, mb, page = g.shape[0], g.shape[1], g.shape[2]
    return g.reshape(B, mb * page, *g.shape[3:])


def paged_attention_ref(q, k_pool, v_pool, block_table, context_len, *,
                        window: Optional[int] = None,
                        softmax_scale: Optional[float] = None,
                        return_lse: bool = False):
    """Decode attention: q [B,H,hd]; pools [nblk,page,KV,hd];
    block_table [B,mb]; context_len [B] (includes the current token).
    Returns [B,H,hd] in q's dtype or, with ``return_lse``, (out [B,H,hd]
    fp32, lse [B,H] fp32)."""
    hd = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    k = paged_gather(k_pool, block_table)          # [B, Tk, KV, hd]
    v = paged_gather(v_pool, block_table)
    kpos = torch.arange(k.shape[1], device=q.device)[None, :]
    ctx = context_len.long()[:, None]
    mask = kpos < ctx
    if window is not None:
        mask &= kpos >= ctx - window
    out, lse = attention_with_lse(q[:, None], k, v, mask[:, None, None, :],
                                  scale)
    if return_lse:
        return out[:, 0], lse[..., 0]
    return out[:, 0].to(q.dtype)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainBackend:
    """Full-sequence causal attention, no cache (training / eval); the
    gradient flows through the flash-prefill op's backward."""
    window: Optional[int] = None

    def attend(self, state, q, k, v, *, positions, window=None):
        from repro_torch.kernels.flash_prefill import ops as fp_ops
        w = window if window is not None else self.window
        return fp_ops.flash_prefill(q, k, v, window=w), state


@dataclass(frozen=True)
class PrefillBackend:
    """Chunked prefill straight over the paged pool: the chunk's K/V rows
    are written at ``slots`` [B,T], then query row i of request b (at
    absolute position ``prior_len[b] + i``) attends every pool position
    ``kpos <= qpos`` through ``block_table`` [B,mb], which covers prior
    pages and the chunk's own."""
    slots: torch.Tensor
    prior_len: torch.Tensor
    block_table: torch.Tensor

    def attend(self, state, q, k, v, *, positions, window=None):
        from repro_torch.kernels.flash_prefill import ops as fp_ops
        k_pool, v_pool = state
        out = fp_ops.paged_flash_prefill(
            q, k, v, k_pool, v_pool, self.slots, self.block_table,
            self.prior_len, window=window)
        return out, (k_pool, v_pool)


@dataclass(frozen=True)
class DecodeBackend:
    """Single-token decode over the paged pool: the new token's K/V row
    is written at ``slots`` [B], then paged attention reads
    ``context_len`` [B] tokens (incl. the new one) through
    ``block_table`` [B,mb] (mb-bucketed width)."""
    slots: torch.Tensor
    block_table: torch.Tensor
    context_len: torch.Tensor

    def attend(self, state, q, k, v, *, positions, window=None):
        from repro_torch.kernels.paged_attention import ops as pa_ops
        k_pool, v_pool = state
        out, k_pool, v_pool = pa_ops.paged_attention_decode(
            q[:, 0], k[:, 0], v[:, 0], k_pool, v_pool, self.slots,
            self.block_table, self.context_len, window=window)
        return out[:, None], (k_pool, v_pool)
