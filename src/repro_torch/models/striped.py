"""Context-parallel (striped) KV pools.

In the head layout a pool holds this rank's KV-head slice of every
token, so capacity grows with the merge only while KV heads split
further; MLA's compressed cache never splits (``PoolGeometry.head_split``
is 1) and is replicated over the TP group. The striped layout holds ALL
KV heads of every F-th token instead: token t of a request lives on the
rank of stripe ``t % F`` of its TP group (F = the TP degree,
``PoolGeometry.stripe_factor``), at stripe-local index ``t // F``. A
logical block of ``block_base * F`` tokens is ``block_base`` rows on each
rank, so capacity grows with the full TP degree for any architecture.

Decode is context parallel:

  1. gather the new token's K/V to full heads; the rank of its stripe
     writes it (K1 on the card),
  2. all-gather the queries to full heads, at the pool's dtype,
  3. each rank attends over its stripe: (acc, l, m) partials,
  4. one LSE merge over the TP group (a max and two sums), then the
     rank's own query heads are cut back out for the row-parallel
     output projection.

MLA runs absorbed: scores of ``q W_uk`` against the compressed entries,
the read is the compressed context vector, so only [B, H, R] crosses the
wire. Prefill is fresh only: every token of the chunk is a live
activation, so attention is in-chunk causal (K5 forward on the card) and
each rank writes its stripe of the chunk (K3).

Which implementation runs follows the tensors, as everywhere in the
port: the CUDA kernels for tensors on the card, the plain versions for
tensors on the CPU. On the card a stripe partial is K2 (or
``mla_decode``) with its LSE over the stripe's rows, an already
normalised partial, merged as ``(out, 1, lse)``; on the CPU it is
``_partial_attention``'s unnormalised (acc, l, m).

Two guards where the JAX package's arithmetic would write garbage:
a position whose stripe-local block lies past the block table parks
(its gather reads a fill value there), and a backend given the engine's
staged ``slots`` parks every position whose staged slot is negative
(the batch's padding rows, which would otherwise write block 0).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.core.views import TPContext
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.cache import NEG_INF, paged_gather

# ---------------------------------------------------------------------------
# shared striped primitives
# ---------------------------------------------------------------------------


def stripe_write_slot(positions: torch.Tensor, stripe: int, F: int,
                      block_table: torch.Tensor, page: int) -> torch.Tensor:
    """positions [B,T] absolute -> flat local slots [B,T] int32 (-1 where
    the token belongs to another stripe, or its stripe-local block lies
    past the table). block_table [B,MB] covers local blocks of ``page``
    stripe-local tokens each."""
    pos = positions.long()
    local = pos // F
    page_idx = local // page
    inside = page_idx < block_table.shape[1]
    blk = torch.gather(block_table.long(), 1,
                       page_idx.clamp_max(block_table.shape[1] - 1))
    slot = blk * page + local % page
    mine = ((pos % F) == stripe) & inside
    return torch.where(mine, slot, -1).to(torch.int32)


def stripe_counts(context_len: torch.Tensor, stripe: int, F: int
                  ) -> torch.Tensor:
    """Number of stripe-local tokens among [0, context_len)."""
    return (context_len + F - 1 - stripe) // F


def _partial_attention(q, k, v, valid, scale: float):
    """q [B,H,hd]; k/v [B,Tl,KV,hd]; valid [B,Tl] -> (acc [B,H,hd] fp32
    unnormalised, l [B,H], m [B,H]). Grouped GQA; q is rounded to the
    storage dtype and p to the value dtype before their products, which
    accumulate in fp32."""
    B, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    qg = q.reshape(B, KV, rep, hd).to(k.dtype).float()
    s = torch.einsum("bgrd,btgd->bgrt", qg, k.float()) * scale
    s = s.reshape(B, H, -1)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[:, None, :], p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bgrt,btgd->bgrd",
                       p.reshape(B, KV, rep, -1).to(v.dtype).float(),
                       v.float())
    return acc.reshape(B, H, hd), l, m


def _stripe_valid(context_len, stripe: int, F: int, Tl: int,
                  window: Optional[int]):
    """[B,Tl] bool: the stripe-local rows a decode query reads."""
    idx = torch.arange(Tl, device=context_len.device)[None, :]
    ctx = context_len.long()[:, None]
    valid = idx < stripe_counts(ctx, stripe, F)
    if window is not None:
        # the absolute position of local index j is j*F + stripe
        valid &= idx * F + stripe >= ctx - window
    return valid


def stripe_partial(q, k_pool, v_pool, block_table, context_len, stripe: int,
                   F: int, *, window: Optional[int] = None):
    """This rank's stripe partial of GQA decode: q [B,H,hd] at the pool's
    dtype; pools [nblk,page,KV,hd] -> (acc [B,H,hd], l [B,H], m [B,H])
    for ``TPContext.lse_merge``. On the card: K2 with its LSE over the
    stripe's rows (``stripe_counts`` of them), a normalised partial
    (acc = out, l = 1, m = lse); a window there raises (K2 takes one
    scalar window, the stripe needs a bound on each row's local index).
    On the CPU: ``_partial_attention``. On meta (the dry run): K2's meta
    route, a window counted as its ``ceil(window / F)`` stripe-local
    keys."""
    hd = q.shape[-1]
    r = pa_ops.route(q)
    if r != "cpu":
        if window is not None and r == "cuda":
            raise NotImplementedError(
                "a sliding window over the striped pool needs a per-row "
                "stripe-local bound that K2 does not take")
        out, lse = pa_ops.paged_attention_with_lse(
            q, k_pool, v_pool, block_table,
            stripe_counts(context_len, stripe, F).to(torch.int32),
            window=-(-window // F) if window is not None else None,
            softmax_scale=hd ** -0.5)
        return out, torch.ones_like(lse), lse
    kg = paged_gather(k_pool, block_table)               # [B, Tl, KV, hd]
    vg = paged_gather(v_pool, block_table)
    valid = _stripe_valid(context_len, stripe, F, kg.shape[1], window)
    return _partial_attention(q, kg, vg, valid, hd ** -0.5)


def stripe_partial_mla(qa, qp, pool, block_table, context_len, stripe: int,
                       F: int, *, R: int):
    """This rank's stripe partial of absorbed MLA decode: qa [B,H,R] and
    qp [B,H,Rr] at the pool's dtype (pre-scaled); pool [nblk,page,R+Rr]
    -> (acc [B,H,R], l [B,H], m [B,H]). On the card: ``mla_decode`` with
    its LSE (a normalised partial); on the CPU the plain products, the
    scores accumulated in fp32 from q at the pool's dtype; on meta the
    card's route (its meta route)."""
    if pa_ops.route(qa) != "cpu":
        out, lse = pa_ops.paged_mla_attention_with_lse(
            torch.cat([qa, qp], dim=-1), pool, block_table,
            stripe_counts(context_len, stripe, F).to(torch.int32), R=R)
        return out, torch.ones_like(lse), lse
    ctx_tok = paged_gather(pool, block_table)             # [B, Tl, R+Rr]
    c, pe = ctx_tok[..., :R].float(), ctx_tok[..., R:].float()
    valid = _stripe_valid(context_len, stripe, F, ctx_tok.shape[1], None)
    s = torch.einsum("bhr,btr->bht", qa.float(), c) \
        + torch.einsum("bhr,btr->bht", qp.float(), pe)
    s = torch.where(valid[:, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    p = torch.where(valid[:, None, :], p, 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bht,btr->bhr", p.to(pool.dtype).float(), c)
    return acc, l, m


def _wire(pool: torch.Tensor) -> Optional[torch.dtype]:
    """The merge's summand dtype: bf16 for bf16 pools, else fp32."""
    return pool.dtype if pool.dtype == torch.bfloat16 else None


def _park_padding(slot: torch.Tensor, staged: Optional[torch.Tensor]):
    """Park the positions the engine staged no slot for (padding)."""
    if staged is None:
        return slot
    return torch.where(staged.reshape(slot.shape) >= 0, slot, -1)


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class StripedDecodeBackend:
    """Decode over the striped pool. State a layer: (k_pool, v_pool)
    viewed [nblk, page, KV_full, hd] (GQA) or (pool,) [nblk, page, W]
    (MLA, through ``attend_mla``). ``slots`` [B], when given, are the
    engine's staged slots: only their sign is read (negative: a padding
    row, whose write parks)."""
    ctx: TPContext
    block_table: torch.Tensor   # [B, MB] logical blocks of page * F tokens
    context_len: torch.Tensor   # [B] incl. the current token
    n_q_heads: int = 0          # logical head counts (set by the step)
    n_kv_heads: int = 0
    window: Optional[int] = None
    slots: Optional[torch.Tensor] = None

    def _stripe(self):
        return self.ctx.stripe_index(), self.ctx.tp

    def attend(self, state, q, k, v, *, positions, window=None):
        """q [B,1,Hl,hd]; k/v [B,1,KVl,hd] (local heads, new token)."""
        tctx = self.ctx
        w = window if window is not None else self.window
        k_pool, v_pool = state
        page = k_pool.shape[1]
        stripe, F = self._stripe()

        # 1. the new token's kv at full heads; my stripe's rank writes it
        kf, vf = k[:, 0], v[:, 0]
        if kf.shape[1] != k_pool.shape[2]:
            kf = tctx.gather_heads(kf, self.n_kv_heads, axis=1)
            vf = tctx.gather_heads(vf, self.n_kv_heads, axis=1)
        slot = stripe_write_slot(positions[:, :1], stripe, F,
                                 self.block_table, page)[:, 0]
        _write_token((k_pool, v_pool), (kf, vf),
                     _park_padding(slot, self.slots))

        # 2. q at full logical heads, on the pool-dtype wire
        qf = tctx.gather_heads(q[:, 0].to(k_pool.dtype), self.n_q_heads,
                               axis=1)

        # 3. the partial over my stripe, 4. merged across the stripes
        acc, l, m = stripe_partial(qf, k_pool, v_pool, self.block_table,
                                   self.context_len, stripe, F, window=w)
        out_full = tctx.lse_merge(acc, l, m, wire_dtype=_wire(k_pool))
        out = _take_local_heads(tctx, out_full, self.n_q_heads)
        return out[:, None].to(q.dtype), (k_pool, v_pool)

    def attend_mla(self, state, q_abs, q_pe, entry, *, R: int,
                   n_heads: int):
        """q_abs [B,Hl,R] (q_nope W_uk) and q_pe [B,Hl,Rr], pre-scaled;
        entry [B,R+Rr] the new token's compressed row (alike on every
        rank). Returns the merged compressed context [B,Hl,R] fp32 (the
        caller up-projects with its W_uv slice) and (pool,)."""
        tctx = self.ctx
        (pool,) = state
        page = pool.shape[1]
        stripe, F = self._stripe()

        pos = (self.context_len - 1)[:, None]
        slot = stripe_write_slot(pos, stripe, F, self.block_table, page)
        _write_token((pool,), (entry,), _park_padding(slot[:, 0],
                                                      self.slots))

        # queries at the pool's dtype: half the wire bytes at bf16
        qa = tctx.gather_heads(q_abs.to(pool.dtype), n_heads, axis=1)
        qp = tctx.gather_heads(q_pe.to(pool.dtype), n_heads, axis=1)
        acc, l, m = stripe_partial_mla(qa, qp, pool, self.block_table,
                                       self.context_len, stripe, F, R=R)
        out_full = tctx.lse_merge(acc, l, m, wire_dtype=_wire(pool))
        return _take_local_heads(tctx, out_full, n_heads), (pool,)


@dataclass(frozen=True)
class StripedPrefillBackend:
    """Fresh prefill with striped writes: in-chunk causal attention (every
    token is a live activation; K5 forward on the card) and each rank's
    stripe of the chunk written (K3). ``slots`` [B,T], when given, mark
    the padding positions as in ``StripedDecodeBackend``. A chunk after
    a prior context is refused by the step (``build_serve_step``): it
    would attend within the chunk only."""
    ctx: TPContext
    block_table: torch.Tensor
    window: Optional[int] = None
    slots: Optional[torch.Tensor] = None

    def _slots(self, positions, page):
        slots = stripe_write_slot(positions, self.ctx.stripe_index(),
                                  self.ctx.tp, self.block_table, page)
        return _park_padding(slots, self.slots)

    def attend(self, state, q, k, v, *, positions, window=None):
        from repro_torch.kernels.flash_prefill import ops as fp_ops
        k_pool, v_pool = state
        kf, vf = k, v
        if k.shape[2] != k_pool.shape[2]:
            kf = self.ctx.gather_heads(k, k_pool.shape[2], axis=2)
            vf = self.ctx.gather_heads(v, k_pool.shape[2], axis=2)
        pa_ops.paged_append_chunk((k_pool, v_pool), (kf, vf),
                                  self._slots(positions, k_pool.shape[1]))
        w = window if window is not None else self.window
        return fp_ops.flash_prefill(q, k, v, window=w), (k_pool, v_pool)

    def append_ctx(self, state, vals, *, positions):
        """MLA prefill: write my stripe of the chunk's entries vals
        [B,T,W], return them as the in-line (causal) context."""
        (pool,) = state
        pa_ops.paged_append_chunk((pool,), (vals,),
                                  self._slots(positions, pool.shape[1]))
        return vals, None, (pool,)


def _write_token(pools, vals, slot):
    """The new token's rows vals [B,*w] into pools [nblk,page,*w] at
    ``slot`` [B] (-1 parks on the scratch row): K1 on the card. The JAX
    package writes the scratch row's old value back where the kernel
    overwrites it, which is alike while the adaptor never allocates the
    reserved last block, in either layout."""
    pa_ops.paged_append_token(pools, vals, slot)


def _take_local_heads(tctx: TPContext, full: torch.Tensor, n: int):
    """Cut [B, H_full, ...] back to this rank's compute slice of the n
    logical heads (the inverse of ``TPContext.gather_heads``)."""
    if tctx.tp == 1:
        return full
    want = tctx.compute_shards(n)
    per = full.shape[1] // want
    stored = tctx.stored_shards(n)
    if stored == 1:
        idx = (tctx.storage_major_rank() * want) // tctx.tp
    else:
        rep = tctx.tp // want
        idx = tctx.storage_rank() * (want // stored) \
            + tctx.view_rank() // rep
    return full.narrow(1, idx * per, per)
