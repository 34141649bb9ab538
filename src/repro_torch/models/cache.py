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

MLA layers (models/attention.py) keep one compressed pool ``(pool,)``
``[num_blocks, page, W]`` instead of the pair and use the raw
primitives: ``append_ctx`` (append the chunk's entries, gather the
prefix) for prefill, ``attend_mla_absorbed`` for decode.

Which implementation runs is decided by where the tensors lie: the CUDA
kernels for tensors on the card, their plain PyTorch versions for
tensors on the CPU. The plain attention math the plain versions share
lives here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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

    def append_ctx(self, state, vals, *, positions):
        """MLA: the sequence is its own context, causal in line."""
        return vals, None, state


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

    def append_ctx(self, state, vals, *, positions):
        """MLA: append the chunk's compressed entries vals [B,T,W] (K3's
        one-pool form on the card), then gather the whole prefix through
        the block table -> (ctx [B,MB*page,W], None: causal by absolute
        position, (pool,))."""
        from repro_torch.kernels.paged_attention import ops as pa_ops
        (pool,) = state
        pa_ops.paged_append_chunk((pool,), (vals,), self.slots)
        return paged_gather(pool, self.block_table), None, (pool,)


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

    def attend_mla_absorbed(self, state, q_abs, q_pe, entry, *, R: int,
                            window=None):
        """Absorbed MLA decode: q_abs [B,Hl,R] = q_nope W_uk and q_pe
        [B,Hl,Rr] (both pre-scaled), entry [B,R+Rr] the new token's
        compressed row. Scores run against the compressed pool directly
        (K1's one-pool append, then the MLA decode kernel on the card);
        returns ([B,Hl,R] fp32 context read, (pool,)) for the caller to
        up-project with W_uv."""
        from repro_torch.kernels.paged_attention import ops as pa_ops
        (pool,) = state
        q_cat = torch.cat([q_abs, q_pe], dim=-1)
        out_c, pool = pa_ops.paged_mla_attention_decode(
            q_cat, entry, pool, self.slots, self.block_table,
            self.context_len, R=R, window=window)
        return out_c, (pool,)

    def append_ctx(self, state, vals, *, positions):
        """MLA's raw primitive in decode: append vals [B,W] (or [B,1,W])
        at ``slots``, gather the prefix -> (ctx, context_len, (pool,))."""
        from repro_torch.kernels.paged_attention import ops as pa_ops
        (pool,) = state
        pa_ops.paged_append_token((pool,), (vals.reshape(vals.shape[0], -1),),
                                  self.slots)
        return (paged_gather(pool, self.block_table), self.context_len,
                (pool,))


# ---------------------------------------------------------------------------
# live cross-layout backends
# ---------------------------------------------------------------------------
#
# A request riding a LIVE rebind holds block SEGMENTS written under
# earlier merges. A tag-t segment's per-rank head slices live on the t
# engines of its owner group (a buddy-aligned part of the current group)
# under the tag-t pool view [nb, B_base*t, kvh/t, hd]. The live backends
# therefore compute attention in the STORED head frame (the rank's whole
# storage-shard head set: ``gqa_attention`` projects without the merge
# slice when ``backend.stored_frame``): each rank sweeps every segment
# it owns, under that segment's view, for the stored-head part its old
# view rank held, giving partial (out, lse) pairs. The partials merge
# locally across segments, then across the merge axis with one LSE merge
# over the view group (``TPContext.lse_merge(..., view=True)``), and the
# merged stored-frame output is cut back to the current mode's heads for
# the unchanged output projection. New tokens are written under the
# CURRENT view (the host retags pending slots at a rebind), so writes
# never cross layouts; only reads do. No block moves. Every view below
# is a ``view`` of the flat per-layer pool: a write through it lands in
# the pool.

def _seg_scatter(out_t, lse_t, v_old, ok, H_st: int, head_axis: int):
    """Scatter one segment sweep's (out, lse), computed for the Hq_t
    stored heads at per-row offset ``v_old * Hq_t``, into the full
    stored-head frame. Absent heads and rows where ``ok`` is False get
    out 0 and lse ``NEG_INF`` (whatever the sweep wrote there, NaN
    included), so the merges ignore them."""
    Hq_t = out_t.shape[head_axis]
    jpos = torch.arange(H_st, device=out_t.device)[None, :] \
        - v_old[:, None] * Hq_t                                   # [B,H_st]
    okj = ok[:, None] & (jpos >= 0) & (jpos < Hq_t)
    src = jpos.clamp(0, Hq_t - 1)
    hd = out_t.shape[-1]
    if head_axis == 1:        # decode: out [B,Hq,hd], lse [B,Hq]
        o = torch.gather(out_t, 1, src[:, :, None].expand(-1, -1, hd))
        o = torch.where(okj[:, :, None], o, 0.0)
        l = torch.where(okj, torch.gather(lse_t, 1, src), NEG_INF)
    else:                     # prefill: out [B,T,Hq,hd], lse [B,Hq,T]
        B, T = out_t.shape[0], out_t.shape[1]
        o = torch.gather(out_t, 2,
                         src[:, None, :, None].expand(B, T, H_st, hd))
        o = torch.where(okj[:, None, :, None], o, 0.0)
        l = torch.gather(lse_t, 1, src[:, :, None].expand(B, H_st, T))
        l = torch.where(okj[:, :, None], l, NEG_INF)
    return o, l


def _merge_sweeps(outs_lses):
    """Local (out, lse) -> (m, weights, l) combine across segment sweeps,
    ready for the cross-rank ``lse_merge``. Each normalized sweep is an
    (acc=out, l=1, m=lse) partial; heads absent from every local sweep
    keep m = ``NEG_INF`` and weigh nothing in the merge."""
    ms = torch.stack([l for _, l in outs_lses])             # [S,...]
    m = ms.amax(dim=0)
    ws = torch.exp(ms - m[None])
    ws = torch.where(ms <= NEG_INF / 2, 0.0, ws)
    return m, ws, ws.sum(dim=0)


def _lane_heads(v_idx: int, own, tag: int, Hq: int):
    """Per lane: which rows this rank owns a part of (``ok`` [B]), its old
    view rank there (``v_old`` [B]) and the stored heads it held then
    (``idx`` [B, Hq])."""
    ok = (own <= v_idx) & (v_idx < own + tag)
    v_old = (v_idx - own).clamp(0, tag - 1)
    idx = v_old[:, None] * Hq + torch.arange(Hq, device=own.device)[None]
    return ok, v_old, idx


def _sp_write(k, v, k_pool, v_pool, slots, own, v_idx: int, merge: int,
              sp: int, block_base: int, owner_mask=None):
    """The sequence-parallel write: the new rows land under the
    SHARD-width tag ``merge // sp`` on the row's owner shard only
    (``own`` [B], merge-axis offset); a rank outside it parks the row on
    the last slot of the reserved block, ``nb * cap_w - 1``, computed
    here, outside the append kernel. k/v [B,T,KV_st,hd], slots [B,T]."""
    nb, hd = k_pool.shape[0], k.shape[-1]
    wt = merge // sp
    cap_w = block_base * wt
    kvh_w = k.shape[2] // wt
    is_owner = (own <= v_idx) & (v_idx < own + wt)                # [B]
    v_w = (v_idx - own).clamp(0, wt - 1)
    idx = v_w[:, None] * kvh_w + torch.arange(kvh_w, device=own.device)
    B, T = k.shape[0], k.shape[1]
    idx = idx[:, None, :, None].expand(B, T, kvh_w, hd)
    k_new, v_new = torch.gather(k, 2, idx), torch.gather(v, 2, idx)
    keep = is_owner[:, None] if owner_mask is None \
        else is_owner[:, None] & owner_mask
    slots_w = torch.where(keep, slots, nb * cap_w - 1).to(slots.dtype)
    kp_w = k_pool.view(nb, cap_w, kvh_w, hd)
    vp_w = v_pool.view(nb, cap_w, kvh_w, hd)
    assert kp_w.data_ptr() == k_pool.data_ptr()
    return kp_w, vp_w, k_new, v_new, slots_w


@dataclass(frozen=True)
class LiveDecodeBackend:
    """Decode over a request set whose KV spans mode-tagged segments.

    ``segs``: one entry per placement LANE, (tag, block_table [B, mb_t],
    seg_len [B], owner [B]): ``seg_len`` is the lane's token count per
    row (0: the row has no such lane), ``owner`` the merge-axis offset
    where the lane's owner group starts in the current group. Tags may
    repeat across lanes (sequence parallelism: one lane per SP shard).
    The lane holding each row's live segment counts the new token, which
    is appended before the sweeps: all masking derives from the per-lane
    counts.

    ``sp`` > 1 selects the sequence-parallel write (``_sp_write``);
    ``sp`` 1 writes the current view's head slice at ``slots``."""
    ctx: "TPContext"
    slots: torch.Tensor       # [B] write-view slot of the new token
    segs: Tuple[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor], ...]
    merge: int                # current mode (the state view's tag)
    block_base: int           # B_base: tokens a block holds at merge 1
    window: Optional[int] = None
    sp: int = 1               # sequence-parallel degree (divides merge)
    write_own: Optional[torch.Tensor] = None   # [B] owner shard offset
    stored_frame = True       # gqa_attention: project the stored heads

    def attend(self, state, q, k, v, *, positions, window=None):
        from repro_torch.kernels.paged_attention import ops as pa_ops
        if (window or self.window) is not None:
            raise ValueError("live cross-layout reads do not support "
                             "sliding windows")
        k_pool, v_pool = state                 # current-tag view
        H_st, hd = q.shape[2], q.shape[3]
        KV_st = k.shape[2]
        m = self.merge
        nb = k_pool.shape[0]
        v_idx = self.ctx.view_rank()
        if self.sp == 1:
            kv_loc = KV_st // m
            lo = v_idx * kv_loc
            pa_ops.paged_append_token(
                (k_pool, v_pool), (k[:, 0, lo:lo + kv_loc],
                                   v[:, 0, lo:lo + kv_loc]), self.slots)
        else:
            kp_w, vp_w, k_new, v_new, slots_w = _sp_write(
                k, v, k_pool, v_pool, self.slots[:, None], self.write_own,
                v_idx, m, self.sp, self.block_base)
            pa_ops.paged_append_token((kp_w, vp_w), (k_new[:, 0],
                                                     v_new[:, 0]),
                                      slots_w[:, 0])
        flat_k, flat_v = k_pool.view(nb, -1), v_pool.view(nb, -1)
        q_st = q[:, 0]                          # [B, H_st, hd]
        partials = []
        for tag, bt_t, len_t, own_t in self.segs:
            cap_t, kvh_t, Hq_t = self.block_base * tag, KV_st // tag, \
                H_st // tag
            ok, v_old, idx = _lane_heads(v_idx, own_t, tag, Hq_t)
            q_sub = torch.gather(q_st, 1, idx[:, :, None].expand(-1, -1, hd))
            out_t, lse_t = pa_ops.paged_attention_with_lse(
                q_sub, flat_k.view(nb, cap_t, kvh_t, hd),
                flat_v.view(nb, cap_t, kvh_t, hd), bt_t,
                torch.where(ok, len_t, 0).to(torch.int32),
                softmax_scale=hd ** -0.5)
            partials.append(_seg_scatter(out_t, lse_t, v_old,
                                         ok & (len_t > 0), H_st, 1))
        m_loc, ws, l_loc = _merge_sweeps(partials)
        acc = sum(o * w[..., None] for (o, _), w in zip(partials, ws))
        out_full = self.ctx.lse_merge(acc, l_loc, m_loc, view=True)
        h_loc = H_st // m
        out = out_full[:, v_idx * h_loc:(v_idx + 1) * h_loc]
        return out[:, None].to(q.dtype), (k_pool, v_pool)


@dataclass(frozen=True)
class LivePrefillBackend:
    """Chunked prefill whose PRIOR context spans mode-tagged segments.

    The chunk lands in the write-tag lane: its pages are in that lane's
    table, and the causal in-chunk plus lane-prior attention is one
    sweep (the causal lane's ``seg_len`` counts the prior tokens in that
    lane, not the chunk). Every other lane gets a ``prior_only`` sweep.
    At ``sp`` 1 the causal lane is the current-tag lane; at ``sp`` > 1 it
    is the LAST lane (the host stages each row's owner shard there), and
    the chunk is written shard-width to the row's owner only."""
    ctx: "TPContext"
    slots: torch.Tensor       # [B,T] write-view chunk write slots
    segs: Tuple[Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor], ...]
    merge: int
    block_base: int
    window: Optional[int] = None
    sp: int = 1
    write_own: Optional[torch.Tensor] = None
    stored_frame = True

    def attend(self, state, q, k, v, *, positions, window=None):
        from repro_torch.kernels.flash_prefill import ops as fp_ops
        from repro_torch.kernels.paged_attention import ops as pa_ops
        if (window or self.window) is not None:
            raise ValueError("live cross-layout reads do not support "
                             "sliding windows")
        k_pool, v_pool = state
        B, T, H_st, hd = q.shape
        KV_st = k.shape[2]
        m = self.merge
        nb = k_pool.shape[0]
        v_idx = self.ctx.view_rank()
        if self.sp == 1:
            kv_loc = KV_st // m
            lo = v_idx * kv_loc
            pa_ops.paged_append_chunk(
                (k_pool, v_pool), (k[:, :, lo:lo + kv_loc],
                                   v[:, :, lo:lo + kv_loc]), self.slots)
        else:
            # the engine keeps each row's chunk within ONE block, so one
            # owner shard covers the whole row
            kp_w, vp_w, k_new, v_new, slots_w = _sp_write(
                k, v, k_pool, v_pool, self.slots, self.write_own, v_idx,
                m, self.sp, self.block_base, owner_mask=self.slots >= 0)
            pa_ops.paged_append_chunk((kp_w, vp_w), (k_new, v_new),
                                      slots_w)
        flat_k, flat_v = k_pool.view(nb, -1), v_pool.view(nb, -1)
        partials = []
        for i, (tag, bt_t, len_t, own_t) in enumerate(self.segs):
            cap_t, kvh_t, Hq_t = self.block_base * tag, KV_st // tag, \
                H_st // tag
            ok, v_old, idx = _lane_heads(v_idx, own_t, tag, Hq_t)
            q_sub = torch.gather(
                q, 2, idx[:, None, :, None].expand(B, T, Hq_t, hd))
            cur = tag == m if self.sp == 1 else i == len(self.segs) - 1
            out_t, lse_t = fp_ops.paged_prefill_sweep_with_lse(
                q_sub, flat_k.view(nb, cap_t, kvh_t, hd),
                flat_v.view(nb, cap_t, kvh_t, hd), bt_t,
                torch.where(ok, len_t, 0).to(torch.int32),
                prior_only=not cur, softmax_scale=hd ** -0.5)
            # the causal lane always holds the chunk's own rows on the
            # owner ranks; other lanes count only where the lane exists
            partials.append(_seg_scatter(
                out_t, lse_t, v_old, ok if cur else ok & (len_t > 0),
                H_st, 2))
        m_loc, ws, l_loc = _merge_sweeps(partials)   # lse-shaped [B,H,T]
        acc = sum(o * w.transpose(1, 2)[..., None]
                  for (o, _), w in zip(partials, ws))
        out_full = self.ctx.lse_merge(acc, l_loc.transpose(1, 2),
                                      m_loc.transpose(1, 2), view=True)
        h_loc = H_st // m
        out = out_full[:, :, v_idx * h_loc:(v_idx + 1) * h_loc]
        return out.to(q.dtype), (k_pool, v_pool)
