"""Attention layers over a pluggable cache backend (models/cache.py):
GQA (with optional qk_norm) and MLA (DeepSeek-V2's Multi-head Latent
Attention over a compressed cache)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import TPContext
from repro_torch.models.common import apply_rope, init_linear, rms_norm


def init_gqa(generator, cfg: ArchConfig, dtype, device):
    d, H, KV = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {"wq": init_linear(generator, d, H * hd, dtype, device),
         "wk": init_linear(generator, d, KV * hd, dtype, device),
         "wv": init_linear(generator, d, KV * hd, dtype, device),
         "wo": init_linear(generator, H * hd, d, dtype, device)}
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((hd,), dtype=dtype, device=device)
    return p


def gqa_attention(cfg: ArchConfig, p, x, ctx: TPContext, backend, state, *,
                  positions, window: Optional[int] = None):
    """x [B,T,d] -> ([B,T,d], state). ``state`` is the layer's (k, v)
    pool pair, updated in place by the backend."""
    B, T, d = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    Hl, KVl = ctx.local_units(H), ctx.local_units(KV)

    if getattr(backend, "stored_frame", False):
        # live cross-layout reads: project the rank's whole storage-shard
        # head set; the backend sweeps each segment's heads and hands
        # back this mode's local slice, so the output projection below
        # is unchanged
        q = (x @ p["wq"]).reshape(B, T, ctx.stored_units(H), hd)
        k = (x @ p["wk"]).reshape(B, T, ctx.stored_units(KV), hd)
        v = (x @ p["wv"]).reshape(B, T, ctx.stored_units(KV), hd)
    else:
        q = (x @ ctx.activate(p["wq"], 1, H)).reshape(B, T, Hl, hd)
        k = (x @ ctx.activate(p["wk"], 1, KV)).reshape(B, T, KVl, hd)
        v = (x @ ctx.activate(p["wv"], 1, KV)).reshape(B, T, KVl, hd)

    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    out, state = backend.attend(state, q, k, v, positions=positions,
                                window=window)
    out = out.reshape(B, T, Hl * hd)
    out = out @ ctx.activate(p["wo"], 0, H)
    return ctx.psum(out, H), state


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2). The compressed cache entry [c_kv ++ k_pe] (width R +
# Rr) is replicated over the TP group; the head up-projections are
# view-sharded.
# ---------------------------------------------------------------------------

def mla_cache_width(cfg: ArchConfig) -> int:
    m = cfg.mla
    return m.kv_lora_rank + m.qk_rope_head_dim


def init_mla(generator, cfg: ArchConfig, dtype, device):
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    qk_hd = m.qk_nope_head_dim + m.qk_rope_head_dim
    lin = lambda i, o: init_linear(generator, i, o, dtype, device)  # noqa
    return {"wdq": lin(d, m.q_lora_rank),
            "q_norm": torch.ones((m.q_lora_rank,), dtype=dtype,
                                 device=device),
            "wuq": lin(m.q_lora_rank, H * qk_hd),
            "wdkv": lin(d, m.kv_lora_rank + m.qk_rope_head_dim),
            "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dtype,
                                  device=device),
            "wuk": lin(m.kv_lora_rank, H * m.qk_nope_head_dim),
            "wuv": lin(m.kv_lora_rank, H * m.v_head_dim),
            "wo": lin(H * m.v_head_dim, d)}


def mla_attention(cfg: ArchConfig, p, x, ctx: TPContext, backend, state, *,
                  positions, window: Optional[int] = None):
    """x [B,T,d] -> ([B,T,d], state); ``state`` is the layer's one
    compressed pool (a 1-tuple), updated in place. Decode (a
    ``DecodeBackend``) runs absorbed: q . W_uk scores the compressed
    entries directly and the read context vectors are up-projected with
    W_uv, so no [B,Tk,H,.] K/V exists. Prefill and train expand the
    gathered context naively in fp32, as the JAX package does."""
    from repro_torch.models.cache import NEG_INF, DecodeBackend
    if getattr(backend, "stored_frame", False):
        raise NotImplementedError(
            "live cross-layout reads do not cover MLA: its compressed "
            "cache is replicated, not head-sharded (live_readable False)")
    B, T, d = x.shape
    m, H = cfg.mla, cfg.num_heads
    Hl = ctx.local_units(H)
    R, Rr, Dn, Dv = (m.kv_lora_rank, m.qk_rope_head_dim,
                     m.qk_nope_head_dim, m.v_head_dim)
    scale = (Dn + Rr) ** -0.5

    # queries (low rank)
    cq = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ ctx.activate(p["wuq"], 1, H)).reshape(B, T, Hl, Dn + Rr)
    q_nope = q[..., :Dn]
    q_pe = apply_rope(q[..., Dn:], positions, cfg.rope_theta)

    # the compressed entry [c_kv ++ k_pe] [B,T,R+Rr], cached as is
    ckv_full = x @ p["wdkv"]
    c_kv = rms_norm(ckv_full[..., :R], p["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(ckv_full[..., None, R:], positions,
                      cfg.rope_theta)[..., 0, :]
    entry = torch.cat([c_kv, k_pe], dim=-1)
    wuk = ctx.activate(p["wuk"], 1, H).reshape(R, Hl, Dn).float()
    wuv = ctx.activate(p["wuv"], 1, H).reshape(R, Hl, Dv).float()

    if isinstance(backend, DecodeBackend):
        q_abs = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].float(),
                             wuk) * scale
        out_c, state = backend.attend_mla_absorbed(
            state, q_abs, q_pe[:, 0].float() * scale, entry[:, 0], R=R,
            window=window)
        out = torch.einsum("bhr,rhd->bhd", out_c, wuv)
        out = out.to(x.dtype).reshape(B, 1, Hl * Dv)
        return ctx.psum(out @ ctx.activate(p["wo"], 0, H), H), state

    ctx_tokens, ctx_len, state = backend.append_ctx(state, entry,
                                                    positions=positions)
    # ctx_tokens [B,Tk,R+Rr]: the whole prefix, this chunk included
    c_ctx, pe_ctx = ctx_tokens[..., :R].float(), ctx_tokens[..., R:].float()
    k_nope = torch.einsum("btr,rhd->bthd", c_ctx, wuk)
    vexp = torch.einsum("btr,rhd->bthd", c_ctx, wuv)
    s = (torch.einsum("bqhd,bkhd->bhqk", q_nope.float(), k_nope)
         + torch.einsum("bqhd,bkd->bhqk", q_pe.float(), pe_ctx)) * scale
    Tk = ctx_tokens.shape[1]
    kpos = torch.arange(Tk, device=x.device)[None, None, :]     # [1,1,Tk]
    qpos = positions[..., None].long()                          # [B,T,1]
    if ctx_len is None:           # in-line or paged prefix: causal
        mask = kpos <= qpos
    else:
        mask = (kpos < ctx_len.long()[:, None, None]).expand(B, T, Tk)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    s = torch.where(mask[:, None], s, NEG_INF)
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", pr, vexp)
    out = out.to(x.dtype).reshape(B, T, Hl * Dv)
    return ctx.psum(out @ ctx.activate(p["wo"], 0, H), H), state
