"""Attention layer: GQA (with optional qk_norm) over a pluggable cache
backend (models/cache.py)."""
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
