"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).

The block of the JAX package's ``models/rglru.py``: the input and gate
projections, a 4-tap causal depthwise convolution (no activation) over
the input branch, the fp32 gates

    r_t = sigmoid(w_a * u_t + b_a),  i_t = sigmoid(w_i * u_t + b_i),
    log a_t = -8 * softplus(Lambda) * r_t,
    g_t = sqrt(max(1 - a_t^2, 1e-12)) * (i_t * u_t),

the recurrence ``h_t = a_t h_{t-1} + g_t``, the GeLU gate and the out
projection. The gates are per-channel (diagonal) weights, as in the JAX
package, and their leaves and Lambda are fp32 in a model of any dtype.
TP shards the channels through ``ctx.activate``; the row-parallel out
projection ends in one psum.

Train mode runs the recurrence from h0 = 0 through K7's autograd op.
Serving carries a per-request state ``(conv [B, 3, Wl], h [B, Wl]
fp32)`` from call to call, batch-dense (row b is the step's batch row
b): a prefill runs K7 from the carried h (``rglru_scan_from``) after the
convolution from the carried tail, a decode step one plain elementwise
update. The state leaves are written in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import TPContext
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.models.common import (conv_tail, gelu, init_linear,
                                      keep_rows, pad_mask, softplus)

CONV_W = 4


def width(cfg: ArchConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


def init_rglru(generator, cfg: ArchConfig, dtype, device):
    """Seeded parameters with the JAX package's scales, names and dtypes
    (Lambda and the gates fp32)."""
    d, w = cfg.d_model, width(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    conv = torch.empty((CONV_W, w), **f32)
    conv.normal_(0.0, 1.0, generator=generator)
    return {
        "w_x": init_linear(generator, d, w, dtype, device),
        "w_gate": init_linear(generator, d, w, dtype, device),
        "conv_w": (conv * (1.0 / math.sqrt(CONV_W))).to(dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=device),
        "lam": torch.full((w,), 0.7, **f32),
        "gate_a_w": torch.zeros((w,), **f32),
        "gate_a_b": torch.full((w,), 2.0, **f32),
        "gate_i_w": torch.zeros((w,), **f32),
        "gate_i_b": torch.zeros((w,), **f32),
        "w_out": init_linear(generator, w, d, dtype, device),
    }


def rglru_block(cfg: ArchConfig, p, x, ctx: TPContext, state, *,
                mode: str, valid=None):
    """x [B,T,d] replicated -> (y replicated, state). ``state`` is None
    in train mode, else the layer's (conv, h) leaves, updated in place
    and returned. ``valid`` [B] (serving only; None: every position)
    counts each row's real positions: past it log a and g are zero (a =
    1, nothing added), so h stays where the row's last real token put
    it, the conv tail is taken at the row's end, and a row of 0 keeps
    its leaves bit for bit."""
    if (state is None) != (mode == "train"):
        raise ValueError(f"rglru {mode} with state "
                         f"{'None' if state is None else 'given'}")
    w = width(cfg)
    T = x.shape[1]
    u = x @ ctx.activate(p["w_x"], 1, w)
    gate = gelu(x @ ctx.activate(p["w_gate"], 1, w))
    cw = ctx.activate(p["conv_w"], 1, w)
    conv_state, h0 = state if state is not None else (None, None)
    if conv_state is None:
        conv_state = u.new_zeros((u.shape[0], CONV_W - 1, u.shape[2]))
    # causal conv from the carried tail, summed tap by tap in x's dtype
    # as the JAX package sums it, then the bias
    full = torch.cat([conv_state, u], dim=1)
    u = full[:, 0:T] * cw[0][None, None]
    for i in range(1, CONV_W):
        u = u + full[:, i:i + T] * cw[i][None, None]
    u = u + ctx.activate(p["conv_b"], 0, w)[None, None]

    uf = u.float()
    r = torch.sigmoid(uf * ctx.activate(p["gate_a_w"], 0, w)
                      + ctx.activate(p["gate_a_b"], 0, w))
    i = torch.sigmoid(uf * ctx.activate(p["gate_i_w"], 0, w)
                      + ctx.activate(p["gate_i_b"], 0, w))
    log_a = -8.0 * softplus(ctx.activate(p["lam"], 0, w)) * r   # <= 0
    a = torch.exp(log_a)
    g = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * uf)
    if valid is not None:
        pad = pad_mask(valid, T)[..., None]
        a = torch.where(pad, 1.0, a)
        g = torch.where(pad, 0.0, g)
    if mode == "decode":
        h = a[:, 0] * h0 + g[:, 0]
        y = h[:, None]
    elif state is None:
        y, h = rg_ops.rglru_scan(a, g)
    else:
        y, h = rg_ops.rglru_scan_from(a, g, h0)
    y = y.to(x.dtype) * gate
    out = ctx.psum(y @ ctx.activate(p["w_out"], 0, w), w)
    if state is not None:
        state[0].copy_(conv_tail(full, CONV_W - 1, valid))
        h0.copy_(keep_rows(h, h0, valid))
    return out, state
