"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427),
train mode.

The full-sequence block of the JAX package's ``models/rglru.py``: the
input and gate projections, a 4-tap causal depthwise convolution (no
activation) over the input branch, the fp32 gates

    r_t = sigmoid(w_a * u_t + b_a),  i_t = sigmoid(w_i * u_t + b_i),
    log a_t = -8 * softplus(Lambda) * r_t,
    g_t = sqrt(max(1 - a_t^2, 1e-12)) * (i_t * u_t),

the recurrence ``h_t = a_t h_{t-1} + g_t`` from h0 = 0
(``kernels/rglru_scan``, K7), the GeLU gate and the out projection. The
gates are per-channel (diagonal) weights, as in the JAX package, and
their leaves and Lambda are fp32 in a model of any dtype.

Only train mode is ported. Prefill and decode carry the recurrent state
(conv tail and h) from call to call, which needs K7 with an h0 and a
decision on the JAX engine's recurrent state (ROADMAP Queue 3); they
raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import TPContext
from repro_torch.kernels.rglru_scan import ops as rg_ops
from repro_torch.models.common import gelu, init_linear, softplus

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
                mode: str):
    """x [B,T,d] -> (y [B,T,d], None). Train mode only (``state`` None)."""
    if mode != "train" or state is not None:
        raise NotImplementedError(
            f"rglru {mode}: the port trains RecurrentGemma only; serving "
            f"needs K7 with a carried h0 and a decision on the JAX engine's "
            f"recurrent state (ROADMAP Queue 3)")
    T = x.shape[1]
    u = x @ p["w_x"]
    gate = gelu(x @ p["w_gate"])
    # causal conv from a zero state, summed tap by tap in x's dtype as the
    # JAX package sums it, then the bias
    full = torch.cat([u.new_zeros((u.shape[0], CONV_W - 1, u.shape[2])), u],
                     dim=1)
    u = full[:, 0:T] * p["conv_w"][0][None, None]
    for i in range(1, CONV_W):
        u = u + full[:, i:i + T] * p["conv_w"][i][None, None]
    u = u + p["conv_b"][None, None]

    uf = u.float()
    r = torch.sigmoid(uf * p["gate_a_w"] + p["gate_a_b"])
    i = torch.sigmoid(uf * p["gate_i_w"] + p["gate_i_b"])
    log_a = -8.0 * softplus(p["lam"]) * r                 # <= 0
    a = torch.exp(log_a)
    g = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * uf)
    y, _ = rg_ops.rglru_scan(a, g)
    y = y.to(x.dtype) * gate
    return y @ p["w_out"], None
