"""Mamba-2 SSD layer (arXiv:2405.21060), attention-free, train mode.

The full-sequence layer of the JAX package's ``models/mamba2.py``: z, x,
BC and dt projections, a causal depthwise convolution with SiLU over
[x, B, C], ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD
scan from h0 = 0 (``kernels/ssd_scan``, K6), the ``D`` skip, a gated
per-head RMSNorm and the out projection. B and C have one group (shared
by every head).

Only train mode is ported. Prefill and decode carry the recurrent state
(conv tail and ssm state) from call to call, which needs K6 with an h0
and a decision on the JAX engine's recurrent state (ROADMAP Queue 3);
they raise.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import TPContext
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import init_linear, rms_norm, silu, softplus


def dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nh = d_in // s.head_dim
    return d_in, nh, s.head_dim, s.d_state, s.conv_width


def init_mamba2(generator, cfg: ArchConfig, dtype, device):
    """Seeded parameters with the JAX package's scales and names."""
    d = cfg.d_model
    d_in, nh, hd, S, cw = dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)

    def conv(width):
        w = torch.empty((cw, width), **f32)
        w.normal_(0.0, 1.0, generator=generator)
        return (w * (1.0 / math.sqrt(cw))).to(dtype)
    return {
        "w_z": init_linear(generator, d, d_in, dtype, device),
        "w_x": init_linear(generator, d, d_in, dtype, device),
        "w_BC": init_linear(generator, d, 2 * S, dtype, device),
        "w_dt": init_linear(generator, d, nh, dtype, device),
        "conv_x": conv(d_in),
        "conv_BC": conv(2 * S),
        "conv_b_x": torch.zeros((d_in,), dtype=dtype, device=device),
        "conv_b_BC": torch.zeros((2 * S,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm_w": torch.ones((d_in,), dtype=dtype, device=device),
        "w_out": init_linear(generator, d_in, d, dtype, device),
    }


def _causal_conv(xBC, w, b, cw: int):
    """xBC [B,T,C] after a zero prefix of cw - 1 rows (train mode: no
    carried conv state) -> silu(depthwise causal conv + b), summed tap by
    tap in xBC's dtype as the JAX package does."""
    T = xBC.shape[1]
    full = torch.cat([xBC.new_zeros((xBC.shape[0], cw - 1, xBC.shape[2])),
                      xBC], dim=1)
    out = full[:, 0:T] * w[0][None, None]
    for i in range(1, cw):
        out = out + full[:, i:i + T] * w[i][None, None]
    return silu(out + b[None, None])


def mamba2_layer(cfg: ArchConfig, p, x, ctx: TPContext, state, *,
                 mode: str):
    """x [B,T,d] -> (y [B,T,d], None). Train mode only (``state`` None)."""
    if mode != "train" or state is not None:
        raise NotImplementedError(
            f"mamba2 {mode}: the port trains Mamba-2 only; serving needs "
            f"K6 with a carried h0 and a decision on the JAX engine's "
            f"recurrent state (ROADMAP Queue 3)")
    d_in, nh, hd, S, cw = dims(cfg)
    B_, T, _ = x.shape

    z = x @ p["w_z"]
    xr = x @ p["w_x"]
    BC = x @ p["w_BC"]
    dt = x @ p["w_dt"]
    conv_w = torch.cat([p["conv_x"], p["conv_BC"]], dim=1)
    conv_b = torch.cat([p["conv_b_x"], p["conv_b_BC"]], dim=0)
    xBC = _causal_conv(torch.cat([xr, BC], dim=-1), conv_w, conv_b, cw)
    xr = xBC[..., :d_in].reshape(B_, T, nh, hd)
    Bm = xBC[..., d_in:d_in + S]
    Cm = xBC[..., d_in + S:]

    A = -torch.exp(p["A_log"])
    dtf = softplus(dt.float() + p["dt_bias"][None, None])
    y, _ = ssd_ops.ssd_scan(xr, dtf, A, Bm, Cm, chunk=cfg.ssm.chunk)

    y = y + xr.float() * p["D"][None, None, :, None]
    y = y.to(x.dtype).reshape(B_, T, d_in)
    # gated grouped RMSNorm: normalize per head
    g = (y * silu(z)).reshape(B_, T, nh, hd)
    g = rms_norm(g, torch.ones((hd,), dtype=g.dtype, device=g.device),
                 cfg.norm_eps)
    y = g.reshape(B_, T, d_in) * p["norm_w"]
    return y @ p["w_out"], None
