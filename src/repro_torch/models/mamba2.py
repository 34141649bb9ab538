"""Mamba-2 SSD layer (arXiv:2405.21060), attention-free.

The layer of the JAX package's ``models/mamba2.py``: z, x, BC and dt
projections, a causal depthwise convolution with SiLU over [x, B, C],
``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``, the SSD scan, the
``D`` skip, a gated per-head RMSNorm and the out projection. B and C
have one group (shared by every head). TP shards the heads (and their
channels) through ``ctx.activate``; B and C are replicated, and the
row-parallel out projection ends in one psum.

Train mode scans from h0 = 0 through K6's autograd op. Serving carries a
per-request state ``(conv [B, cw-1, nhl*hd + 2S], ssm [B, nhl, hd, S]
fp32)`` from call to call, batch-dense (row b is the step's batch row
b): a prefill runs K6 from the carried ssm state (``ssd_scan_from``)
after the convolution from the carried tail, a decode step the
one-token update in plain torch (the JAX package's is jnp too). The
state leaves are written in place.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import TPContext
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.common import (conv_tail, init_linear, keep_rows,
                                      pad_mask, rms_norm, silu, softplus)


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


def _causal_conv(xBC, w, b, cw: int, conv_state=None, valid=None):
    """xBC [B,T,C] after the carried prefix ``conv_state`` [B,cw-1,C]
    (None: zeros, train mode) -> (silu(depthwise causal conv + b), the
    new prefix: the cw - 1 rows before each row's end, ``valid`` [B] or
    T), summed tap by tap in xBC's dtype as the JAX package does."""
    T = xBC.shape[1]
    if conv_state is None:
        conv_state = xBC.new_zeros((xBC.shape[0], cw - 1, xBC.shape[2]))
    full = torch.cat([conv_state, xBC], dim=1)
    out = full[:, 0:T] * w[0][None, None]
    for i in range(1, cw):
        out = out + full[:, i:i + T] * w[i][None, None]
    return silu(out + b[None, None]), conv_tail(full, cw - 1, valid)


def ssd_decode_step(x1, dt1, A, B1, C1, h):
    """One-token update. x1 [B,H,hd]; dt1 [B,H]; B1/C1 [B,S]; h
    [B,H,hd,S] fp32 -> (y [B,H,hd] fp32, h')."""
    a = torch.exp(dt1 * A[None])                         # [B,H]
    upd = torch.einsum("bh,bhd,bs->bhds", dt1, x1.float(), B1.float())
    h = h * a[..., None, None] + upd
    return torch.einsum("bs,bhds->bhd", C1.float(), h), h


def mamba2_layer(cfg: ArchConfig, p, x, ctx: TPContext, state, *,
                 mode: str, valid=None):
    """x [B,T,d] replicated -> (y replicated, state). ``state`` is None
    in train mode, else the layer's (conv, ssm) leaves, updated in place
    and returned. ``valid`` [B] (serving only; None: every position)
    counts each row's real positions: past it dt is zero, so the scan
    leaves the state where the row's last real token put it, the conv
    tail is taken at the row's end, and a row of 0 keeps its leaves bit
    for bit."""
    d_in, nh, hd, S, cw = dims(cfg)
    if (state is None) != (mode == "train"):
        raise ValueError(f"mamba2 {mode} with state "
                         f"{'None' if state is None else 'given'}")
    B_, T, _ = x.shape
    nhl = ctx.local_units(nh)

    z = x @ ctx.activate(p["w_z"], 1, nh)
    xr = x @ ctx.activate(p["w_x"], 1, nh)
    BC = x @ p["w_BC"]
    dt = x @ ctx.activate(p["w_dt"], 1, nh)
    conv_w = torch.cat([ctx.activate(p["conv_x"], 1, nh), p["conv_BC"]],
                       dim=1)
    conv_b = torch.cat([ctx.activate(p["conv_b_x"], 0, nh),
                        p["conv_b_BC"]], dim=0)
    conv_state, h0 = state if state is not None else (None, None)
    xBC, conv_new = _causal_conv(torch.cat([xr, BC], dim=-1), conv_w,
                                 conv_b, cw, conv_state, valid)
    xr = xBC[..., :nhl * hd].reshape(B_, T, nhl, hd)
    Bm = xBC[..., nhl * hd:nhl * hd + S]
    Cm = xBC[..., nhl * hd + S:]

    A = -torch.exp(ctx.activate(p["A_log"], 0, nh))
    dtf = softplus(dt.float()
                   + ctx.activate(p["dt_bias"], 0, nh)[None, None])
    if valid is not None:
        dtf = torch.where(pad_mask(valid, T)[..., None], 0.0, dtf)
    if mode == "decode":
        y1, h = ssd_decode_step(xr[:, 0], dtf[:, 0], A, Bm[:, 0], Cm[:, 0],
                                h0)
        y = y1[:, None]
    elif state is None:
        y, h = ssd_ops.ssd_scan(xr, dtf, A, Bm, Cm, chunk=cfg.ssm.chunk)
    else:
        y, h = ssd_ops.ssd_scan_from(xr, dtf, A, Bm, Cm, h0,
                                     chunk=cfg.ssm.chunk)

    y = y + xr.float() * ctx.activate(p["D"], 0, nh)[None, None, :, None]
    y = y.to(x.dtype).reshape(B_, T, nhl * hd)
    # gated grouped RMSNorm: normalize per head (TP-invariant)
    g = (y * silu(z)).reshape(B_, T, nhl, hd)
    g = rms_norm(g, torch.ones((hd,), dtype=g.dtype, device=g.device),
                 cfg.norm_eps)
    y = g.reshape(B_, T, nhl * hd) * ctx.activate(p["norm_w"], 0, nh)
    out = ctx.psum(y @ ctx.activate(p["w_out"], 0, nh), nh)
    if state is not None:
        conv_state.copy_(conv_new)
        h0.copy_(keep_rows(h, h0, valid))
    return out, state
