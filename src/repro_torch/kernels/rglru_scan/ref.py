"""Plain PyTorch versions of the RG-LRU recurrence: what the op runs for
CPU tensors, and what the CUDA kernels are held against.

``rglru_scan_ref`` is the forward kernel's function, the sequential
recurrence ``h_t = a_t * h_{t-1} + g_t`` from h0 (0 unless given) in
fp32;
``rglru_scan_bwd_ref`` the backward kernel's, written as its formula: the
same recurrence run backwards in time.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a, g, h0=None):
    """a/g [B,T,C] (any float, upcast to fp32); h0 [B,C] fp32 (None:
    zero). Returns (y [B,T,C] fp32, hT [B,C] fp32)."""
    af, gf = a.float(), g.float()
    y = torch.empty_like(af)
    h = af.new_zeros((a.shape[0], a.shape[2])) if h0 is None \
        else h0.float()
    for t in range(a.shape[1]):
        h = af[:, t] * h + gf[:, t]
        y[:, t] = h
    return y, h


def rglru_scan_bwd_ref(a, y, dy):
    """The backward kernel's function: a [B,T,C], the forward's y and the
    gradient dy of y [B,T,C] fp32 -> (da, dg) in a's dtype, with
    dh_t = dy_t + a_{t+1} dh_{t+1}, dg_t = dh_t, da_t = dh_t y_{t-1}
    (y_{-1} = 0); every sum in fp32."""
    af, dyf = a.float(), dy.float()
    da = torch.empty_like(af)
    dg = torch.empty_like(af)
    carry = af.new_zeros((a.shape[0], a.shape[2]))   # a_{t+1} dh_{t+1}
    for t in reversed(range(a.shape[1])):
        dh = dyf[:, t] + carry
        dg[:, t] = dh
        da[:, t] = dh * y[:, t - 1] if t > 0 else 0.0
        carry = af[:, t] * dh
    return da.to(a.dtype), dg.to(a.dtype)
