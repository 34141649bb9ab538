"""SSD scan dispatch layer: the Mamba-2 chunked scan with h0 = 0 as a
``torch.autograd.Function`` whose backward is a kernel too (training),
and the forward alone from a carried state (``ssd_scan_from``, a serving
prefill).

As in the other ops modules, the tensors' device picks the
implementation in both directions: the CUDA kernels on the card, the
plain versions on the CPU (the chunked form forward, autograd through it
backward), the meta route (outputs on meta, the call's cost recorded)
for meta tensors; any other device raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import cost
from repro_torch.kernels.paged_attention.ops import route
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R


def _meta(name, x, B, chunk, *reads, h0=False, backward=False):
    Bs, T, H, hd = x.shape
    S = B.shape[-1]
    cost.record(name, cost.ssd(Bs, T, H, hd, S, chunk, x.element_size(),
                               B.element_size(), h0=h0, backward=backward),
                *reads)
    return (torch.empty((Bs, T, H, hd), dtype=torch.float32, device="meta"),
            torch.empty((Bs, H, hd, S), dtype=torch.float32, device="meta"))


class _SSDScan(torch.autograd.Function):
    """y, hT of the scan; the backward takes the gradient of y only (the
    training path discards hT)."""

    @staticmethod
    def forward(fctx, x, dt, A, B, C, chunk):
        fctx.set_materialize_grads(False)
        fctx.chunk = chunk
        r = route(x)
        if r == "meta":
            y, hT = _meta("ssd_scan", x, B, chunk, x, dt, A, B, C)
            fctx.save_for_backward(x, dt, A, B, C)
        elif r == "cuda":
            y, hT, states = K.ssd_scan_kernel(x, dt, A, B, C, chunk=chunk)
            fctx.save_for_backward(x, dt, A, B, C, states)
        else:
            y, hT, _ = R.ssd_scan_fwd_ref(x, dt, A, B, C, chunk=chunk)
            fctx.save_for_backward(x, dt, A, B, C)
        return y, hT

    @staticmethod
    def backward(fctx, dy, dhT):
        if dhT is not None:
            raise NotImplementedError(
                "ssd_scan: no gradient through the final state hT (the "
                "training path discards it; serving needs none)")
        if dy is None:
            return (None,) * 6
        saved = fctx.saved_tensors
        r = route(saved[0])
        if r == "meta":
            x, B = saved[0], saved[3]
            _meta("ssd_scan_bwd", x, B, fctx.chunk, *saved, dy,
                  backward=True)
            return (*(torch.empty_like(t) for t in saved), None)
        bwd = K.ssd_scan_bwd_kernel if r == "cuda" else R.ssd_scan_bwd_ref
        return (*bwd(*saved, dy, chunk=fctx.chunk), None)


def _pad(x, dt, B, C, chunk: int):
    """T padded with zeros up to a multiple of min(chunk, T), as the JAX
    package pads it: a zero dt makes a pad an identity step, so hT is
    the state after the last real row."""
    T = x.shape[1]
    ch = min(chunk, T)
    pad = (-T) % ch
    dt = dt.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    return x, dt, B, C, ch


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """x [Bs,T,H,hd]; dt [Bs,T,H]; A [H] fp32; B/C [Bs,T,S]; h0 = 0.
    Returns (y [Bs,T,H,hd] fp32, hT [Bs,H,hd,S] fp32), differentiable in
    x, dt, A, B and C through y. T is padded as ``_pad`` says."""
    T = x.shape[1]
    x, dt, B, C, ch = _pad(x, dt, B, C, chunk)
    y, hT = _SSDScan.apply(x, dt, A, B, C, ch)
    return y[:, :T], hT


def ssd_scan_from(x, dt, A, B, C, h0, *, chunk: int = 128):
    """The forward from a carried state h0 [Bs,H,hd,S] fp32 (a serving
    prefill; no autograd). Returns (y [Bs,T,H,hd] fp32, hT [Bs,H,hd,S]
    fp32); T is padded as ``_pad`` says. CUDA tensors run K6 with its h0
    input, CPU tensors ``ref.ssd_chunked``."""
    T = x.shape[1]
    x, dt, B, C, ch = _pad(x, dt, B, C, chunk)
    r = route(x)
    if r == "cuda":
        y, hT, _ = K.ssd_scan_kernel(x, dt, A, B, C, chunk=ch, h0=h0)
    elif r == "meta":
        y, hT = _meta("ssd_scan_from", x, B, ch, x, dt, A, B, C, h0,
                      h0=True)
    else:
        y, hT = R.ssd_chunked(x, dt, A, B, C, h0, ch)
    return y[:, :T], hT
