"""SSD scan dispatch layer: the Mamba-2 chunked scan with h0 = 0 as a
``torch.autograd.Function`` whose backward is a kernel too.

As in the other ops modules, the tensors' device picks the
implementation in both directions: the CUDA kernels on the card, the
plain versions on the CPU (the chunked form forward, autograd through it
backward); any other device raises.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.paged_attention.ops import on_cuda
from repro_torch.kernels.ssd_scan import kernel as K
from repro_torch.kernels.ssd_scan import ref as R


class _SSDScan(torch.autograd.Function):
    """y, hT of the scan; the backward takes the gradient of y only (the
    training path discards hT)."""

    @staticmethod
    def forward(fctx, x, dt, A, B, C, chunk):
        fctx.set_materialize_grads(False)
        fctx.chunk = chunk
        if on_cuda(x):
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
        bwd = K.ssd_scan_bwd_kernel if on_cuda(saved[0]) \
            else R.ssd_scan_bwd_ref
        return (*bwd(*saved, dy, chunk=fctx.chunk), None)


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """x [Bs,T,H,hd]; dt [Bs,T,H]; A [H] fp32; B/C [Bs,T,S]; h0 = 0.
    Returns (y [Bs,T,H,hd] fp32, hT [Bs,H,hd,S] fp32), differentiable in
    x, dt, A, B and C through y. T is padded with zeros up to a multiple
    of min(chunk, T): a zero dt makes a pad an identity step."""
    T = x.shape[1]
    ch = min(chunk, T)
    pad = (-T) % ch
    dt = dt.float()
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    y, hT = _SSDScan.apply(x, dt, A, B, C, ch)
    return y[:, :T], hT
