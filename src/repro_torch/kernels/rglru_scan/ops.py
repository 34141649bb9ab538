"""RG-LRU dispatch layer: the recurrence ``h_t = a_t h_{t-1} + g_t`` from
h0 = 0 as a ``torch.autograd.Function`` whose backward is a kernel too.

As in the other ops modules, the tensors' device picks the
implementation in both directions: the CUDA kernels on the card, the
plain loops on the CPU; any other device raises. T and C take any size
(the JAX package pads them to its kernel's tiles; the CUDA kernels mask
the ragged ends).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.ops import on_cuda
from repro_torch.kernels.rglru_scan import kernel as K
from repro_torch.kernels.rglru_scan import ref as R


class _RGLRUScan(torch.autograd.Function):
    """y, hT of the recurrence; the backward takes the gradient of y only
    (the training path discards hT)."""

    @staticmethod
    def forward(fctx, a, g):
        fctx.set_materialize_grads(False)
        if on_cuda(a):
            y, hT = K.rglru_scan_kernel(a, g)
        else:
            y, hT = R.rglru_scan_ref(a, g)
        fctx.save_for_backward(a, y)
        return y, hT

    @staticmethod
    def backward(fctx, dy, dhT):
        if dhT is not None:
            raise NotImplementedError(
                "rglru_scan: no gradient through the final state hT (the "
                "training path discards it; serving needs none)")
        if dy is None:
            return None, None
        a, y = fctx.saved_tensors
        bwd = K.rglru_scan_bwd_kernel if on_cuda(a) else R.rglru_scan_bwd_ref
        return bwd(a, y, dy)


def rglru_scan(a, g):
    """a/g [B,T,C] of one dtype; h0 = 0. Returns (y [B,T,C] fp32, hT
    [B,C] fp32), differentiable in a and g through y."""
    if a.dim() != 3 or g.shape != a.shape or a.dtype != g.dtype:
        raise ValueError(f"rglru_scan: a {tuple(a.shape)} {a.dtype} and g "
                         f"{tuple(g.shape)} {g.dtype} must be one [B,T,C] "
                         f"shape and dtype")
    return _RGLRUScan.apply(a, g)
