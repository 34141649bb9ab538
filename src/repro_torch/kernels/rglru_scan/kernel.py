"""CUDA wrappers of the RG-LRU recurrence (csrc/rglru_scan.cu), forward
and backward. Each validates, allocates outputs, launches on the current
stream, counts the launch and raises on a launch error. CUDA tensors
only; ``ops`` routes CPU tensors to the plain versions.

Replaces the TPU kernel ``rglru_scan_kernel``
(src/repro/kernels/rglru_scan/kernel.py:53), an associative scan over
128 x 128 time tiles carrying h from tile to tile; the backward has no
TPU counterpart (XLA autodiff in the JAX package). On the H100 both are
bytes-bound: at the training shape (B 4, T 2048, C 4096, fp32) 0.120 ms
forward and 0.200 ms backward at 3.35 TB/s. The kernels give each
thread one (batch row, channel) and walk T in order; the head of
rglru_scan.cu says why.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib


def _args(a, other, what: str):
    """Validate a [B,T,C] and a second [B,T,C] input on a's device."""
    _lib.require_cuda(a, other)
    if a.dim() != 3 or other.shape != a.shape:
        raise ValueError(f"{what}: a {tuple(a.shape)} and "
                         f"{tuple(other.shape)} must be one [B,T,C] shape")
    return a.shape


def rglru_scan_kernel(a, g, h0=None):
    """a/g [B,T,C] of one dtype (fp32 or bf16), from the state ``h0``
    [B,C] fp32 (None: zero, the training path). Returns (y [B,T,C] fp32,
    hT [B,C] fp32); counted as ``rglru_scan_from`` when ``h0`` is
    given."""
    a, g = a.contiguous(), g.contiguous()
    B, T, C = _args(a, g, "rglru_scan")
    if a.dtype != g.dtype:
        raise TypeError(f"rglru_scan: a and g of one dtype, not {a.dtype}, "
                        f"{g.dtype}")
    if h0 is not None:
        h0 = h0.contiguous()
        _lib.require_cuda(a, h0)
        if h0.shape != (B, C) or h0.dtype != torch.float32:
            raise ValueError(f"rglru_scan: h0 {tuple(h0.shape)} {h0.dtype},"
                             f" not [{B},{C}] fp32")
    y = torch.empty((B, T, C), dtype=torch.float32, device=a.device)
    hT = torch.empty((B, C), dtype=torch.float32, device=a.device)
    rc = _lib.func("rglru_scan_fwd")(
        a.data_ptr(), g.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(),
        hT.data_ptr(), B, T, C, _lib.dtype_code(a), _lib.stream_of(a))
    what = "rglru_scan" if h0 is None else "rglru_scan_from"
    _lib.LAUNCHES[what] += 1
    _lib.check(rc, what)
    return y, hT


def rglru_scan_bwd_kernel(a, y, dy):
    """Backward of ``rglru_scan_kernel`` for a gradient ``dy`` of y: a,
    the forward's y and dy -> (da, dg) in a's dtype."""
    a, y, dy = a.contiguous(), y.contiguous(), dy.float().contiguous()
    B, T, C = _args(a, y, "rglru_scan_bwd")
    _args(a, dy, "rglru_scan_bwd")
    if y.dtype != torch.float32:
        raise TypeError(f"rglru_scan_bwd: y fp32, not {y.dtype}")
    da, dg = torch.empty_like(a), torch.empty_like(a)
    rc = _lib.func("rglru_scan_bwd")(
        a.data_ptr(), y.data_ptr(), dy.data_ptr(), da.data_ptr(),
        dg.data_ptr(), B, T, C, _lib.dtype_code(a), _lib.stream_of(a))
    _lib.LAUNCHES["rglru_scan_bwd"] += 1
    _lib.check(rc, "rglru_scan_bwd")
    return da, dg
