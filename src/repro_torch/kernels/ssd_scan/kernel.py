"""CUDA wrappers of the Mamba-2 SSD chunked scan (csrc/ssd_scan.cu),
forward and backward. Each validates, allocates outputs and scratch,
launches on the current stream, counts the launch and raises on a launch
error. CUDA tensors only; ``ops`` routes CPU tensors to the plain
versions.

Replaces the TPU kernel ``ssd_scan_kernel``
(src/repro/kernels/ssd_scan/kernel.py:67), a grid over (batch, head,
chunk) whose chunk axis ran in order with the state in VMEM scratch; the
backward has no TPU counterpart (XLA autodiff in the JAX package). On
the H100 the training shape (Bs 4, T 2048, H 80, hd 64, S 128) is
bytes-bound, at about 0.08 ms for the forward's 0.27 GB, while its 54
GFLOP would take 0.054 ms at the bf16 tensor-core rate. Both directions
dispatch by dtype. fp32 runs kernels whose products are on the CUDA
cores in fp32 (the forward one block per (head, batch row) sweeping the
chunks with the state in shared memory), bound by that arithmetic; bf16
x, B and C run chunk-parallel kernels on the tensor cores, one block per
(chunk, batch row, head group), with C·Bᵀ made once per head group. The
head file of ssd_scan.cu says how the work is tiled.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib

_HD = (32, 64)
_S = (32, 128)


def _args(x, dt, A, B, C, chunk: int):
    """Validate x [Bs,T,H,hd], dt [Bs,T,H] fp32, A [H] fp32, B/C [Bs,T,S]
    (x, B, C of one dtype), T a multiple of ``chunk`` <= 128."""
    _lib.require_cuda(x, dt, A, B, C)
    Bs, T, H, hd = x.shape
    S = B.shape[-1]
    if dt.shape != (Bs, T, H) or A.shape != (H,) or B.shape != (Bs, T, S) \
            or C.shape != B.shape:
        raise ValueError(f"ssd_scan: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32 \
            or not x.dtype == B.dtype == C.dtype:
        raise TypeError(f"ssd_scan: dt and A fp32, x, B, C of one dtype, "
                        f"not {dt.dtype}, {A.dtype}, {x.dtype}, {B.dtype}, "
                        f"{C.dtype}")
    if hd not in _HD or S not in _S:
        raise ValueError(f"ssd_scan kernels take hd in {_HD} and S in "
                         f"{_S}, not hd={hd}, S={S}")
    if not 0 < chunk <= 128 or T % chunk:
        raise ValueError(f"ssd_scan kernels take a chunk of 1-128 dividing "
                         f"T, not chunk={chunk}, T={T}")
    return Bs, T, H, hd, S


def ssd_scan_kernel(x, dt, A, B, C, *, chunk: int, group=None, h0=None):
    """From the state ``h0`` [Bs,H,hd,S] fp32 (None: zero, the training
    path). Returns (y [Bs,T,H,hd] fp32, hT [Bs,H,hd,S] fp32, the state
    before each chunk [Bs,H,T/chunk,hd,S] fp32, which the backward
    reads). Two routes by dtype, one launch count (``ssd_scan_from`` when
    ``h0`` is given): bf16 x, B, C run the tensor-core kernels (``group``
    heads a block, ``head_group``'s choice unless given: tests only);
    fp32 runs the CUDA-core kernel."""
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    Bs, T, H, hd, S = _args(x, dt, A, B, C, chunk)
    if h0 is not None:
        h0 = _lib.aligned(h0.contiguous())
        _lib.require_cuda(x, h0)
        if h0.shape != (Bs, H, hd, S) or h0.dtype != torch.float32:
            raise ValueError(f"ssd_scan: h0 {tuple(h0.shape)} {h0.dtype}, "
                             f"not [{Bs},{H},{hd},{S}] fp32")
    h0p = h0.data_ptr() if h0 is not None else None
    nc = T // chunk
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((Bs, T, H, hd), **f32)
    hT = torch.empty((Bs, H, hd, S), **f32)
    states = torch.empty((Bs, H, nc, hd, S), **f32)
    if x.dtype == torch.bfloat16:
        send = torch.empty((Bs, H, nc), **f32)
        rc = _lib.func("ssd_scan_fwd_tc")(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), h0p, y.data_ptr(), hT.data_ptr(),
            states.data_ptr(), send.data_ptr(), Bs, T, H, hd, S, chunk,
            group or head_group(Bs, nc, H, x.device), _lib.stream_of(x))
    else:
        rc = _lib.func("ssd_scan_fwd")(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), h0p, y.data_ptr(), hT.data_ptr(),
            states.data_ptr(), Bs, T, H, hd, S, chunk, _lib.dtype_code(x),
            _lib.stream_of(x))
    what = "ssd_scan" if h0 is None else "ssd_scan_from"
    _lib.LAUNCHES[what] += 1
    _lib.check(rc, what)
    return y, hT, states


_SMS = {}
MAX_GROUP = 10      # heads of a head group of the bf16 kernels


def head_group(Bs: int, nc: int, H: int, device) -> int:
    """Heads per block of the bf16 kernels (forward and backward), one
    block per (chunk, batch row, head group), counted as one block on an
    SM at a time (the forward's ``chunk_state_tc`` fits two). A block's
    time is about one head's work for each head of its group plus one
    for its set-up (B and C staged, G = C B^T; in the backward one fp32
    part of dB and dC written), so the group size of at most
    ``MAX_GROUP`` whose waves of blocks cost the least (waves x (group +
    1)) wins, the larger group on a tie."""
    sms = _SMS.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = sms
    best = (None, 1)
    for g in range(1, min(H, MAX_GROUP) + 1):
        cost = -(-Bs * nc * -(-H // g) // sms) * (g + 1)
        if best[0] is None or cost <= best[0]:
            best = (cost, g)
    return best[1]


def ssd_scan_bwd_kernel(x, dt, A, B, C, states, dy, *, chunk: int,
                        group=None):
    """Backward of ``ssd_scan_kernel`` for a gradient ``dy`` of y: the
    forward's inputs and states -> (dx, ddt, dA, dB, dC), each in its
    input's dtype. Two routes by dtype, one launch count: bf16 x, B, C run
    the tensor-core kernels (``group`` heads a block, ``head_group``'s
    choice unless given: tests only), whose per-chunk parts of dA are
    summed here; fp32 runs the CUDA-core kernels, whose per-head parts of
    dB and dC and per-row parts of dA are summed here."""
    x, dt, A, B, C = (t.contiguous() for t in (x, dt, A, B, C))
    states, dy = states.contiguous(), dy.float().contiguous()
    Bs, T, H, hd, S = _args(x, dt, A, B, C, chunk)
    _lib.require_cuda(x, states, dy)
    nc = T // chunk
    if dy.shape != x.shape or states.shape != (Bs, H, nc, hd, S) \
            or states.dtype != torch.float32:
        raise ValueError("ssd_scan_bwd: dy must be [Bs,T,H,hd], states "
                         "[Bs,H,T/chunk,hd,S] fp32")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    ddt = torch.empty((Bs, T, H), **f32)
    ub = torch.empty((Bs, T, H), **f32)
    if x.dtype == torch.bfloat16:
        g = group or head_group(Bs, nc, H, x.device)
        groups = -(-H // g)
        dAp = torch.empty((Bs, H, nc), **f32)
        dB, dC = torch.empty_like(B), torch.empty_like(C)
        dBp = torch.empty((groups, Bs, T, S), **f32)
        dCp = torch.empty((groups, Bs, T, S), **f32)
        Dc = torch.empty((Bs, H, nc, hd, S), **f32)
        send = torch.empty((Bs, H, nc), **f32)
        rc = _lib.func("ssd_scan_bwd_tc")(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), states.data_ptr(), dy.data_ptr(), dx.data_ptr(),
            ddt.data_ptr(), dAp.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            dBp.data_ptr(), dCp.data_ptr(), ub.data_ptr(), Dc.data_ptr(),
            send.data_ptr(), Bs, T, H, hd, S, chunk, g, _lib.stream_of(x))
        _lib.LAUNCHES["ssd_scan_bwd"] += 1
        _lib.check(rc, "ssd_scan_bwd")
        return dx, ddt, dAp.sum((0, 2)), dB, dC
    dAp = torch.empty((Bs, H), **f32)
    dBp = torch.empty((Bs, H, T, S), **f32)
    dCp = torch.empty((Bs, H, T, S), **f32)
    rc = _lib.func("ssd_scan_bwd")(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), states.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dAp.data_ptr(), dBp.data_ptr(), dCp.data_ptr(),
        ub.data_ptr(), Bs, T, H, hd, S, chunk, _lib.dtype_code(x),
        _lib.stream_of(x))
    _lib.LAUNCHES["ssd_scan_bwd"] += 1
    _lib.check(rc, "ssd_scan_bwd")
    return (dx, ddt, dAp.sum(0), dBp.sum(1).to(B.dtype),
            dCp.sum(1).to(C.dtype))
