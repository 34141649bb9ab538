"""Plain PyTorch versions of the Mamba-2 SSD chunked scan: what the op
runs for CPU tensors, and what the CUDA kernels are held against.

``ssd_chunked`` is the chunked form of the model (intra-chunk decay-
masked ``C·Bᵀ`` products, an inter-chunk ``[hd, S]`` state carry) with
``h0`` as an argument. ``ssd_scan_fwd_ref`` is the forward kernel's
function (``h0 = 0``, also returning the state before each chunk), and
``ssd_scan_bwd_ref`` the backward kernel's: autograd through the chunked
form. ``ssd_scan_ref`` is the sequential recurrence, the oracle of the
tests.
"""
from __future__ import annotations

import torch


def _chunked(xh, dt, A, Bm, Cm, h0, chunk: int):
    """The chunked scan -> (y [B,T,H,hd] fp32, hT [B,H,hd,S] fp32, the
    state before each chunk [B,H,nc,hd,S] fp32)."""
    Bsz, T, H, hd = xh.shape
    S = Bm.shape[-1]
    nc = T // chunk
    xs = xh.reshape(Bsz, nc, chunk, H, hd).float()
    dts = dt.reshape(Bsz, nc, chunk, H).float()
    Bs = Bm.reshape(Bsz, nc, chunk, S).float()
    Cs = Cm.reshape(Bsz, nc, chunk, S).float()

    loga = dts * A.float()[None, None, None]          # [B,nc,c,H] (<= 0)
    s = torch.cumsum(loga, dim=2)                     # within each chunk
    # intra-chunk: Y[i] = C_i . sum_{j<=i} exp(s_i - s_j) dt_j B_j x_j^T
    li = s[:, :, :, None, :] - s[:, :, None, :, :]    # [B,nc,ci,cj,H]
    ar = torch.arange(chunk, device=xh.device)
    tri = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    # clamp BEFORE exp: masked entries have li > 0 and exp(li) could be
    # inf, poisoning the backward pass through where (NaN = inf * 0)
    li = torch.where(tri, li, 0.0)
    L = torch.where(tri, torch.exp(li), 0.0)
    cb = torch.einsum("bncs,bnjs->bncj", Cs, Bs)      # [B,nc,ci,cj]
    y_intra = torch.einsum("bncjh,bnjh,bnjhd->bnchd", cb[..., None] * L,
                           dts, xs)

    # chunk summaries: S_n = sum_j exp(s_last - s_j) dt_j B_j x_j^T
    decay_out = torch.exp(s[:, :, -1:, :] - s)        # [B,nc,c,H]
    ssum = torch.einsum("bnjh,bnjh,bnjhd,bnjs->bnhds", decay_out, dts, xs,
                        Bs)                           # [B,nc,H,hd,S]
    chunk_decay = torch.exp(s[:, :, -1, :])           # [B,nc,H]
    h = h0.float()
    prev = []
    for n in range(nc):
        prev.append(h)
        h = h * chunk_decay[:, n, :, None, None] + ssum[:, n]
    h_prev = torch.stack(prev, dim=1)                 # [B,nc,H,hd,S]
    y_inter = torch.einsum("bncs,bnch,bnhds->bnchd", Cs, torch.exp(s),
                           h_prev)
    y = (y_intra + y_inter).reshape(Bsz, T, H, hd)
    return y, h, h_prev.transpose(1, 2)


def ssd_chunked(xh, dt, A, Bm, Cm, h0, chunk: int):
    """Chunked SSD scan, the model's form. xh [B,T,H,hd]; dt [B,T,H]
    (softplus'ed, fp32); A [H] (negative); Bm/Cm [B,T,S]; h0 [B,H,hd,S]
    fp32; T a multiple of ``chunk``. Returns (y [B,T,H,hd] fp32, hT)."""
    y, hT, _ = _chunked(xh, dt, A, Bm, Cm, h0, chunk)
    return y, hT


def ssd_scan_fwd_ref(x, dt, A, B, C, *, chunk: int):
    """The forward kernel's function, h0 = 0, T a multiple of ``chunk``:
    (y [Bs,T,H,hd] fp32, hT [Bs,H,hd,S] fp32, the state before each chunk
    [Bs,H,T/chunk,hd,S] fp32)."""
    return _chunked(x, dt, A, B, C, _zero_state(x, B), chunk)


def _zero_state(x, B):
    Bs, _, H, hd = x.shape
    return torch.zeros((Bs, H, hd, B.shape[-1]), dtype=torch.float32,
                       device=x.device)


def ssd_scan_bwd_ref(x, dt, A, B, C, dy, *, chunk: int):
    """The backward kernel's function: the gradients (dx, ddt, dA, dB,
    dC) of ``<dy, y>``, y the forward's output, each in its input's
    dtype; autograd through the chunked form in fp32."""
    ins = [t.detach().requires_grad_(True) for t in (x, dt, A, B, C)]
    with torch.enable_grad():
        y, _, _ = _chunked(*ins, _zero_state(x, B), chunk)
        grads = torch.autograd.grad(y, ins, dy.float())
    return tuple(g.to(t.dtype) for g, t in zip(grads, (x, dt, A, B, C)))


def ssd_scan_ref(x, dt, A, B, C, h0):
    """The sequential recurrence (the oracle): x [Bs,T,H,hd]; dt [Bs,T,H]
    (> 0, fp32); A [H] (< 0); B/C [Bs,T,S]; h0 [Bs,H,hd,S] fp32 -> (y
    [Bs,T,H,hd] fp32, hT)."""
    xf, Bf, Cf = x.float(), B.float(), C.float()
    h = h0.float()
    ys = []
    for t in range(x.shape[1]):
        a = torch.exp(dt[:, t] * A[None])                   # [Bs,H]
        h = h * a[..., None, None] + torch.einsum(
            "bh,bhd,bs->bhds", dt[:, t], xf[:, t], Bf[:, t])
        ys.append(torch.einsum("bs,bhds->bhd", Cf[:, t], h))
    return torch.stack(ys, dim=1), h
