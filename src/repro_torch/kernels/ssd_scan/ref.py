"""Plain PyTorch versions of the Mamba-2 SSD chunked scan: what the op
runs for CPU tensors, and what the CUDA kernels are held against.

``ssd_chunked`` is the chunked form of the model (intra-chunk decay-
masked ``C·Bᵀ`` products, an inter-chunk ``[hd, S]`` state carry) with
``h0`` as an argument. ``ssd_scan_fwd_ref`` is the forward kernel's
function (``h0 = 0``, also returning the state before each chunk), and
``ssd_scan_bwd_ref`` the backward kernel's: autograd through the chunked
form. ``ssd_scan_ref`` is the sequential recurrence, the oracle of the
tests. ``ssd_scan_fwd_chunks_ref`` and ``ssd_scan_bwd_chunks_ref`` mirror
the bf16 kernels' algebra step by step, for the tests.
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


def ssd_scan_fwd_chunks_ref(x, dt, A, B, C, *, chunk: int, group: int = 8):
    """The bf16 forward kernels' algebra in plain PyTorch (fp32), step by
    step as csrc/ssd_scan.cu computes it; the same function as
    ``ssd_scan_fwd_ref``, for the tests. Per (batch row, chunk c, head),
    with s the chunk's cumsum of dt * A and L[t,j] = e^{s_t-s_j} (j <= t):

    1. the chunk's own state S_c = sum_j e^{s_end-s_j} dt_j x_j B_j^T
       goes into the states slot of chunk c+1, hT for the last chunk;
    2. the forward pass, in place: slot 0 = 0, slot c+1 = e^{s_end(c)}
       (slot c) + S_c, hT the final state;
    3. G = C B^T, made once per head group of ``group`` heads; per head
       y_t = sum_{j<=t} (G o L)_{tj} dt_j x_j + e^{s_t} C_t.h_c.

    Returns (y [Bs,T,H,hd], hT [Bs,H,hd,S], the state before each chunk
    [Bs,H,T/chunk,hd,S]), all fp32."""
    Bs, T, H, hd = x.shape
    S = B.shape[-1]
    nc = T // chunk
    f = torch.float32
    xs = x.reshape(Bs, nc, chunk, H, hd).to(f)
    dts = dt.reshape(Bs, nc, chunk, H).to(f)
    Bc = B.reshape(Bs, nc, chunk, S).to(f)
    Cc = C.reshape(Bs, nc, chunk, S).to(f)
    s = torch.cumsum(dts * A.to(f), dim=2)            # [B,nc,c,H]
    s_end = s[:, :, -1]                               # [B,nc,H]
    w = torch.exp(s_end[:, :, None] - s)

    # 1. each chunk's own state, into the next chunk's slot
    Sc = torch.einsum("bnjh,bnjhd,bnjs->bhnds", w * dts, xs, Bc)
    states = torch.empty((Bs, H, nc, hd, S), dtype=f, device=x.device)
    states[:, :, 1:] = Sc[:, :, :-1]
    hT = Sc[:, :, -1].clone()
    # 2. the forward pass, in place
    carry = torch.zeros_like(hT)
    for c in range(nc):
        own = states[:, :, c + 1].clone() if c + 1 < nc else hT
        states[:, :, c] = carry
        carry = torch.exp(s_end[:, c])[..., None, None] * carry + own
    hT = carry

    # 3. the chunk scan, G once per head group
    ar = torch.arange(chunk, device=x.device)
    tri = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    li = torch.where(tri, s[:, :, :, None, :] - s[:, :, None, :, :], 0.0)
    L = torch.where(tri, torch.exp(li), 0.0)          # [B,nc,t,j,H]
    hs = states.transpose(1, 2)                       # [B,nc,H,hd,S]
    y = torch.empty((Bs, nc, chunk, H, hd), dtype=f, device=x.device)
    for h0 in range(0, H, group):
        hg = slice(h0, h0 + group)
        G = torch.einsum("bnts,bnjs->bntj", Cc, Bc)
        M = G[..., None] * L[..., hg] * dts[:, :, None, :, hg]
        y[:, :, :, hg] = torch.einsum("bntjh,bnjhd->bnthd", M,
                                      xs[:, :, :, hg]) \
            + torch.exp(s[..., hg])[..., None] * torch.einsum(
                "bnts,bnhds->bnthd", Cc, hs[:, :, hg])
    return y.reshape(Bs, T, H, hd), hT, states


def ssd_scan_bwd_chunks_ref(x, dt, A, B, C, dy, *, chunk: int,
                            group: int = 8):
    """The bf16 backward kernels' algebra in plain PyTorch (fp32), step
    by step as csrc/ssd_scan.cu computes it; the same function as
    ``ssd_scan_bwd_ref``, for the tests. Per (batch row, chunk c, head),
    with s the chunk's cumsum of dt * A, L[t,j] = e^{s_t-s_j} (j <= t)
    and h_c the forward's state before the chunk:

    - D_c = sum_t e^{s_t} dy_t C_t^T, and the reverse carry R_c (the
      gradient of the state after chunk c): R_{c-1} = e^{s_end} R_c +
      D_c, R_last = 0;
    - G = C B^T of the chunk, one for every head;
    - dxd_j = sum_t G L dy_t + e^{s_end-s_j} R_c B_j, dx = dt dxd;
    - dB_j = sum_t N L dt_j C_t + e^{s_end-s_j} dt_j R_c^T x_j and dC_t
      = sum_j N L dt_j B_j + e^{s_t} h_c^T dy_t, with N = dy x^T, each
      summed over the ``group`` heads of a head group, then over the
      groups in order;
    - dloga_k, the sum of P(t,j) = G L N dt_j over the pairs j < k <= t,
      in four parts: inside the chunk, the exclusive prefix sum over k of
      (sum_{t>k} P(t,k) - sum_{j<k} P(k,j)); t here and j before (a
      suffix sum of u_t = e^{s_t} C_t.(h_c^T dy_t)); j here and t after
      (a prefix sum of v_j = e^{s_end-s_j} dt_j x_j.(R_c B_j)); j before
      and t after (e^{s_end} <R_c, h_c>);
    - ddt = A dloga + x.dxd, dA = sum dt dloga.

    Returns (dx, ddt, dA, dB, dC), each in its input's dtype."""
    Bs, T, H, hd = x.shape
    S = B.shape[-1]
    nc = T // chunk
    f = torch.float32
    _, _, states = ssd_scan_fwd_ref(x, dt, A, B, C, chunk=chunk)
    hs = states.transpose(1, 2)                       # [B,nc,H,hd,S]
    xs = x.reshape(Bs, nc, chunk, H, hd).to(f)
    dts = dt.reshape(Bs, nc, chunk, H).to(f)
    Bc = B.reshape(Bs, nc, chunk, S).to(f)
    Cc = C.reshape(Bs, nc, chunk, S).to(f)
    dys = dy.reshape(Bs, nc, chunk, H, hd).to(f)
    s = torch.cumsum(dts * A.to(f), dim=2)            # [B,nc,c,H]
    s_end = s[:, :, -1]                               # [B,nc,H]
    es, w = torch.exp(s), torch.exp(s_end[:, :, None] - s)

    # the carry: D_c, then the reverse pass over the chunks
    D = torch.einsum("bnth,bnthd,bnts->bnhds", es, dys, Cc)
    R = torch.empty_like(D)
    carry = torch.zeros_like(D[:, 0])
    for c in range(nc - 1, -1, -1):
        R[:, c] = carry
        carry = torch.exp(s_end[:, c])[..., None, None] * carry + D[:, c]

    G = torch.einsum("bnts,bnjs->bntj", Cc, Bc)       # shared by the heads
    ar = torch.arange(chunk, device=x.device)
    tri = (ar[:, None] >= ar[None, :])[None, None, :, :, None]
    li = torch.where(tri, s[:, :, :, None, :] - s[:, :, None, :, :], 0.0)
    L = torch.where(tri, torch.exp(li), 0.0)          # [B,nc,t,j,H]
    M = G[..., None] * L
    N = torch.einsum("bnthd,bnjhd->bntjh", dys, xs)
    Nd = N * L * dts[:, :, None]                      # dt_j on column j

    RB = torch.einsum("bnhds,bnjs->bnjhd", R, Bc)
    dxd = torch.einsum("bntjh,bnthd->bnjhd", M, dys) + w[..., None] * RB
    RX = torch.einsum("bnhds,bnjhd->bnjhs", R, xs)
    dB_h = torch.einsum("bntjh,bnts->bnjhs", Nd, Cc) \
        + (w * dts)[..., None] * RX
    hdy = torch.einsum("bnhds,bnthd->bnths", hs, dys)
    dC_h = torch.einsum("bntjh,bnjs->bnths", Nd, Bc) + es[..., None] * hdy
    groups = -(-H // group)
    dB = sum(dB_h[:, :, :, g * group:(g + 1) * group].sum(3)
             for g in range(groups))
    dC = sum(dC_h[:, :, :, g * group:(g + 1) * group].sum(3)
             for g in range(groups))

    P = G[..., None] * Nd                             # [B,nc,t,j,H]
    strict = (ar[:, None] > ar[None, :])[None, None, :, :, None]
    P = torch.where(strict, P, 0.0)
    col = P.sum(2)                                    # sum_{t>k} P(t,k)
    row = P.sum(3)                                    # sum_{j<k} P(k,j)
    intra = torch.cumsum(col - row, dim=2) - (col - row)
    u = es * (Cc[:, :, :, None] * hdy).sum(-1)
    usuf = torch.flip(torch.cumsum(torch.flip(u, [2]), 2), [2])
    v = w * dts * (xs * RB).sum(-1)
    vpre = torch.cumsum(v, 2) - v
    across = torch.exp(s_end) * (R * hs).sum((-1, -2))
    dloga = intra + usuf + vpre + across[:, :, None]

    ddt = A.to(f) * dloga + (xs * dxd).sum(-1)
    dA = (dts * dloga).sum((0, 1, 2))
    dx = (dts[..., None] * dxd).reshape(Bs, T, H, hd)
    return (dx.to(x.dtype), ddt.reshape(Bs, T, H).to(dt.dtype),
            dA.to(A.dtype), dB.reshape(Bs, T, S).to(B.dtype),
            dC.reshape(Bs, T, S).to(C.dtype))
