"""Plain PyTorch versions of the flash-prefill kernels: what the wrappers
run for CPU tensors, and what the CUDA kernels are held against. The
paged chunked-prefill sweep (serving) and the dense causal attention of
the training path, forward and backward."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.cache import (attention_with_lse, causal_attention,
                                      causal_mask, paged_gather)


def paged_prefill_sweep_with_lse_ref(q, k_pool, v_pool, block_table,
                                     prior_len, *, prior_only: bool = False,
                                     window: Optional[int] = None,
                                     softmax_scale: Optional[float] = None):
    """q [B,T,H,hd] with q[:, i] at absolute position prior_len[b] + i;
    pools [nblk,page,KV,hd] already holding the chunk's rows; block_table
    [B,MB]; prior_len [B]. Returns (out [B,T,H,hd] fp32, lse [B,H,T]
    fp32). The mask is the causal chunked-prefill sweep ``kpos <= qpos``
    or, with ``prior_only``, exactly the first ``prior_len[b]`` keys (a
    segment that lies wholly in the past). Rows with nothing to attend
    get a zero output and lse ``NEG_INF``."""
    B, T, H, hd = q.shape
    scale = softmax_scale if softmax_scale is not None else hd ** -0.5
    k = paged_gather(k_pool, block_table)              # [B,Tk,KV,hd]
    v = paged_gather(v_pool, block_table)
    prior = prior_len.long()
    qpos = prior[:, None] + torch.arange(T, device=q.device)[None, :]
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    if prior_only:
        mask = (kpos < prior[:, None, None]).expand(B, T, k.shape[1])
    else:
        mask = kpos <= qpos[:, :, None]
    if window is not None:
        mask = mask & (kpos > qpos[:, :, None] - window)
    return attention_with_lse(q, k, v, mask[:, None], scale)


def paged_flash_prefill_ref(q, k_pool, v_pool, block_table, prior_len, *,
                            window: Optional[int] = None,
                            softmax_scale: Optional[float] = None):
    """The causal sweep -> [B,T,H,hd] in q's dtype."""
    out, _ = paged_prefill_sweep_with_lse_ref(
        q, k_pool, v_pool, block_table, prior_len, window=window,
        softmax_scale=softmax_scale)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# dense causal attention (the training path)
# ---------------------------------------------------------------------------

def flash_prefill_ref(q, k, v, *, window: Optional[int] = None):
    """q [B,T,H,hd]; k/v [B,T,KV,hd]; causal (+ window) -> [B,T,H,hd] in
    q's dtype, scaled by hd^-0.5."""
    return causal_attention(q, k, v, window=window)


def flash_prefill_fwd_ref(q, k, v, *, window: Optional[int] = None):
    """The forward kernel's function: (out [B,T,H,hd] in q's dtype, lse
    [B,H,T] fp32, the log-sum-exp of each row's scaled scores)."""
    T, hd = q.shape[1], q.shape[-1]
    mask = causal_mask(T, window=window, device=q.device)
    out, lse = attention_with_lse(q, k, v, mask[None, None], hd ** -0.5)
    return out.to(q.dtype), lse


def flash_prefill_bwd_ref(q, k, v, out, lse, dout, *,
                          window: Optional[int] = None):
    """The backward kernel's function, written as its formula: with S =
    Q K^T * scale, P = exp(S - lse) on live keys, D = rowsum(dO * O),
    dS = P * (dO V^T - D): dQ = scale * dS K, dK = scale * dS^T Q,
    dV = P^T dO, GQA heads summed onto their kv head. Returns (dq, dk,
    dv) in the inputs' dtypes; all sums in fp32."""
    B, T, H, hd = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = hd ** -0.5
    qg = q.float().reshape(B, T, KV, rep, hd)
    dog = dout.float().reshape(B, T, KV, rep, hd)
    kf, vf = k.float(), v.float()
    mask = causal_mask(T, window=window, device=q.device)
    s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale
    lse_g = lse.reshape(B, KV, rep, T)[..., None]
    p = torch.where(mask, torch.exp(s - lse_g), 0.0)
    dv = torch.einsum("bgrqk,bqgrd->bkgd", p, dog)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf)
    d = (dout.float() * out.float()).sum(-1)               # [B,T,H]
    d = d.reshape(B, T, KV, rep).permute(0, 2, 3, 1)[..., None]
    ds = p * (dp - d)
    dq = torch.einsum("bgrqk,bkgd->bqgrd", ds, kf) * scale
    dk = torch.einsum("bgrqk,bqgrd->bkgd", ds, qg) * scale
    return (dq.reshape(B, T, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
