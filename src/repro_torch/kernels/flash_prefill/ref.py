"""Plain PyTorch versions of the paged flash-prefill kernel: what the
wrappers run for CPU tensors, and what the CUDA kernel is held against."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.cache import attention_with_lse, paged_gather


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
