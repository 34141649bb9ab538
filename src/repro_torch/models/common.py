"""Shared layer primitives (plain functions over tensors)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def init_linear(generator: torch.Generator, d_in: int, d_out: int, dtype,
                device) -> torch.Tensor:
    """U(-1/sqrt(d_in), 1/sqrt(d_in)) drawn in fp32, stored in ``dtype``
    (the JAX package's scale: full-width bf16 activations stay finite)."""
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((d_in, d_out), dtype=torch.float32, device=device)
    w.uniform_(-scale, scale, generator=generator)
    return w.to(dtype)


def init_embedding(generator: torch.Generator, vocab: int, d: int, dtype,
                   device) -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(0.0, 0.02, generator=generator)
    return w.to(dtype)


# RoPE -------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: [..., T] (int)."""
    if theta <= 0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [hd/2]
    ang = positions[..., None].float() * freqs               # [..., T, hd/2]
    ang = ang[..., None, :]                                  # [..., T, 1, hd/2]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(max_len: int, d: int, device=None) -> torch.Tensor:
    """Whisper's sinusoidal embeddings [max_len, d] in fp32: the sines of
    every frequency, then their cosines (concatenated, not
    interleaved)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    ang = pos * torch.exp(-math.log(10000.0) * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every
    x. ``F.softplus`` returns x itself above its threshold of 20, where
    logaddexp adds log1p(e^-x) < 2.1e-9, under half an fp32 unit of x;
    the same formula keeps the two packages' gradients alike as well."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# per-row valid lengths of a serving step (ragged recurrent rows) --------

def pad_mask(valid: torch.Tensor, T: int) -> torch.Tensor:
    """[B, T] bool: True at each row's positions at or past ``valid``
    [B] (the row's pads)."""
    return torch.arange(T, device=valid.device)[None] >= valid[:, None]


def conv_tail(full: torch.Tensor, n: int, valid=None) -> torch.Tensor:
    """The ``n`` rows of ``full`` [B, n + T, C] (a conv's carried prefix,
    then the T new rows) before each row's end: ``full[b, v : v + n]``
    at v = ``valid[b]``, the last n rows when ``valid`` is None. A row
    of 0 gets its prefix back unchanged."""
    if valid is None:
        return full[:, full.shape[1] - n:]
    idx = valid.long()[:, None] + torch.arange(n, device=full.device)[None]
    return torch.gather(full, 1, idx[..., None].expand(-1, -1,
                                                       full.shape[2]))


def keep_rows(new: torch.Tensor, old: torch.Tensor, valid=None):
    """``new`` where a row has a real position (``valid`` [B] > 0), else
    ``old`` bit for bit; ``new`` when ``valid`` is None."""
    if valid is None:
        return new
    live = (valid > 0).reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(live, new, old)
