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
