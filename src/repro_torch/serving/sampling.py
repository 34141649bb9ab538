"""Token sampling over full-vocab logits (greedy / temperature / top-k),
drawn bit for bit as the JAX package draws them.

The JAX package samples row ``b`` as
``jax.random.categorical(jax.random.PRNGKey(seeds[b]), logits[b])``
(with ``jax_threefry_partitionable``, jax's default). Written out, for a
row of ``V`` logits and a uint32 seed ``s``:

- the key is ``(0, s)``;
- element ``i`` takes ``bits1, bits2 = threefry2x32(key, (hi(i), lo(i)))``
  and its 32 random bits are ``bits1 ^ bits2``;
- a uniform in ``[1, 2)`` is those bits' top 23 as the mantissa of an
  exponent-0 float32, minus 1, scaled into ``[tiny, 1)``;
- Gumbel noise is ``-log(-log(u))``;
- the token is ``argmax(gumbel + logits)``, the first index among ties.

Here the same steps run as torch tensor ops over a whole ``[B, V]``
batch on the logits' device. torch's ``uint32`` lacks the arithmetic,
so threefry's 20 rounds work on int64 tensors masked to 32 bits. No
launch counter: this is plain torch, not a kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1: torch.Tensor, x2: torch.Tensor):
    """Threefry-2x32 with 20 rounds (jax's ``threefry2x32_p``). Keys and
    counts are int64 tensors (or ints) holding uint32 values; they
    broadcast against each other. Returns the two uint32 words, as
    int64."""
    k1 = torch.as_tensor(k1, dtype=torch.int64, device=x1.device) & _MASK
    k2 = torch.as_tensor(k2, dtype=torch.int64, device=x1.device) & _MASK
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & _MASK
    b = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _MASK
        b = (b + ks[(i + 2) % 3] + i + 1) & _MASK
    return a, b


def random_bits(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, n]`` uint32 values (as int64): row ``b`` is
    ``jax.random.bits(PRNGKey(seeds[b]), (n,))``."""
    seeds = seeds.to(torch.int64).reshape(-1, 1) & _MASK
    count = torch.arange(n, dtype=torch.int64, device=seeds.device)
    b1, b2 = threefry2x32(0, seeds, count >> 32, count & _MASK)
    return b1 ^ b2


def uniform(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, n]`` float32 in ``[tiny, 1)``: jax's ``_uniform`` with
    ``minval=tiny``, as its ``gumbel`` draws it."""
    bits = (random_bits(seeds, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_TINY, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (1.0 - lo) + lo)


def gumbel(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """``[B, n]`` float32 Gumbel noise, jax's default ("low") mode."""
    return -torch.log(-torch.log(uniform(seeds, n)))


def categorical(seeds: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per row of ``logits`` [B, V] (float32): row ``b`` is
    ``jax.random.categorical(PRNGKey(seeds[b]), logits[b])``. int64
    [B]."""
    return torch.argmax(gumbel(seeds, logits.shape[-1]) + logits, dim=-1)


def sample(logits: torch.Tensor, *, seeds: Optional[torch.Tensor] = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits [B, V] fp32 -> token ids [B] int32. ``temperature <= 0`` is
    greedy; otherwise the logits are divided by the temperature, masked
    below their ``top_k``-th value when ``top_k`` is set, and drawn with
    each row's seed from ``seeds`` [B]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    # a tensor divisor: a Python scalar turns into a multiplication by
    # its reciprocal on the card, which rounds differently
    logits = logits.float() / torch.tensor(temperature, dtype=torch.float32,
                                           device=logits.device)
    if top_k:
        cutoff = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < cutoff, float("-inf"), logits)
    if seeds is None:
        raise ValueError("temperature sampling needs per-row seeds")
    return categorical(seeds, logits).to(torch.int32)
