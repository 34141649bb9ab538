"""Mixture-of-Experts FFN: top-k routing and capacity-factor dispatch.

The JAX package's layer (``src/repro/models/moe.py``), tensor op for
tensor op. Routing is an fp32 softmax router with top-k, the k weights
renormalised; each (token, choice) entry takes the next place in its
expert's arrival order, and entries past the expert's capacity
``ceil(N k / E * capacity_factor)`` (at least 8, rounded up to 8) are
dropped, as in Switch/GShard. The experts run as batched products over
``[E, cap, d]``; shared experts are one gated MLP of width
``num_shared * d_ff_expert``. Under TP each expert's d_ff is the rank's
slice (storage over 'model' by the weights manager, the merge view
here), so the layer's one psum sums disjoint partials. Nothing here is
a kernel: the JAX package computes it outside any Pallas call, and the
products go to ``torch.bmm``.

Expert parallelism (``ctx.ep > 1``: experts stored over 'ed', an
all_to_all of the dispatch buffers) raises: no real-execution
reference script runs it yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import SINGLE, TPContext
from repro_torch.models.common import init_linear, silu
from repro_torch.models.ffn import init_mlp, mlp


def init_moe(generator, cfg: ArchConfig, dtype, device):
    e, d = cfg.moe, cfg.d_model
    p = {"router": init_linear(generator, d, e.num_experts, torch.float32,
                               device),
         "e_gate": _init_experts(generator, e.num_experts, d, e.d_ff_expert,
                                 dtype, device),
         "e_up": _init_experts(generator, e.num_experts, d, e.d_ff_expert,
                               dtype, device),
         "e_down": _init_experts(generator, e.num_experts, e.d_ff_expert, d,
                                 dtype, device)}
    if e.num_shared_experts:
        p["shared"] = init_mlp(generator, d,
                               e.num_shared_experts * e.d_ff_expert, dtype,
                               device)
    return p


def _init_experts(generator, E: int, d_in: int, d_out: int, dtype, device):
    scale = 1.0 / math.sqrt(d_in)
    w = torch.empty((E, d_in, d_out), dtype=torch.float32, device=device)
    w.uniform_(-scale, scale, generator=generator)
    return w.to(dtype)


def _positions_in_expert(e_flat: torch.Tensor,
                         num_experts: int) -> torch.Tensor:
    """Rank of each entry within its expert's arrival order (entries in
    flat token-major order, choice-minor), O(M log M)."""
    M = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    starts = torch.searchsorted(
        se, torch.arange(num_experts, device=se.device, dtype=se.dtype))
    pos_sorted = torch.arange(M, device=se.device) - starts[se.long()]
    out = torch.zeros((M,), dtype=torch.int32, device=se.device)
    out[order] = pos_sorted.to(torch.int32)
    return out


def route(p_router, x_tokens, top_k: int):
    """x_tokens [N,d] -> (experts [N,k] int32, weights [N,k] fp32, aux):
    the top-k of the fp32 softmax router, ties to the lower expert index
    as ``lax.top_k``, weights renormalised; aux is the Switch load-balance
    loss."""
    logits = x_tokens.float() @ p_router.float()                  # [N,E]
    probs = torch.softmax(logits, dim=-1)
    w, e = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, e = w[:, :top_k], e[:, :top_k]
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    E = logits.shape[-1]
    frac = torch.nn.functional.one_hot(e[:, 0], E).float().mean(dim=0)
    aux = E * torch.sum(frac * probs.mean(dim=0))
    return e.to(torch.int32), w, aux


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Slots an expert holds for ``n_tokens`` tokens: ceil(N k / E * cf),
    at least 8, rounded up to a multiple of 8."""
    e = cfg.moe
    cap = max(8, int(math.ceil(n_tokens * e.top_k / e.num_experts
                               * e.capacity_factor)))
    return -(-cap // 8) * 8


def moe_ffn(cfg: ArchConfig, p, x, ctx: TPContext):
    """x [B,T,d] replicated over the TP group -> (y [B,T,d] replicated,
    aux)."""
    e = cfg.moe
    if ctx.ep > 1:
        raise NotImplementedError(
            "expert parallelism over 'ed' (engine_rows > 1) is not ported: "
            "no real-execution reference script runs it (ROADMAP.md, "
            "Queue 1); serve MoE models at engine_rows 1")
    B, T, d = x.shape
    N, E, k = B * T, e.num_experts, e.top_k
    tokens = x.reshape(N, d)
    experts, weights, aux = route(p["router"], tokens, k)
    e_flat = experts.reshape(N * k)
    w_flat = weights.reshape(N * k)
    t_flat = torch.arange(N * k, device=x.device) // k
    pos = _positions_in_expert(e_flat, E)
    cap = capacity(cfg, N)
    slot = torch.where(pos < cap, e_flat.long() * cap + pos.long(), E * cap)
    buf = x.new_zeros((E * cap + 1, d))
    buf[slot] = tokens[t_flat]
    buf = buf[:-1].reshape(E, cap, d)
    wg = ctx.activate_view(p["e_gate"], 2)
    wu = ctx.activate_view(p["e_up"], 2)
    wd = ctx.activate_view(p["e_down"], 1)
    h = silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd)                        # [E, cap, d] partial
    flat_out = torch.cat([out.reshape(E * cap, d), out.new_zeros((1, d))])
    gathered = flat_out[slot] * w_flat[:, None].to(out.dtype)
    # entry i is choice i % k of token i // k: a token's k rows are
    # adjacent, so the scatter-add is a sum over them
    y = gathered.float().reshape(B, T, k, d).sum(dim=2)
    y = (ctx.psum(y) if ctx.tp > 1 else y).to(x.dtype)
    if e.num_shared_experts:
        y = y + mlp(p["shared"], x, ctx,
                    e.num_shared_experts * e.d_ff_expert)
    return y, aux


def dense_moe_ref(cfg: ArchConfig, p, x):
    """Every token through its top-k experts: no capacity, no
    parallelism (the tests' bound on what dispatch drops)."""
    e = cfg.moe
    B, T, d = x.shape
    tokens = x.reshape(-1, d)
    experts, weights, aux = route(p["router"], tokens, e.top_k)
    h_all = torch.einsum("nd,edf->enf", tokens, p["e_gate"])
    u_all = torch.einsum("nd,edf->enf", tokens, p["e_up"])
    o_all = torch.einsum("enf,efd->end", silu(h_all) * u_all, p["e_down"])
    sel = torch.gather(o_all.transpose(0, 1), 1,
                       experts.long()[..., None].expand(-1, -1, d))
    y = (sel * weights[..., None].to(sel.dtype)).sum(dim=1)
    y = y.reshape(B, T, d).to(x.dtype)
    if e.num_shared_experts:
        y = y + mlp(p["shared"], x, SINGLE,
                    e.num_shared_experts * e.d_ff_expert)
    return y, aux
