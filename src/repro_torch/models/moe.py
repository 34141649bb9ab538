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

In training (the train specs' layout, ``WeightsManager.train_dims``)
a TP rank may hold ``E / tp`` whole experts: the stored expert count
says which, and the rank computes its experts' share of every token of
its data shard, the psum summing the ranks' disjoint shares (where the
layout cuts neither E nor the expert d_ff, every rank computes it all
and the psum pre-scales by ``tp``). A training rank's tokens are one
dispatch group of the JAX package's per-data-shard dispatch
(``moe_groups = pods * data_rows``), so routing, positions, the
capacity and the scatter see only them.

Expert parallelism (serving at ``ctx.ep > 1``: experts stored over
'ed') follows the JAX package's: each 'ed' rank routes its slice of the
replicated tokens, one all_to_all over the 'ed' group takes each
expert's dispatch buffer to the rank that stores it and one brings the
outputs back, each rank writes its slice's rows and the layer's psum
over the TP group assembles them. It departs from it where the tokens
do not split over 'ed' (a decode step of fewer rows than 'ed' ranks):
the port pads them with zero rows to a multiple of ``ep`` and drops the
pads' outputs, so every token gets its experts, where the JAX package's
slices of ``N // ep`` tokens leave the last ``N % ep`` tokens with no
routed expert (ROADMAP.md, Queue 3). It needs
the 'ed' group bound into the ctx (``build_serve_step``'s ``ed``): the
engine passes its island seat's (``CommunicatorPool.seat``), the dry run
(``launch/dryrun.py``) its own.
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
        return _moe_ep(cfg, p, x, ctx)
    B, T, d = x.shape
    N, E, k = B * T, e.num_experts, e.top_k
    tokens = x.reshape(N, d)
    experts, weights, aux = route(p["router"], tokens, k)
    e_flat = experts.reshape(N * k).long()
    w_flat = weights.reshape(N * k)
    t_flat = torch.arange(N * k, device=x.device) // k
    pos = _positions_in_expert(e_flat, E).long()
    cap = capacity(cfg, N)
    # the experts this rank stores: a slice of E over 'model' (training)
    # or all of them
    El = p["e_gate"].shape[0]
    lo = ctx.stripe_index() * El if El < E else 0
    mine = (pos < cap) & (e_flat >= lo) & (e_flat < lo + El)
    slot = torch.where(mine, (e_flat - lo) * cap + pos, El * cap)
    buf = x.new_zeros((El * cap + 1, d))
    buf[slot] = tokens[t_flat]
    buf = buf[:-1].reshape(El, cap, d)
    wg = ctx.activate_view(p["e_gate"], 2)
    wu = ctx.activate_view(p["e_up"], 2)
    wd = ctx.activate_view(p["e_down"], 1)
    h = silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd)                        # [El, cap, d] partial
    flat_out = torch.cat([out.reshape(El * cap, d), out.new_zeros((1, d))])
    gathered = flat_out[slot] * w_flat[:, None].to(out.dtype)
    # entry i is choice i % k of token i // k: a token's k rows are
    # adjacent, so the scatter-add is a sum over them
    y = gathered.float().reshape(B, T, k, d).sum(dim=2)
    if ctx.tp > 1:
        # every rank computes every expert whole where neither E nor the
        # expert d_ff is cut
        whole = El == E and wg.shape[2] == e.d_ff_expert
        y = ctx.psum_scaled(y, ctx.tp if whole else 1)
    y = y.to(x.dtype)
    if e.num_shared_experts:
        y = y + mlp(p["shared"], x, ctx,
                    e.num_shared_experts * e.d_ff_expert)
    return y, aux


def _moe_ep(cfg: ArchConfig, p, x, ctx: TPContext):
    """``moe_ffn`` with the experts stored over 'ed' (module
    docstring)."""
    e = cfg.moe
    if ctx.ed_group is None:
        raise NotImplementedError(
            f"expert parallelism (ep={ctx.ep}) needs the island's 'ed' "
            f"group bound into the ctx, and the step was given none "
            f"(build_serve_step's run(..., ed=)); it does not fall back "
            f"to ep=1")
    B, T, d = x.shape
    N, E, k, ep = B * T, e.num_experts, e.top_k, ctx.ep
    Nl, El = -(-N // ep), E // ep
    tokens = x.reshape(N, d)
    if N % ep:
        tokens = torch.cat([tokens, tokens.new_zeros((Nl * ep - N, d))])
    off = ctx.ep_rank() * Nl
    tokens = tokens[off:off + Nl]
    experts, weights, aux = route(p["router"], tokens, k)
    e_flat = experts.reshape(Nl * k).long()
    w_flat = weights.reshape(Nl * k)
    t_flat = torch.arange(Nl * k, device=x.device) // k
    pos = _positions_in_expert(e_flat, E).long()
    cap = capacity(cfg, Nl)
    slot = torch.where(pos < cap, e_flat * cap + pos, E * cap)
    buf = x.new_zeros((E * cap + 1, d))
    buf[slot] = tokens[t_flat]
    # [E, cap, d]: expert block j to 'ed' rank j, which returns
    # [ep, El, cap, d], the senders in rank order -> [El, ep * cap, d]
    got = ctx.ed_group.all_to_all(buf[:-1].reshape(E, cap, d))
    buf = got.reshape(ep, El, cap, d).transpose(0, 1).reshape(El, ep * cap,
                                                               d)
    wg = ctx.activate_view(p["e_gate"], 2)
    wu = ctx.activate_view(p["e_up"], 2)
    wd = ctx.activate_view(p["e_down"], 1)
    h = silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    out = torch.bmm(h, wd)                  # [El, ep * cap, d] partial
    back = out.reshape(El, ep, cap, d).transpose(0, 1)
    out = ctx.ed_group.all_to_all(back).reshape(E * cap, d)
    flat_out = torch.cat([out, out.new_zeros((1, d))])
    gathered = flat_out[slot] * w_flat[:, None].to(out.dtype)
    y = torch.zeros((Nl * ep, d), dtype=torch.float32, device=x.device)
    y[off:off + Nl] = gathered.float().reshape(Nl, k, d).sum(dim=1)
    y = ctx.psum_scaled(y[:N].reshape(B, T, d), 1).to(x.dtype)
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
