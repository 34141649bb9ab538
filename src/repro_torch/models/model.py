"""Public model API: build a dense GQA, Mamba-2 or RecurrentGemma
architecture from its ArchConfig.

``Model.init`` makes the parameters as a plain dict of tensors, layers of
a group stacked on axis 0 as in the JAX package (so its parameters carry
over leaf for leaf, ``repro_torch.convert``). ``forward`` runs train,
prefill or decode with a cache backend; the JAX package scans each group
of layers, the port loops over them. Per-layer states (the paged KV pool
views) are written in place and returned as given. Train mode keeps the
autograd graph and, as the JAX package's ``remat``, recomputes each
layer's activations in the backward pass. Mamba-2 and RecurrentGemma
stacks run in train mode only: their serving states are not ported, and
asking for them raises (``check_serving``, ``layer_state``). Parameter
leaves keep the dtypes the JAX package gives them, so the RG-LRU's
decay and gate leaves stay fp32 in a bf16 model.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property, partial
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import TPContext
from repro_torch.device import resolve_device
from repro_torch.models import transformer as tfm


def _stack_into(per_layer, n: int):
    """Stack the first layer's tree with ``n - 1`` more drawn by
    ``per_layer(i)``, one layer alive at a time (full-width weights never
    sit in memory twice)."""
    first = per_layer(0)

    def alloc(t):
        if isinstance(t, dict):
            return {k: alloc(v) for k, v in t.items()}
        return t.new_empty((n,) + tuple(t.shape))

    def put(dst, src, i):
        if isinstance(src, dict):
            for k in src:
                put(dst[k], src[k], i)
        else:
            dst[i].copy_(src)

    out = alloc(first)
    put(out, first, 0)
    for i in range(1, n):
        put(out, per_layer(i), i)
    return out


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


@dataclass
class Model:
    cfg: ArchConfig
    dtype: torch.dtype = torch.bfloat16
    device: torch.device = torch.device("cpu")
    # rematerialize layer activations in the backward pass (training)
    remat: bool = True

    @cached_property
    def plan(self):
        plan = tfm.stack_plan(self.cfg)
        for kind_seq, _ in plan:
            for kind in kind_seq:
                tfm.check_kind(kind)
        return plan

    # ------------------------------------------------------------------
    # params
    # ------------------------------------------------------------------
    def init(self, generator: torch.Generator) -> Dict[str, Any]:
        """Seeded random parameters on ``self.device`` (the generator must
        live there too), drawn with the JAX package's scales."""
        cfg, dt, dev = self.cfg, self.dtype, self.device
        params: Dict[str, Any] = {
            "embed": tfm.init_embed(generator, cfg, dt, dev)}
        groups = []
        for kind_seq, n in self.plan:
            groups.append(tuple(
                _stack_into(lambda i, kind=kind: tfm.init_layer(
                    generator, cfg, kind, dt, dev), n)
                for kind in kind_seq))
        params["groups"] = groups
        return params

    # ------------------------------------------------------------------
    # per-layer cache/state construction
    # ------------------------------------------------------------------
    def layer_state(self, kind, *, ctx: TPContext, num_blocks: int,
                    page: int):
        """One layer's state: the (k, v) pool pair [num_blocks, page,
        kvh_local, hd], zeroed."""
        tfm.check_kind(kind, serving=True)
        shape = (num_blocks, page, ctx.local_units(self.cfg.num_kv_heads),
                 self.cfg.resolved_head_dim)
        return {"mixer": tuple(torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
                               for _ in range(2))}

    def check_serving(self) -> None:
        """Raise unless every layer kind of the stack can serve."""
        for kind_seq, _ in self.plan:
            for kind in kind_seq:
                tfm.check_kind(kind, serving=True)

    def init_states(self, *, ctx: TPContext, num_blocks: int, page: int):
        """Full stacked state tree aligned with the stack plan: per group,
        per kind, {"mixer": (k [n, ...], v [n, ...])}."""
        groups = []
        for kind_seq, n in self.plan:
            per_kind = []
            for kind in kind_seq:
                one = self.layer_state(kind, ctx=ctx, num_blocks=num_blocks,
                                       page=page)
                per_kind.append({"mixer": tuple(
                    t.new_zeros((n,) + tuple(t.shape))
                    for t in one["mixer"])})
            groups.append(tuple(per_kind))
        return groups

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, params, ctx: TPContext, *, mode: str, tokens,
                backend, states=None, positions=None, last_pos=None):
        """Returns (fp32 logits, states, aux_loss).

        mode: 'train' | 'prefill' | 'decode'. ``positions`` [B,T] absolute
        positions. ``last_pos`` [B] (prefill only): per-request index of
        the final real prompt token, so the sampled logits don't depend
        on batch padding; defaults to the padded window's last position.
        Serving ``states`` are updated in place and returned as given;
        train mode takes none, and is the only mode that records the
        autograd graph."""
        if mode == "train":
            if states is not None:
                raise ValueError("train mode runs without cache states")
            return self._forward(params, ctx, mode=mode, tokens=tokens,
                                 backend=backend, states=None,
                                 positions=positions, last_pos=None)
        with torch.no_grad():
            return self._forward(params, ctx, mode=mode, tokens=tokens,
                                 backend=backend, states=states,
                                 positions=positions, last_pos=last_pos)

    def _forward(self, params, ctx, *, mode, tokens, backend, states,
                 positions, last_pos):
        cfg = self.cfg
        x = tfm.embed_tokens(cfg, params["embed"], tokens, ctx)
        B, T = x.shape[0], x.shape[1]
        if positions is None:
            positions = torch.arange(T, device=x.device)[None].expand(B, T)
        remat = mode == "train" and self.remat
        for gi, (kind_seq, n) in enumerate(self.plan):
            p_group = params["groups"][gi]
            for li in range(n):
                for si, kind in enumerate(kind_seq):
                    st = None if states is None else tuple(
                        t[li] for t in states[gi][si]["mixer"])
                    layer = partial(tfm.apply_layer, cfg, kind,
                                    _index(p_group[si], li), ctx=ctx,
                                    backend=backend, state=st,
                                    positions=positions, mode=mode)
                    if remat:
                        x, _ = checkpoint(layer, x, use_reentrant=False)
                    else:
                        x, _ = layer(x)
        x = tfm.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
        if mode == "prefill":
            if last_pos is not None:
                x = x[torch.arange(B, device=x.device),
                      last_pos.long()][:, None, :]
            else:
                x = x[:, -1:]
        logits = tfm.lm_head(cfg, params["embed"], x, ctx)
        return logits, states, 0.0


def build_model(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """The model on the CUDA card, or on the CPU when asked for."""
    return Model(cfg, dtype, resolve_device(device))
