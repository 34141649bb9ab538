"""Public model API: build a dense GQA, MLA/MoE, Mamba-2, RecurrentGemma,
whisper (enc-dec) or InternVL2 (vision prefix) architecture from its
ArchConfig.

``Model.init`` makes the parameters as a plain dict of tensors, layers of
a group stacked on axis 0 as in the JAX package (so its parameters carry
over leaf for leaf, ``repro_torch.convert``). ``forward`` runs train,
prefill or decode with a cache backend; the JAX package scans each group
of layers, the port loops over them. Per-layer states (the paged KV pool
views) are written in place and returned as given. Train mode keeps the
autograd graph and, as the JAX package's ``remat``, recomputes each
layer's activations in the backward pass. A Mamba-2 or RG-LRU layer's
serving state is its batch-dense recurrent rows (row b is the step's
batch row b), updated in place too. A MoE stack (DeepSeek-V2,
Phi-3.5-MoE) returns the sum of its layers' load-balance losses as
``forward``'s aux loss (0.0 for a stack without MoE). Parameter
leaves keep the dtypes the JAX package gives them, so the RG-LRU's
decay and gate leaves stay fp32 in a bf16 model.

The modality frontends are stubs, as in the JAX package: ``forward``
takes their precomputed embeddings (``frontend_embeds``, in the model's
dtype). Whisper's run through the bidirectional encoder (its layers a
list, ``params["encoder"]``), whose output every decoder layer
cross-attends to; a prefill writes each layer's cross K/V into its
``"cross"`` state, which the decode steps read. InternVL2's patches go
through ``embed.projector`` and precede the token embeddings.
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
from repro_torch.models import attention as attn_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import sinusoidal_positions
from repro_torch.models.mamba2 import dims as mamba_dims
from repro_torch.models.rglru import CONV_W as RG_CONV_W
from repro_torch.models.rglru import width as rg_width


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
    dtype: torch.dtype
    device: torch.device
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
        if cfg.enc_dec is not None:
            params["encoder"] = tfm.init_encoder(generator, cfg, dt, dev)
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
    @staticmethod
    def pools_of(kind) -> int:
        """Paged pools of a layer kind: MLA's one compressed pool, the
        (k, v) pair, or none for a Mamba-2 or RG-LRU layer."""
        return {"mla": 1, "mamba": 0, "rglru": 0}.get(kind[0], 2)

    def recurrent_state(self, kind, *, ctx: TPContext, batch: int,
                        device=None):
        """A Mamba-2 or RG-LRU layer's recurrent rows, zeroed, at the TP
        width of ``ctx`` (``compute_shards``, as the JAX package's
        ``layer_state``): Mamba-2's (conv [batch, cw-1, nhl*hd + 2S],
        ssm [batch, nhl, hd, S] fp32), RG-LRU's (conv [batch, 3, Wl], h
        [batch, Wl] fp32); on ``device`` (default the model's). An
        engine island's rows are ``bpe * merge`` a rank (its group's
        batch) at the island's ctx: merge x tp_base shards of the heads
        or channels."""
        dev = self.device if device is None else device
        if kind[0] == "mamba":
            _, nh, hd, S, cw = mamba_dims(self.cfg)
            nhl = ctx.local_units(nh)
            shapes = ((batch, cw - 1, nhl * hd + 2 * S),
                      (batch, nhl, hd, S))
        else:
            wl = ctx.local_units(rg_width(self.cfg))
            shapes = ((batch, RG_CONV_W - 1, wl), (batch, wl))
        return (torch.zeros(shapes[0], dtype=self.dtype, device=dev),
                torch.zeros(shapes[1], dtype=torch.float32, device=dev))

    def layer_state(self, kind, *, ctx: TPContext, num_blocks: int,
                    page: int, batch: int = 0, enc_frames: int = 0):
        """One layer's state, zeroed: the (k, v) pool pair [num_blocks,
        page, kvh_local, hd], or for MLA the one compressed pool
        [num_blocks, page, W] as a 1-tuple (replicated over the TP
        group), or a Mamba-2 or RG-LRU layer's ``recurrent_state`` of
        ``batch`` rows; an enc-dec attention layer adds ``"cross"``, its
        cross K/V pair [batch, enc_frames, kvh_local, hd] (batch-dense
        rows of the step's batch)."""
        tfm.check_kind(kind)
        cfg = self.cfg
        if self.pools_of(kind) == 0:
            return {"mixer": self.recurrent_state(kind, ctx=ctx,
                                                  batch=batch)}
        kvl, hd = ctx.local_units(cfg.num_kv_heads), cfg.resolved_head_dim
        if kind[0] == "mla":
            shape = (num_blocks, page, attn_mod.mla_cache_width(cfg))
        else:
            shape = (num_blocks, page, kvl, hd)

        def zeros(shape):
            return torch.zeros(shape, dtype=self.dtype, device=self.device)
        st = {"mixer": tuple(zeros(shape)
                             for _ in range(self.pools_of(kind)))}
        if cfg.enc_dec is not None and kind[0] in ("gqa", "gqa_win"):
            st["cross"] = tuple(zeros((batch, enc_frames, kvl, hd))
                                for _ in range(2))
        return st

    def check_serving(self) -> None:
        """Raise unless every layer kind of the stack can serve."""
        for kind_seq, _ in self.plan:
            for kind in kind_seq:
                tfm.check_kind(kind)

    def init_states(self, *, ctx: TPContext, num_blocks: int, page: int,
                    batch: int = 0, enc_frames: int = 0):
        """Full stacked state tree aligned with the stack plan: per group,
        per kind, {"mixer": (k [n, ...], v [n, ...])} (MLA: (pool [n,
        ...],); Mamba-2 and RG-LRU: their recurrent rows [n, batch,
        ...]), and for an enc-dec stack {"cross": (k [n, batch,
        enc_frames, ...], v [n, ...])} beside it."""
        groups = []
        for kind_seq, n in self.plan:
            per_kind = []
            for kind in kind_seq:
                one = self.layer_state(kind, ctx=ctx, num_blocks=num_blocks,
                                       page=page, batch=batch,
                                       enc_frames=enc_frames)
                per_kind.append({k: tuple(t.new_zeros((n,) + tuple(t.shape))
                                          for t in leaves)
                                 for k, leaves in one.items()})
            groups.append(tuple(per_kind))
        return groups

    # ------------------------------------------------------------------
    # forward
    # ------------------------------------------------------------------
    def forward(self, params, ctx: TPContext, *, mode: str, tokens,
                backend, states=None, positions=None, last_pos=None,
                window: Optional[int] = None, frontend_embeds=None,
                enc_len=None, valid=None):
        """Returns (fp32 logits, states, aux_loss).

        mode: 'train' | 'prefill' | 'decode'. ``positions`` [B,T] absolute
        positions (with a vision prefix, T counts the patches). ``last_pos``
        [B] (prefill only): per-request index of the final real prompt
        token, so the sampled logits don't depend on batch padding;
        defaults to the padded window's last position. ``window`` is the
        sliding window of every attention layer (a ``gqa_win`` layer
        keeps its config's). ``frontend_embeds`` [B, num_embeds, width]
        feeds the stubbed frontend: whisper's frames (the encoder runs,
        ``enc_len`` [B] masks frames at or past it, in the encoder's keys
        and the cross-attention; a serving call writes the cross caches)
        or InternVL2's patches (projected and put before the tokens).
        ``valid`` [B] (serving) counts each row's real positions for the
        Mamba-2 and RG-LRU layers: a ragged prefill batch, or a decode
        step's rows (1) beside rows that sit it out (0), whose recurrent
        rows stay as they are; None means every position is real.
        Serving ``states`` are updated in place and returned as given;
        train mode takes none, and is the only mode that records the
        autograd graph. Under TP, train mode takes a training ctx
        (``views.make_train_ctx``) and the rank's shards of the
        training layout."""
        cfg = self.cfg
        if frontend_embeds is not None:
            if cfg.frontend is None:
                raise ValueError(f"{cfg.name} has no modality frontend")
            if frontend_embeds.dtype != self.dtype:
                raise ValueError(f"frontend embeddings in "
                                 f"{frontend_embeds.dtype} for a "
                                 f"{self.dtype} model")
        if mode == "train":
            if states is not None or valid is not None:
                raise ValueError("train mode runs without cache states "
                                 "or valid counts")
            if cfg.enc_dec is not None and frontend_embeds is None:
                raise ValueError("an enc-dec decoder trains on its "
                                 "encoder's output: pass frontend_embeds")
            return self._forward(params, ctx, mode=mode, tokens=tokens,
                                 backend=backend, states=None,
                                 positions=positions, last_pos=None,
                                 window=window, fe=frontend_embeds,
                                 enc_len=enc_len, valid=None)
        with torch.no_grad():
            return self._forward(params, ctx, mode=mode, tokens=tokens,
                                 backend=backend, states=states,
                                 positions=positions, last_pos=last_pos,
                                 window=window, fe=frontend_embeds,
                                 enc_len=enc_len, valid=valid)

    def _forward(self, params, ctx, *, mode, tokens, backend, states,
                 positions, last_pos, window, fe, enc_len, valid):
        cfg = self.cfg
        enc_out = None
        if cfg.enc_dec is not None and fe is not None:
            enc_out = tfm.encode(cfg, params["encoder"], fe, ctx,
                                 frame_len=enc_len)
        x = tfm.embed_tokens(cfg, params["embed"], tokens, ctx)
        if cfg.frontend is not None and cfg.frontend.kind == "vision" \
                and fe is not None:
            patches = (fe @ params["embed"]["projector"]).to(x.dtype)
            x = torch.cat([patches, x], dim=1)
        B, T = x.shape[0], x.shape[1]
        if positions is None:
            positions = torch.arange(T, device=x.device)[None].expand(B, T)
        if cfg.enc_dec is not None:
            # whisper's decoder: sinusoidal positions over its context
            n_pos = int(cfg.max_decode_context)
            # meta tensors (the dry run) hold no positions to check
            if not positions.is_meta and int(positions.max()) >= n_pos:
                raise ValueError(f"decoder position {int(positions.max())} "
                                 f"past {cfg.name}'s {n_pos} positions")
            pe = sinusoidal_positions(n_pos, cfg.d_model, x.device)
            x = x + pe[positions.long()].to(x.dtype)
        remat = mode == "train" and self.remat
        aux_total = 0.0
        for gi, (kind_seq, n) in enumerate(self.plan):
            p_group = params["groups"][gi]
            for li in range(n):
                for si, kind in enumerate(kind_seq):
                    st = cross = None
                    if states is not None:
                        st_l = states[gi][si]
                        st = tuple(t[li] for t in st_l["mixer"])
                        if "cross" in st_l:
                            cross = tuple(t[li] for t in st_l["cross"])
                    layer = partial(tfm.apply_layer, cfg, kind,
                                    _index(p_group[si], li), ctx=ctx,
                                    backend=backend, state=st,
                                    positions=positions, mode=mode,
                                    window=window, cross=cross,
                                    enc_out=enc_out, enc_len=enc_len,
                                    valid=valid)
                    if remat:
                        x, _, aux = checkpoint(layer, x, use_reentrant=False)
                    else:
                        x, _, aux = layer(x)
                    aux_total = aux_total + aux
        x = tfm.rms_norm(x, params["embed"]["norm_f"], cfg.norm_eps)
        if mode == "prefill":
            if last_pos is not None:
                x = x[torch.arange(B, device=x.device),
                      last_pos.long()][:, None, :]
            else:
                x = x[:, -1:]
        logits = tfm.lm_head(cfg, params["embed"], x, ctx)
        return logits, states, aux_total


def build_model(cfg: ArchConfig, dtype: torch.dtype = torch.bfloat16,
                device: Optional[Union[str, torch.device]] = None) -> Model:
    """The model on the CUDA card, or on the CPU when asked for."""
    return Model(cfg, dtype, resolve_device(device))
