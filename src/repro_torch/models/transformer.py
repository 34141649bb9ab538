"""Backbone assembly for dense GQA stacks, Mamba-2 stacks and the hybrid
RecurrentGemma stack.

A layer *kind* is ``(mixer, ffn)``. The stack plan partitions layers into
groups of a repeating kind sequence, as in the JAX package (which scans
each group); the port loops over the layers of a group. The port serves
and trains dense decoder stacks (mixers ``gqa``/``gqa_win`` with the
gated ``mlp``), trains Mamba-2 stacks (``("mamba", "none")``: no
``norm2`` and no FFN, so the parameter tree is the JAX package's leaf for
leaf) and trains the hybrid stack (``("rglru", "gelu_mlp")`` and
``("gqa_win", "gelu_mlp")``: the RG-LRU block or windowed attention,
then the ungated GeLU MLP); it raises on the other kinds, and on serving
a Mamba-2 or hybrid stack.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import TPContext
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.common import init_embedding, init_linear, rms_norm
from repro_torch.models.mamba2 import init_mamba2, mamba2_layer
from repro_torch.models.rglru import init_rglru, rglru_block
from repro_torch.serving.sampling import sample

Kind = Tuple[str, str]  # (mixer, ffn)

# vocab columns of the head upcast to fp32 at a time (bf16 weights)
_HEAD_CHUNK = 16384


def stack_plan(cfg: ArchConfig) -> List[Tuple[Tuple[Kind, ...], int]]:
    """[(kind_sequence, repeat_count), ...] covering all decoder layers."""
    L = cfg.num_layers
    if cfg.family == "ssm":
        return [((("mamba", "none"),), L)]
    if cfg.hybrid is not None:
        pat = tuple(("rglru" if k == "rglru" else "gqa_win", "gelu_mlp")
                    for k in cfg.hybrid.pattern)
        n = L // len(pat)
        plan = [(pat, n)] if n else []
        rem = L % len(pat)
        if rem:
            plan.append((pat[:rem], 1))
        return plan
    ffn = "moe" if cfg.moe is not None else (
        "gelu_mlp" if cfg.enc_dec is not None else "mlp")
    mixer = "mla" if cfg.mla is not None else "gqa"
    if cfg.mla is not None and cfg.moe is not None:
        return [(((mixer, "mlp"),), 1), (((mixer, "moe"),), L - 1)]
    return [(((mixer, ffn),), L)]


MAMBA: Kind = ("mamba", "none")
RGLRU: Kind = ("rglru", "gelu_mlp")
LOCAL_ATTN: Kind = ("gqa_win", "gelu_mlp")


def check_kind(kind: Kind, *, serving: bool = False) -> None:
    """Raise unless the port runs this kind (in serving, if asked)."""
    mixer, ffn = kind
    if kind == MAMBA:
        if serving:
            raise NotImplementedError(
                "Mamba-2 serving is not ported: it needs K6 with a carried "
                "h0 and a decision on the JAX engine's recurrent state "
                "(ROADMAP Queue 3); the port trains Mamba-2 stacks only")
    elif kind in (RGLRU, LOCAL_ATTN):
        if serving:
            raise NotImplementedError(
                "RecurrentGemma serving is not ported: it needs K7 with a "
                "carried h0 and a decision on the JAX engine's recurrent "
                "state (ROADMAP Queue 3); the port trains hybrid stacks "
                "only")
    elif mixer not in ("gqa", "gqa_win") or ffn != "mlp":
        raise NotImplementedError(
            f"layer kind {kind}: the port runs dense GQA stacks with a "
            f"gated MLP and trains Mamba-2 and RecurrentGemma stacks")


def init_layer(generator, cfg: ArchConfig, kind: Kind, dtype, device):
    check_kind(kind)
    mixer, ffn = kind
    ones = dict(dtype=dtype, device=device)
    p = {"norm1": torch.ones((cfg.d_model,), **ones)}
    if kind == MAMBA:
        p["mixer"] = init_mamba2(generator, cfg, dtype, device)
        return p
    if mixer == "rglru":
        p["mixer"] = init_rglru(generator, cfg, dtype, device)
    else:
        p["attn"] = attn_mod.init_gqa(generator, cfg, dtype, device)
    p["norm2"] = torch.ones((cfg.d_model,), **ones)
    p["ffn"] = ffn_mod.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                                device, gated=(ffn == "mlp"))
    return p


def apply_layer(cfg: ArchConfig, kind: Kind, p, x, ctx: TPContext, backend,
                state, *, positions, mode: str,
                window: Optional[int] = None):
    """One pre-norm decoder layer. ``state`` is the layer's (k, v) pool
    pair (None for a Mamba-2 or RG-LRU layer, which runs in train mode
    only); returns (x, state)."""
    mixer, ffn = kind
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == MAMBA:
        out, state = mamba2_layer(cfg, p["mixer"], h, ctx, state, mode=mode)
        return x + out, state
    if mixer == "rglru":
        out, state = rglru_block(cfg, p["mixer"], h, ctx, state, mode=mode)
    else:
        w = cfg.hybrid.window if (mixer == "gqa_win" and cfg.hybrid) \
            else window
        out, state = attn_mod.gqa_attention(cfg, p["attn"], h, ctx, backend,
                                            state, positions=positions,
                                            window=w)
    x = x + out
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    ffn_fn = ffn_mod.gelu_mlp if ffn == "gelu_mlp" else ffn_mod.mlp
    x = x + ffn_fn(p["ffn"], h2, ctx, cfg.d_ff)
    return x, state


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def init_embed(generator, cfg: ArchConfig, dtype, device):
    p: Dict[str, Any] = {
        "tok": init_embedding(generator, cfg.vocab_size, cfg.d_model, dtype,
                              device),
        "norm_f": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = init_linear(generator, cfg.d_model, cfg.vocab_size,
                                dtype, device)
    return p


def vocab_offset(cfg, ctx: TPContext) -> Tuple[int, int]:
    """(first vocab id, width) of this rank's vocab slice; the slice
    choice mirrors ``TPContext.activate``'s."""
    V = cfg.vocab_size
    if ctx.tp == 1:
        return 0, V
    shard = ctx.compute_shards(V)
    Vl = V // shard
    stored = ctx.stored_shards(V)
    if stored == 1:
        idx = (ctx.storage_major_rank() * shard) // ctx.tp
    else:
        rep = ctx.tp // shard
        idx = ctx.storage_rank() * (shard // stored) + ctx.view_rank() // rep
    return idx * Vl, Vl


def embed_tokens(cfg, p, tokens, ctx: TPContext):
    """Vocab-sharded embedding lookup: masked local gather + one psum."""
    if ctx.tp == 1:
        x = p["tok"][tokens.long()]
    else:
        emb = ctx.activate(p["tok"], 0, cfg.vocab_size)
        off, Vl = vocab_offset(cfg, ctx)
        local = tokens.long() - off
        ok = (local >= 0) & (local < Vl)
        x = torch.where(ok[..., None], emb[local.clamp(0, Vl - 1)],
                        torch.zeros((), dtype=emb.dtype, device=emb.device))
        x = ctx.psum(x, cfg.vocab_size)
    if cfg.hybrid is not None:
        x = x * math.sqrt(cfg.d_model)
    return x


def lm_head(cfg, p, x, ctx: TPContext):
    """fp32 logits of this rank's vocab slice [.., Vl] (the whole vocab at
    tp 1). A bf16 head is upcast a slice of vocab columns at a time, so
    the products are fp32 without an fp32 copy of the whole head."""
    V = cfg.vocab_size
    if cfg.tie_embeddings:
        w = ctx.activate(p["tok"], 0, V).t()
    else:
        w = ctx.activate(p["head"], 1, V)
    x = x.float()
    if w.dtype == torch.float32:
        return x @ w
    Vl = w.shape[1]
    out = x.new_empty(x.shape[:-1] + (Vl,))
    for i in range(0, Vl, _HEAD_CHUNK):
        out[..., i:i + _HEAD_CHUNK] = x @ w[:, i:i + _HEAD_CHUNK].float()
    return out


def gather_vocab(cfg, logits_local, ctx: TPContext):
    """Full-vocab logits from the local slices: masked placement + one
    psum (replication-safe). [.., Vl] -> [.., V] fp32, the same on every
    rank of the group."""
    if ctx.tp == 1:
        return logits_local
    off, Vl = vocab_offset(cfg, ctx)
    full = logits_local.new_zeros(logits_local.shape[:-1]
                                  + (cfg.vocab_size,), dtype=torch.float32)
    full[..., off:off + Vl] = logits_local
    return ctx.psum_scaled(full, ctx.replication(cfg.vocab_size))


def tp_cross_entropy(cfg, logits_local, labels, ctx: TPContext, mask=None):
    """Softmax cross entropy over the whole vocab (tp = 1: the local
    shard is the vocab), as the JAX package computes it: max-shifted
    log-sum-exp minus the gold logit; labels outside the vocab score a
    gold logit of 0. ``mask`` [..] weights positions; the mean over the
    weighted positions is returned. The shift's gradient is zero (the
    JAX package's carries only rounding), so the max is taken without
    one: ``amax``'s backward would count ties in an int64 copy of the
    whole [tokens, vocab] mask, 16.8 GB at 8192 tokens of a 256000-word
    vocab."""
    if ctx.tp != 1:
        raise NotImplementedError("sharded training is not ported: the "
                                  "cross entropy takes the whole vocab")
    V = logits_local.shape[-1]
    m = logits_local.detach().amax(dim=-1)
    denom = torch.exp(logits_local - m[..., None]).sum(dim=-1)
    labels = labels.long()
    ok = (labels >= 0) & (labels < V)
    gold = logits_local.gather(-1, labels.clamp(0, V - 1)[..., None])[..., 0]
    gold = torch.where(ok, gold, 0.0)
    nll = torch.log(denom.clamp_min(1e-30)) + m - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


def tp_argmax(cfg, logits_local, ctx: TPContext):
    """Greedy token ids [..] int32 over vocab-sharded logits [.., Vl],
    the same on every rank of the group, without gathering the vocab.
    Ties break as ``jnp.argmax`` over the gathered logits: each slice
    proposes its first-occurrence global index, losers propose V, and a
    pmin picks the lowest winner."""
    if ctx.tp == 1:
        return torch.argmax(logits_local, dim=-1).to(torch.int32)
    off, _ = vocab_offset(cfg, ctx)
    local_max = logits_local.amax(dim=-1)
    local_arg = torch.argmax(logits_local, dim=-1).to(torch.int32) + off
    m = ctx.pmax(local_max)
    cand = torch.where(local_max == m, local_arg,
                       torch.full_like(local_arg, cfg.vocab_size))
    return ctx.pmin(cand)


def sample_tokens(cfg, logits_local, ctx: TPContext, *,
                  temperature: float = 0.0, top_k: int = 0, seeds=None):
    """In-step sampling over vocab-sharded logits [B, Vl] -> [B] int32.

    temperature <= 0: greedy (``tp_argmax``). temperature > 0: gather the
    vocab (the same on every rank of the group, so every rank draws the
    same token), apply optional top-k truncation, and draw categorically
    with row ``b``'s seed ``seeds[b]``, bit for bit as the JAX package's
    ``jax.random.categorical(jax.random.PRNGKey(seed), row)``
    (``serving/sampling.py``)."""
    if temperature <= 0.0:
        return tp_argmax(cfg, logits_local, ctx)
    return sample(gather_vocab(cfg, logits_local, ctx), seeds=seeds,
                  temperature=temperature, top_k=top_k)
