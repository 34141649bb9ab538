"""Backbone assembly for dense GQA stacks, MLA and MoE stacks, Mamba-2
stacks, the hybrid RecurrentGemma stack and whisper's encoder-decoder.

A layer *kind* is ``(mixer, ffn)``. The stack plan partitions layers into
groups of a repeating kind sequence, as in the JAX package (which scans
each group); the port loops over the layers of a group. The port serves
and trains dense decoder stacks (mixers ``gqa``/``gqa_win`` with the
gated ``mlp``, or whisper's ``("gqa", "gelu_mlp")``: an enc-dec decoder
layer adds a cross-attention sub-block over the encoder's output), MLA
and MoE stacks (DeepSeek-V2's ``("mla", "mlp")`` then ``("mla",
"moe")``, Phi-3.5-MoE's ``("gqa", "moe")``; a MoE layer hands its
load-balance loss up through ``apply_layer``), Mamba-2 stacks
(``("mamba", "none")``: no ``norm2`` and no FFN, so the parameter tree
is the JAX package's leaf for leaf) and the hybrid stack (``("rglru",
"gelu_mlp")`` and ``("gqa_win", "gelu_mlp")``: the RG-LRU block or
windowed attention over the paged pool with the config's window, then
the ungated GeLU MLP); it raises on the other kinds. A Mamba-2 or RG-LRU
layer's serving state is its batch-dense recurrent rows, not a pool.

Whisper's encoder (``encode``) and the cross-attention are plain torch,
as they are plain jnp in the JAX package: bidirectional attention with
fp32 scores and softmax, no kernel.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.views import TPContext
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.cache import NEG_INF
from repro_torch.models.common import (init_embedding, init_linear, rms_norm,
                                       sinusoidal_positions)
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
# whisper's decoder and encoder layers
ENC_DEC: Kind = ("gqa", "gelu_mlp")


def check_kind(kind: Kind) -> None:
    """Raise unless the port runs this kind (it serves and trains every
    kind it runs)."""
    mixer, ffn = kind
    if kind not in (MAMBA, RGLRU, LOCAL_ATTN, ENC_DEC) and (
            mixer not in ("gqa", "gqa_win", "mla")
            or ffn not in ("mlp", "moe")):
        raise NotImplementedError(
            f"layer kind {kind}: the port runs GQA and MLA stacks with a "
            f"gated MLP or MoE, whisper's GQA with the GeLU MLP, Mamba-2 "
            f"and RecurrentGemma stacks")


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
    elif mixer == "mla":
        p["attn"] = attn_mod.init_mla(generator, cfg, dtype, device)
    else:
        p["attn"] = attn_mod.init_gqa(generator, cfg, dtype, device)
    if cfg.enc_dec is not None and mixer in ("gqa", "gqa_win"):
        p["norm_x"] = torch.ones((cfg.d_model,), **ones)
        p["cross"] = attn_mod.init_gqa(generator, cfg, dtype, device)
    p["norm2"] = torch.ones((cfg.d_model,), **ones)
    if ffn == "moe":
        p["ffn"] = moe_mod.init_moe(generator, cfg, dtype, device)
    else:
        p["ffn"] = ffn_mod.init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                                    device, gated=(ffn == "mlp"))
    return p


def _dense_attention(q, k, v, key_len=None):
    """Bidirectional attention as the JAX package's encoder and cross
    attention compute it: q [B,T,Hl,hd] over k/v [B,F,KVl,hd] (each kv
    head repeated for its query heads), fp32 scores scaled by hd^-1/2,
    keys at or past ``key_len`` [B] masked with NEG_INF, fp32 softmax;
    returns fp32 [B,T,Hl,hd]."""
    rep = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(rep, dim=2).float()
    v = v.repeat_interleave(rep, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) * q.shape[-1] ** -0.5
    if key_len is not None:
        keys = torch.arange(k.shape[1], device=k.device)
        s = torch.where(keys[None, None, None, :]
                        < key_len.to(k.device)[:, None, None, None], s,
                        NEG_INF)
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)


def make_cross_kv(cfg, p_cross, enc_out, ctx: TPContext):
    """The cross-attention's K/V [B,F,KVl,hd] from the encoder output."""
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    B, F, _ = enc_out.shape
    shape = (B, F, ctx.local_units(KV), hd)
    return ((enc_out @ ctx.activate(p_cross["wk"], 1, KV)).reshape(shape),
            (enc_out @ ctx.activate(p_cross["wv"], 1, KV)).reshape(shape))


def cross_attention(cfg, p, x, ctx: TPContext, enc_kv, *, enc_len=None):
    """Decoder cross-attention over the encoder's K/V ``enc_kv`` ((k, v)
    [B,F,KVl,hd]); frames at or past ``enc_len`` [B] are masked."""
    B, T, _ = x.shape
    H, hd = cfg.num_heads, cfg.resolved_head_dim
    Hl = ctx.local_units(H)
    if enc_kv[0].shape[0] != B:
        raise ValueError(f"cross K/V of {enc_kv[0].shape[0]} rows for a "
                         f"batch of {B}")
    q = (x @ ctx.activate(p["wq"], 1, H)).reshape(B, T, Hl, hd)
    o = _dense_attention(q, *enc_kv, key_len=enc_len).to(x.dtype)
    return ctx.psum(o.reshape(B, T, Hl * hd) @ ctx.activate(p["wo"], 0, H),
                    H)


def apply_layer(cfg: ArchConfig, kind: Kind, p, x, ctx: TPContext, backend,
                state, *, positions, mode: str,
                window: Optional[int] = None, cross=None, enc_out=None,
                enc_len=None, valid=None):
    """One pre-norm decoder layer. ``state`` is the layer's (k, v) pool
    pair, its one compressed pool for MLA, or a Mamba-2 or RG-LRU layer's
    recurrent rows (None in train mode); returns (x, state). ``valid``
    [B] counts each row's real positions for a recurrent layer (None:
    all of them); attention layers mask pads by their slots.

    An enc-dec layer runs its cross-attention sub-block between the mixer
    and the FFN: over K/V projected from ``enc_out`` when the encoder ran
    in this call (train and prefill; ``cross``, the layer's cross cache
    pair [B,F,KVl,hd], is then written with them in place), else over
    the cached ``cross`` (decode). Returns (x, state, aux): aux is a MoE
    layer's load-balance loss, 0.0 for every other layer."""
    mixer, ffn = kind
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    if kind == MAMBA:
        out, state = mamba2_layer(cfg, p["mixer"], h, ctx, state, mode=mode,
                                  valid=valid)
        return x + out, state, 0.0
    if mixer == "rglru":
        out, state = rglru_block(cfg, p["mixer"], h, ctx, state, mode=mode,
                                 valid=valid)
    elif mixer == "mla":
        out, state = attn_mod.mla_attention(cfg, p["attn"], h, ctx, backend,
                                            state, positions=positions,
                                            window=window)
    else:
        w = cfg.hybrid.window if (mixer == "gqa_win" and cfg.hybrid) \
            else window
        out, state = attn_mod.gqa_attention(cfg, p["attn"], h, ctx, backend,
                                            state, positions=positions,
                                            window=w)
    x = x + out
    if "cross" in p:
        if enc_out is not None:
            enc_kv = make_cross_kv(cfg, p["cross"], enc_out, ctx)
            if cross is not None:
                for cache, new in zip(cross, enc_kv):
                    if cache.shape != new.shape:
                        raise ValueError(f"cross cache {tuple(cache.shape)}"
                                         f" for K/V {tuple(new.shape)}")
                    cache.copy_(new)
        else:
            enc_kv = cross
        hx = rms_norm(x, p["norm_x"], cfg.norm_eps)
        x = x + cross_attention(cfg, p["cross"], hx, ctx, enc_kv,
                                enc_len=enc_len)
    h2 = rms_norm(x, p["norm2"], cfg.norm_eps)
    if ffn == "moe":
        y, aux = moe_mod.moe_ffn(cfg, p["ffn"], h2, ctx)
        return x + y, state, aux
    ffn_fn = ffn_mod.gelu_mlp if ffn == "gelu_mlp" else ffn_mod.mlp
    x = x + ffn_fn(p["ffn"], h2, ctx, cfg.d_ff)
    return x, state, 0.0


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
    if cfg.frontend is not None and cfg.frontend.kind == "vision":
        p["projector"] = init_linear(
            generator, cfg.frontend.embed_width or cfg.d_model, cfg.d_model,
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
    """Softmax cross entropy over the whole vocab from this rank's vocab
    slice of the logits [.., Vl], as the JAX package computes it, never
    gathering the vocab: the pmax of the slices' maxima shifts, the
    psum (pre-scaled by the vocab's replication) of the slices' sums of
    exponentials is the denominator and that of the slices' gold logits
    the gold logit, one rank's slice holding it; labels outside the
    vocab score a gold logit of 0. ``mask`` [..] weights positions; the
    mean over the weighted positions is returned. The shift's gradient
    is zero (the JAX package's carries only rounding), so the max is
    taken without one: ``amax``'s backward would count ties in an int64
    copy of the whole [tokens, vocab] mask, 16.8 GB at 8192 tokens of a
    256000-word vocab."""
    off, Vl = vocab_offset(cfg, ctx)
    rep = ctx.replication(cfg.vocab_size) if ctx.tp > 1 else 1
    m = ctx.pmax(logits_local.detach().amax(dim=-1))
    denom = ctx.psum_scaled(
        torch.exp(logits_local - m[..., None]).sum(dim=-1), rep)
    local = labels.long() - off
    ok = (local >= 0) & (local < Vl)
    gold = logits_local.gather(-1, local.clamp(0, Vl - 1)[..., None])[..., 0]
    gold = ctx.psum_scaled(torch.where(ok, gold, 0.0), rep)
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


# ---------------------------------------------------------------------------
# whisper encoder (bidirectional, run once a request at prefill)
# ---------------------------------------------------------------------------

def init_encoder(generator, cfg: ArchConfig, dtype, device):
    """``{"layers": [one dict a layer], "norm"}``; each layer is built
    as a decoder layer, so it holds the (unused) cross sub-block too, as
    the JAX package's does."""
    return {"layers": [init_layer(generator, cfg, ENC_DEC, dtype, device)
                       for _ in range(cfg.enc_dec.enc_layers)],
            "norm": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def encode(cfg: ArchConfig, p_enc, frames, ctx: TPContext, *,
           frame_len=None):
    """frames [B,F,d] (the frontend's precomputed embeddings) plus
    sinusoidal positions through the bidirectional encoder; frames at or
    past ``frame_len`` [B] are masked as keys. Heads are TP-sharded as
    in the decoder (one psum after each row-parallel projection)."""
    B, F, _ = frames.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    Hl, KVl = ctx.local_units(H), ctx.local_units(KV)
    x = frames + sinusoidal_positions(F, cfg.d_model, frames.device)[None] \
        .to(frames.dtype)
    for lp in p_enc["layers"]:
        h = rms_norm(x, lp["norm1"], cfg.norm_eps)
        ap = lp["attn"]
        q = (h @ ctx.activate(ap["wq"], 1, H)).reshape(B, F, Hl, hd)
        k = (h @ ctx.activate(ap["wk"], 1, KV)).reshape(B, F, KVl, hd)
        v = (h @ ctx.activate(ap["wv"], 1, KV)).reshape(B, F, KVl, hd)
        o = _dense_attention(q, k, v, key_len=frame_len).to(x.dtype)
        x = x + ctx.psum(o.reshape(B, F, Hl * hd)
                         @ ctx.activate(ap["wo"], 0, H), H)
        h2 = rms_norm(x, lp["norm2"], cfg.norm_eps)
        x = x + ffn_mod.gelu_mlp(lp["ffn"], h2, ctx, cfg.d_ff)
    return rms_norm(x, p_enc["norm"], cfg.norm_eps)
