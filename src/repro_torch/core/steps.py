"""Step programs: what the Communicator Pool hands the engine per runner
key.

``build_serve_step`` returns the step function for one (mode, phase) at
one rank: plain eager PyTorch over the rank's storage shard of the
parameters, nothing to compile. Where the JAX package's shard_map hands
each device its DP group's rows of the batch, the engine hands the step
only this rank's group rows (``bpe * merge`` of them) and the group's
TP collectives (``comm``), bound into the mode's ``TPContext`` at call
time. The JAX package donated the state pytree so that XLA could update
the KV pools in place; the port updates them in place: the step writes
through a view of each flat per-layer pool and returns the very tensors
it was given, their ``data_ptr()`` unchanged.

The live variants (``live=``, ``sp=``) read KV that spans block segments
written under other merges (models/cache.py's live backends); they take
the island's view group (``view``) besides its TP group.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import FlyingMode
from repro_torch.core.views import make_serving_ctx
from repro_torch.models.cache import (DecodeBackend, LiveDecodeBackend,
                                      LivePrefillBackend, PrefillBackend)
from repro_torch.models.model import Model
from repro_torch.models.transformer import gather_vocab, sample_tokens


def build_serve_step(model: Model, mode: FlyingMode, geom: PoolGeometry, *,
                     phase: str,
                     sample: Optional[Tuple[float, int]] = None,
                     live: Optional[Tuple[int, ...]] = None, sp: int = 1,
                     window: Optional[int] = None):
    """Build the step fn ``run(params, states, batch, comm=None,
    view=None)`` for (mode, phase); ``comm`` is the island group's
    ``RankGroup`` (None at tp 1), ``view`` its view group at this rank's
    storage rank (None at merge 1).

    ``phase`` is 'prefill' (one chunked-prefill launch), 'decode', or
    'mixed' (prefill chunk rows ``p_*`` and the decode batch ``d_*`` in
    one step; ``d_src_rows`` [B] names, for decode rows whose request
    finished prefill in this step, the prefill row whose sampled token is
    their input, -1 otherwise).

    ``sample=(temperature, top_k)`` fuses token sampling into the step:
    it returns device-resident ``[B]`` int32 token ids (a pair for
    'mixed'). Greedy (temperature <= 0) is the argmax; stochastic
    sampling reads per-row seeds from ``batch['sample_seeds']``
    (``p_sample_seeds`` and ``d_sample_seeds`` for 'mixed').
    ``sample=None`` returns full-vocab fp32 logits of each row's last
    position instead.

    ``live`` selects the cross-layout read variant: an ordered tuple of
    placement LANES, one per (tag, owner shard) slice of the batch's KV,
    tags possibly repeated. For lane i of tag ``live[i]`` the batch
    carries ``lt{i}_bt`` [B, mb_i] segment block tables, ``lt{i}_len``
    [B] segment token counts and ``lt{i}_own`` [B] merge-axis owner
    offsets, in place of ``block_table`` and ``context_len``/
    ``prior_len``; attention runs one partial sweep a lane and one LSE
    merge over the view group. A rebind rider has one lane per distinct
    tag.

    ``sp`` > 1 is the sequence-parallel variant of the live step: each
    merge group holds ``sp`` shards of ``merge // sp`` engines, new KV
    is written under the shard-width tag to the row's owner shard only
    (``write_own`` [B] its merge offset; other ranks park the write on
    the reserved block), and prefill's causal sweep is the LAST lane.

    ``window`` is a sliding window over every attention layer; the live
    variants refuse one (a segment-local sweep has lost the absolute
    key positions)."""
    if phase not in ("prefill", "decode", "mixed"):
        raise ValueError(phase)
    cfg = model.cfg
    mode_ctx = make_serving_ctx(mode.merge, mode.plan.engine_rows,
                                mode.plan.tp_base,
                                cfg.moe.num_experts if cfg.moe else 0)
    merge = mode.merge
    if sp < 1 or merge % sp:
        raise ValueError(f"sp={sp} does not divide merge {merge}")
    wtag = merge // sp
    if sp > 1 and live is None:
        raise ValueError("sequence-parallel serving always runs the live "
                         "lane step")
    if live is not None:
        if phase not in ("decode", "prefill"):
            raise ValueError("live cross-layout reads cover the paged "
                             "decode and prefill steps (mixed ticks fall "
                             "back to the sequential pair)")
        if geom.layout != "head" or cfg.mla is not None:
            raise ValueError("live reads need the head-layout paged pool")
        if window is not None:
            raise ValueError("live reads do not support sliding windows")
        # sp 1: the write tag IS the merge and one lane carries it; sp >
        # 1: the write-tag lanes are the sp shard lanes
        if wtag not in live or any(t > merge for t in live):
            raise ValueError(f"lanes {live} for merge {merge}, sp {sp}")
        for t in live:
            if not (geom.live_readable(t) and geom.live_readable(merge)):
                raise ValueError(f"tag {t} under merge {merge}: the "
                                 f"architecture is not tag-readable")

    def live_segs(batch):
        return tuple((t, batch[f"lt{i}_bt"], batch[f"lt{i}_len"],
                      batch[f"lt{i}_own"]) for i, t in enumerate(live))

    temp, top_k = sample if sample is not None else (0.0, 0)

    def draw(ctx, logits, seeds):
        return sample_tokens(cfg, logits[:, -1], ctx, temperature=temp,
                             top_k=top_k, seeds=seeds)

    def finish(ctx, logits, seeds):
        if sample is not None:
            return draw(ctx, logits, seeds)
        return gather_vocab(cfg, logits[:, -1], ctx)

    def live_backend(ctx, batch):
        kind = LiveDecodeBackend if phase == "decode" else LivePrefillBackend
        return kind(ctx=ctx, slots=batch["slots"], segs=live_segs(batch),
                    merge=merge, block_base=geom.block_base, sp=sp,
                    write_own=batch.get("write_own"))

    def prefill(ctx, params, sts, batch, pre=""):
        if live is not None:
            backend = live_backend(ctx, batch)
        else:
            backend = PrefillBackend(slots=batch[pre + "slots"],
                                     prior_len=batch[pre + "prior_len"],
                                     block_table=batch[pre + "block_table"])
        logits, _, _ = model.forward(
            params, ctx, mode="prefill", tokens=batch[pre + "tokens"],
            positions=batch[pre + "positions"], backend=backend,
            states=sts, last_pos=batch.get(pre + "last_pos"),
            window=window)
        return logits

    def decode(ctx, params, sts, batch, tokens, pre=""):
        if live is not None:
            backend = live_backend(ctx, batch)
        else:
            backend = DecodeBackend(slots=batch[pre + "slots"],
                                    block_table=batch[pre + "block_table"],
                                    context_len=batch[pre + "context_len"])
        logits, _, _ = model.forward(
            params, ctx, mode="decode", tokens=tokens,
            positions=batch[pre + "positions"], backend=backend,
            states=sts, window=window)
        return logits

    @torch.no_grad()
    def run(params, states, batch, comm=None, view=None):
        ctx = mode_ctx.bind(comm, view)
        sts = _view_states(model, states, geom, merge)
        if phase == "prefill":
            out = finish(ctx, prefill(ctx, params, sts, batch),
                         batch.get("sample_seeds"))
        elif phase == "decode":
            out = finish(ctx, decode(ctx, params, sts, batch,
                                     batch["tokens"]),
                         batch.get("sample_seeds"))
        else:
            logits_p = prefill(ctx, params, sts, batch, "p_")
            p_toks = draw(ctx, logits_p, batch.get("p_sample_seeds"))
            # decode rows promoted out of THIS step's prefill read their
            # input token from the prefill output row, on device
            src = batch["d_src_rows"]
            d_in = torch.where(
                src[:, None] >= 0,
                p_toks[src.clamp_min(0).long()][:, None].to(torch.int32),
                batch["d_tokens"])
            out = (p_toks if sample is not None
                   else gather_vocab(cfg, logits_p[:, -1], ctx),
                   finish(ctx, decode(ctx, params, sts, batch, d_in, "d_"),
                          batch.get("d_sample_seeds")))
        return out, states

    return run, mode_ctx


def _view_states(model: Model, states, geom: PoolGeometry, merge: int):
    """Physical layout -> mode view (paper §4.2: a mode switch IS this
    metadata reshape). Each paged pool leaf is stored flat ``[n_layers,
    num_blocks, block_elems]`` and viewed as ``[n_layers, num_blocks,
    B(m), kvh/m, hd]`` (MLA's one compressed pool: ``[n_layers,
    num_blocks, B_base, W]`` at every merge): the same storage, so
    writes through the view land in the flat pool and no reverse reshape
    is needed."""
    shape = tuple(geom.view_shape(merge))
    return [tuple({**st, "mixer": tuple(p.view((p.shape[0],) + shape)
                                        for p in st["mixer"])}
                  for st in group)
            for group in states]
