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

A striped ``PoolGeometry`` (``layout='striped'``) runs the context-
parallel backends of models/striped.py: every token's KV heads on the
rank of its stripe, decode merged over the TP group. Its prefill is
fresh only, and it has no mixed or live variant.

Enc-dec (whisper) and vision-prefix (InternVL2) models take their
frontend embeddings in the prefill and decode steps' batches
(``frontend_embeds``, and ``enc_len`` for whisper's frames), as the JAX
package's step does. A whisper layer's state holds its cross K/V rows
beside the paged pools (``"cross"``, batch-dense: row b is the step's
batch row b), which the prefill writes and the decode steps read.

Mamba-2 and RG-LRU layers keep no pool: their state is batch-dense
recurrent rows (conv tail and ssm state, or conv tail and h; row b is
the step's batch row b) that every prefill and decode step reads and
updates in place. A batch may carry ``valid`` [B] int32, each row's real
positions (a prefill chunk's tokens; 1 or 0 in a decode step): the
recurrent layers then leave a row's state where its last real token put
it, so the rows of a prefill batch may differ in length and a row of 0
sits the step out with its state untouched (the engine's rows, which
stay with their request). Without ``valid`` every position is real, and
every row of a prefill batch must have one length: a padded row would
run its pads through the recurrence.
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
from repro_torch.models.striped import (StripedDecodeBackend,
                                        StripedPrefillBackend)
from repro_torch.models.transformer import gather_vocab, sample_tokens


def build_serve_step(model: Model, mode: FlyingMode, geom: PoolGeometry, *,
                     phase: str,
                     sample: Optional[Tuple[float, int]] = None,
                     live: Optional[Tuple[int, ...]] = None, sp: int = 1,
                     window: Optional[int] = None):
    """Build the step fn ``run(params, states, batch, comm=None,
    view=None, ed=None)`` for (mode, phase); ``comm`` is the island
    group's ``RankGroup`` (None at tp 1), ``view`` its view group at this
    rank's storage rank (None at merge 1), ``ed`` its 'ed' group at this
    rank's merge and 'model' index (a MoE model's expert parallelism at
    ``engine_rows > 1``; None otherwise).

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
    key positions).

    A striped ``geom`` refuses the mixed phase and the live variants, as
    the JAX package asserts, and a prefill batch with any ``prior_len``
    above 0: the striped prefill attends within its chunk only, so a
    prompt's later chunk would lose its prior context (the JAX package
    runs it and drops that context). An enc-dec model refuses the mixed
    phase and the live variants, as the JAX package asserts; an enc-dec
    model refuses a striped ``geom``, and a vision-prefix model a striped
    prefill, which no run of the JAX package covers. A Mamba-2 or
    RecurrentGemma model refuses the mixed phase (its recurrent rows
    belong to one batch, the mixed step runs two), the live variants and
    a striped prefill, which no run of the JAX package covers either. A
    striped decode step of a vision-prefix, Mamba-2 or RecurrentGemma
    model (its language model's decoder over the striped pool; the
    recurrent rows as on the head layout) builds, for the dry run's
    long-context decode (``launch/dryrun.py``), and runs on meta tensors
    only: no run holds its tokens, so on CPU or CUDA tensors it
    raises."""
    if phase not in ("prefill", "decode", "mixed"):
        raise ValueError(phase)
    cfg = model.cfg
    striped = geom.layout == "striped"
    if striped and phase == "mixed":
        raise ValueError("the mixed step covers the head-layout pool; a "
                         "striped pool runs prefill and decode apart")
    if cfg.enc_dec is not None and phase == "mixed":
        raise ValueError("the mixed step covers paged attention models "
                         "only, not an enc-dec model")
    if cfg.enc_dec is not None and live is not None:
        raise ValueError("live reads need the head-layout paged pool and "
                         "no cross caches")
    if striped and (cfg.enc_dec is not None or (
            cfg.frontend is not None and phase != "decode")):
        raise ValueError("the striped pool serves decoder-only models, "
                         "and the decode step of a vision-prefix model")
    if cfg.family in ("ssm", "hybrid") and (
            phase == "mixed" or live is not None
            or (striped and phase != "decode")):
        raise ValueError(f"{cfg.name}: recurrent rows serve the prefill "
                         f"and decode steps over the head-layout pool and "
                         f"the decode step over a striped one, not a "
                         f"mixed, live or striped prefill step")
    meta_only = striped and phase == "decode" and (
        cfg.frontend is not None or cfg.family in ("ssm", "hybrid"))
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

    def frontend(batch, pre):
        # the mixed step's halves take no frontend inputs
        if pre:
            return {}
        return {"enc_len": batch.get("enc_len"),
                "frontend_embeds": batch.get("frontend_embeds")}

    def prefill(ctx, params, sts, batch, pre=""):
        if live is not None:
            backend = live_backend(ctx, batch)
        elif striped:
            prior = batch["prior_len"]
            # meta tensors (the dry run) hold no lengths to check
            if not prior.is_meta and bool((prior > 0).any()):
                raise ValueError("a striped prefill is fresh only: a chunk "
                                 "after a prior context would not attend "
                                 "to it")
            backend = StripedPrefillBackend(
                ctx=ctx, block_table=batch["block_table"], window=window,
                slots=batch["slots"])
        else:
            backend = PrefillBackend(slots=batch[pre + "slots"],
                                     prior_len=batch[pre + "prior_len"],
                                     block_table=batch[pre + "block_table"])
        logits, _, _ = model.forward(
            params, ctx, mode="prefill", tokens=batch[pre + "tokens"],
            positions=batch[pre + "positions"], backend=backend,
            states=sts, last_pos=batch.get(pre + "last_pos"),
            window=window, valid=batch.get(pre + "valid"),
            **frontend(batch, pre))
        return logits

    def decode(ctx, params, sts, batch, tokens, pre=""):
        if live is not None:
            backend = live_backend(ctx, batch)
        elif striped:
            backend = StripedDecodeBackend(
                ctx=ctx, block_table=batch["block_table"],
                context_len=batch["context_len"], n_q_heads=cfg.num_heads,
                n_kv_heads=cfg.num_kv_heads, window=window,
                slots=batch["slots"])
        else:
            backend = DecodeBackend(slots=batch[pre + "slots"],
                                    block_table=batch[pre + "block_table"],
                                    context_len=batch[pre + "context_len"])
        logits, _, _ = model.forward(
            params, ctx, mode="decode", tokens=tokens,
            positions=batch[pre + "positions"], backend=backend,
            states=sts, window=window, valid=batch.get(pre + "valid"),
            **frontend(batch, pre))
        return logits

    @torch.no_grad()
    def run(params, states, batch, comm=None, view=None, ed=None):
        if meta_only and not batch["tokens"].is_meta:
            raise ValueError(f"{cfg.name}: the striped decode step runs on "
                             f"meta tensors only (the dry run's count)")
        ctx = mode_ctx.bind(comm, view, ed)
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


def fresh_states(model: Model, mode: FlyingMode, geom: PoolGeometry, *,
                 batch: int = 0, enc_frames: int = 0, device=None):
    """Zeroed states as the steps of ``mode`` take them, on ``device``
    (default the model's): per group, per kind, the flat pools
    ``[n_layers, num_blocks, block_elems]`` (MLA: its one compressed
    pool; Mamba-2 and RG-LRU: their recurrent rows ``[n_layers, batch,
    ...]``, ``Model.recurrent_state``), and for an enc-dec attention
    layer its cross K/V rows ``[n_layers, batch, enc_frames, KV_local,
    hd]``, at the mode's TP width (a step's batch is ``batch`` rows)."""
    cfg = model.cfg
    ctx = make_serving_ctx(mode.merge, mode.plan.engine_rows,
                           mode.plan.tp_base)
    kvl = ctx.local_units(cfg.num_kv_heads)
    dev = model.device if device is None else device

    def zeros(shape):
        return torch.zeros(shape, dtype=model.dtype, device=dev)
    groups = []
    for kind_seq, n in model.plan:
        per_kind = []
        for kind in kind_seq:
            if model.pools_of(kind) == 0:
                rows = model.recurrent_state(kind, ctx=ctx, batch=batch,
                                             device=dev)
                per_kind.append({"mixer": tuple(
                    t.new_zeros((n,) + tuple(t.shape)) for t in rows)})
                continue
            st = {"mixer": tuple(zeros((n,) + tuple(geom.flat_shape()))
                                 for _ in range(model.pools_of(kind)))}
            if cfg.enc_dec is not None and kind[0] in ("gqa", "gqa_win"):
                st["cross"] = tuple(
                    zeros((n, batch, enc_frames, kvl, cfg.resolved_head_dim))
                    for _ in range(2))
            per_kind.append(st)
        groups.append(tuple(per_kind))
    return groups


def _view_states(model: Model, states, geom: PoolGeometry, merge: int):
    """Physical layout -> mode view (paper §4.2: a mode switch IS this
    metadata reshape). Each paged pool leaf is stored flat ``[n_layers,
    num_blocks, block_elems]`` and viewed as ``[n_layers, num_blocks,
    B(m), kvh/m, hd]`` (MLA's one compressed pool: ``[n_layers,
    num_blocks, B_base, W]`` at every merge): the same storage, so
    writes through the view land in the flat pool and no reverse reshape
    is needed. Batch-dense leaves (a Mamba-2 or RG-LRU layer's recurrent
    rows, an enc-dec layer's ``"cross"`` rows) are carried as they
    are."""
    shape = tuple(geom.view_shape(merge))
    return [tuple({**st, "mixer": tuple(p.view((p.shape[0],) + shape)
                                        for p in st["mixer"])}
                  if model.pools_of(kind) else st
                  for kind, st in zip(kind_seq, group))
            for (kind_seq, _), group in zip(model.plan, states)]
