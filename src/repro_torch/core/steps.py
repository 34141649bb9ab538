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
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import FlyingMode
from repro_torch.core.views import make_serving_ctx
from repro_torch.models.cache import DecodeBackend, PrefillBackend
from repro_torch.models.model import Model
from repro_torch.models.transformer import gather_vocab, sample_tokens


def build_serve_step(model: Model, mode: FlyingMode, geom: PoolGeometry, *,
                     phase: str,
                     sample: Optional[Tuple[float, int]] = None):
    """Build the step fn ``run(params, states, batch, comm=None)`` for
    (mode, phase); ``comm`` is the island group's ``RankGroup`` (None at
    tp 1).

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
    position instead."""
    if phase not in ("prefill", "decode", "mixed"):
        raise ValueError(phase)
    cfg = model.cfg
    mode_ctx = make_serving_ctx(mode.merge, mode.plan.engine_rows,
                                mode.plan.tp_base)
    merge = mode.merge

    temp, top_k = sample if sample is not None else (0.0, 0)

    def draw(ctx, logits, seeds):
        return sample_tokens(cfg, logits[:, -1], ctx, temperature=temp,
                             top_k=top_k, seeds=seeds)

    def finish(ctx, logits, seeds):
        if sample is not None:
            return draw(ctx, logits, seeds)
        return gather_vocab(cfg, logits[:, -1], ctx)

    def prefill(ctx, params, sts, batch, pre=""):
        backend = PrefillBackend(slots=batch[pre + "slots"],
                                 prior_len=batch[pre + "prior_len"],
                                 block_table=batch[pre + "block_table"])
        logits, _, _ = model.forward(
            params, ctx, mode="prefill", tokens=batch[pre + "tokens"],
            positions=batch[pre + "positions"], backend=backend,
            states=sts, last_pos=batch.get(pre + "last_pos"))
        return logits

    def decode(ctx, params, sts, batch, tokens, pre=""):
        backend = DecodeBackend(slots=batch[pre + "slots"],
                                block_table=batch[pre + "block_table"],
                                context_len=batch[pre + "context_len"])
        logits, _, _ = model.forward(
            params, ctx, mode="decode", tokens=tokens,
            positions=batch[pre + "positions"], backend=backend,
            states=sts)
        return logits

    @torch.no_grad()
    def run(params, states, batch, comm=None):
        ctx = mode_ctx.bind(comm)
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
    B(m), kvh/m, hd]``: the same storage, so writes through the view
    land in the flat pool and no reverse reshape is needed."""
    shape = tuple(geom.view_shape(merge))
    return [tuple({**st, "mixer": tuple(p.view((p.shape[0],) + shape)
                                        for p in st["mixer"])}
                  for st in group)
            for group in states]
