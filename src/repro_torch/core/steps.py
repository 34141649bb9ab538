"""Step programs: what the Communicator Pool hands the engine per runner
key.

``build_serve_step`` returns the step function for one (mode, phase) at
one rank: plain eager PyTorch over the canonical parameters, no
shard_map and nothing to compile. The JAX package donated the state
pytree so that XLA could update the KV pools in place; the port updates
them in place: the step writes through a view of each flat per-layer
pool and returns the very tensors it was given, their ``data_ptr()``
unchanged.
"""
from __future__ import annotations

import torch

from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import FlyingMode
from repro_torch.core.views import make_serving_ctx
from repro_torch.models.cache import DecodeBackend, PrefillBackend
from repro_torch.models.model import Model
from repro_torch.models.transformer import gather_vocab, sample_tokens


def build_serve_step(model: Model, mode: FlyingMode, geom: PoolGeometry, *,
                     phase: str, sampled: bool = False):
    """Build the step fn ``run(params, states, batch)`` for (mode, phase).

    ``phase`` is 'prefill' (one chunked-prefill launch), 'decode', or
    'mixed' (prefill chunk rows ``p_*`` and the decode batch ``d_*`` in
    one step; ``d_src_rows`` [B] names, for decode rows whose request
    finished prefill in this step, the prefill row whose sampled token is
    their input, -1 otherwise).

    ``sampled`` fuses greedy sampling into the step: it returns
    device-resident ``[B]`` int32 token ids (a pair for 'mixed');
    otherwise full-vocab fp32 logits of each row's last position."""
    if phase not in ("prefill", "decode", "mixed"):
        raise ValueError(phase)
    cfg = model.cfg
    ctx = make_serving_ctx(mode.merge, mode.plan.engine_rows,
                           mode.plan.tp_base)
    merge = mode.merge

    def finish(logits):
        if sampled:
            return sample_tokens(cfg, logits[:, -1], ctx)
        return gather_vocab(cfg, logits[:, -1], ctx)

    def prefill(params, sts, batch, pre=""):
        backend = PrefillBackend(slots=batch[pre + "slots"],
                                 prior_len=batch[pre + "prior_len"],
                                 block_table=batch[pre + "block_table"])
        logits, _, _ = model.forward(
            params, ctx, mode="prefill", tokens=batch[pre + "tokens"],
            positions=batch[pre + "positions"], backend=backend,
            states=sts, last_pos=batch.get(pre + "last_pos"))
        return logits

    def decode(params, sts, batch, tokens, pre=""):
        backend = DecodeBackend(slots=batch[pre + "slots"],
                                block_table=batch[pre + "block_table"],
                                context_len=batch[pre + "context_len"])
        logits, _, _ = model.forward(
            params, ctx, mode="decode", tokens=tokens,
            positions=batch[pre + "positions"], backend=backend,
            states=sts)
        return logits

    @torch.no_grad()
    def run(params, states, batch):
        sts = _view_states(model, states, geom, merge)
        if phase == "prefill":
            out = finish(prefill(params, sts, batch))
        elif phase == "decode":
            out = finish(decode(params, sts, batch, batch["tokens"]))
        else:
            logits_p = prefill(params, sts, batch, "p_")
            p_toks = sample_tokens(cfg, logits_p[:, -1], ctx)
            # decode rows promoted out of THIS step's prefill read their
            # input token from the prefill output row, on device
            src = batch["d_src_rows"]
            d_in = torch.where(
                src[:, None] >= 0,
                p_toks[src.clamp_min(0).long()][:, None].to(torch.int32),
                batch["d_tokens"])
            out = (p_toks if sampled else finish(logits_p),
                   finish(decode(params, sts, batch, d_in, "d_")))
        return out, states

    return run, ctx


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
