"""Feed-forward layers: gated MLP (SwiGLU) and the ungated GeLU MLP."""
from __future__ import annotations

from repro_torch.core.views import TPContext
from repro_torch.models.common import gelu, init_linear, silu


def init_mlp(generator, d: int, d_ff: int, dtype, device,
             gated: bool = True):
    p = {"w_up": init_linear(generator, d, d_ff, dtype, device),
         "w_down": init_linear(generator, d_ff, d, dtype, device)}
    if gated:
        p["w_gate"] = init_linear(generator, d, d_ff, dtype, device)
    return p


def mlp(p, x, ctx: TPContext, d_ff: int, *, act=silu):
    """Column-parallel up/gate, row-parallel down, one psum (paper §4.1.1:
    'one synchronization step per pair of linear layers'). Without a
    ``w_gate`` the activation applies to the up projection itself."""
    up = x @ ctx.activate(p["w_up"], 1, d_ff)
    if "w_gate" in p:
        up = act(x @ ctx.activate(p["w_gate"], 1, d_ff)) * up
    else:
        up = act(up)
    out = up @ ctx.activate(p["w_down"], 0, d_ff)
    return ctx.psum(out, d_ff)


def gelu_mlp(p, x, ctx: TPContext, d_ff: int):
    return mlp(p, x, ctx, d_ff, act=gelu)
