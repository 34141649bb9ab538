"""Feed-forward layers: gated MLP (SwiGLU)."""
from __future__ import annotations

from repro_torch.core.views import TPContext
from repro_torch.models.common import init_linear, silu


def init_mlp(generator, d: int, d_ff: int, dtype, device):
    return {"w_up": init_linear(generator, d, d_ff, dtype, device),
            "w_down": init_linear(generator, d_ff, d, dtype, device),
            "w_gate": init_linear(generator, d, d_ff, dtype, device)}


def mlp(p, x, ctx: TPContext, d_ff: int, *, act=silu):
    """Column-parallel up/gate, row-parallel down, one psum (paper §4.1.1:
    'one synchronization step per pair of linear layers')."""
    up = x @ ctx.activate(p["w_up"], 1, d_ff)
    up = act(x @ ctx.activate(p["w_gate"], 1, d_ff)) * up
    out = up @ ctx.activate(p["w_down"], 0, d_ff)
    return ctx.psum(out, d_ff)
