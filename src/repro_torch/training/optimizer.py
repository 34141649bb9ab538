"""AdamW over the port's parameter tree: fp32 moments beside parameters of
any dtype, the JAX package's schedule, clip and decay.

The JAX package's update is pure and returns new trees; the port updates
the parameter tensors and the moments in place under ``no_grad`` (an
optimizer step at full width would otherwise hold a second copy of the
parameters and moments). ``update`` returns the same tensors it was
given.

On sharded ranks the trees are the rank's shards, so the moments exist
for the shard alone; the global gradient norm is the logical tree's,
which the caller's ``global_sq`` assembles from the shards' sums of
squares (``training/train_step.py``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.training.checkpoint import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: int
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup: int = 100

    def init(self, params) -> AdamWState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return AdamWState(step=0, m=tree_map(zeros, params),
                          v=tree_map(zeros, params))

    def _schedule(self, step: int) -> float:
        """lr * min(1, (step + 1) / warmup), in fp32 as the JAX package
        computes it."""
        s = np.float32(step)
        ramp = (s + np.float32(1)) / np.float32(max(self.warmup, 1))
        return float(np.float32(self.lr) * np.minimum(np.float32(1), ramp))

    @torch.no_grad()
    def update(self, params, grads, state: AdamWState, *,
               global_sq: Optional[Callable[[torch.Tensor],
                                            torch.Tensor]] = None):
        """One step: clip by the global gradient norm, update the fp32
        moments, and move each parameter by the bias-corrected Adam
        direction plus decoupled weight decay on its fp32 upcast. Returns
        (params, state), both updated in place. ``global_sq`` maps the
        leaves' sums of squares [n_leaves] to the squared norm of the
        whole gradient (default: their sum)."""
        ps: List[torch.Tensor] = tree_leaves(params)
        gs: List[torch.Tensor] = tree_leaves(grads)
        ms, vs = tree_leaves(state.m), tree_leaves(state.v)
        sq = torch.stack([g.float().square().sum() for g in gs])
        gnorm = (sq.sum() if global_sq is None else global_sq(sq)).sqrt()
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        step = state.step + 1
        lr = self._schedule(step)
        b1c = float(1 - np.float32(self.b1) ** np.float32(step))
        b2c = float(1 - np.float32(self.b2) ** np.float32(step))
        for p, g, m, v in zip(ps, gs, ms, vs):
            g = g.float() * scale
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g.square_(), alpha=1 - self.b2)
            p32 = p.float()
            delta = (m / b1c).div_((v / b2c).sqrt_().add_(self.eps))
            delta.add_(p32, alpha=self.weight_decay)
            p.copy_(p32.sub_(delta, alpha=lr))
        return params, AdamWState(step=step, m=state.m, v=state.v)
