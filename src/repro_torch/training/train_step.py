"""The training step of the port: one card, no sharding.

``build_train_step`` mirrors the JAX package's: the loss is the model's
cross entropy (plus the MoE auxiliary loss, zero for dense stacks) with
``TrainBackend`` attention, the gradient comes from autograd (through the
flash-prefill op's backward kernel for attention), and ``AdamW.update``
applies it in place. GSPMD meshes, FSDP specs and vocab-sharded logits
come with the islands slice; until then any plan but ``ParallelPlan(1, 1,
1)`` raises.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.modes import ParallelPlan
from repro_torch.core.views import SINGLE
from repro_torch.models.cache import TrainBackend
from repro_torch.models.model import Model
from repro_torch.models.transformer import tp_cross_entropy
from repro_torch.training.checkpoint import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import AdamW


def build_train_step(model: Model, plan: ParallelPlan, *,
                     opt: Optional[AdamW] = None, aux_weight: float = 0.01):
    """Returns ``step((params, opt_state), batch) -> ((params, opt_state),
    {"loss", "total"})``. ``batch`` holds ``tokens`` and ``labels`` [B,T]
    (tensors or numpy arrays); they move to the model's device. The
    parameters are updated in place and returned as given."""
    if (plan.engine_rows, plan.tp_base, plan.data_rows, plan.pods) != \
            (1, 1, 1, 1):
        raise NotImplementedError(
            f"{plan}: the port trains on one card (ParallelPlan(1, 1, 1)); "
            f"sharded training arrives with the islands slice")
    cfg = model.cfg
    opt = opt or AdamW()

    def loss_fn(params, batch):
        logits, _, aux = model.forward(params, SINGLE, mode="train",
                                       tokens=batch["tokens"],
                                       backend=TrainBackend())
        loss = tp_cross_entropy(cfg, logits, batch["labels"], SINGLE)
        return loss + aux_weight * aux, loss

    def step(carry, batch) -> tuple:
        params, opt_state = carry
        batch = {k: torch.as_tensor(v, device=model.device)
                 for k, v in batch.items()}
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        total, loss = loss_fn(params, batch)
        grads = torch.autograd.grad(total, leaves)
        params, opt_state = opt.update(
            params, tree_unflatten(params, list(grads)), opt_state)
        mets: Dict[str, torch.Tensor] = {"loss": loss.detach(),
                                         "total": total.detach()}
        return (params, opt_state), mets

    return step
