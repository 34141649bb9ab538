"""The training step of the port, on one card or sharded over ranks.

``build_train_step`` ports the JAX package's GSPMD step for any
``ParallelPlan``: one process a rank, ``pods * data_rows * tp_base``
ranks on the mesh ``('pod', 'data', 'model')`` of ``train_mesh``, rank
``(pod * data_rows + data) * tp_base + model``. Where GSPMD places the
collectives, the port writes them out:

- the batch shards over ('pod', 'data'): each rank takes its rows of
  the global batch;
- the weights follow ``WeightsManager.train_dims``: DENSE and EXPERT
  dims over 'model', a rank computing with its shards under a training
  ctx (``views.make_train_ctx``); with ``engine_rows > 1`` ZeRO-3 leaves
  are all-gathered over 'data' before the forward and their gradients
  reduce-scattered after it;
- the optimizer state is the rank's shard's;
- the logits stay vocab-sharded: ``tp_cross_entropy`` reduces the
  slices with a pmax and two psums;
- MoE layers dispatch each data rank's tokens alone (the JAX package's
  ``moe_groups = pods * data_rows``), experts over 'model'.

The loss is the cross entropy plus ``aux_weight`` times the MoE
auxiliary loss (zero for dense stacks), its gradient autograd's: the
backward is seeded with ``1 / tp_base`` (``core/views.py``: gradients of
TP-replicated tensors are per-rank partials), so a leaf that 'model'
does not shard sums its gradient over the TP group, and every gradient
is averaged over the data ranks; ``AdamW.update`` clips by the logical
tree's norm, each element counted once. ``loss`` and ``total`` are the
global batch's. A plan whose rank count is not the world's raises, and
so does any collective that fails: nothing trains unsharded in their
place.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.core.modes import ParallelPlan
from repro_torch.core.views import CommStats, RankGroup, make_train_ctx
from repro_torch.core.weights_manager import Spec, WeightsManager
from repro_torch.models.cache import TrainBackend
from repro_torch.models.model import Model
from repro_torch.models.transformer import tp_cross_entropy
from repro_torch.training.checkpoint import tree_leaves, tree_unflatten
from repro_torch.training.optimizer import AdamW

@dataclass
class TrainMesh:
    """This rank on the training mesh of ``plan``: its coordinate and its
    groups, each None where it would hold this rank alone: ``model``
    (the TP group), ``data`` (the ranks of its pod and model index: the
    ZeRO-3 axis), ``pod`` (its data and model index across pods), ``dp``
    (every rank of its model index: the batch's shards) and ``world``.
    Each group's collectives add to ``stats`` under its axis."""
    plan: ParallelPlan
    rank: int
    pod: int
    data: int
    model: int
    groups: Dict[str, Optional[RankGroup]]
    stats: Dict[str, CommStats] = field(default_factory=dict)

    @property
    def world(self) -> int:
        p = self.plan
        return p.pods * p.data_rows * p.tp_base

    @property
    def dp_size(self) -> int:
        return self.plan.pods * self.plan.data_rows

    @property
    def dp_index(self) -> int:
        """This rank's batch shard: pod * data_rows + data."""
        return self.pod * self.plan.data_rows + self.data


def mesh_rank(plan: ParallelPlan, pod: int, data: int, model: int) -> int:
    """The world rank at (pod, data, model): ``train_mesh``'s order."""
    return (pod * plan.data_rows + data) * plan.tp_base + model


def train_mesh(plan: ParallelPlan) -> TrainMesh:
    """This process's place on the training mesh of ``plan``, its groups
    built (every rank makes every group, in one order: ``new_group`` is
    collective over the world). Raises unless the world (1 without a
    process group) has ``pods * data_rows * tp_base`` ranks."""
    n = plan.pods * plan.data_rows * plan.tp_base
    if dist.is_available() and dist.is_initialized():
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        rank, world = 0, 1
    if world != n:
        raise ValueError(f"{plan} trains on {n} ranks; this world has "
                         f"{world}")
    pod, rest = divmod(rank, plan.data_rows * plan.tp_base)
    data, model = divmod(rest, plan.tp_base)
    mesh = TrainMesh(plan, rank, pod, data, model, {})
    P, D, M = plan.pods, plan.data_rows, plan.tp_base
    members = {
        "model": [[mesh_rank(plan, p, d, m) for m in range(M)]
                  for p in range(P) for d in range(D)],
        "data": [[mesh_rank(plan, p, d, m) for d in range(D)]
                 for p in range(P) for m in range(M)],
        "pod": [[mesh_rank(plan, p, d, m) for p in range(P)]
                for d in range(D) for m in range(M)],
        "dp": [[mesh_rank(plan, p, d, m) for p in range(P)
                for d in range(D)] for m in range(M)],
        "world": [list(range(n))]}
    built: Dict[tuple, object] = {}
    for axis, runs in members.items():
        mesh.groups[axis] = None
        mesh.stats[axis] = CommStats()
        for ranks in runs:
            if len(ranks) == 1:
                continue
            key = tuple(ranks)
            if key not in built:
                built[key] = None if len(ranks) == world \
                    else dist.new_group(ranks=ranks)
            if rank in ranks:
                mesh.groups[axis] = RankGroup(built[key], ranks,
                                              ranks.index(rank),
                                              mesh.stats[axis])
    return mesh


def logical_specs(model: Model, plan: ParallelPlan):
    """The training specs of ``model``'s logical parameter tree (drawn
    on the meta device: shapes only)."""
    meta = Model(model.cfg, model.dtype, torch.device("meta")).init(
        torch.Generator(device="cpu"))
    return WeightsManager(model.cfg, plan).partition_specs(meta)


def _all_reduce_many(tensors: List[torch.Tensor], group: RankGroup) -> None:
    """Sum ``tensors`` over ``group`` in place, one all_reduce a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = group.all_reduce(torch.cat([t.reshape(-1) for t in ts]))
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def build_train_step(model: Model, plan: ParallelPlan, *,
                     opt: Optional[AdamW] = None, aux_weight: float = 0.01,
                     mesh: Optional[TrainMesh] = None):
    """Returns ``step((params, opt_state), batch) -> ((params, opt_state),
    {"loss", "total"})`` for this rank of ``plan`` (``mesh``: default
    ``train_mesh(plan)``, which checks the world). ``params`` is the
    rank's shards of the logical tree (``WeightsManager.train_shard``;
    the whole tree on one rank) and ``opt_state`` their ``opt.init``.
    ``batch`` holds the global batch's ``tokens`` and ``labels`` [B,T]
    (tensors or numpy arrays, the same on every rank), and for a model
    with a modality frontend its ``frontend_embeds``; the rank's rows
    move to the model's device. A vision prefix makes the logits longer
    than the labels: only the text tail is scored, as in the JAX
    package. The parameters are updated in place and returned as
    given. ``step.gradients(params, batch)`` is the step's gradient
    alone: (this rank's shard of it, leaves in tree order, the loss,
    the total)."""
    cfg = model.cfg
    opt = opt or AdamW()
    mesh = mesh or train_mesh(plan)
    if mesh.plan != plan:
        raise ValueError(f"a mesh of {mesh.plan} for {plan}")
    tp, D = plan.tp_base, mesh.dp_size
    ctx = make_train_ctx(tp, mesh.groups["model"])
    specs: List[Spec] = tree_leaves(logical_specs(model, plan))
    zero = [("data" in s) and plan.data_rows > 1 for s in specs]
    # each shard's copies across the world: the norm counts it once
    weight = torch.tensor(
        [(tp if "model" in s else 1) * (plan.data_rows if z else 1)
         / mesh.world for s, z in zip(specs, zero)], device=model.device)
    groups = mesh.groups

    def loss_fn(params, batch):
        logits, _, aux = model.forward(
            params, ctx, mode="train", tokens=batch["tokens"],
            backend=TrainBackend(),
            frontend_embeds=batch.get("frontend_embeds"))
        labels = batch["labels"]
        if logits.shape[1] != labels.shape[1]:
            # modality prefix (VLM): score only the text tail
            logits = logits[:, -labels.shape[1]:]
        loss = tp_cross_entropy(cfg, logits, labels, ctx)
        return loss + aux_weight * aux, loss

    def rows(v):
        v = torch.as_tensor(v)
        if v.shape[0] % D:
            raise ValueError(f"a batch of {v.shape[0]} rows does not "
                             f"split over {D} data ranks")
        n = v.shape[0] // D
        return v[mesh.dp_index * n:(mesh.dp_index + 1) * n].to(
            model.device)

    def gather_zero(leaves):
        """Each ZeRO-3 leaf whole (all-gathered over 'data'), a fresh
        leaf of the graph; the rest themselves."""
        work = []
        for p, s, z in zip(leaves, specs, zero):
            if z:
                d = s.axes.index("data")
                p = torch.cat(groups["data"].all_gather(p.detach()), dim=d)
            work.append(p.requires_grad_(True))
        return work

    @torch.no_grad()
    def reduce_grads(grads):
        """Rank-local gradients -> this rank's shard of the global
        batch's gradient."""
        grads = list(grads)
        if any(zero):
            # ZeRO-3: reduce-scatter over 'data' (all_reduce + this
            # rank's slice: gloo has no reduce_scatter)
            _all_reduce_many([g for g, z in zip(grads, zero) if z],
                             groups["data"])
            for i, s in enumerate(specs):
                if zero[i]:
                    d = s.axes.index("data")
                    n = grads[i].shape[d] // plan.data_rows
                    grads[i] = grads[i].narrow(d, mesh.data * n, n) \
                        .contiguous()
            if groups["pod"] is not None:
                _all_reduce_many([g for g, z in zip(grads, zero) if z],
                                 groups["pod"])
        if groups["dp"] is not None:
            _all_reduce_many([g for g, z in zip(grads, zero) if not z],
                             groups["dp"])
        if groups["model"] is not None:
            _all_reduce_many([g for g, s in zip(grads, specs)
                              if "model" not in s], groups["model"])
        if D > 1:
            for g in grads:
                g.div_(D)
        return grads

    def global_sq(sq):
        total = (sq * weight).sum()
        if groups["world"] is not None:
            total = groups["world"].all_reduce(total)
        return total

    def gradients(params, batch):
        """(this rank's shard of the global batch's gradient, a list in
        tree order; the global loss and total) at ``params``."""
        batch = {k: rows(v) for k, v in batch.items()}
        leaves = tree_leaves(params)
        if len(leaves) != len(specs):
            raise ValueError(f"{len(leaves)} parameter leaves for "
                             f"{len(specs)} specs")
        work = gather_zero(leaves)
        total, loss = loss_fn(tree_unflatten(params, work), batch)
        # a leaf the loss does not reach (an encoder layer's unused cross
        # sub-block) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(
            total, work, grad_outputs=torch.full_like(total, 1.0 / tp),
            allow_unused=True, materialize_grads=True)
        both = torch.stack([loss.detach(), total.detach()])
        if groups["dp"] is not None:
            both = groups["dp"].all_reduce(both) / D
        return reduce_grads(grads), both[0], both[1]

    def step(carry, batch) -> tuple:
        params, opt_state = carry
        grads, loss, total = gradients(params, batch)
        params, opt_state = opt.update(
            params, tree_unflatten(params, grads), opt_state,
            global_sq=global_sq)
        mets: Dict[str, torch.Tensor] = {"loss": loss, "total": total}
        return (params, opt_state), mets

    step.gradients = gradients
    return step
