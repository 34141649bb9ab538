"""Checkpoints in the JAX package's on-disk layout, and the tree helpers
the training path uses.

A checkpoint is a directory of ``leaf_{i}.npy`` files plus
``manifest.json`` (``n_leaves``, ``step``, ``treedef``), with the leaves
in ``jax.tree.flatten`` order: dict keys sorted, lists and tuples in
order. The port's parameter tree has the JAX package's nesting, so a
checkpoint either package wrote restores into the other. bf16 leaves are
stored as numpy writes ml_dtypes' bfloat16, raw 2-byte words (``<V2``).

Sharded training keeps the same files: ``save_sharded`` gathers the
ranks' shards into the logical tree and rank 0 writes it, and
``restore_sharded`` reads the logical tree and hands each rank its
shards (``WeightsManager.train_shard``), so a checkpoint of any plan
restores at any other, or into the JAX package.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable, List, Tuple

import numpy as np
import torch


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree.flatten`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """A tree of ``like``'s structure holding ``leaves`` in order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree):
    return tree_unflatten(tree, [fn(x) for x in tree_leaves(tree)])


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:     # bf16 words
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def save(path: str, tree, step: int = 0) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = tree_leaves(tree)
    for i, leaf in enumerate(leaves):
        np.save(os.path.join(path, f"leaf_{i}.npy"), _to_numpy(leaf))
    manifest = {"n_leaves": len(leaves), "step": step,
                "treedef": f"port tree of {len(leaves)} leaves"}
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)


def restore(path: str, like_tree) -> Tuple[Any, int]:
    """(tree, step): the leaves of the checkpoint at ``path`` in
    ``like_tree``'s structure, each on its like leaf's device and in its
    dtype (a like leaf on the meta device: on the CPU as stored); shapes
    must match."""
    like = tree_leaves(like_tree)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["n_leaves"] != len(like):
        raise ValueError(f"checkpoint holds {manifest['n_leaves']} leaves, "
                         f"the tree {len(like)}")
    new = []
    for i, old in enumerate(like):
        t = _to_torch(np.load(os.path.join(path, f"leaf_{i}.npy")))
        if tuple(t.shape) != tuple(old.shape):
            raise ValueError(f"leaf {i}: {tuple(t.shape)} vs "
                             f"{tuple(old.shape)}")
        new.append(t if old.device.type == "meta"
                   else t.to(device=old.device, dtype=old.dtype))
    return tree_unflatten(like_tree, new), manifest["step"]


def latest_step(path: str) -> int:
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            return json.load(f)["step"]
    except FileNotFoundError:
        return -1


def save_sharded(path: str, shards, mesh, model, step: int = 0) -> None:
    """Save the logical tree of the training ranks' ``shards`` (this
    rank's, under ``mesh``, a ``train_step.TrainMesh``): every rank of
    the mesh calls it (the gather is collective), rank 0 writes."""
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.training.train_step import logical_specs
    tree = WeightsManager(model.cfg, mesh.plan).gather_train(
        shards, logical_specs(model, mesh.plan), mesh.groups)
    if mesh.rank == 0:
        save(path, tree, step)
    if mesh.groups["world"] is not None:
        mesh.groups["world"].all_reduce(torch.zeros(1, device=model.device))


def restore_sharded(path: str, like_shards, mesh, model) -> Tuple[Any, int]:
    """(this rank's shards, step) of the logical checkpoint at ``path``:
    the leaves checked against the model's logical shapes, cut to the
    rank's (pod, data, model) coordinate, each on its like shard's
    device and in its dtype."""
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.models.model import Model
    meta = Model(model.cfg, model.dtype, torch.device("meta")).init(
        torch.Generator(device="cpu"))
    logical, step = restore(path, meta)
    shards = WeightsManager(model.cfg, mesh.plan).train_shard(
        logical, mesh.pod, mesh.data, mesh.model)
    out = []
    for got, like in zip(tree_leaves(shards), tree_leaves(like_shards)):
        if tuple(got.shape) != tuple(like.shape):
            raise ValueError(f"shard {tuple(got.shape)} vs "
                             f"{tuple(like.shape)}")
        out.append(got.to(device=like.device, dtype=like.dtype))
    return tree_unflatten(like_shards, out), step
