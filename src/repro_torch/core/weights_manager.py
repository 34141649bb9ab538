"""Model Weights Manager (paper §4.1), one process per rank.

Weights are loaded ONCE into the *canonical storage layout*: every tensor
sharded over the engine-tile axes ``('ed','model')`` on its partition dim
(when divisible, the same rule ``TPContext.stored_shards`` assumes) and
replicated over the DP axes ``('pod','dp','merge')``. A rank's storage
shard is therefore the same under every mode: rank ``r`` holds engine-
tile position ``r % (engine_rows * tp_base)`` of each tensor. Re-binding
the params to another island or mode is a pure metadata operation: no
bytes move (the paper's zero-copy invariant; ``island_view`` and
``shard_view`` return the resident tensors themselves; the engine
asserts it by ``data_ptr()`` comparison under ``check_zero_copy``).

TP execution then *activates* per-rank views inside the step
(core/views.py), never resharding storage. This module owns the
name->rule mapping that keeps the storage shards and
``TPContext.activate`` consistent (copied from the JAX package's).

Training has a layout of its own, the JAX package's ``_spec_for(train=
True)`` over the mesh ``('pod', 'data', 'model')``: DENSE and EXPERT
dims over 'model' (MODEL_ONLY where no dim took 'model'), and for
``engine_rows > 1`` ZeRO-3 over 'data' on the first free dim of at least
1024 that divides (``train_dims``). ``train_shard`` cuts a logical tree
into one rank's shards, ``gather_train`` puts the shards of every rank
back together (collective).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.modes import ParallelPlan
from repro_torch.models.mamba2 import dims as mamba_dims
from repro_torch.models.rglru import width as rg_width
from repro_torch.training.checkpoint import tree_leaves

if TYPE_CHECKING:
    from repro_torch.core.views import RankGroup

# rule kinds
DENSE = "dense"       # partition dim over ('ed','model') jointly
EXPERT = "expert"     # expert dim over 'ed'
MODEL_ONLY = "model"  # dim over 'model' (expert d_ff; merge adds views)
REPL = "repl"


@dataclass(frozen=True)
class Rule:
    """(axis_from_end, logical unit count, kind) per sharded dim."""
    dims: Tuple[Tuple[int, int, str], ...] = ()


def _units(cfg: ArchConfig) -> Dict[str, int]:
    u = {
        "H": cfg.num_heads, "KV": cfg.num_kv_heads, "DFF": cfg.d_ff,
        "V": cfg.vocab_size,
    }
    if cfg.moe:
        u["E"] = cfg.moe.num_experts
        u["DFFE"] = cfg.moe.d_ff_expert
        u["SDFF"] = cfg.moe.num_shared_experts * cfg.moe.d_ff_expert
    if cfg.ssm:
        u["NH"] = mamba_dims(cfg)[1]
    if cfg.hybrid:
        u["W"] = rg_width(cfg)
    return u


def rule_for(cfg: ArchConfig, path: Tuple[str, ...]) -> Rule:
    """Shard rule for a param identified by its (parent..., name) path."""
    u = _units(cfg)
    name = path[-1]
    parent = next((p for p in reversed(path[:-1])
                   if p in ("attn", "cross", "mixer", "ffn", "shared",
                            "embed", "encoder")), "")

    if parent in ("attn", "cross"):
        table = {
            "wq": ((-1, u["H"], DENSE),), "wo": ((-2, u["H"], DENSE),),
            "wk": ((-1, u["KV"], DENSE),), "wv": ((-1, u["KV"], DENSE),),
            "wuq": ((-1, u["H"], DENSE),), "wuk": ((-1, u["H"], DENSE),),
            "wuv": ((-1, u["H"], DENSE),),
        }
        return Rule(table.get(name, ()))
    if parent == "shared":
        table = {
            "w_up": ((-1, u.get("SDFF", 0), DENSE),),
            "w_gate": ((-1, u.get("SDFF", 0), DENSE),),
            "w_down": ((-2, u.get("SDFF", 0), DENSE),),
        }
        return Rule(table.get(name, ()))
    if parent == "ffn":
        table = {
            "w_up": ((-1, u["DFF"], DENSE),),
            "w_gate": ((-1, u["DFF"], DENSE),),
            "w_down": ((-2, u["DFF"], DENSE),),
            "e_gate": ((-3, u.get("E", 0), EXPERT),
                       (-1, u.get("DFFE", 0), MODEL_ONLY)),
            "e_up": ((-3, u.get("E", 0), EXPERT),
                     (-1, u.get("DFFE", 0), MODEL_ONLY)),
            "e_down": ((-3, u.get("E", 0), EXPERT),
                       (-2, u.get("DFFE", 0), MODEL_ONLY)),
        }
        return Rule(table.get(name, ()))
    if parent == "mixer":
        n = u["NH"] if cfg.ssm else u.get("W", 0)
        table = {
            "w_z": ((-1, n, DENSE),), "w_x": ((-1, n, DENSE),),
            "w_dt": ((-1, n, DENSE),), "conv_x": ((-1, n, DENSE),),
            "conv_b_x": ((-1, n, DENSE),), "A_log": ((-1, n, DENSE),),
            "D": ((-1, n, DENSE),), "dt_bias": ((-1, n, DENSE),),
            "norm_w": ((-1, n, DENSE),), "w_out": ((-2, n, DENSE),),
            "w_gate": ((-1, n, DENSE),), "conv_w": ((-1, n, DENSE),),
            "conv_b": ((-1, n, DENSE),), "lam": ((-1, n, DENSE),),
            "gate_a_w": ((-1, n, DENSE),), "gate_a_b": ((-1, n, DENSE),),
            "gate_i_w": ((-1, n, DENSE),), "gate_i_b": ((-1, n, DENSE),),
        }
        return Rule(table.get(name, ()))
    # embed level
    table = {
        "tok": ((-2, u["V"], DENSE),),
        "head": ((-1, u["V"], DENSE),),
    }
    return Rule(table.get(name, ()))


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a dict/list/tuple tree; the path holds dict
    keys only (sequence positions dropped, as the JAX package's
    ``_path_keys`` drops them)."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path) for v in tree)
    return fn(path, tree)


@dataclass(frozen=True)
class Spec:
    """A leaf's training partition spec, the JAX package's
    ``PartitionSpec``: one mesh axis (or None) a dim."""
    axes: Tuple[Optional[str], ...]

    def __contains__(self, axis: str) -> bool:
        return axis in self.axes


class WeightsManager:
    """Owns the canonical layout and the zero-copy island views."""

    def __init__(self, cfg: ArchConfig, plan: ParallelPlan):
        self.cfg = cfg
        self.plan = plan
        self.storage = plan.engine_rows * plan.tp_base

    def shard_dims(self, path: Tuple[str, ...], shape: Tuple[int, ...]
                   ) -> List[Tuple[int, int, str]]:
        """(dim, shard count, mesh axes) of each dim the serving storage
        layout shards for the leaf at ``path`` (the JAX package's
        ``_spec_for`` with ``train=False``)."""
        ndim = len(shape)
        out: List[Tuple[int, int, str]] = []
        for (from_end, n, kind) in rule_for(self.cfg, path).dims:
            d = ndim + from_end
            if d < 0 or n <= 0:
                continue
            if kind == DENSE and n % self.storage == 0 and self.storage > 1:
                out.append((d, self.storage, "ed,model"))
            elif kind == EXPERT and self.plan.engine_rows > 1 \
                    and n % self.plan.engine_rows == 0:
                out.append((d, self.plan.engine_rows, "ed"))
            elif kind == MODEL_ONLY and n % self.plan.tp_base == 0 \
                    and self.plan.tp_base > 1 \
                    and all(a != "model" for _, _, a in out):
                out.append((d, self.plan.tp_base, "model"))
        return out

    def train_dims(self, path: Tuple[str, ...], shape: Tuple[int, ...]
                   ) -> "Spec":
        """The training partition spec of the leaf at ``path``: one entry
        a dim, ``"model"``, ``"data"`` or None (the JAX package's
        ``_spec_for`` with ``train=True``)."""
        ndim, tp = len(shape), self.plan.tp_base
        entries: List[Optional[str]] = [None] * ndim
        for (from_end, n, kind) in rule_for(self.cfg, path).dims:
            d = ndim + from_end
            if d < 0 or n <= 0:
                continue
            if kind in (DENSE, EXPERT) and n % tp == 0:
                entries[d] = "model"
            elif kind == MODEL_ONLY and n % tp == 0 \
                    and "model" not in entries:
                entries[d] = "model"
        if self.plan.engine_rows > 1:
            for d in range(ndim):
                if entries[d] is None and shape[d] >= 1024 \
                        and shape[d] % self.plan.data_rows == 0:
                    entries[d] = "data"
                    break
        return Spec(tuple(entries))

    def partition_specs(self, params):
        """The tree of ``train_dims`` of ``params`` (the JAX package's
        ``partition_specs(train=True)``; the serving layout is
        ``shard_dims``)."""
        return _map_with_path(
            lambda path, t: self.train_dims(path, tuple(t.shape)), params)

    def _counts(self) -> Dict[str, int]:
        return {"model": self.plan.tp_base, "data": self.plan.data_rows}

    def train_shard(self, params, pod: int, data: int, model: int,
                    device=None):
        """The shards of the logical tree ``params`` that the rank at
        ``(pod, data, model)`` of the training mesh holds, each a copy of
        its own on ``device`` (default: where the leaf lies). Raises if a
        sharded dim does not divide (a tree of another config)."""
        if not (0 <= pod < self.plan.pods and 0 <= data < self.plan.data_rows
                and 0 <= model < self.plan.tp_base):
            raise ValueError(f"({pod}, {data}, {model}) is off the mesh of "
                             f"{self.plan}")
        index, counts = {"model": model, "data": data}, self._counts()

        def one(path, t: torch.Tensor):
            spec = self.train_dims(path, tuple(t.shape))
            for d, axis in enumerate(spec.axes):
                if axis is None:
                    continue
                if t.shape[d] % counts[axis]:
                    raise ValueError(
                        f"{'/'.join(path)}: dim {d} of {tuple(t.shape)} "
                        f"does not split {counts[axis]} ways over '{axis}'")
                size = t.shape[d] // counts[axis]
                t = t.narrow(d, index[axis] * size, size)
            dev = t.device if device is None else torch.device(device)
            return t.to(dev, copy=True).contiguous()
        return _map_with_path(one, params)

    def gather_train(self, shards, specs, groups: Dict[str, "RankGroup"]):
        """The logical tree from every rank's ``train_shard``: each leaf
        all-gathered over the groups of the axes its spec (``specs``, the
        ``partition_specs`` of the logical tree) shards it on
        (``groups["model"]``, ``groups["data"]``). Collective: every rank
        of the mesh calls it, and each gets the whole tree."""
        counts = self._counts()

        def one(t: torch.Tensor, spec: Spec):
            for d, axis in enumerate(spec.axes):
                if axis is not None and counts[axis] > 1:
                    t = torch.cat(groups[axis].all_gather(t), dim=d)
            return t
        return zip_map(one, shards, specs)

    def storage_shard(self, params, storage_rank: int, device=None):
        """This rank's canonical storage shard of the full parameter tree
        ``params``: each sharded dim narrowed to position ``storage_rank``
        (``ed * tp_base + model``) of the engine tile. A sharded leaf is
        copied into storage of its own on ``device`` (the full tensor can
        then be freed); a replicated leaf is the tensor itself when it
        already lies on ``device``."""
        if not 0 <= storage_rank < self.storage:
            raise ValueError(f"storage rank {storage_rank} of "
                             f"{self.storage}")
        ed, model = divmod(storage_rank, self.plan.tp_base)
        index = {"ed,model": storage_rank, "ed": ed, "model": model}

        def one(path, t: torch.Tensor):
            cuts = self.shard_dims(path, tuple(t.shape))
            for d, k, axes in cuts:
                size = t.shape[d] // k
                t = t.narrow(d, index[axes] * size, size)
            dev = t.device if device is None else torch.device(device)
            return t.to(dev, copy=bool(cuts)) if cuts else t.to(dev)
        return _map_with_path(one, params)

    def island_view(self, params):
        """One island's view of the canonical params: the rank's resident
        storage shard, unchanged. The canonical layout shards only
        ('ed','model') and replicates over the DP axes an island subsets,
        so every rank already holds what any island asks of it."""
        return _map_with_path(lambda _, a: shard_view(a), params)


def zip_map(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(zip_map(fn, v, o) for v, o in zip(tree, other))
    return fn(tree, other)


def shard_view(a: torch.Tensor) -> torch.Tensor:
    """The resident shard ``a`` under another island's binding: the tensor
    itself (the JAX package assembles a global array from the same
    per-device buffers)."""
    return a


def _ptrs(tree) -> Tuple[int, ...]:
    """The ``data_ptr()`` of every tensor in ``tree``, in tree order."""
    return tuple(t.data_ptr() for t in tree_leaves(tree))
