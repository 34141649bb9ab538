"""Carry parameters over from the JAX package's layout.

The JAX package's parameter pytree — ``{"embed": {...}, "groups": [(per
kind dict, ...), ...]}``, layers of a group stacked on axis 0 — is the
port's parameter tree leaf for leaf. ``params_from_numpy`` takes that
tree with numpy leaves and returns torch tensors of the same nesting,
checked against the shapes the port's ``Model`` draws itself.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import Model


def _leaf(a: np.ndarray, dtype: Optional[torch.dtype]) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes bf16: no numpy bridge
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


def _convert(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_convert(v, dtype, device) for v in tree)
    return _leaf(tree, dtype).to(device)


def params_from_numpy(cfg: ArchConfig, tree: Any, *,
                      dtype: Optional[torch.dtype] = None,
                      device="cpu") -> Any:
    """The JAX package's param tree (numpy leaves) as the port's
    parameters on ``device``; ``dtype`` casts every leaf (None keeps each
    leaf's own)."""
    want = _shapes(Model(cfg, torch.float32, torch.device("meta")).init(
        torch.Generator(device="cpu")))
    got = _shapes(tree)
    if got != want:
        raise ValueError(f"param tree of {cfg.name} does not match the "
                         f"port's layout:\n{got}\nvs\n{want}")
    return _convert(tree, dtype, torch.device(device))
