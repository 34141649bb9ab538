"""Roofline terms of one step of the port, counted on the meta device.

Three terms per (arch x shape x mesh), in seconds:

    compute    = FLOPs a rank / peak
    memory     = HBM bytes a rank / hbm_bw
    collective = wire bytes a rank / link rate

``_DTYPE_BYTES``, ``wire_bytes``, ``RooflineTerms`` and ``model_flops``
are the JAX package's (``RooflineTerms`` defaults to the H100 and takes
the rate beyond one link domain, ``Hardware.inter_bw``, for a group
wider than the domain). The JAX package reads its counts from XLA's
compiled artifacts (``collective_bytes`` and
``collective_bytes_stablehlo`` parse the HLO, ``scaled_cost`` and
``scaled_collectives`` scale a scanned layer's count from two unrolled
probes). The port has no HLO and runs its layers in a Python loop, so
every layer is counted as it runs: ``count()`` runs a step on meta
tensors and adds up

- (a) the GEMM FLOPs of aten ops (``torch.utils.flop_counter``);
- (b) each kernel call's FLOPs and HBM bytes, which its wrapper's meta
  route reports (``kernels/cost.py``);
- (c) the collectives' result bytes by kind, from the ``CommStats`` of
  the groups the step runs over;
- (d) the bytes every other aten op reads and writes (each input and
  output once: the eager program's traffic, which XLA's ``bytes
  accessed`` counts after fusion) and the peak of live tensor bytes the
  step allocates, by a dispatch mode of its own (``_Tally``).

Elementwise FLOPs are not counted (XLA's ``flops`` counts them): the
compute term is the GEMMs' and the kernels'.
"""
from __future__ import annotations

import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Set

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.views import tensor_bytes
from repro_torch.kernels import cost
from repro_torch.serving.hardware import H100, Hardware

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}


def wire_bytes(coll: Dict[str, int], tp_hint: int = 16) -> float:
    """Bytes actually crossing links per device, ring-algorithm factors:
    all-reduce moves 2(p-1)/p of the buffer, gather/scatter (p-1)/p,
    all-to-all (p-1)/p, permute 1x."""
    p = max(tp_hint, 2)
    f_ar = 2 * (p - 1) / p
    f_ag = (p - 1) / p
    return (coll.get("all-reduce", 0) * f_ar
            + coll.get("all-gather", 0) * f_ag
            + coll.get("reduce-scatter", 0) * f_ag
            + coll.get("all-to-all", 0) * f_ag
            + coll.get("collective-permute", 0) * 1.0)


@dataclass
class RooflineTerms:
    flops: float            # per device
    hbm_bytes: float        # per device
    coll_bytes: float       # per device wire bytes
    chips: int
    hw: Hardware = H100
    group: int = 1          # ranks of the widest group the bytes cross

    @property
    def t_compute(self) -> float:
        return self.flops / self.hw.peak_flops_bf16

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / self.hw.hbm_bw

    @property
    def link_bw(self) -> float:
        """The link rate a rank sees: within one domain the fast links,
        beyond it ``inter_bw``."""
        return self.hw.ici_bw if self.group <= self.hw.domain_ranks \
            else self.hw.inter_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.link_bw

    @property
    def dominant(self) -> str:
        ts = {"compute": self.t_compute, "memory": self.t_memory,
              "collective": self.t_collective}
        return max(ts, key=ts.get)

    def row(self) -> Dict:
        return {
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "flops_per_dev": self.flops,
            "hbm_bytes_per_dev": self.hbm_bytes,
            "coll_bytes_per_dev": self.coll_bytes,
        }


def model_flops(cfg, shape, phase: str) -> float:
    """MODEL_FLOPS = 6ND (train) / 2ND (inference) on active params,
    plus attention context terms — the 'useful work' yardstick."""
    n = cfg.active_params()
    toks = shape.global_batch * (shape.seq_len if phase != "decode" else 1)
    mult = 6 if phase == "train" else 2
    base = mult * n * toks
    # attention: 2*2*L*d_kvproj... context term (approximate, GQA/MLA):
    hd = cfg.resolved_head_dim
    H = cfg.num_heads
    L = cfg.num_layers
    if cfg.family == "ssm":
        return base
    ctx = shape.seq_len
    if phase == "decode":
        att = 2 * 2 * L * H * hd * ctx * toks
    else:
        att = 2 * 2 * L * H * hd * (ctx / 2) * toks
    if phase == "train":
        att *= 3  # fwd + bwd
    return base + att


# ---------------------------------------------------------------------------
# counting a step
# ---------------------------------------------------------------------------

def _is_view(func) -> bool:
    """True for an op whose every result aliases an input without
    writing it (a view: no bytes move)."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _fresh(func):
    """Whether each result of ``func`` is a new tensor (no alias)."""
    return [r.alias_info is None for r in func._schema.returns]


_OVERWRITES = (torch.ops.aten.copy_.default, torch.ops.aten.fill_.Scalar,
               torch.ops.aten.fill_.Tensor, torch.ops.aten.zero_.default)


def _leaves(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tree_bytes(tree) -> int:
    """Bytes of every tensor in a tree of dicts, lists and tuples."""
    return sum(tensor_bytes(t) for t in _leaves(tree))


class _Tally(TorchDispatchMode):
    """Bytes every aten op reads and writes (views and collectives
    apart), the storages (``_cdata``) those ops read, and the peak of the
    bytes of the storages allocated under the mode and still alive (a
    storage is freed when its last tensor, the autograd graph's saved
    ones included, goes)."""

    def __init__(self):
        super().__init__()
        self.op_bytes = 0
        self.live = 0
        self.peak = 0
        self.reads = set()
        self._keys = set()

    def _free(self, key: int, n: int) -> None:
        self._keys.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        if ns == "c10d" or ns == "_c10d_functional" or _is_view(func):
            return out
        ins = [t for t in tree_flatten((args, kwargs or {}))[0]
               if isinstance(t, torch.Tensor)]
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.op_bytes += sum(tensor_bytes(t) for t in ins)
        # an op that overwrites its first argument does not read it
        written = args[0] if func in _OVERWRITES else None
        self.reads.update(t.untyped_storage()._cdata for t in ins
                          if t is not written)
        fresh = _fresh(func)
        for i, t in enumerate(outs):
            if not isinstance(t, torch.Tensor):
                continue
            self.op_bytes += tensor_bytes(t)
            if i < len(fresh) and fresh[i]:
                st = t.untyped_storage()
                key = st._cdata
                if key not in self._keys:
                    n = st.nbytes()
                    self._keys.add(key)
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(st, self._free, key, n)
        return out


@dataclass
class Counts:
    """What ``count()`` added up over one step (module docstring)."""
    gemm_flops: float = 0.0
    kernels: cost.Sink = field(default_factory=cost.Sink)
    collectives: Dict[str, int] = field(default_factory=dict)
    op_bytes: float = 0.0
    peak_bytes: int = 0
    # the storages (``_cdata``) that ops and kernels read
    reads: Set[int] = field(default_factory=set)

    def read_bytes(self, tree) -> int:
        """Bytes of the tensors of ``tree`` the step read: XLA's
        argument bytes count only the arguments a program uses (jit
        prunes the rest)."""
        return sum(tensor_bytes(t) for t in _leaves(tree)
                   if t.untyped_storage()._cdata in self.reads)

    @property
    def flops(self) -> float:
        return self.gemm_flops + self.kernels.total.flops

    @property
    def hbm_bytes(self) -> float:
        return self.op_bytes + self.kernels.total.nbytes


@contextmanager
def count(stats: Iterable = ()) -> Iterator[Counts]:
    """Count what runs inside: yields a ``Counts`` filled in on exit.
    ``stats`` are the ``CommStats`` of the groups the step's collectives
    run over; their bytes by kind are taken as they grow inside."""
    from torch.utils.flop_counter import FlopCounterMode
    stats = list({id(s): s for s in stats}.values())
    before = [dict(s.nbytes) for s in stats]
    counts = Counts()
    tally = _Tally()
    with FlopCounterMode(display=False) as fc, counts.kernels, tally:
        yield counts
    counts.gemm_flops = float(fc.get_total_flops())
    counts.op_bytes = float(tally.op_bytes)
    counts.peak_bytes = int(tally.peak)
    counts.reads = tally.reads | counts.kernels.reads
    for s, b in zip(stats, before):
        for k, v in s.nbytes.items():
            d = v - b.get(k, 0)
            if d:
                counts.collectives[k] = counts.collectives.get(k, 0) + d
