"""What each kernel costs: the bytes it must move and the operations it
does, one function a kernel, and the sink the meta routes report to.

The definitions are ``PERF.md`` section 6's: each input read once, each
output written once, nothing staged between a kernel's launches; an
attention kernel does 4 hd operations a live (query row, key) pair and
head forward (two products) and 10 backward (five); K6's and K7's
operations are those of the TPU kernels' products and terms. ``bound_ms``
turns a cost into the card's least time for it at the H100's data-sheet
HBM rate and dense bf16 peak (``serving/hardware.py``).

Where the work depends on the data (the live keys of a paged table) the
caller passes what its data needs. A kernel wrapper called with meta
tensors (the dry run, ``launch/dryrun.py``) knows no lengths, so it
counts every block of its table as live, as the JAX package's refs
attend over the whole gathered table; it reports its cost with
``record``, which adds it to every open ``Sink``. No other call records
anything.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple


@dataclass(frozen=True)
class Cost:
    nbytes: float
    flops: float

    def __add__(self, other: "Cost") -> "Cost":
        return Cost(self.nbytes + other.nbytes, self.flops + other.flops)


def bound_ms(c: Cost, hw=None) -> Tuple[float, str]:
    """The card's least time (ms) for ``c`` and what sets it: ``"bytes"``
    at ``hw.hbm_bw`` or ``"operations"`` at ``hw.peak_flops_bf16``
    (default the H100's data sheet)."""
    if hw is None:
        from repro_torch.serving.hardware import H100 as hw
    t_b = c.nbytes / hw.hbm_bw * 1e3
    t_f = c.flops / hw.peak_flops_bf16 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


# ---------------------------------------------------------------------------
# one function a kernel
# ---------------------------------------------------------------------------

def append(rows: int, width: int, pools: int, val_bytes: int,
           pool_bytes: int) -> Cost:
    """K1 and K3: ``rows`` slots (parked ones too) of ``width`` elements
    into each of ``pools`` pools: the values read, the pool rows written,
    the int32 slots read."""
    return Cost(pools * rows * width * (val_bytes + pool_bytes) + 4 * rows,
                0.0)


def paged_decode(B: int, H: int, KV: int, hd: int, keys: int, pages: int,
                 q_bytes: int, out_bytes: int, pool_bytes: int,
                 lse: bool = False) -> Cost:
    """K2: q [B,H,hd] read and out written, the ``keys`` live keys' K and V
    rows (KV heads of hd) read over ``pages`` block-table entries, the
    context lengths, and the fp32 lse when asked."""
    nbytes = B * H * hd * (q_bytes + out_bytes) + keys * KV * hd * 2 * \
        pool_bytes + pages * 4 + B * 4 + (B * H * 4 if lse else 0)
    return Cost(nbytes, 4.0 * H * hd * keys)


def mla_decode(B: int, H: int, W: int, R: int, keys: int, pages: int,
               q_bytes: int, pool_bytes: int, lse: bool = False) -> Cost:
    """K2 at MLA width: q [B,H,W] read, out [B,H,R] fp32 written, the live
    keys' compressed entries of W read once for all H heads, the pages,
    the lengths, and the fp32 lse when asked; 2 (W + R) operations a
    live (head, key) pair."""
    nbytes = keys * W * pool_bytes + B * H * (W * q_bytes + R * 4) \
        + pages * 4 + B * 4 + (B * H * 4 if lse else 0)
    return Cost(nbytes, 2.0 * (W + R) * H * keys)


def paged_prefill(B: int, T: int, H: int, KV: int, hd: int, keys: int,
                  pages: int, pairs: int, q_bytes: int, out_bytes: int,
                  pool_bytes: int, lse: bool = False) -> Cost:
    """K4: q [B,T,H,hd] read and out written, the ``keys`` keys its rows
    read (summed over requests) over ``pages`` table entries, the prior
    lengths and the fp32 lse when asked; ``pairs`` live (query row, key)
    pairs summed over requests, each for every head."""
    nbytes = B * T * H * hd * (q_bytes + out_bytes) + keys * KV * hd * 2 * \
        pool_bytes + pages * 4 + B * 4 + (B * H * T * 4 if lse else 0)
    return Cost(nbytes, 4.0 * H * hd * pairs)


def causal_pairs(T: int, window: Optional[int] = None) -> int:
    """Live (query, key) pairs of one causal row of T, under a window."""
    w = window or T
    if w >= T:
        return T * (T + 1) // 2
    return w * (w + 1) // 2 + (T - w) * w


def flash(B: int, T: int, H: int, KV: int, hd: int, elem: int,
          window: Optional[int] = None, backward: bool = False) -> Cost:
    """K5 forward (q, k, v read, out and the fp32 lse written) or backward
    (q, out, dout, k, v and lse read, dq, dk, dv written)."""
    pairs = B * H * causal_pairs(T, window)
    qb, kb, stat = B * T * H * hd * elem, B * T * KV * hd * elem, B * H * T * 4
    if backward:
        return Cost(4 * qb + 4 * kb + stat, 10.0 * hd * pairs)
    return Cost(2 * qb + 2 * kb + stat, 4.0 * hd * pairs)


def ssd(Bs: int, T: int, H: int, hd: int, S: int, chunk: int, x_bytes: int,
        bc_bytes: int, h0: bool = False, backward: bool = False) -> Cost:
    """K6 over T padded to whole chunks: forward x, dt (fp32), A, B, C
    (and h0) read, y and hT (fp32) written; backward the five inputs and
    dy (fp32) read, their five gradients written."""
    xb, yb = Bs * T * H * hd * x_bytes, Bs * T * H * hd * 4
    bcb, dtb = 2 * Bs * T * S * bc_bytes, Bs * T * H * 4
    htb = Bs * H * hd * S * 4
    per = Bs * H * (T // chunk)
    ch = chunk
    if backward:
        return Cost(2 * (xb + dtb + H * 4 + bcb) + yb,
                    per * (2 * ch * ch * (3 * S + 2 * hd) + 10 * ch * hd * S))
    return Cost(xb + dtb + H * 4 + bcb + yb + htb + (htb if h0 else 0),
                per * (2 * ch * ch * S + 2 * ch * ch * hd + 4 * ch * hd * S))


def rglru(B: int, T: int, C: int, elem: int, h0: bool = False,
          backward: bool = False) -> Cost:
    """K7: forward a and g read (and h0, fp32), y and hT (fp32) written,
    two operations an element; backward a, y and dy read, da and dg
    written, three."""
    n = B * T * C
    if backward:
        return Cost(n * (elem + 4 + 4) + 2 * n * elem, 3.0 * n)
    return Cost(2 * n * elem + n * 4 + B * C * 4 + (B * C * 4 if h0 else 0),
                2.0 * n)


def live_keys(lengths, page: int) -> Tuple[int, int]:
    """(keys, pages) of rows with these live key counts."""
    return (int(sum(int(n) for n in lengths)),
            int(sum(math.ceil(int(n) / page) for n in lengths)))


# ---------------------------------------------------------------------------
# the sink the meta routes report to
# ---------------------------------------------------------------------------

@dataclass
class Sink:
    """Kernel calls recorded while open: by kernel name, calls, bytes and
    operations; and the storages (``_cdata``) of the tensors they read."""
    calls: Dict[str, int] = field(default_factory=dict)
    nbytes: Dict[str, float] = field(default_factory=dict)
    flops: Dict[str, float] = field(default_factory=dict)
    reads: Set[int] = field(default_factory=set)

    @property
    def total(self) -> Cost:
        return Cost(sum(self.nbytes.values()), sum(self.flops.values()))

    def __enter__(self) -> "Sink":
        _SINKS.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _SINKS.remove(self)


_SINKS: List[Sink] = []


def record(name: str, c: Cost, *reads) -> None:
    """Add one call of kernel ``name`` costing ``c``, which reads the
    tensors ``reads`` (None ignored), to every open sink."""
    keys = {t.untyped_storage()._cdata for t in reads if t is not None}
    for s in _SINKS:
        s.calls[name] = s.calls.get(name, 0) + 1
        s.nbytes[name] = s.nbytes.get(name, 0.0) + c.nbytes
        s.flops[name] = s.flops.get(name, 0.0) + c.flops
        s.reads |= keys
