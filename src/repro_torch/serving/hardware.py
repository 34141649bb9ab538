"""Hardware constants (TPU v5e target) used by the cost model and the
roofline analysis."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Hardware:
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12     # FLOP/s per chip
    hbm_bw: float = 819e9               # B/s per chip
    hbm_bytes: float = 16e9             # per chip
    ici_bw: float = 50e9                # B/s per link
    ici_latency: float = 1e-6           # per-hop collective latency (s)
    # cold-start modeling (static baselines; paper Table 2 cold restarts)
    weight_load_bw: float = 2e9         # B/s per chip from host/storage
    startup_fixed: float = 20.0         # process/compile/init seconds
    mfu_prefill: float = 0.5            # achievable fraction of peak
    mfu_decode_bw: float = 0.7          # achievable fraction of HBM bw


V5E = Hardware()

# paper's evaluation hardware, for reproducing the published numbers
H200 = Hardware(name="h200", peak_flops_bf16=989e12, hbm_bw=4.8e12,
                hbm_bytes=141e9, ici_bw=450e9, ici_latency=2e-6,
                weight_load_bw=1.5e9, startup_fixed=30.0)

# the port's card: NVIDIA H100 SXM5 data sheet (dense bf16 tensor-core
# FLOP/s, HBM3 bandwidth and capacity, NVLink 4 at 900 GB/s both ways);
# the remaining fields take H200's values
H100 = Hardware(name="h100", peak_flops_bf16=989e12, hbm_bw=3.35e12,
                hbm_bytes=80e9, ici_bw=450e9, ici_latency=2e-6,
                weight_load_bw=1.5e9, startup_fixed=30.0)
