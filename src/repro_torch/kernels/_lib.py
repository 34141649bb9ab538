"""Build, load and count the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into its own shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), bound with ``ctypes``. The first use of any kernel builds all
sources, one ``nvcc`` per source, all started together, into
``build/kernels/`` at the repository root; a library whose name carries
the hash of its sources is reused as long as they are unchanged.
Nothing here runs when a module is imported.

``LAUNCHES`` counts each kernel's launches: its wrapper adds one where it
launches the kernel, and nowhere else. ``LSE_LAUNCHES`` counts, of K2's
and K4's, those that return the LSE (the live lanes' partial sweeps).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("paged_append", "paged_attention", "paged_prefill",
           "flash_prefill", "ssd_scan", "rglru_scan")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

KERNELS = ("paged_append_token", "paged_attention", "paged_append_chunk",
           "mla_decode",
           "paged_flash_prefill", "flash_prefill", "flash_prefill_bwd",
           "ssd_scan", "ssd_scan_bwd", "rglru_scan", "rglru_scan_bwd")
LAUNCHES: Dict[str, int] = {k: 0 for k in KERNELS}
LSE_LAUNCHES: Dict[str, int] = {"paged_attention": 0,
                                "paged_flash_prefill": 0}
# nvcc's -Xptxas -v report of each source's last build (registers,
# shared memory, spills), for chip_smoke.py to print
BUILD_LOG: Dict[str, str] = {}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "paged_append": {
        "paged_append_rows": [_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _P]},
    "paged_attention": {
        "paged_attention_decode": [_P] * 9 + [_I] * 7 + [_F] + [_I] * 4
                                  + [_P],
        "mla_decode": [_P] * 7 + [_I] * 7 + [_F] + [_I] * 3 + [_P]},
    "paged_prefill": {
        "paged_flash_prefill": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, _I, _I, _F, _I, _I, _I, _P],
        "paged_prefill_tc_smem": [_I]},
    "flash_prefill": {
        "flash_prefill_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _P],
        "flash_prefill_bwd": [_P] * 11 + [_I] * 7 + [_F, _I, _P],
        "flash_tile_check": [_P] * 3 + [_I] * 2 + [_P],
        "flash_tc_smem": [_I, _I]},
    "ssd_scan": {
        "ssd_scan_fwd": [_P] * 8 + [_I] * 7 + [_P],
        "ssd_scan_fwd_tc": [_P] * 9 + [_I] * 7 + [_P],
        "ssd_scan_bwd": [_P] * 13 + [_I] * 7 + [_P],
        "ssd_scan_bwd_tc": [_P] * 17 + [_I] * 7 + [_P]},
    "rglru_scan": {
        "rglru_scan_fwd": [_P] * 4 + [_I] * 4 + [_P],
        "rglru_scan_bwd": [_P] * 5 + [_I] * 4 + [_P]},
}
_LIBS: Dict[str, ctypes.CDLL] = {}
# every C function of every source by name, filled when the libraries load
FUNCS: Dict[str, object] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, LSE_LAUNCHES):
        for k in counts:
            counts[k] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                       "machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for p in (CSRC / "common.cuh", CSRC / "hopper.cuh",
              CSRC / f"{name}.cu"):
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def build_all(force: bool = False) -> Dict[str, Path]:
    """Compile every source whose library is missing (every source, with
    ``force``), all in parallel; return the library path of each."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: BUILD_DIR / f"lib{n}-{_digest(n)}.so" for n in SOURCES}
    todo = [n for n in SOURCES if force or not paths[n].exists()]
    procs: List = []
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs.append((n, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for n, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu:\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def _load() -> None:
    """Build what is missing and load every library."""
    paths = build_all()
    for n, path in paths.items():
        cdll = ctypes.CDLL(str(path))
        for fn, argtypes in _SIGNATURES[n].items():
            f = getattr(cdll, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
            FUNCS[fn] = f
        _LIBS[n] = cdll


def func(name: str):
    """The C function ``name`` of any source, built and resolved at first
    use; after that the launch path's lookup is one dictionary read."""
    f = FUNCS.get(name)
    if f is None:
        _load()
        f = FUNCS[name]
    return f


def check(rc: int, what: str) -> None:
    """Raise on a kernel's launch status (its ``cudaGetLastError``)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream of ``t``'s device, without
    building a ``torch.cuda.Stream`` as ``current_stream`` does.
    ``torch._C._cuda_getCurrentRawStream`` is private API (Triton's
    launcher uses it); ``tools/k6_k1_bench.py`` times it against
    ``current_stream(device).cuda_stream``, which returns the same
    handle."""
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def require_cuda(*tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous tensor on the first one's
    CUDA device; each tensor is looked at once (an int compare of its
    device index, -1 on the CPU, and its contiguity)."""
    first = tensors[0]
    if not first.is_cuda:
        raise ValueError(f"CUDA kernel called on a {first.device} tensor")
    index = first.get_device()
    for t in tensors:
        if t.get_device() != index or not t.is_contiguous():
            if t.get_device() != index:
                raise ValueError(f"tensors on {first.device} and {t.device}")
            raise ValueError("CUDA kernel needs contiguous tensors")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data does not start on 16 bytes (the
    kernels that copy rows in 16-byte pieces need that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPES:
        raise TypeError(f"CUDA kernels take fp32 or bf16, not {t.dtype}")
    return DTYPES[t.dtype]
