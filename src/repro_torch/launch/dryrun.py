"""Multi-pod dry run and roofline of the port, counted on the meta device.

For every (architecture x input shape) on the single-pod (16, 16) mesh
and the 2-pod (2, 16, 16) mesh: run rank 0's step program once, at full
width and depth, on meta tensors (nothing allocated), and count what it
takes a rank: the bytes of its arguments and the peak of what it
allocates (does the step fit?), its GEMM and kernel FLOPs, the HBM bytes
its ops and kernels move and its collectives' bytes by kind
(``analysis/roofline.py::count``), and which of the three roofline terms
bounds it on an H100 (data-sheet peaks: analytic predictions, not
measurements).

Where the JAX package lowers and compiles an SPMD program over 256 or
512 forced host devices (``lower_serve``, ``lower_train``) and reads
XLA's analyses, ``count_serve`` and ``count_train`` start rank 0 of the
plan under ``torch.distributed``'s ``fake`` backend at that world (its
collectives return at once; their bytes are counted), build the model
on meta and this rank's weights through the ``WeightsManager``, and run
the step the rank would run: ``build_serve_step`` over the pools and
recurrent rows ``fresh_states`` makes, or one ``build_train_step`` step
with AdamW state. The port runs its layers in a Python loop, so every
layer is counted as it runs: ``probe_layers`` is kept as the JAX
package's and ``--no-probes`` does nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun          # all pairs
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b \\
      --shape decode_32k [--multi-pod | --both-meshes] [--force]
Results accumulate in build/dryrun/<arch>__<shape>__<mesh>.json; the
table: ``python -m repro_torch.analysis.report``.

The JSON keeps the JAX package's keys. ``memory``: ``argument_bytes``
(the rank's parameters, states and batch rows that the step reads, as
XLA counts the arguments a program uses; in training its parameter
shards, AdamW moments and step counter and batch rows), ``output_bytes``
(what the step returns that is not an argument), ``temp_bytes`` (the
peak of the bytes the step allocates and holds at once), ``alias_bytes``
(the states it reads and writes in place: the JAX package's donated
states; 0 in training, whose parameters and moments the port updates in
place and the JAX package does not donate). ``code_bytes`` is null: the
port compiles no program (its kernels are built once, not per step).
``cost_raw`` holds the counts by source, ``collectives_raw`` the bytes
by kind, ``roofline`` the terms (``analysis/roofline.py``) and the share
of ``model_flops`` in the counted FLOPs (``useful_flops_ratio``).
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis import roofline as rl
from repro_torch.configs import ASSIGNED_ARCHS, get_config, get_shape
from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import InputShape
from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import FlyingMode, ParallelPlan, plan_for
from repro_torch.core.steps import build_serve_step, fresh_states
from repro_torch.core.views import CommStats, RankGroup
from repro_torch.core.weights_manager import WeightsManager
from repro_torch.models.model import Model

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
META = torch.device("meta")
BF16 = torch.bfloat16

# documented skips (DESIGN.md §5)
SKIPS = {
    ("whisper-base", "long_500k"):
        "enc-dec decoder context is 448 tokens; 500k decode undefined",
}


# ---------------------------------------------------------------------------
# per-(arch, shape) execution plan (the JAX package's)
# ---------------------------------------------------------------------------

def layout_for(cfg: ArchConfig, shape: InputShape) -> str:
    if cfg.family == "ssm":
        return "head"  # no paged pools at all
    if cfg.mla is not None:
        return "striped"  # compressed cache cannot head-shard
    if shape.name == "long_500k":
        return "striped"  # context-parallel capacity pooling
    if cfg.name.startswith("mistral") and shape.name == "decode_32k":
        return "striped"  # 88-layer KV exceeds HBM under head layout
    return "head"


def merge_for(cfg: ArchConfig, shape: InputShape, plan: ParallelPlan) -> int:
    if shape.name == "long_500k":
        return plan.valid_merges()[-1]  # use case 3: bind the whole pod
    return 1


def window_for(cfg: ArchConfig, shape: InputShape) -> Optional[int]:
    if shape.name == "long_500k" and cfg.family in ("dense", "moe", "vlm"):
        return cfg.long_context_window  # sub-quadratic dense variant
    return None


def batch_geometry(cfg: ArchConfig, shape: InputShape, plan: ParallelPlan,
                   merge: int, layout: str):
    """Returns (batch_per_group, ctx_tokens, geom, max_blocks)."""
    groups = plan.pods * (plan.dp_engines // merge)
    if shape.phase == "prefill":
        bpg = 1  # production prefill: one request per group per step
        ctx = shape.seq_len
    else:
        bpg = max(shape.global_batch // groups, 1)
        ctx = shape.seq_len
    block_base = 16
    geom0 = PoolGeometry(cfg, plan, num_blocks=1, block_base=block_base,
                         layout=layout)
    cap = geom0.capacity(merge)
    per_req_blocks = -(-ctx // cap)
    num_blocks = bpg * per_req_blocks + 1
    geom = PoolGeometry(cfg, plan, num_blocks=num_blocks,
                        block_base=block_base, layout=layout)
    return bpg, ctx, geom, per_req_blocks


def _meta(shape, dtype=torch.int32) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def abstract_batch(cfg: ArchConfig, shape: InputShape, plan: ParallelPlan,
                   merge: int, bpg: int, ctx_tokens: int, max_blocks: int):
    """The serve step's global batch as meta tensors, and its rows B (a
    group's rows are ``bpg`` of them)."""
    groups = plan.pods * (plan.dp_engines // merge)
    B = groups * bpg
    if shape.phase == "decode":
        batch = {
            "tokens": _meta((B, 1)), "positions": _meta((B, 1)),
            "slots": _meta((B,)), "block_table": _meta((B, max_blocks)),
            "context_len": _meta((B,)),
        }
        if cfg.enc_dec is not None:
            batch["enc_len"] = _meta((B,))
        return batch, B
    # prefill
    T = ctx_tokens
    fe_tokens = 0
    extras = {}
    if cfg.enc_dec is not None:
        # whisper: the 32k stress goes through the ENCODER memory; the
        # decoder prompt is its 448-token context (DESIGN.md §5)
        F = ctx_tokens
        T = min(cfg.max_decode_context, 448)
        extras["frontend_embeds"] = _meta((B, F, cfg.d_model), BF16)
        extras["enc_len"] = _meta((B,))
    elif cfg.frontend is not None:
        P_ = cfg.frontend.num_embeds
        T = ctx_tokens - P_
        fe_tokens = P_
        extras["frontend_embeds"] = _meta(
            (B, P_, cfg.frontend.embed_width or cfg.d_model), BF16)
    batch = {
        "tokens": _meta((B, T)),
        "positions": _meta((B, T + fe_tokens)),
        "slots": _meta((B, T + fe_tokens)),
        "block_table": _meta((B, max_blocks)),
        "prior_len": _meta((B,)),
    }
    batch.update(extras)
    return batch, B


def probe_layers(cfg: ArchConfig) -> Tuple[int, int]:
    """(L1, L2) of the JAX package's unrolled roofline probes (unused:
    the port counts every layer as it runs)."""
    if cfg.hybrid is not None:
        k = len(cfg.hybrid.pattern)
        return k, 2 * k
    if cfg.mla is not None and cfg.moe is not None:
        return 2, 3
    return 1, 2


# ---------------------------------------------------------------------------
# counting one step of rank 0
# ---------------------------------------------------------------------------

@contextmanager
def fake_world(world: int):
    """Rank 0 of ``world`` under the ``fake`` backend for the duration
    (nothing at world 1); the process group is destroyed after."""
    if world == 1:
        yield
        return
    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def meta_params(cfg: ArchConfig, dtype=BF16):
    """The logical parameter tree at full size, on meta."""
    return Model(cfg, dtype, META).init(torch.Generator(device="cpu"))


def _group(ranks, stats: CommStats) -> Optional[RankGroup]:
    if len(ranks) == 1:
        return None
    handle = None if len(ranks) == dist.get_world_size() \
        else dist.new_group(ranks=list(ranks))
    return RankGroup(handle, ranks, ranks.index(0), stats)


def count_serve_step(cfg: ArchConfig, plan: ParallelPlan, merge: int,
                     geom: PoolGeometry, phase: str, batch: Dict, *,
                     bpg: int, enc_frames: int = 0,
                     window: Optional[int] = None, dtype=BF16) -> Dict:
    """Rank 0's serve step of (``plan``, ``merge``) over ``geom`` on
    ``batch`` (its group's rows, meta tensors), counted. The world's
    process group, if any, must be up (``fake_world``). Returns
    ``{"counts", "memory", "tp", "stats"}``."""
    model = Model(cfg, dtype, META)
    mode = FlyingMode(plan, merge)
    params = WeightsManager(cfg, plan).storage_shard(meta_params(cfg, dtype),
                                                     0)
    states = fresh_states(model, mode, geom, batch=bpg,
                          enc_frames=enc_frames, device=META)
    run, ctx = build_serve_step(model, mode, geom, phase=phase,
                                window=window)
    stats = CommStats()
    tile = plan.engine_rows * plan.tp_base
    ranks = tuple(range(mode.tp))
    comm = view = ed = None
    if mode.tp > 1:
        comm = _group(ranks, stats)
        view = _group(ranks[::tile], stats) if merge > 1 and tile > 1 \
            else (comm if merge > 1 else None)
    if ctx.ep > 1:
        ed = _group(tuple(ranks[i] for i in ctx.ed_members(0)), stats)
    with rl.count([stats]) as c:
        out, _ = run(params, states, batch, comm, view, ed)
    return {"counts": c, "tp": mode.tp, "memory": {
        "argument_bytes": c.read_bytes((params, states, batch)),
        "output_bytes": rl.tree_bytes(out),
        "temp_bytes": c.peak_bytes,
        "alias_bytes": c.read_bytes(states),
        "code_bytes": None}}


def count_serve(cfg: ArchConfig, shape: InputShape, *, pods: int) -> Dict:
    """The JAX package's ``lower_serve``, counted: rank 0 of
    ``plan_for(cfg, pods)`` under the fake backend."""
    plan = plan_for(cfg, pods=pods)
    layout = layout_for(cfg, shape)
    merge = merge_for(cfg, shape, plan)
    mode = FlyingMode(plan, merge)
    bpg, ctx_tokens, geom, max_blocks = batch_geometry(
        cfg, shape, plan, merge, layout)
    enc_frames = ctx_tokens if cfg.enc_dec is not None else 0
    batch, B = abstract_batch(cfg, shape, plan, merge, bpg, ctx_tokens,
                              max_blocks)
    rows = {k: v[:bpg] for k, v in batch.items()}
    with fake_world(pods * plan.devices_per_pod):
        res = count_serve_step(cfg, plan, merge, geom, shape.phase, rows,
                               bpg=bpg, enc_frames=enc_frames,
                               window=window_for(cfg, shape))
    res["meta"] = dict(merge=merge, layout=layout, bpg=bpg, batch_global=B,
                       max_blocks=max_blocks, tp=mode.tp,
                       groups=plan.pods * mode.dp)
    return res


def train_batch(cfg: ArchConfig, shape: InputShape) -> Dict:
    """The train step's global batch as meta tensors (the JAX package's
    ``lower_train`` batch)."""
    B, T = shape.global_batch, shape.seq_len
    if cfg.enc_dec is not None:
        T = min(cfg.max_decode_context, 448)
        F = shape.seq_len - T
        return {"tokens": _meta((B, T)), "labels": _meta((B, T)),
                "frontend_embeds": _meta((B, F, cfg.d_model), BF16)}
    if cfg.frontend is not None:
        P_ = cfg.frontend.num_embeds
        return {"tokens": _meta((B, T - P_)), "labels": _meta((B, T - P_)),
                "frontend_embeds": _meta(
                    (B, P_, cfg.frontend.embed_width or cfg.d_model), BF16)}
    return {"tokens": _meta((B, T)), "labels": _meta((B, T))}


def count_train(cfg: ArchConfig, shape: InputShape, *, pods: int) -> Dict:
    """The JAX package's ``lower_train``, counted: one step of rank 0 of
    ``plan_for(cfg, pods)`` under the fake backend, AdamW state beside
    its parameter shards."""
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import build_train_step, train_mesh
    plan = plan_for(cfg, pods=pods)
    model = Model(cfg, BF16, META)
    batch = train_batch(cfg, shape)
    B = shape.global_batch
    dp = plan.pods * plan.data_rows
    with fake_world(pods * plan.devices_per_pod):
        mesh = train_mesh(plan)
        params = WeightsManager(cfg, plan).train_shard(
            meta_params(cfg), mesh.pod, mesh.data, mesh.model)
        opt = AdamW()
        ost = opt.init(params)
        step = build_train_step(model, plan, opt=opt, mesh=mesh)
        with rl.count(mesh.stats.values()) as c:
            (_, _), mets = step((params, ost), batch)
    # the rank's rows of the batch (the step slices the global batch),
    # and AdamW's step counter: an int32 in the JAX package's state, a
    # Python int here
    args = c.read_bytes((params, ost.m, ost.v)) + \
        c.read_bytes(batch) // dp + 4
    return {"counts": c, "tp": plan.tp_base, "memory": {
        "argument_bytes": args,
        "output_bytes": rl.tree_bytes(mets),
        "temp_bytes": c.peak_bytes,
        "alias_bytes": 0,
        "code_bytes": None},
        "meta": dict(merge=0, layout="train", bpg=B // plan.data_rows
                     // plan.pods, batch_global=B, max_blocks=0,
                     tp=plan.tp_base, groups=plan.pods * plan.data_rows)}


def roofline_of(cfg: ArchConfig, shape: InputShape, res: Dict, chips: int,
                hw=None) -> Dict:
    """The roofline row of a counted step: its FLOPs (GEMMs and kernels),
    HBM bytes (ops and kernels) and collective wire bytes a rank, the
    collective term at the rate of its widest group."""
    c = res["counts"]
    tp = res["tp"]
    group = chips if res["meta"]["layout"] == "train" and chips > tp else tp
    terms = rl.RooflineTerms(
        flops=c.flops, hbm_bytes=c.hbm_bytes,
        coll_bytes=rl.wire_bytes(c.collectives, tp_hint=max(tp, 2)),
        chips=chips, group=group, **({"hw": hw} if hw is not None else {}))
    row = terms.row()
    mf = rl.model_flops(cfg, shape, shape.phase)
    # the step may process only part of the shape's global batch
    # (prefill: 1 request per group per step): scale the useful-work
    # yardstick to the step's token share
    step_share = res["meta"]["batch_global"] / max(shape.global_batch, 1)
    row["model_flops_total"] = mf
    row["step_share"] = step_share
    row["useful_flops_ratio"] = mf * step_share / max(c.flops * chips, 1.0)
    return row


def run_pair(arch: str, shape_name: str, *, multi_pod: bool,
             force: bool = False) -> Dict:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    mesh_tag = "pod2" if multi_pod else "pod1"
    out_path = RESULTS_DIR / f"{arch}__{shape_name}__{mesh_tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    if (arch, shape_name) in SKIPS:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "skipped": SKIPS[(arch, shape_name)]}
        out_path.write_text(json.dumps(res, indent=1))
        return res
    pods = 2 if multi_pod else 1
    count_fn = count_train if shape.phase == "train" else count_serve
    t0 = time.time()
    counted = count_fn(cfg, shape, pods=pods)
    c = counted["counts"]
    res = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "meta": counted["meta"],
        "count_s": time.time() - t0,
        "memory": counted["memory"],
        "cost_raw": {"flops": c.flops, "bytes accessed": c.hbm_bytes,
                     "gemm_flops": c.gemm_flops, "op_bytes": c.op_bytes,
                     "kernel_calls": c.kernels.calls,
                     "kernel_flops": c.kernels.flops,
                     "kernel_bytes": c.kernels.nbytes},
        "collectives_raw": c.collectives,
        "roofline": roofline_of(cfg, shape, counted, 256 * pods),
    }
    out_path.write_text(json.dumps(res, indent=1))
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-probes", action="store_true",
                    help="accepted and ignored: the port counts every "
                         "layer as it runs, with no probes to scale")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()

    archs = [args.arch] if args.arch else list(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else \
        ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    t_all = time.time()
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                tag = f"{arch} x {shp} x {'pod2' if mp else 'pod1'}"
                try:
                    t0 = time.time()
                    res = run_pair(arch, shp, multi_pod=mp,
                                   force=args.force)
                    if "skipped" in res:
                        print(f"[skip] {tag}: {res['skipped']}", flush=True)
                        continue
                    mem = res["memory"]
                    per_dev = (mem["argument_bytes"] + mem["temp_bytes"])
                    r = res["roofline"]
                    print(f"[ok]   {tag}: args+temp/dev="
                          f"{per_dev / 1e9:.2f}GB"
                          f" compute={r['t_compute_s'] * 1e3:.2f}ms"
                          f" memory={r['t_memory_s'] * 1e3:.2f}ms"
                          f" coll={r['t_collective_s'] * 1e3:.2f}ms"
                          f" dom={r['dominant']}"
                          f" ({time.time() - t0:.0f}s)", flush=True)
                except Exception as e:
                    failures.append((tag, repr(e)))
                    print(f"[FAIL] {tag}: {e!r}", flush=True)
                    traceback.print_exc()
    print(f"\nwall time {time.time() - t_all:.1f} s")
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nDRY-RUN COMPLETE: every combination counted on the meta "
          "device.")


if __name__ == "__main__":
    main()
