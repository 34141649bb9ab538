"""The port's dry run and roofline (``repro_torch.launch.dryrun``,
``repro_torch.analysis``) held against the JAX package's on the CPU.

The JAX side runs in two subprocesses, this file's ``__main__`` with
``ref``: the JAX package's ``lower_serve`` / ``lower_train`` and
``compile()`` under its 512 forced host devices, at a 256-token,
32-request ``InputShape`` (whisper-base's train step at 512: its frames
are ``seq_len - 448``), pod1, the reduced configs' layers unrolled (so
every layer's ops appear in the text). Its prefill pairs lower the
chunked prefill (``build_serve_step(..., chunked=True)``), the step the
JAX package's engine runs and the only prefill the port has; its dry
run lowers the unchunked one, which reads neither ``block_table`` nor
``prior_len``. It writes, for each pair, ``memory_analysis``, the
collective result bytes by kind of the lowered StableHLO (serve: the
shard_map collectives are explicit there, in the target's dtypes) or of
the compiled HLO (train), and the FLOPs of every ``dot_general`` with
the einsum it came from (the lowered text's debug locations; the
compiled HLO's ``op_name`` for train). The port's side runs in a
subprocess of its own, this file's ``__main__`` with ``port``: the
``fake`` process group it starts must not outlive it in a test worker.

Held, for each pair:

- ``argument_bytes`` exactly. XLA counts the arguments a program reads
  (jit prunes the rest), and so does the port (``Counts.read_bytes``).
  One difference is by design: the port's striped backends read the
  batch's ``slots`` to park the engine's padding rows
  (``models/striped.py``), which the JAX package's take no slots for.
- serve collective bytes by kind exactly.
- serve GEMM FLOPs exactly: the JAX side's ``dot_general`` FLOPs less
  those of the einsums in ``KERNEL_EINSUMS``, the refs whose work the
  port does in a kernel (paged attention, absorbed MLA decode, the SSD
  scan) or elementwise (Mamba-2's decode state update).

The train pairs' GEMM FLOPs, total FLOPs and collectives are printed
beside the JAX side's, not held: GSPMD picks its own per-device program
(it replicates a reduced config's 4 heads on all 16 'model' ranks where
the port computes its power-of-two shard, and its remat reruns another
set of products), and the CPU backend widens bf16 collectives to f32
(``src/repro/analysis/roofline.py:60-66``). Their argument bytes are
held.

Besides: ``wire_bytes``, ``RooflineTerms(hw=V5E).row()`` and
``model_flops`` against the JAX package's for every arch x shape; the
report's text byte for byte on the same JSON; each kernel wrapper's meta
route (outputs of the plain version's shapes and dtypes, the recorded
cost that of ``kernels/cost.py``, which gives ``PERF.md`` section 6's
bound column at its rows' shapes; a CPU call records nothing); one
full-width pair, llama3-8b decode_32k pod1, against its closed form;
and the expert-parallel MoE layer on 4 gloo ranks against the JAX
package's under ``shard_map`` on 4 forced host devices (this file's
``__main__`` with ``ep``), with the one place the two depart on
purpose.
"""
from __future__ import annotations

import io
import json
import math
import os
import re
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

# (arch, phase, seq_len, pods, engine_rows); the reduced config at
# ``engine_rows`` (1 its own: the MoE pairs at 2 run expert parallelism
# over 'ed', as the full configs serve), InputShape("t", seq_len, 32,
# phase)
PAIRS = [(a, p, 256, 1, 1) for a in (
    "llama3-8b", "deepseek-v2-236b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
    "recurrentgemma-9b", "internvl2-1b") for p in ("decode", "prefill",
                                                   "train")] + [
    ("whisper-base", "decode", 256, 1, 1),
    ("whisper-base", "prefill", 256, 1, 1),
    ("whisper-base", "train", 512, 1, 1), ("llama3-8b", "decode", 256, 2, 1),
    ("deepseek-v2-236b", "decode", 256, 1, 2),
    ("deepseek-v2-236b", "prefill", 256, 1, 2),
    ("phi3.5-moe-42b-a6.6b", "decode", 256, 1, 2),
    ("phi3.5-moe-42b-a6.6b", "prefill", 256, 1, 2)]
SERVE = [p for p in PAIRS if p[1] != "train"]
TRAIN = [p for p in PAIRS if p[1] == "train"]
PARTS = 2
# the JAX refs whose work the port does in a kernel or elementwise:
# paged GQA attention (K2, K4), absorbed MLA decode over the striped
# pool (mla_decode), Mamba-2's decode state update (elementwise in the
# port) and the SSD chunked scan (K6)
KERNEL_EINSUMS = {
    "bqgrd,bkgd->bgrqk", "bgrqk,bkgd->bqgrd",
    "bhr,btr->bht", "bht,btr->bhr",
    "bh,bhd,bs->bhds",
    "bncs,bnjs->bncj", "bncjh,bnjh,bnjhd->bnchd",
    "bnjh,bnjh,bnjhd,bnjs->bnhds", "bncs,bnch,bnhds->bnchd"}


def key(pair) -> str:
    return ":".join(str(x) for x in pair)


def pair_config(get_config, pair):
    """The reduced config of ``pair`` at its engine rows."""
    import dataclasses
    return dataclasses.replace(get_config(pair[0]).reduced(),
                               engine_rows=pair[4])


# ---------------------------------------------------------------------------
# the JAX side: ``python tests/test_torch_dryrun.py ref DIR PART``
# ---------------------------------------------------------------------------

_DOT = re.compile(
    r"stablehlo\.dot_general\s+%\S+,\s+%\S+,\s+(?:batching_dims = "
    r"\[[\d, ]*\] x \[[\d, ]*\],\s+)?contracting_dims = \[([\d, ]*)\] x "
    r"\[[\d, ]*\].*?:\s+\((tensor<[^>]*>),\s+tensor<[^>]*>\)\s+->\s+"
    r"(tensor<[^>]*>)")
_COLL = re.compile(r'"?stablehlo\.(all_reduce|all_gather|all_to_all|'
                   r'collective_permute|collective_broadcast|reduce_scatter)'
                   r'"?')
_TENSOR = re.compile(r"tensor<([0-9x]*)x?(\w+)>")
_ELEM = {"f64": 8, "f32": 4, "f16": 2, "bf16": 2, "i64": 8, "i32": 4,
         "i16": 2, "i8": 1, "i1": 1, "ui32": 4, "ui8": 1}


def _tdims(t: str):
    return [int(d) for d in t[len("tensor<"):-1].split("x")[:-1]]


def stablehlo_collectives(text: str):
    """Result bytes by kind of every collective in lowered StableHLO,
    read off the op's result type: on its own line, or for an op with a
    reduction region (all_reduce) on the region's closing line. The JAX
    package's ``collective_bytes_stablehlo`` matches one line only, so
    it misses every op with a region."""
    lines = text.splitlines()
    out = {}
    for i, line in enumerate(lines):
        m = _COLL.search(line)
        if not m:
            continue
        j = i
        if "({" in line:
            j = i + 1
            while not lines[j].lstrip().startswith("})"):
                j += 1
        n = 0
        for d, dt in _TENSOR.findall(lines[j].split("->")[-1]):
            n += math.prod(int(x) for x in d.split("x") if x) * _ELEM[dt]
        kind = m.group(1).replace("_", "-")
        out[kind] = out.get(kind, 0) + n
    return out


def stablehlo_dots(text: str):
    """(einsum, FLOPs) of every dot_general of lowered StableHLO printed
    with its debug locations; the einsum is "" for a plain matmul."""
    locs = dict(re.findall(r"^(#loc\d+) = (.*)$", text, re.M))
    out = []
    for line in text.splitlines():
        m = _DOT.search(line)
        if not m:
            continue
        lhs, res = _tdims(m.group(2)), _tdims(m.group(3))
        k = math.prod(lhs[int(i)] for i in m.group(1).split(",")
                      if i.strip())
        lm = re.search(r"loc\((#loc\d+)\)\s*$", line)
        name = re.match(r'loc\("([^"]*)"', locs.get(lm.group(1), "")) \
            if lm else None
        spec = name.group(1).split("/")[0] if name else ""
        out.append((spec if "->" in spec else "", 2 * math.prod(res) * k))
    return out


def hlo_dots(text: str):
    """(op_name, FLOPs) of every dot of compiled HLO (per device)."""
    shapes = {}
    for m in re.finditer(r"^\s*(?:ROOT\s+)?%(\S+)\s*=\s*\w+\[([\d,]*)\]",
                         text, re.M):
        shapes[m.group(1)] = [int(x) for x in m.group(2).split(",") if x]
    out = []
    for m in re.finditer(r"^\s*(?:ROOT\s+)?%\S+\s*=\s*\w+\[([\d,]*)\]\S*\s+"
                         r"dot\(%(\S+?),\s*%\S+?\),(.*)$", text, re.M):
        res = [int(x) for x in m.group(1).split(",") if x]
        lhs = shapes[m.group(2)]
        lc = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", m.group(3))
        k = math.prod(lhs[int(i)] for i in lc.group(1).split(",") if i)
        name = re.search(r'op_name="([^"]*)"', m.group(3))
        out.append((name.group(1) if name else "", 2 * math.prod(res) * k))
    return out


def reference_main(d: str, part: int) -> None:
    import functools

    from repro.launch import dryrun as D     # forces 512 host devices
    from repro.analysis import roofline as rl
    from repro.configs import get_config
    from repro.configs.shapes import InputShape
    unchunked = D.build_serve_step
    out = {}
    for pair in PAIRS[part::PARTS]:
        arch, phase, seq, pods, _ = pair
        cfg = pair_config(get_config, pair)
        shape = InputShape("t", seq, 32, phase)
        D.build_serve_step = functools.partial(unchunked, chunked=True) \
            if phase == "prefill" else unchunked
        lower = D.lower_train if phase == "train" else D.lower_serve
        lowered, meta = lower(cfg, shape, pods=pods, unroll=cfg.num_layers)
        compiled = lowered.compile()
        mem = compiled.memory_analysis()
        res = {"meta": meta, "memory": {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "alias_bytes": mem.alias_size_in_bytes},
            "flops": compiled.cost_analysis().get("flops")}
        if phase == "train":
            hlo = compiled.as_text()
            res["collectives"] = rl.collective_bytes(hlo)
            res["dots"] = hlo_dots(hlo)
        else:
            text = lowered.as_text(debug_info=True)
            res["collectives"] = stablehlo_collectives(text)
            res["own_parser"] = rl.collective_bytes_stablehlo(text)
            res["dots"] = stablehlo_dots(text)
        out[key(pair)] = res
    with open(os.path.join(d, f"ref{part}.json"), "w") as f:
        json.dump(out, f)


# ---------------------------------------------------------------------------
# the port's side: ``python tests/test_torch_dryrun.py port DIR``
# ---------------------------------------------------------------------------

def port_main(d: str) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config, get_shape
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    def entry(res):
        c = res["counts"]
        return {"meta": res["meta"], "memory": res["memory"],
                "gemm": c.gemm_flops, "flops": c.flops,
                "collectives": c.collectives, "kernels": c.kernels.calls}
    out = {}
    for pair in PAIRS:
        _, phase, seq, pods, _ = pair
        count = D.count_train if phase == "train" else D.count_serve
        out[key(pair)] = entry(count(pair_config(get_config, pair),
                                     InputShape("t", seq, 32, phase),
                                     pods=pods))
    out["full"] = entry(D.count_serve(get_config("llama3-8b"),
                                      get_shape("decode_32k"), pods=1))
    mesh = make_production_mesh()
    out["mesh"] = {"bare": [list(mesh.shape), list(mesh.axes),
                            mesh.rank_mesh is None]}
    with D.fake_world(512):
        m = make_production_mesh(multi_pod=True)
        out["mesh"]["up"] = [list(m.shape), list(m.axes),
                             m.rank_mesh.rank, m.rank_mesh.world,
                             m.rank_mesh.groups["model"].ranks[-1]]
    out["mesh"]["after"] = dist.is_initialized()
    with open(os.path.join(d, "port.json"), "w") as f:
        json.dump(out, f)


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both sides' JSON, the JAX side's two parts and the port's run at
    once."""
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    env.pop("XLA_FLAGS", None)
    cmds = [[sys.executable, __file__, "ref", str(d), str(i)]
            for i in range(PARTS)] + [[sys.executable, __file__, "port",
                                       str(d)]]
    procs = [subprocess.Popen(c, env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for c in cmds]
    try:
        for proc in procs:
            _, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    ref = {}
    for i in range(PARTS):
        ref.update(json.loads((d / f"ref{i}.json").read_text()))
    return ref, json.loads((d / "port.json").read_text())


# ---------------------------------------------------------------------------
# the counts against the JAX dry run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", PAIRS, ids=key)
def test_argument_bytes_equal(sides, pair):
    """The bytes of the arguments a rank's step reads: parameters,
    states and batch rows (training: parameter shards, AdamW moments and
    step, batch rows), to the byte; a striped step reads its rows'
    ``slots`` besides (module docstring)."""
    ref, port = sides
    r, p = ref[key(pair)], port[key(pair)]
    want = r["memory"]["argument_bytes"]
    if p["meta"]["layout"] == "striped":
        rows = p["meta"]["bpg"] * (1 if pair[1] == "decode" else pair[2])
        want += 4 * rows
    assert p["meta"] == r["meta"]
    assert p["memory"]["argument_bytes"] == want
    if pair[1] != "train":
        assert p["memory"]["alias_bytes"] == r["memory"]["alias_bytes"]


@pytest.mark.parametrize("pair", SERVE, ids=key)
def test_serve_collective_bytes_equal(sides, pair):
    """Each kind's result bytes equal the shard_map step's, as lowered
    (the JAX package's own StableHLO parser is printed beside: it finds
    no op with a reduction region)."""
    ref, port = sides
    r, p = ref[key(pair)], port[key(pair)]
    print(f"{key(pair)}: port {p['collectives']}, JAX {r['collectives']} "
          f"(its collective_bytes_stablehlo: {r['own_parser']})")
    assert r["collectives"]
    assert p["collectives"] == r["collectives"]


@pytest.mark.parametrize("pair", SERVE, ids=key)
def test_serve_gemm_flops_equal(sides, pair):
    """The port's GEMM FLOPs (``FlopCounterMode`` over meta tensors; its
    kernels run their meta routes, which count no GEMM) equal the JAX
    side's dot_general FLOPs less those of ``KERNEL_EINSUMS``; its total
    ``cost_analysis`` FLOPs (elementwise work and the refs' masked
    rectangles included) are printed beside the port's GEMM and kernel
    FLOPs."""
    ref, port = sides
    r, p = ref[key(pair)], port[key(pair)]
    kept = sum(f for spec, f in r["dots"] if spec not in KERNEL_EINSUMS)
    print(f"{key(pair)}: GEMM FLOPs port {p['gemm']:.0f}, JAX {kept} of "
          f"{sum(f for _, f in r['dots'])}; total FLOPs port "
          f"{p['flops']:.0f} (kernels {p['kernels']}), JAX {r['flops']}")
    assert p["gemm"] > 0
    assert p["gemm"] == kept


@pytest.mark.parametrize("pair", TRAIN, ids=key)
def test_train_counts_beside_the_reference(sides, pair):
    """The train step's counts printed beside the JAX side's compiled
    program (module docstring: not held); held: the step ran K5, K6 or
    K7 through their meta routes, twice forward a layer (the remat
    reruns it) and once backward, and its collectives carry bytes."""
    ref, port = sides
    r, p = ref[key(pair)], port[key(pair)]
    kept = sum(f for name, f in r["dots"]
               if not re.search(r"[a-z]+(,[a-z]+)+->[a-z]+", name))
    print(f"{key(pair)}: GEMM FLOPs port {p['gemm']:.0f}, JAX {kept} of "
          f"{sum(f for _, f in r['dots'])}; total FLOPs port "
          f"{p['flops']:.0f}, JAX {r['flops']}; collectives port "
          f"{p['collectives']}, JAX (compiled, bf16 widened) "
          f"{r['collectives']}")
    arch = pair[0]
    fwd = {"mamba2-2.7b": "ssd_scan", "recurrentgemma-9b": "rglru_scan"}
    name = fwd.get(arch, "flash_prefill")
    if arch != "deepseek-v2-236b":   # MLA trains with plain attention
        assert p["kernels"][name] == 2 * p["kernels"][name + "_bwd"] > 0
    assert p["gemm"] > 0 and p["collectives"].get("all-reduce", 0) > 0


def test_full_width_decode_argument_bytes(sides):
    """llama3-8b decode_32k on pod1 at full width: the weights manager's
    stored shards of every leaf, the 32 layers' (k, v) pools and 8 rows
    of a 2048-block decode batch, in closed form."""
    from repro_torch.configs import get_config
    from repro_torch.core.modes import plan_for
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.launch.dryrun import meta_params
    _, port = sides
    cfg = get_config("llama3-8b")
    plan = plan_for(cfg)
    wm = WeightsManager(cfg, plan)

    def shard_bytes(path, t):
        n = t.numel() // math.prod(k for _, k, _ in
                                   wm.shard_dims(path, tuple(t.shape)))
        return n * t.element_size()

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return sum(walk(v, path + (k,)) for k, v in tree.items())
        if isinstance(tree, (list, tuple)):
            return sum(walk(v, path + (str(i),)) for i, v in enumerate(tree))
        return shard_bytes(path, tree)
    weights = walk(meta_params(cfg))
    B, blocks, page = 128 // 16, 32768 // 16, 16
    kv_dev = 1                         # 8 KV heads over 16 ranks
    pools = 32 * 2 * (B * blocks + 1) * page * kv_dev * 128 * 2
    batch = 4 * (B + B + B + B * blocks + B)
    full = port["full"]
    assert full["meta"]["tp"] == 16 and full["meta"]["bpg"] == B
    assert full["memory"]["argument_bytes"] == weights + pools + batch
    assert full["kernels"] == {"paged_append_token": 32,
                               "paged_attention": 32}


def test_production_mesh(sides):
    """``make_production_mesh`` gives the layout alone without a process
    group, and with one of its world this rank's training mesh; the
    group is gone after."""
    from repro_torch.launch.mesh import required_devices
    _, port = sides
    m = port["mesh"]
    assert m["bare"] == [[16, 16], ["data", "model"], True]
    assert m["up"] == [[2, 16, 16], ["pod", "data", "model"], 0, 512, 15]
    assert m["after"] is False
    assert (required_devices(), required_devices(True)) == (256, 512)


# ---------------------------------------------------------------------------
# expert parallelism on gloo ranks
# ---------------------------------------------------------------------------

EP_ARCHS = ("phi3.5-moe-42b-a6.6b", "deepseek-v2-236b")


def _moe_layer(tree):
    """The first MoE layer's parameters of a parameter tree."""
    def first(t):
        return {k: first(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[0]
    for group in tree["groups"]:
        for layer in group:
            if "e_gate" in layer.get("ffn", {}):
                return first(layer["ffn"])
    raise ValueError("no MoE layer")


def _ep_inputs(arch):
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = pair_config(get_config, (arch, "", 0, 1, 2))
    params = Model(cfg, torch.float32, torch.device("cpu")).init(
        torch.Generator().manual_seed(0))
    x = torch.randn((2, 8, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    return cfg, params, x


def _flat_layer(layer, prefix=""):
    """A layer's parameters as ``{"a/b": ndarray}``."""
    out = {}
    for k, v in layer.items():
        if isinstance(v, dict):
            out.update(_flat_layer(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v.numpy()
    return out


def ep_reference_main(d: str) -> None:
    """The JAX package's MoE layer under ``shard_map`` on 4 forced host
    devices, 2 'ed' x 2 'model' (``make_serving_ctx(1, 2, 2, E)``, the
    weights manager's storage specs), on the tokens and first MoE layer
    saved in ``d``: every device's output, both token counts."""
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config
    from repro.core.modes import MODE_AXES, ParallelPlan
    from repro.core.steps import _SM_KW, _shard_map
    from repro.core.views import make_serving_ctx
    from repro.core.weights_manager import WeightsManager
    from repro.models.moe import moe_ffn
    mesh = jax.sharding.Mesh(
        np.asarray(jax.devices()[:4]).reshape(1, 1, 1, 2, 2), MODE_AXES)
    plan = ParallelPlan(engine_rows=2, tp_base=2, data_rows=2)
    out = {}
    for arch in EP_ARCHS:
        cfg = pair_config(get_config, (arch, "", 0, 1, 2))
        ins = np.load(os.path.join(d, f"{arch}.in.npz"))
        layer = {}
        for name in ins.files:
            if name.startswith("p/"):
                *path, leaf = name[2:].split("/")
                node = layer
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = ins[name]
        specs = WeightsManager(cfg, plan).partition_specs(
            {"ffn": layer})["ffn"]
        ctx = make_serving_ctx(1, 2, 2, cfg.moe.num_experts)

        def f(p, x, cfg=cfg, ctx=ctx):
            return moe_ffn(cfg, p, x, ctx)[0][None]
        fn = jax.jit(_shard_map(f, mesh=mesh, in_specs=(specs, P()),
                                out_specs=P(MODE_AXES), **_SM_KW))
        out[f"{arch}/y"] = np.asarray(fn(layer, ins["x"]))
        out[f"{arch}/y3"] = np.asarray(fn(layer, ins["x"][:1, :3]))
    np.savez(os.path.join(d, "ep_ref.npz"), **out)


def ep_rank(rank: int, world: int, out: str) -> None:
    """One of 4 ranks of one engine tile of 2 'ed' rows x 2 'model'
    ranks: each MoE config's first MoE layer over the same tokens, its
    experts over 'ed'."""
    import torch.distributed as dist

    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.views import CommStats, RankGroup, \
        make_serving_ctx
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.models.moe import moe_ffn
    plan = ParallelPlan(engine_rows=2, tp_base=2, data_rows=2)
    for arch in EP_ARCHS:
        cfg, params, x = _ep_inputs(arch)
        ctx = make_serving_ctx(1, 2, 2, cfg.moe.num_experts)
        stats = CommStats()
        eds = {}
        for i in range(world):                 # every rank, one order
            members = ctx.ed_members(i)
            if members not in eds:
                eds[members] = dist.new_group(ranks=list(members))
        mine = ctx.ed_members(rank)
        ctx = ctx.bind(RankGroup(None, range(world), rank, stats), None,
                       RankGroup(eds[mine], mine, mine.index(rank), stats))
        shard = WeightsManager(cfg, plan).storage_shard(params, rank)
        y, _ = moe_ffn(cfg, _moe_layer(shard), x, ctx)
        a2a = stats.nbytes["all-to-all"]
        # three tokens: padded to four, two an 'ed' rank
        y3, _ = moe_ffn(cfg, _moe_layer(shard), x[:1, :3], ctx)
        torch.save({"y": y, "y3": y3, "bytes": a2a},
                   os.path.join(out, f"{arch}.{rank}.pt"))


def test_expert_parallel_moe_on_ranks(tmp_path):
    """The MoE layer with its experts over 'ed' (2 'ed' rows x 2 'model'
    ranks, gloo, fp32) against the JAX package's under ``shard_map`` on
    4 forced host devices (a subprocess) on the same parameters and
    tokens: every rank's output equals the JAX device's of its index and
    the one-rank layer's (the reduced configs' capacity drops nothing,
    so slicing the tokens over 'ed' changes no entry); two all_to_alls
    of [E, cap, d] a rank.

    Three tokens do not split over 'ed', and there the port departs
    from the JAX package on purpose: the port pads them to four, two an
    'ed' rank, and every token gets its experts (the one-rank layer's
    three rows); the JAX package's ranks take ``3 // 2`` = 1 token each,
    so its first two rows equal the port's and its third gets no routed
    expert at all, only the shared experts' output (zero without
    them)."""
    from repro_torch.core.views import SINGLE
    from repro_torch.launch.ranks import spawn
    from repro_torch.models.ffn import mlp
    from repro_torch.models.moe import capacity, moe_ffn
    for arch in EP_ARCHS:
        _, params, x = _ep_inputs(arch)
        np.savez(tmp_path / f"{arch}.in.npz", x=x.numpy(), **{
            "p/" + k: v for k, v in _flat_layer(_moe_layer(params)).items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    ref = subprocess.Popen([sys.executable, __file__, "ep", str(tmp_path)],
                           env=env, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True)
    try:
        spawn(ep_rank, 4, (str(tmp_path),), device_type="cpu", timeout=240,
              threads=1)
        _, err = ref.communicate(timeout=240)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    jax_out = np.load(tmp_path / "ep_ref.npz")
    for arch in EP_ARCHS:
        cfg, params, x = _ep_inputs(arch)
        layer = _moe_layer(params)
        want, _ = moe_ffn(cfg, layer, x, SINGLE)
        cap = capacity(cfg, x.shape[0] * x.shape[1] // 2)
        want3, _ = moe_ffn(cfg, layer, x[:1, :3], SINGLE)
        e = cfg.moe
        shared = mlp(layer["shared"], x[:1, 2:3], SINGLE,
                     e.num_shared_experts * e.d_ff_expert) \
            if e.num_shared_experts else torch.zeros((1, 1, cfg.d_model))
        for rank in range(4):
            got = torch.load(tmp_path / f"{arch}.{rank}.pt")
            jy = torch.from_numpy(jax_out[f"{arch}/y"][rank])
            jy3 = torch.from_numpy(jax_out[f"{arch}/y3"][rank])
            torch.testing.assert_close(got["y"], jy, atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(got["y"], want, atol=1e-5,
                                       rtol=1e-5)
            torch.testing.assert_close(got["y3"], want3, atol=1e-5,
                                       rtol=1e-5)
            torch.testing.assert_close(got["y3"][:, :2], jy3[:, :2],
                                       atol=1e-5, rtol=1e-5)
            torch.testing.assert_close(jy3[:, 2:], shared, atol=1e-5,
                                       rtol=1e-5)
            assert not torch.allclose(got["y3"][:, 2:], jy3[:, 2:],
                                      atol=1e-3)
            assert got["bytes"] == \
                2 * cfg.moe.num_experts * cap * cfg.d_model * 4


# ---------------------------------------------------------------------------
# the pure functions and the report against the JAX package's
# ---------------------------------------------------------------------------

ARCHS = ("stablelm-1.6b", "deepseek-v2-236b", "qwen3-4b",
         "mistral-large-123b", "phi3.5-moe-42b-a6.6b", "llama3-8b",
         "mamba2-2.7b", "internvl2-1b", "whisper-base", "recurrentgemma-9b")
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_functions_match_reference(arch, shape):
    """``wire_bytes`` at TP hints 1-32, ``RooflineTerms(hw=V5E).row()``
    and ``model_flops`` equal the JAX package's, on numbers drawn from a
    seed for this pair."""
    from repro.analysis import roofline as jrl
    from repro.configs import get_config as jcfg
    from repro.configs import get_shape as jshape
    from repro.serving.hardware import V5E as JV5E

    from repro_torch.analysis import roofline as rl
    from repro_torch.configs import get_config, get_shape
    from repro_torch.serving.hardware import V5E
    rng = np.random.default_rng(len(arch) * 7 + len(shape))
    coll = {k: int(rng.integers(0, 1 << 30)) for k in (
        "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
        "collective-permute")}
    for tp in (1, 2, 16, 32):
        assert rl.wire_bytes(coll, tp) == jrl.wire_bytes(coll, tp)
    f, b, c = (float(x) for x in rng.random(3) * 1e12)
    chips = int(rng.choice([256, 512]))
    assert rl.RooflineTerms(f, b, c, chips, hw=V5E).row() == \
        jrl.RooflineTerms(f, b, c, chips, hw=JV5E).row()
    phase = get_shape(shape).phase
    assert rl.model_flops(get_config(arch), get_shape(shape), phase) == \
        jrl.model_flops(jcfg(arch), jshape(shape), phase)


def test_collective_term_crosses_the_domain():
    """On the H100 a group within one 8-GPU NVLink domain runs at
    NVLink's rate, a wider one at the inter-node rate; V5E's torus has
    one rate for any group."""
    from repro_torch.analysis.roofline import RooflineTerms
    from repro_torch.serving.hardware import H100, V5E
    t8 = RooflineTerms(0.0, 0.0, 450e9, 256, group=8)
    t16 = RooflineTerms(0.0, 0.0, 450e9, 256, group=16)
    assert t8.hw is H100 and t8.t_collective == 1.0
    assert t16.t_collective == 450e9 / H100.inter_bw == 9.0
    assert RooflineTerms(0.0, 0.0, 50e9, 512, hw=V5E,
                         group=512).t_collective == 1.0


def _rows_json(d: Path) -> None:
    rng = np.random.default_rng(3)
    for i, (arch, shape) in enumerate([(a, s) for a in ARCHS[:4]
                                       for s in SHAPES]):
        for mesh in ("pod1", "pod2"):
            r = {"arch": arch, "shape": shape, "mesh": mesh,
                 "meta": {"layout": ["head", "striped"][i % 2],
                          "tp": int(rng.choice([16, 256]))},
                 "memory": {"argument_bytes": int(rng.integers(1, 1 << 36)),
                            "temp_bytes": int(rng.integers(1, 1 << 34))},
                 "roofline": {
                     "dominant": ["compute", "memory", "collective"][i % 3],
                     "t_compute_s": float(rng.random()),
                     "t_memory_s": float(rng.random()),
                     "t_collective_s": float(rng.random()),
                     "useful_flops_ratio": float(rng.random())}}
            if i == 5:
                del r["roofline"]            # a pair without a row
            (d / f"{arch}__{shape}__{mesh}.json").write_text(json.dumps(r))


@pytest.mark.parametrize("markdown", [False, True])
def test_report_text_matches_reference(tmp_path, monkeypatch, markdown):
    """The port's report renders the JAX package's text byte for byte
    from the same JSON."""
    from repro.analysis import report as jreport

    from repro_torch.analysis import report
    _rows_json(tmp_path)
    texts = []
    for mod in (jreport, report):
        monkeypatch.setattr(mod, "RESULTS", str(tmp_path))
        monkeypatch.setattr(sys, "argv", ["report"] + (
            ["--markdown"] if markdown else []))
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.main()
        texts.append(buf.getvalue())
    assert texts[0] == texts[1] and texts[0].count("\n") > 10


# ---------------------------------------------------------------------------
# the kernel wrappers' meta routes
# ---------------------------------------------------------------------------

META = torch.device("meta")


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _cases():
    """(name, call(make) -> outputs, cost at those shapes): ``make(shape,
    dtype)`` makes an input on the device under test; the shapes are
    small, with a 4-block table of pages of 8."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_prefill import ops as fo
    from repro_torch.kernels.paged_attention import ops as po
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.ssd_scan import ops as so
    B, H, KV, hd, nblk, page, MB, T = 2, 4, 2, 64, 9, 8, 4, 5
    bf, f32, i32 = torch.bfloat16, torch.float32, torch.int32
    keys, pages = B * MB * page, B * MB

    def tables(mk):
        return mk((B, MB), i32, "table")
    return [
        ("paged_append_token", lambda mk: po.paged_append_token(
            (mk((nblk, page, KV, hd), bf), mk((nblk, page, KV, hd), bf)),
            (mk((B, KV, hd), bf), mk((B, KV, hd), bf)), mk((B,), i32,
                                                           "slot")),
         cost.append(B, KV * hd, 2, 2, 2)),
        ("paged_append_chunk", lambda mk: po.paged_append_chunk(
            (mk((nblk, page, 48), f32),), (mk((B, T, 48), bf),),
            mk((B, T), i32, "slot")), cost.append(B * T, 48, 1, 2, 4)),
        ("paged_attention", lambda mk: po.paged_attention(
            mk((B, H, hd), bf), mk((nblk, page, KV, hd), bf),
            mk((nblk, page, KV, hd), bf), tables(mk), mk((B,), i32, "len")),
         cost.paged_decode(B, H, KV, hd, keys, pages, 2, 2, 2)),
        ("paged_attention_with_lse", lambda mk: po.paged_attention_with_lse(
            mk((B, H, hd), f32), mk((nblk, page, KV, hd), bf),
            mk((nblk, page, KV, hd), bf), tables(mk), mk((B,), i32, "len"),
            window=12),
         cost.paged_decode(B, H, KV, hd, B * 12, B * 2, 4, 4, 2, lse=True)),
        ("paged_mla_attention_decode", lambda mk:
         po.paged_mla_attention_decode(
             mk((B, H, 80), f32), mk((B, 80), bf), mk((nblk, page, 80), bf),
             mk((B,), i32, "slot"), tables(mk), mk((B,), i32, "len"),
             R=64)[0], cost.append(B, 80, 1, 2, 2)
         + cost.mla_decode(B, H, 80, 64, keys, pages, 4, 2)),
        ("paged_mla_attention_with_lse", lambda mk:
         po.paged_mla_attention_with_lse(
             mk((B, H, 80), f32), mk((nblk, page, 80), bf), tables(mk),
             mk((B,), i32, "len"), R=64),
         cost.mla_decode(B, H, 80, 64, keys, pages, 4, 2, lse=True)),
        ("paged_flash_prefill", lambda mk: fo.paged_flash_prefill(
            mk((B, T, H, hd), bf), mk((B, T, KV, hd), bf),
            mk((B, T, KV, hd), bf), mk((nblk, page, KV, hd), bf),
            mk((nblk, page, KV, hd), bf), mk((B, T), i32, "slot"),
            tables(mk), mk((B,), i32, "prior")),
         cost.append(B * T, KV * hd, 2, 2, 2) + cost.paged_prefill(
             B, T, H, KV, hd, keys, pages, T * keys, 2, 2, 2)),
        ("paged_prefill_sweep_with_lse", lambda mk:
         fo.paged_prefill_sweep_with_lse(
             mk((B, T, H, hd), bf), mk((nblk, page, KV, hd), bf),
             mk((nblk, page, KV, hd), bf), tables(mk),
             mk((B,), i32, "prior"), prior_only=True),
         cost.paged_prefill(B, T, H, KV, hd, keys, pages, T * keys, 4, 4, 2,
                            lse=True)),
        ("ssd_scan_from", lambda mk: so.ssd_scan_from(
            mk((B, 16, H, 8), bf), mk((B, 16, H), f32), -mk((H,), f32,
                                                            "pos"),
            mk((B, 16, 4), bf), mk((B, 16, 4), bf), mk((B, H, 8, 4), f32),
            chunk=8), cost.ssd(B, 16, H, 8, 4, 8, 2, 2, h0=True)),
        ("rglru_scan_from", lambda mk: ro.rglru_scan_from(
            mk((B, T, 24), f32, "decay"), mk((B, T, 24), f32),
            mk((B, 24), f32)), cost.rglru(B, T, 24, 4, h0=True)),
    ]


def _maker(device):
    gen = torch.Generator().manual_seed(0)

    def mk(shape, dtype, kind="x"):
        if device == "meta":
            return torch.empty(shape, dtype=dtype, device=META)
        if kind == "table":
            return torch.randperm(shape[0] * shape[1], generator=gen)[
                :math.prod(shape)].reshape(shape).to(dtype)
        if kind == "slot":
            return torch.arange(math.prod(shape)).reshape(shape).to(dtype)
        if kind in ("len", "prior"):
            return torch.full(shape, 3, dtype=dtype)
        if kind == "decay":
            return torch.rand(shape, generator=gen).to(dtype)
        x = torch.randn(shape, generator=gen)
        return (x.abs() + 0.1 if kind == "pos" else x).to(dtype)
    return mk


def _flat(out):
    return [t for t in (out if isinstance(out, (tuple, list)) else (out,))]


@pytest.mark.parametrize("case", range(10))
def test_meta_route_shapes_and_cost(case):
    """A wrapper given meta tensors returns outputs of its plain
    version's shapes and dtypes on meta and records the cost of
    ``kernels/cost.py`` at its shapes, every block of its table live
    (within a window, the window's keys); the same call on CPU tensors
    records nothing."""
    from repro_torch.kernels import cost
    name, call, want = _cases()[case]
    with cost.Sink() as sink:
        got = _flat(call(_maker("meta")))
    with cost.Sink() as cpu:
        plain = _flat(call(_maker("cpu")))
    assert [(t.shape, t.dtype) for t in got] == \
        [(t.shape, t.dtype) for t in plain], name
    assert all(t.is_meta for t in got) and not any(t.is_meta for t in plain)
    assert sink.total == want, name
    assert cpu.calls == {} and cpu.total == cost.Cost(0.0, 0.0)


def _train_meta(op, *shapes_dtypes, **kw):
    ins = [torch.empty(s, dtype=d, device=META,
                       requires_grad=d.is_floating_point)
           for s, d in shapes_dtypes]
    out = op(*ins, **kw)
    y = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(y, [t for t in ins if t.requires_grad],
                                torch.empty_like(y))
    return out, grads, ins


@pytest.mark.parametrize("kernel", ["flash_prefill", "ssd_scan",
                                    "rglru_scan"])
def test_meta_backward_routes(kernel):
    """K5's, K6's and K7's autograd Functions run forward and backward on
    meta: gradients of their inputs' shapes and dtypes, one forward and
    one backward call recorded at the cost of ``kernels/cost.py``."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_prefill import ops as fo
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.ssd_scan import ops as so
    bf, f32 = torch.bfloat16, torch.float32
    with cost.Sink() as sink:
        if kernel == "flash_prefill":
            _, grads, ins = _train_meta(
                fo.flash_prefill, ((2, 40, 8, 64), bf), ((2, 40, 2, 64), bf),
                ((2, 40, 2, 64), bf), window=16)
            want = (cost.flash(2, 40, 8, 2, 64, 2, 16),
                    cost.flash(2, 40, 8, 2, 64, 2, 16, backward=True))
        elif kernel == "ssd_scan":
            _, grads, ins = _train_meta(
                so.ssd_scan, ((2, 20, 4, 8), bf), ((2, 20, 4), f32),
                ((4,), f32), ((2, 20, 6), bf), ((2, 20, 6), bf), chunk=8)
            # T 20 padded to 24, three chunks of 8
            want = (cost.ssd(2, 24, 4, 8, 6, 8, 2, 2),
                    cost.ssd(2, 24, 4, 8, 6, 8, 2, 2, backward=True))
        else:
            _, grads, ins = _train_meta(ro.rglru_scan, ((2, 9, 24), f32),
                                        ((2, 9, 24), f32))
            want = (cost.rglru(2, 9, 24, 4),
                    cost.rglru(2, 9, 24, 4, backward=True))
    assert [(g.shape, g.dtype) for g in grads] == \
        [(t.shape, t.dtype) for t in ins]
    assert sink.calls == {kernel: 1, kernel + "_bwd": 1}
    assert (cost.Cost(sink.nbytes[kernel], sink.flops[kernel]),
            cost.Cost(sink.nbytes[kernel + "_bwd"],
                      sink.flops[kernel + "_bwd"])) == want


def _phase3_contexts():
    """Phase 3's K2 context lengths (``chip_smoke.kernel_checks``): its
    generator's draws before them, then the lengths."""
    rng = np.random.default_rng(0)
    nblk, page, KV, hd, MB = 4096, 16, 8, 128, 256
    for _ in range(2):                  # K1's fp32 and bf16 cases
        rng.choice((nblk - 1) * page, size=8, replace=False)
        rng.random(8)
        for _ in range(2):
            rng.standard_normal((8, KV, hd))
    return np.concatenate([[1, MB * page], rng.integers(
        2, MB * page, size=6)]).astype(np.int32)


@pytest.mark.parametrize("row,want_ms", [
    ("K2", 0.018034517014925373), ("K4", 0.06950076233771486),
    ("K5", 0.13903545231142567), ("K6", 0.08028658626865671),
    ("K7", 0.12021454328358208)])
def test_costs_give_the_bound_column(row, want_ms):
    """``kernels/cost.py`` at each row's shape gives ``PERF.md`` section
    6's bound (H100 data sheet; 0.0180, 0.0695, 0.139, 0.0803 and 0.120
    ms there, here as the last ``chip_smoke.py`` run before the costs
    moved into ``kernels/cost.py`` printed them): K2 at phase 3's
    contexts, K4 at its priors, and K5 (llama3-8b, 4 x 2048), K6
    (mamba2-2.7b, 4 x 2048) and K7 (4 x 2048 x 4096, fp32) as their meta
    routes record them."""
    from repro_torch.kernels import cost
    from repro_torch.kernels.flash_prefill import ops as fo
    from repro_torch.kernels.rglru_scan import ops as ro
    from repro_torch.kernels.ssd_scan import ops as so
    bf, f32 = torch.bfloat16, torch.float32
    with cost.Sink() as sink:
        if row == "K2":
            keys, pages = cost.live_keys(_phase3_contexts(), 16)
            c = cost.paged_decode(8, 32, 8, 128, keys, pages, 2, 2, 2)
        elif row == "K4":
            prior = np.array([0, 1024, 2560, 4096 - 512])
            keys, pages = cost.live_keys(prior + 512, 16)
            pairs = int(sum(512 * p + 512 * 513 // 2 for p in prior))
            c = cost.paged_prefill(4, 512, 32, 8, 128, keys, pages, pairs,
                                   2, 2, 2)
        elif row == "K5":
            fo.flash_prefill(_meta((4, 2048, 32, 128)),
                             _meta((4, 2048, 8, 128)),
                             _meta((4, 2048, 8, 128)))
        elif row == "K6":
            so.ssd_scan(_meta((4, 2048, 80, 64)), _meta((4, 2048, 80), f32),
                        _meta((80,), f32), _meta((4, 2048, 128)),
                        _meta((4, 2048, 128)), chunk=128)
        else:
            ro.rglru_scan(_meta((4, 2048, 4096), f32),
                          _meta((4, 2048, 4096), f32))
    if row in ("K5", "K6", "K7"):
        assert len(sink.calls) == 1
        c = sink.total
    ms, _ = cost.bound_ms(c)
    assert ms == pytest.approx(want_ms, rel=1e-12)


if __name__ == "__main__":
    if sys.argv[1] == "ref":
        reference_main(sys.argv[2], int(sys.argv[3]))
    elif sys.argv[1] == "ep":
        ep_reference_main(sys.argv[2])
    else:
        port_main(sys.argv[2])
