"""The port's MLA and MoE on 8 gloo ranks against the JAX package's
distributed step, on the CPU.

``tests/md_scripts/check_serve_consistency.py``'s ``run_arch`` for the
reduced ``deepseek-v2-236b`` (MLA + MoE) and ``phi3.5-moe-42b-a6.6b``
(GQA + MoE) at ``ParallelPlan(1, 2, 4)`` (4 engines of 2 ranks, as that
script runs on 8 forced host devices), merges 1 and 2: one chunked
prefill of 10 tokens and one decode step for 4 requests. The JAX side
runs in a subprocess (this file's ``__main__``) and writes the
parameters, its distributed step logits and its single-device forward;
the port runs one process per rank over gloo (``tests/
test_torch_islands.py``'s pattern), each rank on its DP group's rows
with its storage shard of the parameters: experts' d_ff over 'model'
and the merge view, the MLA cache replicated over the TP group. Held:
every row within the script's rtol = atol = 3e-3 of the JAX distributed
step and of the JAX single-device forward, the ranks of a TP group bit
for bit alike, greedy tokens identical to the JAX step's.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
from repro_torch.core.modes import FlyingMode, Island, ParallelPlan
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as ckpt
from test_torch_islands import (ATOL, PLAN, RTOL, B, T, _decode_tables,
                                _prefill_tables, _spawn, _step_geom)

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("deepseek-v2-236b", "phi3.5-moe-42b-a6.6b")
MERGES = (1, 2)


def reference_main(out: str) -> None:
    """The JAX side: ``python tests/test_torch_moe_ranks.py OUT_DIR``."""
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO / "tests" / "md_scripts"))
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.core.kv_adaptor import KVCacheAdaptor as JAdaptor
    from repro.core.kv_adaptor import PoolGeometry as JGeometry
    from repro.core.modes import FlyingMode as JMode
    from repro.core.modes import ParallelPlan as JPlan
    from repro.core.modes import mode_mesh
    from repro.core.steps import build_serve_step
    from repro.core.views import SINGLE
    from repro.core.weights_manager import WeightsManager
    from repro.models.cache import TrainBackend
    from repro.models.model import build_model
    from check_serve_consistency import global_states

    plan = JPlan(*PLAN)
    for arch in ARCHS:
        cfg = jget(arch).reduced()
        model = build_model(cfg, jnp.float32)
        params = model.init(jax.random.key(0))
        np.savez(os.path.join(out, f"{arch}.params.npz"),
                 *[np.asarray(a) for a in jax.tree.leaves(params)])
        toks = jax.random.randint(jax.random.key(1), (B, T + 1), 0,
                                  cfg.vocab_size)
        ref, _, _ = model.forward(params, SINGLE, mode="train", tokens=toks,
                                  backend=TrainBackend())
        steps = {"tokens": np.asarray(toks),
                 "single_prefill": np.asarray(ref[:, -2]),
                 "single_decode": np.asarray(ref[:, -1])}
        wm = WeightsManager(cfg, plan)
        for merge in MERGES:
            mode = JMode(plan, merge)
            mesh = mode_mesh(mode)
            p_sh = jax.device_put(params, wm.shardings(params, mesh))
            bpg = B // (plan.pods * mode.dp)
            geom = _step_geom(JGeometry, cfg, plan, merge, bpg)
            adaptors = [JAdaptor(geom) for _ in range(plan.pods * mode.dp)]
            for a in adaptors:
                a.switch_mode(merge)
            slots, btab, max_blocks = _prefill_tables(adaptors, geom, merge,
                                                      bpg)
            st = global_states(model, geom, mode, bpg, mesh, "prefill")
            prefill, _, _ = build_serve_step(model, mode, geom,
                                             phase="prefill")
            lp, st = jax.jit(prefill)(p_sh, st, {
                "tokens": toks[:, :T],
                "positions": jnp.broadcast_to(jnp.arange(T)[None], (B, T)),
                "slots": jnp.asarray(slots),
                "block_table": jnp.asarray(btab),
                "prior_len": jnp.zeros((B,), jnp.int32)})
            dslots, btab2 = _decode_tables(adaptors, bpg, max_blocks)
            decode, _, _ = build_serve_step(model, mode, geom,
                                            phase="decode")
            ld, st = jax.jit(decode)(p_sh, st, {
                "tokens": toks[:, T:T + 1],
                "positions": jnp.full((B, 1), T, jnp.int32),
                "slots": jnp.asarray(dslots),
                "block_table": jnp.asarray(btab2),
                "context_len": jnp.full((B,), T + 1, jnp.int32)})
            steps[f"prefill{merge}"] = np.asarray(lp)
            steps[f"decode{merge}"] = np.asarray(ld)
        np.savez(os.path.join(out, f"{arch}.steps.npz"), **steps)


def steps_rank(rank, world, ref_dir, out):
    """One prefill and one decode step of each architecture at merges 1
    and 2, each rank on its DP group's rows; every rank writes them."""
    from repro_torch.core.communicator_pool import CommunicatorPool
    from repro_torch.core.steps import build_serve_step
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.models.model import build_model
    plan = ParallelPlan(*PLAN)
    res = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, torch.float32, "cpu")
        like = Model(cfg, torch.float32, torch.device("meta")).init(
            torch.Generator(device="cpu"))
        with np.load(os.path.join(ref_dir, f"{arch}.params.npz")) as z:
            leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
        params = params_from_numpy(cfg, ckpt.tree_unflatten(like, leaves))
        shard = WeightsManager(cfg, plan).storage_shard(params, rank % 2)
        toks = torch.from_numpy(np.load(os.path.join(
            ref_dir, f"{arch}.steps.npz"))["tokens"]).long()
        pool = CommunicatorPool(model, plan, None, batch_per_engine=1)
        for merge in MERGES:
            mode = FlyingMode(plan, merge)
            bpg = B // mode.dp
            geom = _step_geom(PoolGeometry, cfg, plan, merge, bpg)
            seat = pool.seat(Island(0, 4, merge))
            adaptors = [KVCacheAdaptor(geom) for _ in range(mode.dp)]
            for a in adaptors:
                a.switch_mode(merge)
            slots, btab, max_blocks = _prefill_tables(adaptors, geom, merge,
                                                      bpg)
            dslots, btab2 = _decode_tables(adaptors, bpg, max_blocks)
            rows = slice(seat.lo, seat.hi)
            states = [tuple({"mixer": tuple(
                torch.zeros((n,) + geom.flat_shape())
                for _ in range(model.pools_of(kind)))} for kind in ks)
                for ks, n in model.plan]
            prefill, _ = build_serve_step(model, mode, geom, phase="prefill")
            decode, _ = build_serve_step(model, mode, geom, phase="decode")
            i32 = torch.int32
            lp, states = prefill(shard, states, {
                "tokens": toks[rows, :T].to(i32),
                "positions": torch.arange(T, dtype=i32)[None].expand(bpg, T),
                "slots": torch.from_numpy(slots[rows]).to(i32),
                "block_table": torch.from_numpy(btab[rows]).to(i32),
                "prior_len": torch.zeros((bpg,), dtype=i32)}, seat.comm)
            ld, states = decode(shard, states, {
                "tokens": toks[rows, T:T + 1].to(i32),
                "positions": torch.full((bpg, 1), T, dtype=i32),
                "slots": torch.from_numpy(dslots[rows]).to(i32),
                "block_table": torch.from_numpy(btab2[rows]).to(i32),
                "context_len": torch.full((bpg,), T + 1, dtype=i32)},
                seat.comm)
            res[f"{arch}.prefill{merge}"] = lp.numpy()
            res[f"{arch}.decode{merge}"] = ld.numpy()
            res[f"{arch}.rows{merge}"] = np.arange(seat.lo, seat.hi)
    np.savez(f"{out}.{rank}.npz", **res)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_moe_ranks")
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(out)


@pytest.fixture(scope="module")
def port_steps(ref_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moe_steps") / "steps")
    _spawn(steps_rank, 8, ref_dir, out)
    return [np.load(f"{out}.{r}.npz") for r in range(8)]


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_logits_match_jax(ref_dir, port_steps, arch, phase, merge):
    want = np.load(os.path.join(ref_dir, f"{arch}.steps.npz"))
    ref = want[f"{phase}{merge}"]
    got = np.zeros_like(ref)
    by_rows = {}
    for r, res in enumerate(port_steps):
        rows = res[f"{arch}.rows{merge}"]
        lg = res[f"{arch}.{phase}{merge}"]
        key = tuple(rows.tolist())
        if key in by_rows:
            assert np.array_equal(lg, by_rows[key]), (r, merge)
        by_rows[key] = lg
        got[rows] = lg
    assert len(by_rows) == 4 // merge
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want[f"single_{phase}"], rtol=RTOL,
                               atol=ATOL)
    top2 = np.sort(ref, -1)[:, -2:]
    flips = [(b, float(top2[b, 1] - top2[b, 0])) for b in range(B)
             if got[b].argmax() != ref[b].argmax()]
    assert flips == [], f"greedy tokens flip at (row, margin) {flips}"


if __name__ == "__main__":
    reference_main(sys.argv[1])
