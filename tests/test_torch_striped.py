"""The port's striped (context-parallel) KV pools against the JAX
package's, on the CPU.

``repro_torch.models.striped`` against ``repro.models.striped``, with
numpy inputs from seeded generators, fp32:

- ``stripe_write_slot`` and ``stripe_counts``, property-tested against
  the JAX functions (positions inside the block table; past it the port
  parks, where the JAX gather reads a fill value);
- both backends at tp = 1, with and without a window, and ``attend_mla``
  and ``append_ctx``: outputs within atol = rtol = 1e-5, pools equal;
  at F = 2 and 4 stripes on one process, each stripe's plain partial
  (``_partial_attention`` of both packages) and the merge of all of
  them against one whole-context ``paged_attention_ref``;
- ``paged_mla_attention_ref(..., return_lse=True)`` against the JAX
  package's ``paged_attention_kernel(return_lse=True)`` in interpret
  mode on the KV = 1 view of the compressed pool;
- the refusals (a striped mixed step, live lanes, a prefill after a
  prior context), and the adaptor never handing out the reserved last
  block, on which a striped step parks its padding rows' writes.

On 8 gloo ranks at ``ParallelPlan(1, 2, 4)`` (``tests/
test_torch_islands.py``'s pattern: the JAX side in a subprocess, this
file's ``__main__``, on 8 forced host devices; the port one process a
rank): ``tests/md_scripts/check_serve_consistency.py``'s ``run_arch``
with ``layout='striped'`` for the reduced llama3-8b, deepseek-v2-236b
and stablelm-1.6b (4 KV heads, gathered from the ranks for each new
token) at merges 1 and 2 (stripe factors 2 and 4), held within its rtol
= atol = 3e-3 of the JAX distributed step and of the JAX single-device
forward, the ranks of a TP group bit for bit alike, greedy tokens equal;
and a scheduler run of the first two at fixed merge 2 with every prompt
within one prefill chunk, against the JAX ``FlyingEngine``
(``AbstractMesh`` patched to the pair form, as in ``tests/
test_torch_islands.py``): token streams, phase logs and the allocators'
block tables after every step equal.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from hyp_fallback import given, settings, st

from repro.core.views import SINGLE as JSINGLE
from repro.kernels.paged_attention.kernel import \
    paged_attention_kernel as jax_paged_attention_kernel
from repro.models import striped as JS
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import FlyingEngine
from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
from repro_torch.core.modes import FlyingMode, Island, ParallelPlan
from repro_torch.core.steps import build_serve_step
from repro_torch.core.views import SINGLE
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_mla_attention_ref)
from repro_torch.models import striped as TS
from repro_torch.models.model import Model, build_model
from repro_torch.training import checkpoint as ckpt
from test_torch_islands import (ATOL, PLAN, RTOL, B, T, FixedClock,
                                _decode_tables, _prefill_tables,
                                _read_json, _spawn, _write_json)

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("llama3-8b", "deepseek-v2-236b")
# the step logits also at 4 KV heads (the reduced llama3-8b has one, MLA
# a replicated cache), so that the new token's K/V heads are gathered
STEP_ARCHS = ARCHS + ("stablelm-1.6b",)
MERGES = (1, 2)
TOL = dict(atol=1e-5, rtol=1e-5)
# the engine-level run: fixed merge 2, prompts within one 16-token chunk
ENGINE_MERGE, CHUNK = 2, 16
TRACE = [dict(req_id=f"r{i}", arrival=i * 0.01,
              prompt_len=(12, 6, 16, 9, 14, 7)[i], output_len=(5, 7, 4, 6,
                                                               8, 3)[i])
         for i in range(6)]


def _geom(Geom, cfg, plan, merge, bpg):
    """check_serve_consistency's striped pool: enough blocks for the
    batch at the merge's stripe factor."""
    probe = Geom(cfg, plan, num_blocks=2, block_base=4, layout="striped")
    need = bpg * (-(-(T + 1) // probe.capacity(merge))) + 2
    return Geom(cfg, plan, num_blocks=max(need, 10), block_base=4,
                layout="striped")


# ---------------------------------------------------------------------------
# the JAX side: ``python tests/test_torch_striped.py OUT_DIR``
# ---------------------------------------------------------------------------

def _sched_trace(eng, Sched, SConf, Req, plan, geom) -> dict:
    """``TRACE`` under HARD at fixed merge 2 over ``eng`` (bound to it
    first, as the launcher binds a fixed merge), 10 ms a step; each
    adaptor's block tables after every step."""
    eng.switch(1, ENGINE_MERGE)
    tables = []

    class Clock(FixedClock):
        def _note(self):
            tables.append([sorted((rid, list(map(int, e.block_ids)))
                                  for rid, e in a.table.items())
                           for a in eng.adaptors])

        def prefill(self, *a):
            dt = super().prefill(*a)
            self._note()
            return dt

        def decode(self, *a):
            dt = super().decode(*a)
            self._note()
            return dt

    sched = Sched(plan, geom, Clock(eng), SConf(
        strategy="hard", max_batch_per_group=2, prefill_chunk=CHUNK,
        fixed_merge=ENGINE_MERGE))
    for r in TRACE:
        sched.submit(Req(**r))
    sched.run(max_steps=300)
    done = sorted(r.req_id for r in sched.pool.all.values()
                  if r.state == "done")
    return {"done": done,
            "toks": {rid: list(map(int, eng.generated_tokens(rid)))
                     for rid in done},
            "phases": [l.phase for l in sched.log],
            "merges": [l.merge for l in sched.log],
            "tables": tables,
            "free": [len(a._free_set) for a in eng.adaptors]}


def reference_main(out: str) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO / "tests" / "md_scripts"))
    from repro.configs import get_config as jget
    from repro.core.engine import FlyingEngine as JEngine
    from repro.core.kv_adaptor import KVCacheAdaptor as JAdaptor
    from repro.core.kv_adaptor import PoolGeometry as JGeometry
    from repro.core.modes import FlyingMode as JMode
    from repro.core.modes import ParallelPlan as JPlan
    from repro.core.modes import mode_mesh
    from repro.core.scheduler import DynamicScheduler as JScheduler
    from repro.core.scheduler import SchedulerConfig as JSConfig
    from repro.core.steps import build_serve_step as jbuild
    from repro.core.task_pool import Request as JRequest
    from repro.core.weights_manager import WeightsManager
    from repro.models.cache import TrainBackend
    from repro.models.model import build_model as jbuild_model
    from check_serve_consistency import global_states

    class PairMesh(jax.sharding.AbstractMesh):
        def __init__(self, axis_sizes, axis_names=None, *a, **kw):
            if axis_names is None:
                axis_names = tuple(n for n, _ in axis_sizes)
                axis_sizes = tuple(s for _, s in axis_sizes)
            super().__init__(axis_sizes, axis_names, *a, **kw)
    jax.sharding.AbstractMesh = PairMesh

    plan = JPlan(*PLAN)
    for arch in STEP_ARCHS:
        cfg = jget(arch).reduced()
        model = jbuild_model(cfg, jnp.float32)
        params = model.init(jax.random.key(0))
        np.savez(os.path.join(out, f"{arch}.params.npz"),
                 *[np.asarray(a) for a in jax.tree.leaves(params)])
        # check_serve_consistency.run_arch(arch, layout="striped")
        toks = jax.random.randint(jax.random.key(1), (B, T + 1), 0,
                                  cfg.vocab_size)
        ref, _, _ = model.forward(params, JSINGLE, mode="train",
                                  tokens=toks, backend=TrainBackend())
        steps = {"tokens": np.asarray(toks),
                 "single_prefill": np.asarray(ref[:, -2]),
                 "single_decode": np.asarray(ref[:, -1])}
        wm = WeightsManager(cfg, plan)
        for merge in MERGES:
            mode = JMode(plan, merge)
            mesh = mode_mesh(mode)
            p_sh = jax.device_put(params, wm.shardings(params, mesh))
            bpg = B // (plan.pods * mode.dp)
            geom = _geom(JGeometry, cfg, plan, merge, bpg)
            adaptors = [JAdaptor(geom) for _ in range(plan.pods * mode.dp)]
            for a in adaptors:
                a.switch_mode(merge)
            slots, btab, max_blocks = _prefill_tables(adaptors, geom, merge,
                                                      bpg)
            st_ = global_states(model, geom, mode, bpg, mesh, "prefill")
            prefill, _, _ = jbuild(model, mode, geom, phase="prefill")
            lp, st_ = jax.jit(prefill)(p_sh, st_, {
                "tokens": toks[:, :T],
                "positions": jnp.broadcast_to(jnp.arange(T)[None], (B, T)),
                "slots": jnp.asarray(slots),
                "block_table": jnp.asarray(btab),
                "prior_len": jnp.zeros((B,), jnp.int32)})
            dslots, btab2 = _decode_tables(adaptors, bpg, max_blocks)
            decode, _, _ = jbuild(model, mode, geom, phase="decode")
            ld, st_ = jax.jit(decode)(p_sh, st_, {
                "tokens": toks[:, T:T + 1],
                "positions": jnp.full((B, 1), T, jnp.int32),
                "slots": jnp.asarray(dslots),
                "block_table": jnp.asarray(btab2),
                "context_len": jnp.full((B,), T + 1, jnp.int32)})
            steps[f"prefill{merge}"] = np.asarray(lp)
            steps[f"decode{merge}"] = np.asarray(ld)
        np.savez(os.path.join(out, f"{arch}.steps.npz"), **steps)
        if arch not in ARCHS:
            continue
        # the engine-level run
        geom = JGeometry(cfg, plan, num_blocks=64, block_base=4,
                         layout="striped")
        eng = JEngine(model, plan, geom, params, batch_per_engine=2,
                      max_blocks_per_req=16, prefill_len=CHUNK)
        _write_json(os.path.join(out, f"{arch}.sched.json"), _sched_trace(
            eng, JScheduler, JSConfig, JRequest, plan, geom))


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------

def _port_params(ref_dir, arch, cfg):
    like = Model(cfg, torch.float32, torch.device("meta")).init(
        torch.Generator(device="cpu"))
    with np.load(os.path.join(ref_dir, f"{arch}.params.npz")) as z:
        leaves = [z[f"arr_{i}"] for i in range(len(z.files))]
    return params_from_numpy(cfg, ckpt.tree_unflatten(like, leaves),
                             device="cpu")


def steps_rank(rank, world, ref_dir, out):
    """check_serve_consistency's prefill and decode step of each
    architecture over the striped pool at merges 1 and 2, each rank on
    its DP group's rows; every rank writes them. Then the engine-level
    run of each architecture, whose result every rank writes too."""
    from repro_torch.core.communicator_pool import CommunicatorPool
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.core.weights_manager import WeightsManager
    plan = ParallelPlan(*PLAN)
    res, sched = {}, {}
    for arch in STEP_ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg, torch.float32, "cpu")
        params = _port_params(ref_dir, arch, cfg)
        shard = WeightsManager(cfg, plan).storage_shard(params, rank % 2)
        toks = torch.from_numpy(np.load(os.path.join(
            ref_dir, f"{arch}.steps.npz"))["tokens"]).long()
        pool = CommunicatorPool(model, plan, None, batch_per_engine=1)
        for merge in MERGES:
            mode = FlyingMode(plan, merge)
            bpg = B // mode.dp
            geom = _geom(PoolGeometry, cfg, plan, merge, bpg)
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
        if arch not in ARCHS:
            continue
        geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4,
                            layout="striped")
        eng = FlyingEngine(model, plan, geom, params, batch_per_engine=2,
                           max_blocks_per_req=16, device="cpu",
                           check_zero_copy=True)
        sched[arch] = _sched_trace(eng, DynamicScheduler, SchedulerConfig,
                                   Request, plan, geom)
        sched[arch]["supports_mixed"] = eng.supports_mixed()
    np.savez(f"{out}.{rank}.npz", **res)
    _write_json(f"{out}.{rank}.json", sched)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_striped")
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, str(out)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return str(out)


@pytest.fixture(scope="module")
def port_ranks(ref_dir, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("striped_steps") / "steps")
    _spawn(steps_rank, 8, ref_dir, out)
    return ([np.load(f"{out}.{r}.npz") for r in range(8)],
            [_read_json(f"{out}.{r}.json") for r in range(8)])


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_striped_step_logits_match_jax(ref_dir, port_ranks, arch, phase,
                                       merge):
    want = np.load(os.path.join(ref_dir, f"{arch}.steps.npz"))
    ref = want[f"{phase}{merge}"]
    got = np.zeros_like(ref)
    by_rows = {}
    for r, res in enumerate(port_ranks[0]):
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


@pytest.mark.parametrize("arch", ARCHS)
def test_striped_engine_matches_jax(ref_dir, port_ranks, arch):
    """The scheduler run at fixed merge 2 (two TP4 islands, stripe factor
    4): every request done, token streams, phase logs and every step's
    block tables equal to the JAX engine's, the same on every rank; no
    mixed step."""
    want = _read_json(os.path.join(ref_dir, f"{arch}.sched.json"))
    runs = [r[arch] for r in port_ranks[1]]
    got = runs[0]
    assert all(r == got for r in runs[1:])
    assert got.pop("supports_mixed") is False
    assert len(got["done"]) == len(TRACE)
    assert set(got["merges"]) == {ENGINE_MERGE}
    assert "mixed" not in got["phases"]
    for k in ("done", "toks", "phases", "merges", "tables", "free"):
        assert got[k] == want[k], k


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@given(st.integers(0, 2 ** 20), st.sampled_from([1, 2, 4, 8]),
       st.sampled_from([4, 16]), st.integers(1, 6), st.integers(1, 3))
@settings(max_examples=40, deadline=None)
def test_stripe_primitives_match_jax(seed, F, page, MB, Bn):
    rng = np.random.default_rng(seed)
    bt = rng.permutation(64)[:Bn * MB].reshape(Bn, MB).astype(np.int32)
    pos = rng.integers(0, MB * page * F, size=(Bn, 5)).astype(np.int32)
    ctx = rng.integers(0, MB * page * F + 1, size=Bn).astype(np.int32)
    for stripe in range(F):
        want = np.asarray(JS.stripe_write_slot(
            jnp.asarray(pos), stripe, F, jnp.asarray(bt), page))
        got = TS.stripe_write_slot(torch.from_numpy(pos), stripe, F,
                                   torch.from_numpy(bt), page)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            TS.stripe_counts(torch.from_numpy(ctx), stripe, F).numpy(),
            np.asarray(JS.stripe_counts(jnp.asarray(ctx), stripe, F)))


def test_stripe_write_slot_parks_past_the_table():
    """A position whose stripe-local block lies past the table parks."""
    bt = torch.tensor([[5, 7]], dtype=torch.int32)
    pos = torch.tensor([[0, 3, 14, 16, 17, 40]], dtype=torch.int32)
    got = TS.stripe_write_slot(pos, 0, 2, bt, 4)     # 16 tokens covered
    assert got.tolist() == [[20, -1, 31, -1, -1, -1]]


# ---------------------------------------------------------------------------
# the backends at tp 1, and the stripes on one process
# ---------------------------------------------------------------------------

def _pools(rng, nblk, page, KV, hd):
    return tuple(rng.standard_normal((nblk, page, KV, hd)).astype(np.float32)
                 for _ in range(2))


@pytest.mark.parametrize("window", [None, 5])
def test_striped_decode_matches_jax(window):
    rng = np.random.default_rng(1)
    Bn, H, KV, hd, page, nblk, MB = 3, 8, 2, 16, 4, 24, 5
    kp, vp = _pools(rng, nblk, page, KV, hd)
    q = rng.standard_normal((Bn, 1, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((Bn, 1, KV, hd)).astype(np.float32)
            for _ in range(2))
    bt = rng.permutation(nblk - 1)[:Bn * MB].reshape(Bn, MB).astype(np.int32)
    cl = np.array([1, 9, MB * page], np.int32)
    pos = (cl - 1)[:, None].astype(np.int32)
    jb = JS.StripedDecodeBackend(
        ctx=JSINGLE, block_table=jnp.asarray(bt), context_len=jnp.asarray(cl),
        n_q_heads=H, n_kv_heads=KV, window=window)
    jo, (jk, jv) = jb.attend((jnp.asarray(kp), jnp.asarray(vp)),
                             jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             positions=jnp.asarray(pos))
    tb = TS.StripedDecodeBackend(
        ctx=SINGLE, block_table=torch.from_numpy(bt),
        context_len=torch.from_numpy(cl), n_q_heads=H, n_kv_heads=KV,
        window=window)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, (tk2, tv2) = tb.attend((tk, tv), *map(torch.from_numpy, (q, k, v)),
                               positions=torch.from_numpy(pos))
    assert tk2 is tk and tv2 is tv
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("window", [None, 3])
def test_striped_prefill_matches_jax(window):
    rng = np.random.default_rng(2)
    Bn, Tn, H, KV, hd, page, nblk, MB = 2, 7, 4, 2, 16, 4, 16, 3
    kp, vp = _pools(rng, nblk, page, KV, hd)
    q = rng.standard_normal((Bn, Tn, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((Bn, Tn, KV, hd)).astype(np.float32)
            for _ in range(2))
    bt = rng.permutation(nblk - 1)[:Bn * MB].reshape(Bn, MB).astype(np.int32)
    pos = np.broadcast_to(np.arange(Tn, dtype=np.int32), (Bn, Tn)).copy()
    jb = JS.StripedPrefillBackend(ctx=JSINGLE, block_table=jnp.asarray(bt),
                                  window=window)
    jo, (jk, jv) = jb.attend((jnp.asarray(kp), jnp.asarray(vp)),
                             jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             positions=jnp.asarray(pos))
    tb = TS.StripedPrefillBackend(ctx=SINGLE,
                                  block_table=torch.from_numpy(bt),
                                  window=window)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    to, _ = tb.attend((tk, tv), *map(torch.from_numpy, (q, k, v)),
                      positions=torch.from_numpy(pos))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_striped_mla_matches_jax():
    """``attend_mla`` (new entry written, absorbed read) and the MLA
    prefill's ``append_ctx`` against the JAX backends at tp 1."""
    rng = np.random.default_rng(3)
    Bn, H, R, Rr, page, nblk, MB, Tn = 3, 4, 32, 16, 4, 24, 5, 6
    W = R + Rr
    pool = rng.standard_normal((nblk, page, W)).astype(np.float32)
    qa = rng.standard_normal((Bn, H, R)).astype(np.float32) * 0.2
    qp = rng.standard_normal((Bn, H, Rr)).astype(np.float32) * 0.2
    entry = rng.standard_normal((Bn, W)).astype(np.float32)
    bt = rng.permutation(nblk - 1)[:Bn * MB].reshape(Bn, MB).astype(np.int32)
    cl = np.array([1, 7, MB * page], np.int32)
    jb = JS.StripedDecodeBackend(ctx=JSINGLE, block_table=jnp.asarray(bt),
                                 context_len=jnp.asarray(cl))
    jo, (jpool,) = jb.attend_mla((jnp.asarray(pool),), jnp.asarray(qa),
                                 jnp.asarray(qp), jnp.asarray(entry), R=R,
                                 n_heads=H)
    tb = TS.StripedDecodeBackend(ctx=SINGLE, block_table=torch.from_numpy(bt),
                                 context_len=torch.from_numpy(cl))
    tpool = torch.from_numpy(pool.copy())
    to, _ = tb.attend_mla((tpool,), *map(torch.from_numpy, (qa, qp, entry)),
                          R=R, n_heads=H)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))

    vals = rng.standard_normal((Bn, Tn, W)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Tn, dtype=np.int32), (Bn, Tn)).copy()
    jp = JS.StripedPrefillBackend(ctx=JSINGLE, block_table=jnp.asarray(bt))
    jv, jlen, (jpool,) = jp.append_ctx((jnp.asarray(pool),),
                                       jnp.asarray(vals),
                                       positions=jnp.asarray(pos))
    tp = TS.StripedPrefillBackend(ctx=SINGLE, block_table=torch.from_numpy(bt))
    tpool = torch.from_numpy(pool.copy())
    tv, tlen, _ = tp.append_ctx((tpool,), torch.from_numpy(vals),
                                positions=torch.from_numpy(pos))
    assert tlen is None and jlen is None
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))


def _stripe_pools(rng, F, cl, page, KV, hd, MB):
    """A whole-context pool pair and its F stripes: token t of row b at
    the whole pool's slot b*MB*F*page + t, and at stripe t % F's slot
    blk * page + (t // F) % page through a shared local block table."""
    Bn = len(cl)
    kw, vw = (rng.standard_normal((Bn * MB * F, page, KV, hd))
              .astype(np.float32) for _ in range(2))
    bt_whole = np.arange(Bn * MB * F, dtype=np.int32).reshape(Bn, MB * F)
    bt = rng.permutation(Bn * MB + 1)[:Bn * MB].reshape(Bn, MB) \
        .astype(np.int32)
    nblk = Bn * MB + 2
    stripes = []
    for s in range(F):
        kp, vp = (np.zeros((nblk, page, KV, hd), np.float32)
                  for _ in range(2))
        pos = np.arange(MB * F * page)[None].repeat(Bn, 0)
        slots = TS.stripe_write_slot(torch.from_numpy(pos), s, F,
                                     torch.from_numpy(bt), page).numpy()
        for b in range(Bn):
            for t in range(MB * F * page):
                if slots[b, t] >= 0:
                    wb, wo = divmod(b * MB * F * page + t, page)
                    kp.reshape(-1, KV, hd)[slots[b, t]] = kw[wb, wo]
                    vp.reshape(-1, KV, hd)[slots[b, t]] = vw[wb, wo]
        stripes.append((kp, vp))
    return (kw, vw, bt_whole), bt, stripes


@pytest.mark.parametrize("F", [2, 4])
@pytest.mark.parametrize("window", [None, 6])
def test_stripe_partials_merge_to_whole_attention(F, window):
    """Each stripe's plain partial equals the JAX ``_partial_attention``
    over the same rows and mask, and the LSE merge of the F partials
    equals one whole-context attention (window included)."""
    rng = np.random.default_rng(4 + F)
    Bn, H, KV, hd, page, MB = 3, 4, 2, 16, 4, 3
    cl = np.array([1, 2 * F + 1, MB * F * page], np.int32)
    (kw, vw, bt_w), bt, stripes = _stripe_pools(rng, F, cl, page, KV, hd, MB)
    q = rng.standard_normal((Bn, H, hd)).astype(np.float32)
    parts = []
    for s, (kp, vp) in enumerate(stripes):
        acc, l, m = TS.stripe_partial(
            torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
            torch.from_numpy(bt), torch.from_numpy(cl), s, F, window=window)
        # the JAX package's partial over the same gathered rows and mask
        kg = kp[bt].reshape(Bn, MB * page, KV, hd)
        vg = vp[bt].reshape(Bn, MB * page, KV, hd)
        idx = np.arange(MB * page)[None]
        valid = idx < np.asarray(JS.stripe_counts(jnp.asarray(cl), s, F))[
            :, None]
        if window is not None:
            valid &= idx * F + s >= cl[:, None] - window
        ja, jl, jm = JS._partial_attention(jnp.asarray(q), jnp.asarray(kg),
                                           jnp.asarray(vg),
                                           jnp.asarray(valid), hd ** -0.5)
        np.testing.assert_allclose(acc.numpy(), np.asarray(ja), **TOL)
        np.testing.assert_allclose(l.numpy(), np.asarray(jl), **TOL)
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **TOL)
        parts.append((acc, l, m))
    m_g = torch.stack([m for _, _, m in parts]).amax(0)
    num = sum(a * torch.exp(m - m_g)[..., None] for a, _, m in parts)
    den = sum(l * torch.exp(m - m_g) for _, l, m in parts)
    merged = num / den[..., None]
    whole = paged_attention_ref(torch.from_numpy(q), torch.from_numpy(kw),
                                torch.from_numpy(vw), torch.from_numpy(bt_w),
                                torch.from_numpy(cl), window=window)
    np.testing.assert_allclose(merged.numpy(), whole.numpy(), **TOL)


@pytest.mark.parametrize("window", [None, 7])
def test_mla_decode_lse_matches_jax_kernel(window):
    """The plain absorbed MLA decode with ``return_lse`` against the JAX
    package's ``paged_attention_kernel(return_lse=True)`` in interpret
    mode on the KV = 1 view (the pool as K and V, fp32 q pre-scaled,
    scale 1): out over the first R lanes and lse; an empty row gets out
    0 and lse ``NEG_INF`` in both."""
    rng = np.random.default_rng(5)
    Bn, H, R, Rr, page, nblk, MB = 3, 4, 32, 16, 8, 16, 4
    W = R + Rr
    q = (rng.standard_normal((Bn, H, W)) * W ** -0.5).astype(np.float32)
    pool = rng.standard_normal((nblk, page, W)).astype(np.float32)
    bt = rng.permutation(nblk - 1)[:Bn * MB].reshape(Bn, MB).astype(np.int32)
    cl = np.array([0, 11, MB * page], np.int32)
    view = jnp.asarray(pool)[:, :, None, :]
    jo, jl = jax_paged_attention_kernel(
        jnp.asarray(q), view, view, jnp.asarray(bt), jnp.asarray(cl),
        window=window, softmax_scale=1.0, return_lse=True, interpret=True)
    to, tl = paged_mla_attention_ref(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(bt),
        torch.from_numpy(cl), R=R, window=window, return_lse=True)
    assert to.shape == (Bn, H, R) and tl.shape == (Bn, H)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo)[..., :R],
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=2e-5)
    assert (to[0] == 0).all()


# ---------------------------------------------------------------------------
# refusals, the reserved block, padding rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    cfg = get_config("llama3-8b").reduced()
    model = build_model(cfg, torch.float32, "cpu")
    plan = ParallelPlan(1, 1, 1)
    geom = PoolGeometry(cfg, plan, num_blocks=16, block_base=4,
                        layout="striped")
    return model, plan, geom


def test_striped_refuses_mixed_live_and_prior_context(small):
    model, plan, geom = small
    mode = FlyingMode(plan, 1)
    with pytest.raises(ValueError, match="mixed"):
        build_serve_step(model, mode, geom, phase="mixed")
    with pytest.raises(ValueError, match="head-layout"):
        build_serve_step(model, mode, geom, phase="decode", live=(1,))
    run, _ = build_serve_step(model, mode, geom, phase="prefill")
    params = model.init(torch.Generator().manual_seed(0))
    states = [tuple({"mixer": tuple(torch.zeros((n,) + geom.flat_shape())
                                    for _ in range(model.pools_of(k)))}
                    for k in ks) for ks, n in model.plan]
    i32 = torch.int32
    batch = {"tokens": torch.zeros((1, 4), dtype=i32),
             "positions": torch.arange(4, 8, dtype=i32)[None],
             "slots": torch.arange(4, 8, dtype=i32)[None],
             "block_table": torch.tensor([[3, 2]], dtype=i32),
             "prior_len": torch.tensor([4], dtype=i32)}
    with pytest.raises(ValueError, match="fresh only"):
        run(params, states, batch)
    batch["prior_len"] = torch.zeros((1,), dtype=i32)
    batch["positions"] = batch["positions"] - 4
    run(params, states, batch)


def test_striped_engine_refuses_chunked_prompts(small):
    """The engine turns the mixed step off and refuses a prompt that
    spans prefill chunks before staging anything for the step."""
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    model, plan, geom = small
    params = model.init(torch.Generator().manual_seed(0))
    eng = FlyingEngine(model, plan, geom, params, batch_per_engine=2,
                       max_blocks_per_req=8, device="cpu")
    assert eng.supports_mixed() is False and eng.live_readable() is False
    sched = DynamicScheduler(plan, geom, FixedClock(eng), SchedulerConfig(
        strategy="hard", max_batch_per_group=2, prefill_chunk=4))
    sched.submit(Request(req_id="long", arrival=0.0, prompt_len=9,
                         output_len=2))
    with pytest.raises(ValueError, match="fresh only"):
        sched.run(max_steps=20)


def test_striped_pool_never_allocates_the_reserved_block(small):
    """The adaptor hands out every block but the last, in the striped
    layout too: the scratch row the writes park on stays outside every
    request's table."""
    _, plan, geom = small
    ad = KVCacheAdaptor(geom)
    cap = geom.capacity(1)
    n = 0
    while ad.free_blocks() > 0:
        ad.append_slots("r", cap)
        n += 1
    with pytest.raises(MemoryError):
        ad.append_slots("r", cap)
    ids = ad.table["r"].block_ids
    assert n == geom.num_blocks - 1 and len(ids) == n
    assert geom.num_blocks - 1 not in ids


def test_striped_padding_rows_park(small):
    """A striped decode step whose padding row (staged slot -1, table of
    zeros, position 0) would write block 0 parks that write instead."""
    model, plan, geom = small
    run, _ = build_serve_step(model, FlyingMode(plan, 1), geom,
                              phase="decode")
    params = model.init(torch.Generator().manual_seed(0))
    states = [tuple({"mixer": tuple(torch.zeros((n,) + geom.flat_shape())
                                    for _ in range(model.pools_of(k)))}
                    for k in ks) for ks, n in model.plan]
    i32 = torch.int32
    run(params, states, {
        "tokens": torch.tensor([[3], [0]], dtype=i32),
        "positions": torch.tensor([[5], [0]], dtype=i32),
        "slots": torch.tensor([[9], [-1]], dtype=i32),
        "block_table": torch.tensor([[4, 2], [0, 0]], dtype=i32),
        "context_len": torch.tensor([6, 1], dtype=i32)})
    for group in states:
        for st_ in group:
            for p in st_["mixer"]:
                flat = p.view(p.shape[0], geom.num_blocks, -1)
                assert (flat[:, 0] == 0).all()         # block 0 untouched
                assert (flat[:, 2] != 0).any()         # token 5: block 2
                                                       # (5 // 4 = page 1)


if __name__ == "__main__":
    reference_main(sys.argv[1])
