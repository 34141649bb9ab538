"""The port's engine serving mamba2-2.7b and recurrentgemma-9b against the
JAX package's step level, one request at a time, on the CPU.

``DynamicScheduler`` over the port's ``FlyingEngine`` at
``ParallelPlan(1, 1, 1)`` serves a ragged trace of 8 requests (prompts of
24-88 tokens in prefill chunks of 32, so one batch holds chunks of 8, 24
and 32 tokens and a prompt spans 1-3 chunks; outputs of 4-12 tokens,
greedy; 4 batch rows, so later admissions reuse the rows of finished
requests) with the reduced mamba2-2.7b and a 3-layer recurrentgemma-9b
(two RG-LRU layers and one local-attention layer, window 64), in fp32,
with the JAX package's ``model.init(jax.random.key(0))`` parameters and
slowly decaying recurrent leaves (``SLOW_DECAY``), carried over by
``params_from_numpy``. A Mamba-2 or RG-LRU request's output depends on
its own tokens alone, so the reference is the JAX package's
``build_serve_step`` run for each request alone at batch 1, over the
same prefill chunks, then greedy decode steps: every request's tokens
must be equal. The JAX engine is no reference here: it hands its rows
out anew every step, runs its pads through the recurrence and restarts a
reshaped island's states from zeros (ROADMAP Queue 3); one case runs it
on the same trace, under ``tests/test_torch_engine.py``'s mesh shim, and
shows a request leave the step-level reference.

Unit checks on the plain versions: a row whose ``valid`` is 0 keeps its
conv tail and state bit for bit through a prefill and a decode call of
either layer; a ragged row masked past its ``valid`` ends in the state
(and gives the outputs) of the same row run unpadded, within 1e-5; a row
taken by a new request is zeroed in every recurrent leaf. Then the
launcher: it serves both families on the CPU, refuses ``--prefix-cache``
for them, and still refuses whisper-base and internvl2-1b (ROADMAP Queue
1 item 3).
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

from repro.core.engine import FlyingEngine as JaxEngine
from repro.core.kv_adaptor import KVCacheAdaptor as JaxAdaptor
from repro.core.kv_adaptor import PoolGeometry as JaxGeometry
from repro.core.modes import FlyingMode as JaxMode
from repro.core.modes import ParallelPlan as JaxPlan
from repro.core.scheduler import DynamicScheduler as JaxScheduler
from repro.core.scheduler import SchedulerConfig as JaxSchedConfig
from repro.core.steps import build_serve_step as jax_serve_step
from repro.core.task_pool import Request as JaxRequest
from repro.core.views import make_serving_ctx as jax_serving_ctx
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import FlyingEngine
from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import ParallelPlan
from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
from repro_torch.core.task_pool import Request, prompt_token_ids
from repro_torch.core.views import SINGLE
from repro_torch.models import mamba2, rglru
from repro_torch.models.model import build_model
from test_torch_engine import _FixedClock, jax_mesh_shim  # noqa: F401
from test_torch_recurrent import _configs, slow_decay

REPO = Path(__file__).resolve().parents[1]
ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
CHUNK, BPE, NUM_BLOCKS, BLOCK_BASE, MAX_BLOCKS = 32, 4, 256, 4, 32
# (prompt, output) of each request: last chunks of 24, 8 and 32 tokens
TRACE = ((24, 6), (56, 12), (88, 4), (40, 9), (72, 5), (24, 11), (88, 7),
         (40, 4))
TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def zoo():
    """``zoo(arch)``: the JAX model and its init(key(0)) parameters with
    the ``SLOW_DECAY`` leaves set, the port's model and those parameters
    converted, built once."""
    built = {}

    def get(arch):
        if arch not in built:
            jcfg, cfg = _configs(arch)
            jm = jax_build(jcfg, jnp.float32)
            jp = slow_decay(jm.init(jax.random.key(0)))
            built[arch] = (jm, jp, build_model(cfg, torch.float32, "cpu"),
                           params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                               jp),
                                             device="cpu"))
        return built[arch]
    return get


def trace(Req=Request):
    """TRACE's requests, arriving 5 ms apart."""
    return [Req(req_id=f"r{i}", arrival=0.005 * i, prompt_len=p,
                output_len=o) for i, (p, o) in enumerate(TRACE)]


# ---------------------------------------------------------------------------
# the step-level reference: one request alone at batch 1
# ---------------------------------------------------------------------------

def _jax_states(jm, jgeom):
    """Zeroed state leaves [n, 1, 1, *layer state] of a batch-1 step at
    ParallelPlan(1, 1, 1)."""
    ctx = jax_serving_ctx(1, 1, 1)
    groups = []
    for kind_seq, n in jm.plan:
        per = []
        for kind in kind_seq:
            st = dict(jm.layer_state(kind, ctx=ctx, batch=1,
                                     num_blocks=jgeom.num_blocks,
                                     page=jgeom.capacity(1),
                                     make=jax.ShapeDtypeStruct))
            if kind[0] in ("gqa", "gqa_win"):
                st["mixer"] = tuple(
                    jax.ShapeDtypeStruct(jgeom.flat_shape(), s.dtype)
                    for s in st["mixer"])
            per.append({k: tuple(jnp.zeros((n, 1, 1) + tuple(s.shape),
                                           s.dtype) for s in v)
                        for k, v in st.items()})
        groups.append(tuple(per))
    return groups


def jax_reference(jm, jp, steps, prompt, n_out):
    """The JAX package's step for ``prompt`` alone at batch 1: prefill
    chunks of CHUNK tokens from the carried state and the prior pages,
    then ``n_out - 1`` greedy decode steps. Returns the ``n_out`` greedy
    tokens. ``steps`` holds the jitted (prefill, decode) pair, which
    compiles once per chunk length."""
    jpre, jdec = steps
    jgeom = JaxGeometry(jm.cfg, JaxPlan(1, 1, 1), num_blocks=64,
                        block_base=BLOCK_BASE)
    ad = JaxAdaptor(jgeom)
    ad.switch_mode(1)
    st = _jax_states(jm, jgeom)
    i32 = np.int32
    out, pos = [], 0
    P = len(prompt)
    while pos < P:
        T = min(CHUNK, P - pos)
        slots = np.asarray(ad.append_slots("r", T), i32)[None]
        logits, st = jpre(jp, st, {
            "tokens": jnp.asarray(np.asarray(prompt[pos:pos + T], i32)[None]),
            "positions": jnp.arange(pos, pos + T, dtype=jnp.int32)[None],
            "slots": jnp.asarray(slots),
            "block_table": jnp.asarray(ad.block_table("r", 32), i32)[None],
            "prior_len": jnp.asarray([pos], i32)})
        pos += T
    out.append(int(np.asarray(logits).argmax(-1)[0]))
    while len(out) < n_out:
        slot = ad.append_slots("r", 1)[0]
        logits, st = jdec(jp, st, {
            "tokens": jnp.asarray([[out[-1]]], i32),
            "positions": jnp.asarray([[pos]], i32),
            "slots": jnp.asarray([slot], i32),
            "block_table": jnp.asarray(ad.block_table("r", 32), i32)[None],
            "context_len": jnp.asarray([pos + 1], i32)})
        out.append(int(np.asarray(logits).argmax(-1)[0]))
        pos += 1
    return out


@pytest.fixture(scope="module")
def reference(zoo):
    """``reference(arch)``: every TRACE request's step-level tokens, its
    prompt drawn as the engine draws it (``prompt_token_ids``)."""
    refs = {}

    def get(arch):
        if arch not in refs:
            jm, jp, _, _ = zoo(arch)
            jmode = JaxMode(JaxPlan(1, 1, 1), 1)
            jgeom = JaxGeometry(jm.cfg, JaxPlan(1, 1, 1), num_blocks=64,
                                block_base=BLOCK_BASE)
            steps = (jax.jit(jax_serve_step(jm, jmode, jgeom,
                                            phase="prefill",
                                            chunked=True)[0]),
                     jax.jit(jax_serve_step(jm, jmode, jgeom,
                                            phase="decode")[0]))
            refs[arch] = {
                r.req_id: jax_reference(
                    jm, jp, steps, prompt_token_ids(r, jm.cfg.vocab_size),
                    r.output_len)
                for r in trace()}
        return refs[arch]
    return get


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def serve(model, params, Plan=ParallelPlan, Geom=PoolGeometry,
          Engine=FlyingEngine, Sched=DynamicScheduler,
          SConf=SchedulerConfig, Req=Request, **kw):
    """TRACE through the scheduler over an engine at ParallelPlan(1, 1,
    1), every step reporting 10 ms. Returns (tokens by request, the
    engine, the scheduler)."""
    plan = Plan(engine_rows=1, tp_base=1, data_rows=1)
    geom = Geom(model.cfg, plan, num_blocks=NUM_BLOCKS,
                block_base=BLOCK_BASE)
    eng = Engine(model, plan, geom, params, batch_per_engine=BPE,
                 max_blocks_per_req=MAX_BLOCKS, **kw)
    sched = Sched(plan, geom, _FixedClock(eng), SConf(
        strategy="hard", max_batch_per_group=BPE, prefill_chunk=CHUNK))
    for r in trace(Req):
        sched.submit(r)
    sched.run(max_steps=2000)
    return ({r.req_id: list(map(int, eng.generated_tokens(r.req_id)))
             for r in trace(Req)}, eng, sched)


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_step_level_reference(zoo, reference,
                                                      arch):
    """Every request's greedy tokens through DynamicScheduler +
    FlyingEngine equal the JAX step run for it alone; ragged chunks share
    prefill steps, and later requests take the rows of finished ones."""
    _, _, tm, tp = zoo(arch)
    toks, eng, sched = serve(tm, tp, device="cpu")
    assert all(r.state == "done" for r in sched.pool.all.values())
    phases = {e.phase for e in sched.log}
    assert phases == {"prefill", "decode"}, phases   # no mixed step
    assert toks == reference(arch)
    assert eng.sync_stats.host_argmax == 0
    assert not eng.islands[0].held          # every row released


def test_jax_engine_departs_from_the_step_level_reference(
        zoo, reference, jax_mesh_shim):
    """The JAX package's engine on the same trace (mamba2-2.7b): at least
    one request's tokens differ from the step-level reference, which is
    why the port's engine departs from it (ROADMAP Queue 3)."""
    jm, jp, _, _ = zoo("mamba2-2.7b")
    toks, _, _ = serve(jm, jp, JaxPlan, JaxGeometry, JaxEngine,
                       JaxScheduler, JaxSchedConfig, JaxRequest)
    ref = reference("mamba2-2.7b")
    assert {k: len(v) for k, v in toks.items()} == \
        {k: len(v) for k, v in ref.items()}
    assert any(toks[k] != ref[k] for k in ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_taken_row_is_zeroed(zoo, arch):
    """``_take_rows`` hands a request the lowest free row of its group and
    zeroes it in every recurrent leaf, leaving the other rows alone; a
    released row goes back to the free set."""
    _, _, tm, tp = zoo(arch)
    plan = ParallelPlan(1, 1, 1)
    geom = PoolGeometry(tm.cfg, plan, num_blocks=16, block_base=4)
    eng = FlyingEngine(tm, plan, geom, tp, batch_per_engine=BPE,
                       device="cpu")
    rt = eng.islands[0]
    leaves = eng._row_leaves(rt.states)
    assert leaves and all(t.shape[1] == BPE for t in leaves)
    for t in leaves:
        t.fill_(1.0)
    a, b = (Request(req_id=k, arrival=0.0, prompt_len=8, output_len=2)
            for k in "ab")
    a.engine_group = b.engine_group = 0
    eng._take_rows(rt, [a, b])
    assert rt.held == {"a": 0, "b": 1}
    eng.release_row(a)
    for t in leaves:
        t[:, 0].fill_(2.0)
    c = Request(req_id="c", arrival=0.0, prompt_len=8, output_len=2)
    c.engine_group = 0
    eng._take_rows(rt, [c])
    assert rt.held == {"b": 1, "c": 0}
    for t in leaves:
        assert not t[:, :2].any() and bool((t[:, 2:] == 1).all())


# ---------------------------------------------------------------------------
# the layers' masking (plain versions)
# ---------------------------------------------------------------------------

LAYERS = {"mamba2-2.7b": (("mamba", "none"), mamba2.mamba2_layer),
          "recurrentgemma-9b": (("rglru", "gelu_mlp"), rglru.rglru_block)}


def _layer(zoo, arch, rows):
    _, _, tm, tp = zoo(arch)
    kind, fn = LAYERS[arch]
    p = {k: v[0] for k, v in tp["groups"][0][0]["mixer"].items()}
    state = tm.recurrent_state(kind, ctx=SINGLE, batch=rows)
    gen = torch.Generator().manual_seed(3)
    for t in state:
        t.copy_(torch.randn(t.shape, generator=gen))
    return tm, p, fn, state, gen


@pytest.mark.parametrize("mode", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_idle_row_keeps_its_state_bit_for_bit(zoo, arch, mode):
    """A row whose ``valid`` is 0 keeps its conv tail and state bit for
    bit; the row beside it, with every position valid, moves as it does
    without ``valid``."""
    tm, p, fn, state, gen = _layer(zoo, arch, 2)
    T = 1 if mode == "decode" else 12
    x = torch.randn((2, T, tm.cfg.d_model), generator=gen)
    before = [t.clone() for t in state]
    plain = tuple(t.clone() for t in state)
    y_plain, _ = fn(tm.cfg, p, x, SINGLE, plain, mode=mode)
    y, _ = fn(tm.cfg, p, x, SINGLE, state, mode=mode,
              valid=torch.tensor([0, T], dtype=torch.int32))
    for t, b, w in zip(state, before, plain):
        assert torch.equal(t[0], b[0])
        assert torch.equal(t[1], w[1])
    assert torch.equal(y[1], y_plain[1])


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_ragged_row_matches_the_row_unpadded(zoo, arch):
    """A prefill batch of rows of 37 and 11 real positions, padded to 48:
    each row's final state and real outputs equal the row's own unpadded
    call (TOL)."""
    tm, p, fn, state, gen = _layer(zoo, arch, 2)
    lens, T = (37, 11), 48
    x = torch.randn((2, T, tm.cfg.d_model), generator=gen)
    alone = []
    for b, n in enumerate(lens):
        st = tuple(t[b:b + 1].clone() for t in state)
        y, _ = fn(tm.cfg, p, x[b:b + 1, :n], SINGLE, st, mode="prefill")
        alone.append((y, st))
    y, _ = fn(tm.cfg, p, x, SINGLE, state, mode="prefill",
              valid=torch.tensor(lens, dtype=torch.int32))
    for b, (n, (ya, sta)) in enumerate(zip(lens, alone)):
        torch.testing.assert_close(y[b:b + 1, :n], ya, **TOL)
        for t, w in zip(state, sta):
            torch.testing.assert_close(t[b:b + 1], w, **TOL)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(arch, *extra):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--dtype", "float32", "--arch", arch,
         "--requests", "3", "--num-blocks", "64", "--prompt-range", "8",
         "40", "--output-range", "2", "4", "--prefill-chunk", "16",
         "--max-blocks-per-req", "16", *extra],
        env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", ARCHS + ("whisper-base", "internvl2-1b"))
def test_launcher_serves_the_recurrent_families(arch):
    """The launcher's real path serves both recurrent families on the
    CPU; the modality families still exit non-zero, naming the ROADMAP
    item."""
    proc = _launch(arch)
    if arch in ARCHS:
        assert proc.returncode == 0, proc.stderr
        assert "requests done : 3/3" in proc.stdout
    else:
        assert proc.returncode != 0
        assert "NotImplementedError" in proc.stderr
        assert "Queue 1 item 3" in proc.stderr


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_the_prefix_cache(arch):
    """A prefix cache shares KV blocks, never a recurrent state."""
    proc = _launch(arch, "--prefix-cache")
    assert proc.returncode != 0
    assert "never a recurrent state" in proc.stderr
    assert "requests done" not in proc.stdout


@pytest.mark.parametrize("arch", ("whisper-base", "internvl2-1b"))
def test_engine_still_refuses_the_modality_families(arch):
    cfg = get_config(arch).reduced()
    tm = build_model(cfg, torch.float32, "cpu")
    plan = ParallelPlan(1, 1, 1)
    geom = PoolGeometry(cfg, plan, num_blocks=16, block_base=4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        FlyingEngine(tm, plan, geom, tm.init(torch.Generator()),
                     device="cpu")
