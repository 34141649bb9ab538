"""The port's MLA (DeepSeek-V2) against the JAX package's, on the CPU.

Inputs are drawn from seeded numpy generators; the parameters are the
JAX package's ``model.init(jax.random.key(0))`` of the reduced config
(MLA at R 64 + Rr 16 = W 80, one MLA+MLP layer, one MLA+MoE layer),
carried over by ``params_from_numpy``. What is held:

- ``paged_mla_attention_ref`` (through ``ops.paged_mla_attention_decode``
  on CPU tensors: the one-pool append, then the plain absorbed decode)
  against the JAX ``paged_mla_attention_decode``, its jnp reference and
  its Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s
  shapes, with and without a window: fp32, atol = rtol = 2e-5 (that
  test's own bound between the two JAX paths), the pools equal;
- the one-pool chunk append (K3's form for the compressed cache) against
  the JAX ``paged_append``: equal, but for the scratch row;
- the model's logits over two chunked-prefill steps (naive expansion of
  the gathered compressed prefix) and an absorbed decode step, fp32, at
  ``tests/test_torch_model.py``'s atol = rtol = 1e-4, and the absorbed
  decode against the naive expansion of the same step (1e-4);
- ``DynamicScheduler`` runs at ``ParallelPlan(1, 1, 1)`` under HARD,
  SOFT and SEQUENTIAL (prefill, mixed and decode steps): greedy tokens
  and phase logs identical to the JAX ``FlyingEngine``'s, both clocks
  pinned at 10 ms a step (``tests/test_torch_engine.py``).
"""
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.engine import FlyingEngine as JaxEngine
from repro.core.kv_adaptor import PoolGeometry as JaxGeometry
from repro.core.modes import ParallelPlan as JaxPlan
from repro.core.scheduler import DynamicScheduler as JaxScheduler
from repro.core.scheduler import SchedulerConfig as JaxSchedConfig
from repro.core.task_pool import Request as JaxRequest
from repro.core.views import SINGLE as JSINGLE
from repro.kernels.paged_attention.ops import \
    paged_mla_attention_decode as jax_mla_decode
from repro.models.cache import DecodeBackend as JDecode
from repro.models.cache import PrefillBackend as JPrefill
from repro.models.cache import paged_append as jax_paged_append
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import FlyingEngine
from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import ParallelPlan
from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
from repro_torch.core.task_pool import Request
from repro_torch.core.views import SINGLE
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.models.cache import DecodeBackend, PrefillBackend
from repro_torch.models.model import build_model
from test_torch_engine import _FixedClock, jax_mesh_shim  # noqa: F401
from test_torch_model import NBLK, PAGE, _steps

ARCH = "deepseek-v2-236b"
TOL = dict(atol=1e-4, rtol=1e-4)
STRATEGIES = ("hard", "soft", "sequential")


# ---------------------------------------------------------------------------
# helpers shared with tests/test_torch_moe.py
# ---------------------------------------------------------------------------

def both_models(arch):
    """(JAX model, JAX params, port model, port params): the reduced
    config, fp32, the JAX package's seed-0 parameters in both."""
    jm = jax_build(jax_config(arch).reduced(), jnp.float32)
    jp = jm.init(jax.random.key(0))
    cfg = get_config(arch).reduced()
    tm = build_model(cfg, torch.float32, device="cpu")
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def forward_steps(models):
    """Both packages' logits over ``tests/test_torch_model.py``'s two
    chunked-prefill steps and one decode step, and their states."""
    jm, jp, tm, tp = models
    jst = jm.init_states(ctx=JSINGLE, batch=2, num_blocks=NBLK, page=PAGE)
    tst = tm.init_states(ctx=SINGLE, num_blocks=NBLK, page=PAGE)
    out = []
    for mode, b in _steps():
        j = {k: jnp.asarray(v) for k, v in b.items()}
        t = {k: torch.from_numpy(v) for k, v in b.items()}
        if mode == "prefill":
            jb = JPrefill(slots=j["slots"], prior_len=j["prior_len"],
                          block_table=j["block_table"], chunked=True)
            tb = PrefillBackend(slots=t["slots"], prior_len=t["prior_len"],
                                block_table=t["block_table"])
            extra = dict(last_pos=j["last_pos"]), \
                dict(last_pos=t["last_pos"])
        else:
            jb = JDecode(slots=j["slots"], block_table=j["block_table"],
                         context_len=j["context_len"])
            tb = DecodeBackend(slots=t["slots"], block_table=t["block_table"],
                               context_len=t["context_len"])
            extra = {}, {}
        jl, jst, _ = jm.forward(jp, JSINGLE, mode=mode, tokens=j["tokens"],
                                positions=j["positions"], backend=jb,
                                states=jst, **extra[0])
        tl, tst, _ = tm.forward(tp, SINGLE, mode=mode, tokens=t["tokens"],
                                positions=t["positions"], backend=tb,
                                states=tst, **extra[1])
        out.append((mode, np.asarray(jl), tl))
    return out, jst, tst


class FixedClock(_FixedClock):
    """``_FixedClock`` that also pins a rebind's duration."""

    def rebind(self, *a):
        self.eng.rebind(*a)
        return 0.01


def sched_run(arch, side, strategy, models):
    """Six requests 10 ms apart at one rank, two rows an engine: prompts
    of 8-28 tokens in chunks of 8 (the first, of 24, prefills alone),
    3-8 tokens out, request 3 at priority 1; prefill, mixed and decode
    steps all run."""
    jm, jp, tm, tp = models
    if side == "jax":
        m, p, kw = jm, jp, {}
        Plan, Geom, Eng, Sched, SConf, Req = (
            JaxPlan, JaxGeometry, JaxEngine, JaxScheduler, JaxSchedConfig,
            JaxRequest)
    else:
        m, p, kw = tm, tp, dict(device="cpu")
        Plan, Geom, Eng, Sched, SConf, Req = (
            ParallelPlan, PoolGeometry, FlyingEngine, DynamicScheduler,
            SchedulerConfig, Request)
    plan = Plan(engine_rows=1, tp_base=1, data_rows=1)
    geom = Geom(m.cfg, plan, num_blocks=64, block_base=4)
    eng = Eng(m, plan, geom, p, batch_per_engine=2, max_blocks_per_req=16,
              **kw)
    sched = Sched(plan, geom, FixedClock(eng), SConf(
        strategy=strategy, max_batch_per_group=2, prefill_chunk=8))
    for i in range(6):
        sched.submit(Req(req_id=f"r{i}", arrival=i * 0.01,
                         prompt_len=(24, 8, 12, 16, 20, 28)[i],
                         output_len=3 + i,
                         priority=1 if i == 3 else 0))
    sched.run(max_steps=300)
    done = sorted(r.req_id for r in sched.pool.all.values()
                  if r.state == "done")
    return {"done": done,
            "toks": {rid: list(map(int, eng.generated_tokens(rid)))
                     for rid in done},
            "phases": [l.phase for l in sched.log],
            "switches": sched.switches}


# ---------------------------------------------------------------------------
# the absorbed decode op and the one-pool appends
# ---------------------------------------------------------------------------

def _mla_inputs(B, H, R, Rr, page, nblk, MB, seed=0):
    rng = np.random.default_rng(seed)
    W = R + Rr
    q = rng.standard_normal((B, H, W)).astype(np.float32)
    pool = rng.standard_normal((nblk, page, W)).astype(np.float32)
    entry = rng.standard_normal((B, W)).astype(np.float32)
    bt = rng.permutation(nblk - 1)[:B * MB].reshape(B, MB).astype(np.int32)
    cl = rng.integers(1, MB * page + 1, B).astype(np.int32)
    slots = (bt[np.arange(B), (cl - 1) // page] * page
             + (cl - 1) % page).astype(np.int32)
    return q, entry, pool, slots, bt, cl


@pytest.mark.parametrize("impl", ["ref", "interpret"])
@pytest.mark.parametrize("window", [None, 7])
@pytest.mark.parametrize("B,H,R,Rr,page,nblk,MB", [
    (2, 8, 32, 16, 8, 16, 4),
    (3, 4, 64, 32, 16, 32, 6),
])
def test_mla_decode_ref_matches_jax(B, H, R, Rr, page, nblk, MB, window,
                                    impl):
    args = _mla_inputs(B, H, R, Rr, page, nblk, MB)
    scale = (R + Rr) ** -0.5
    jo, jpool = jax_mla_decode(*map(jnp.asarray, args), R=R, window=window,
                               softmax_scale=scale, impl=impl)
    t = [torch.from_numpy(a) for a in args]
    to, tpool = pa_ops.paged_mla_attention_decode(
        t[0], t[1], t[2], t[3], t[4], t[5], R=R, window=window,
        softmax_scale=scale)
    assert to.shape == (B, H, R) and to.dtype == torch.float32
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_array_equal(tpool.numpy(), np.asarray(jpool))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_one_pool_chunk_append_matches_jax(dtype):
    rng = np.random.default_rng(5)
    nblk, page, W, B, T = 12, 8, 80, 3, 5
    pool = rng.standard_normal((nblk, page, W)).astype(np.float32)
    vals = rng.standard_normal((B, T, W)).astype(np.float32)
    slots = rng.choice((nblk - 1) * page, B * T, replace=False)
    slots[[2, 9]] = -1
    slots = slots.reshape(B, T).astype(np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_paged_append(jnp.asarray(pool, jdt), jnp.asarray(vals),
                            jnp.asarray(slots))
    tpool = torch.from_numpy(pool).to(dtype)
    ptr = tpool.data_ptr()
    (got,) = pa_ops.paged_append_chunk((tpool,), (torch.from_numpy(vals),),
                                       torch.from_numpy(slots))
    assert got.data_ptr() == ptr                   # written in place
    rows = nblk * page - 1                         # all but the scratch row
    np.testing.assert_array_equal(
        got.float().numpy().reshape(-1, W)[:rows],
        np.asarray(want.astype(jnp.float32)).reshape(-1, W)[:rows])


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    return both_models(ARCH)


def test_mla_logits_match_jax(models):
    steps, jst, tst = forward_steps(models)
    assert [m for m, _, _ in steps] == ["prefill", "prefill", "decode"]
    for mode, jl, tl in steps:
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
    # one compressed pool a layer [n, NBLK, PAGE, W], as the JAX state
    for g in range(2):
        (got,) = tst[g][0]["mixer"]
        (want,) = jst[g][0]["mixer"]
        assert got.shape == want.shape == (1, NBLK, PAGE, 80)
        rows = NBLK * PAGE - 1
        np.testing.assert_allclose(got.numpy().reshape(-1, 80)[:rows],
                                   np.asarray(want).reshape(-1, 80)[:rows],
                                   **TOL)


@dataclass(frozen=True)
class _NaiveDecode:
    """A decode step through the naive expansion: ``DecodeBackend``'s
    ``append_ctx`` (append, gather the prefix, mask by context length)
    without the absorbed path, which ``mla_attention`` takes only for a
    ``DecodeBackend``."""
    inner: DecodeBackend

    def append_ctx(self, state, vals, *, positions):
        return self.inner.append_ctx(state, vals, positions=positions)


def test_absorbed_decode_matches_naive(models):
    _, _, tm, tp = models
    *prefills, (_, b) = _steps()
    st = tm.init_states(ctx=SINGLE, num_blocks=NBLK, page=PAGE)
    for _, p in prefills:
        t = {k: torch.from_numpy(v) for k, v in p.items()}
        tm.forward(tp, SINGLE, mode="prefill", tokens=t["tokens"],
                   positions=t["positions"], states=st,
                   last_pos=t["last_pos"], backend=PrefillBackend(
                       slots=t["slots"], prior_len=t["prior_len"],
                       block_table=t["block_table"]))
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    dec = DecodeBackend(slots=t["slots"], block_table=t["block_table"],
                        context_len=t["context_len"])
    st2 = [tuple({"mixer": tuple(x.clone() for x in s["mixer"])} for s in g)
           for g in st]
    absorbed, _, _ = tm.forward(tp, SINGLE, mode="decode",
                                tokens=t["tokens"], positions=t["positions"],
                                backend=dec, states=st)
    naive, _, _ = tm.forward(tp, SINGLE, mode="decode", tokens=t["tokens"],
                             positions=t["positions"],
                             backend=_NaiveDecode(dec), states=st2)
    np.testing.assert_allclose(absorbed.numpy(), naive.numpy(), **TOL)
    for a, n in zip(st, st2):
        np.testing.assert_allclose(a[0]["mixer"][0].numpy(),
                                   n[0]["mixer"][0].numpy(), **TOL)


@pytest.fixture(scope="module")
def jax_sched(models, jax_mesh_shim):  # noqa: F811
    return {s: sched_run(ARCH, "jax", s, models) for s in STRATEGIES}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_mla_scheduler_runs_match_jax(models, jax_sched, strategy):
    got = sched_run(ARCH, "torch", strategy, models)
    want = jax_sched[strategy]
    assert len(got["done"]) == 6
    assert {"prefill", "mixed", "decode"} <= set(got["phases"])
    assert got == want
