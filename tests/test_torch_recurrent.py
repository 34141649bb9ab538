"""The port's Mamba-2 and RecurrentGemma serving path against the JAX
package's, on the CPU.

The plain versions of K6 and K7 from a carried state against the JAX
package's scans (``ssd_chunked`` from a random ``h0``, ``_rglru_scan``
from a random ``h0``); the plain paged K2 and K4 at hd 256 (16 query
heads on one kv head, RecurrentGemma's local attention) with a window
against the Pallas kernels in interpret mode, as
``tests/test_torch_kernels.py`` holds them at hd 64 and 128; each
layer's prefill and decode modes from a carried state against the JAX
layer's; then the reduced mamba2-2.7b and a 3-layer recurrentgemma-9b
(two RG-LRU layers and one local-attention layer, window 64) through
``build_serve_step`` against the JAX package's step at
``ParallelPlan(1, 1, 1)``, with the same parameters (the JAX package's
``model.init(jax.random.key(0))`` with slowly decaying recurrent leaves,
``SLOW_DECAY``, carried over by ``params_from_numpy``) and prompts of 80
tokens, longer than the window: one prefill of 80
tokens, or two prefill chunks (48, then 32 from the carried state and
the prior pages), then 3 decode steps. Every prompt of a batch has the
same length (a padded row would run its pads through the recurrence).
Tolerances: fp32 throughout, atol = rtol = 1e-4 for the steps, the
layers and K6's plain version (its chunked fp32 sums run in another
order than jnp's; check_serve_consistency's 3e-3 would also do) and
greedy tokens identical; 1e-5 for K7's and the paged kernels' plain
versions. Then the refusals: the mixed, live and striped steps refuse
both families (the engine serves them: tests/test_torch_recurrent_engine.py).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.kv_adaptor import KVCacheAdaptor as JaxAdaptor
from repro.core.kv_adaptor import PoolGeometry as JaxGeometry
from repro.core.modes import FlyingMode as JaxMode
from repro.core.modes import ParallelPlan as JaxPlan
from repro.core.steps import build_serve_step as jax_serve_step
from repro.core.views import SINGLE as JSINGLE
from repro.core.views import make_serving_ctx as jax_serving_ctx
from repro.models import mamba2 as jmamba
from repro.models import rglru as jrglru
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
from repro_torch.core.modes import FlyingMode, ParallelPlan
from repro_torch.core.steps import build_serve_step, fresh_states
from repro_torch.core.views import SINGLE
from repro_torch.kernels import _lib
from repro_torch.kernels.rglru_scan import ops as rops
from repro_torch.kernels.rglru_scan import ref as rref
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.models import mamba2, rglru
from repro_torch.models.model import build_model
from test_torch_kernels import _case, _close, _jax_sweep, _t

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
TOL = dict(atol=1e-4, rtol=1e-4)
B, PROMPT, DECODES = 2, 80, 3
SPLITS = {"one": (80,), "two": (48, 32)}


def _configs(arch):
    """The reduced config in both packages; recurrentgemma-9b with 3
    layers, so that one local-attention layer runs."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if cfg.hybrid is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=3)
        cfg = dataclasses.replace(cfg, num_layers=3)
    return jcfg, cfg


# the recurrent leaves the tests set so that a state is carried across a
# prefill chunk: at the JAX package's init (dt_bias 0, Lambda 0.7) a
# Mamba-2 state decays by e^-0.7 or more a token and an RG-LRU state by
# e^-7.7, so a state dropped between chunks would not show in a chunk's
# last logits or rows; dt_bias -8 and Lambda -8 keep it for hundreds of
# tokens
SLOW_DECAY = {"dt_bias": -8.0, "lam": -8.0}


def slow_decay(tree):
    """``tree`` with every ``SLOW_DECAY`` leaf set to its value."""
    if isinstance(tree, dict):
        return {k: jnp.full_like(v, SLOW_DECAY[k]) if k in SLOW_DECAY
                else slow_decay(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(slow_decay(v) for v in tree)
    return tree


@pytest.fixture(scope="module")
def zoo():
    """``zoo(arch)``: the JAX model and its init(key(0)) params with the
    ``SLOW_DECAY`` leaves set, the port's model and those params
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


# ---------------------------------------------------------------------------
# K6 and K7 from a carried state (plain versions)
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, Bs, T, H, hd, S):
    f = np.float32
    return (rng.standard_normal((Bs, T, H, hd)).astype(f),
            np.log1p(np.exp(rng.standard_normal((Bs, T, H)))).astype(f),
            -np.linspace(1.0, 16.0, H).astype(f),
            rng.standard_normal((Bs, T, S)).astype(f),
            rng.standard_normal((Bs, T, S)).astype(f),
            rng.standard_normal((Bs, H, hd, S)).astype(f))


@pytest.mark.parametrize("T", [64, 37])
def test_ssd_scan_from_h0_matches_jax(T):
    """``ops.ssd_scan_from`` (T padded to a multiple of min(chunk, T) as
    the JAX layer pads it) and ``ref.ssd_chunked`` from a random h0
    against the JAX package's ``ssd_chunked`` on the padded inputs, and
    against the sequential recurrence; nothing launches on the CPU."""
    rng = np.random.default_rng(T)
    x, dt, A, Bm, Cm, h0 = _ssd_inputs(rng, 2, T, 3, 32, 16)
    chunk = 32
    ch = min(chunk, T)
    pad = (-T) % ch
    padded = [np.pad(a, [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2))
              for a in (x, dt, Bm, Cm)]
    jy, jh = jmamba.ssd_chunked(*map(jnp.asarray, (padded[0], padded[1], A,
                                                   padded[2], padded[3],
                                                   h0)), ch)
    _lib.reset_launches()
    y, hT = sops.ssd_scan_from(*map(_t, (x, dt, A, Bm, Cm, h0)),
                               chunk=chunk)
    assert _lib.LAUNCHES["ssd_scan_from"] == 0
    _close(y, np.asarray(jy)[:, :T], **TOL)
    _close(hT, jh, **TOL)
    sy, sh = sref.ssd_scan_ref(*map(_t, (x, dt, A, Bm, Cm, h0)))
    _close(y, sy, **TOL)
    _close(hT, sh, **TOL)
    if not pad:
        got = sref.ssd_chunked(*map(_t, (x, dt, A, Bm, Cm, h0)), ch)
        for g, w in zip(got, (jy, jh)):
            _close(g, w, **TOL)


@pytest.mark.parametrize("T", [40, 1])
def test_rglru_scan_from_h0_matches_jax(T):
    """``ops.rglru_scan_from`` and ``ref.rglru_scan_ref`` from a random
    h0, fed the gates the RG-LRU block computes from u, against the JAX
    package's ``_rglru_scan`` from the same u and h0."""
    rng = np.random.default_rng(T)
    C = 48
    u = rng.standard_normal((3, T, C)).astype(np.float32)
    h0 = rng.standard_normal((3, C)).astype(np.float32)
    lam, gaw, gab, giw, gib = (rng.standard_normal(C).astype(np.float32)
                               for _ in range(5))
    jy, jh = jrglru._rglru_scan(*map(jnp.asarray,
                                     (u, h0, lam, gaw, gab, giw, gib)))
    uf = _t(u)
    r = torch.sigmoid(uf * _t(gaw) + _t(gab))
    i = torch.sigmoid(uf * _t(giw) + _t(gib))
    log_a = -8.0 * torch.nn.functional.softplus(_t(lam)) * r
    g = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * uf)
    _lib.reset_launches()
    for y, hT in (rops.rglru_scan_from(torch.exp(log_a), g, _t(h0)),
                  rref.rglru_scan_ref(torch.exp(log_a), g, _t(h0))):
        _close(y, jy)
        _close(hT, jh)
    assert _lib.LAUNCHES["rglru_scan_from"] == 0


# ---------------------------------------------------------------------------
# K2 and K4 at hd 256 with a window (plain versions vs Pallas interpret)
# ---------------------------------------------------------------------------

HD256 = dict(H=16, KV=1, HD=256)


@pytest.mark.parametrize("window", [None, 20])
def test_decode_attention_hd256_matches_jax(window):
    """RecurrentGemma's local attention shape (16 heads of 256 on one kv
    head) at page 16 over contexts past the window: the port's op (its
    plain version on the CPU) with and without the LSE against the Pallas
    kernel in interpret mode."""
    from repro.kernels.paged_attention import kernel as jpk
    from repro_torch.kernels.paged_attention import ops as pops
    c = _case(16, MB=4, seed=2, **HD256)
    ctx = np.array([0, 21, 4 * 16], np.int32)
    args = (c["q1"], c["kp"], c["vp"], c["bt"], ctx)
    ker_o, ker_l = jpk.paged_attention_kernel(
        *map(jnp.asarray, args), window=window, return_lse=True,
        interpret=True)
    got_o, got_l = pops.paged_attention_with_lse(*map(_t, args),
                                                 window=window)
    _close(pops.paged_attention(*map(_t, args), window=window), ker_o)
    _close(got_o, ker_o)
    _close(got_l, ker_l)


@pytest.mark.parametrize("window,prior_only", [(None, False), (20, False),
                                               (None, True)])
def test_prefill_sweep_hd256_matches_jax(window, prior_only):
    """K4's plain version at hd 256 over prior pages (priors 0, 13 and
    past the window) against the Pallas kernel in interpret mode."""
    from repro_torch.kernels.flash_prefill import ops as fops
    c = _case(16, MB=4, T=8, seed=3, **HD256)
    prior = np.array([0, 13, 4 * 16 - 8], np.int32)
    args = (c["qT"], c["kp"], c["vp"], c["bt"], prior)
    got = fops.paged_prefill_sweep_with_lse(*map(_t, args), window=window,
                                            prior_only=prior_only)
    ker = _jax_sweep(c, c["qT"], prior, window=window,
                     prior_only=prior_only)
    for g, k in zip(got, ker):
        _close(g, k)


# ---------------------------------------------------------------------------
# the layers' serving modes
# ---------------------------------------------------------------------------

def _layer_modes(jfn, tfn, jcfg, cfg, jlayer, tlayer, state, x, splits):
    """Prefill chunks of ``splits`` then one decode step through the JAX
    layer (its state threaded) and the port's (its state updated in
    place): outputs and states equal."""
    jstate = tuple(jnp.asarray(s.numpy()) for s in state)
    pos = 0
    for T in splits + (1,):
        mode = "decode" if T == 1 else "prefill"
        xi = x[:, pos:pos + T]
        want, jstate = jfn(jcfg, jlayer, jnp.asarray(xi), JSINGLE, jstate,
                           mode=mode)
        got, back = tfn(cfg, tlayer, torch.from_numpy(xi), SINGLE, state,
                        mode=mode)
        assert back is state
        _close(got, want, **TOL)
        for s, w in zip(state, jstate):
            _close(s, w, **TOL)
        pos += T


@pytest.mark.parametrize("split", list(SPLITS))
def test_mamba2_layer_serving_modes_match_jax(zoo, split):
    jm, jp, tm, tp = zoo("mamba2-2.7b")
    x = np.random.default_rng(5).standard_normal(
        (B, PROMPT + 1, tm.cfg.d_model)).astype(np.float32)
    state = tm.recurrent_state(("mamba", "none"), ctx=SINGLE, batch=B)
    _layer_modes(jmamba.mamba2_layer, mamba2.mamba2_layer, jm.cfg, tm.cfg,
                 jax.tree.map(lambda a: a[0], jp["groups"][0][0]["mixer"]),
                 {k: v[0] for k, v in tp["groups"][0][0]["mixer"].items()},
                 state, x, SPLITS[split])


@pytest.mark.parametrize("split", list(SPLITS))
def test_rglru_block_serving_modes_match_jax(zoo, split):
    jm, jp, tm, tp = zoo("recurrentgemma-9b")
    x = np.random.default_rng(6).standard_normal(
        (B, PROMPT + 1, tm.cfg.d_model)).astype(np.float32)
    state = tm.recurrent_state(("rglru", "gelu_mlp"), ctx=SINGLE, batch=B)
    _layer_modes(jrglru.rglru_block, rglru.rglru_block, jm.cfg, tm.cfg,
                 jax.tree.map(lambda a: a[0], jp["groups"][0][0]["mixer"]),
                 {k: v[0] for k, v in tp["groups"][0][0]["mixer"].items()},
                 state, x, SPLITS[split])


@pytest.mark.parametrize("merge", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_rows_at_the_tp_width(zoo, arch, merge):
    """``fresh_states``' recurrent rows have the JAX package's
    ``layer_state`` shapes and dtypes at the mode's TP width (the JAX
    leaves without their sharded group axes); the local-attention layer
    keeps its flat pool pair."""
    jm, _, tm, _ = zoo(arch)
    plan = ParallelPlan(1, 2, 4)
    mode = FlyingMode(plan, merge)
    geom = PoolGeometry(tm.cfg, plan, num_blocks=8, block_base=4)
    states = fresh_states(tm, mode, geom, batch=3)
    jctx = jax_serving_ctx(merge, 1, 2)
    for (kind_seq, n), group in zip(tm.plan, states):
        for kind, st in zip(kind_seq, group):
            if tm.pools_of(kind) == 0:
                want = jm.layer_state(kind, ctx=jctx, batch=3, num_blocks=8,
                                      page=4, make=jax.ShapeDtypeStruct)
                assert [(tuple(t.shape), t.dtype) for t in st["mixer"]] == [
                    ((n,) + tuple(s.shape),
                     torch.float32 if s.dtype == jnp.float32 else tm.dtype)
                    for s in want["mixer"]]
            else:
                assert [tuple(t.shape) for t in st["mixer"]] == \
                    [(n,) + tuple(geom.flat_shape())] * 2


# ---------------------------------------------------------------------------
# whole steps against the JAX package's step
# ---------------------------------------------------------------------------

def _jax_states(jm, jgeom):
    """Zeroed state leaves [n, 1, 1, *layer state] as the JAX step takes
    them at ParallelPlan(1, 1, 1) (check_serve_consistency's layout)."""
    ctx = jax_serving_ctx(1, 1, 1)
    groups = []
    for kind_seq, n in jm.plan:
        per = []
        for kind in kind_seq:
            st = dict(jm.layer_state(kind, ctx=ctx, batch=B,
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


@pytest.mark.parametrize("split", list(SPLITS))
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax_step(zoo, arch, split):
    """Prefill chunks then 3 decode steps of 2 requests through both
    packages' ``build_serve_step`` (the JAX package's with its chunked
    prefill backend, which attends over the prior pages): logits within
    TOL, greedy tokens identical, the recurrent rows equal to the JAX
    step's after every step, every state leaf written in place."""
    jm, jp, tm, tp = zoo(arch)
    cfg = tm.cfg
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size,
                        (B, PROMPT + DECODES)).astype(np.int32)
    jplan, plan = JaxPlan(1, 1, 1), ParallelPlan(1, 1, 1)
    jmode, mode = JaxMode(jplan, 1), FlyingMode(plan, 1)
    jgeom = JaxGeometry(jm.cfg, jplan, num_blocks=64, block_base=4)
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    adaptor = JaxAdaptor(jgeom)
    adaptor.switch_mode(1)
    jst = _jax_states(jm, jgeom)
    states = fresh_states(tm, mode, geom, batch=B)
    ptrs = [t.data_ptr() for g in states for st in g for t in st["mixer"]]
    jpre = jax.jit(jax_serve_step(jm, jmode, jgeom, phase="prefill",
                                  chunked=True)[0])
    jdec = jax.jit(jax_serve_step(jm, jmode, jgeom, phase="decode")[0])
    prefill, _ = build_serve_step(tm, mode, geom, phase="prefill")
    decode, _ = build_serve_step(tm, mode, geom, phase="decode")
    mb = 32

    def run(jfn, fn, batch):
        nonlocal jst
        want, jst = jfn(jp, jst, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
        got, back = fn(tp, states, {k: torch.from_numpy(
            np.ascontiguousarray(v)) for k, v in batch.items()})
        assert back is states
        want = np.asarray(want)
        _close(got, want, **TOL)
        assert np.array_equal(got.numpy().argmax(-1), want.argmax(-1))
        for (kind_seq, _), g, jg in zip(tm.plan, states, jst):
            for kind, st, jst_k in zip(kind_seq, g, jg):
                if tm.pools_of(kind) == 0:
                    for t, w in zip(st["mixer"], jst_k["mixer"]):
                        _close(t, np.asarray(w)[:, 0, 0], **TOL)
    pos = 0
    for T in SPLITS[split]:
        slots = np.stack([adaptor.append_slots(f"r{b}", T)
                          for b in range(B)]).astype(np.int32)
        bt = np.stack([adaptor.block_table(f"r{b}", mb)
                       for b in range(B)]).astype(np.int32)
        run(jpre, prefill, dict(
            tokens=toks[:, pos:pos + T],
            positions=np.broadcast_to(np.arange(pos, pos + T)[None],
                                      (B, T)).astype(np.int32),
            slots=slots, block_table=bt,
            prior_len=np.full((B,), pos, np.int32)))
        pos += T
    for _ in range(DECODES):
        slots = np.array([adaptor.append_slots(f"r{b}", 1)[0]
                          for b in range(B)], np.int32)
        bt = np.stack([adaptor.block_table(f"r{b}", mb)
                       for b in range(B)]).astype(np.int32)
        run(jdec, decode, dict(
            tokens=toks[:, pos:pos + 1],
            positions=np.full((B, 1), pos, np.int32), slots=slots,
            block_table=bt, context_len=np.full((B,), pos + 1, np.int32)))
        pos += 1
    assert ptrs == [t.data_ptr() for g in states for st in g
                    for t in st["mixer"]]


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_steps_refuse_mixed_live_and_striped(zoo, arch):
    """No reference run covers a recurrent model in a mixed, live or
    striped step; the prefill and decode steps build. The striped
    decode step builds for the dry run's count on meta tensors and
    refuses to run on CPU tensors."""
    _, _, tm, _ = zoo(arch)
    plan = ParallelPlan(1, 2, 4)
    mode = FlyingMode(plan, 2)
    geom = PoolGeometry(tm.cfg, plan, num_blocks=16, block_base=4)
    for phase in ("prefill", "decode"):
        build_serve_step(tm, mode, geom, phase=phase)
    with pytest.raises(ValueError, match="recurrent rows"):
        build_serve_step(tm, mode, geom, phase="mixed")
    with pytest.raises(ValueError, match="recurrent rows"):
        build_serve_step(tm, mode, geom, phase="decode", live=(2,))
    striped = PoolGeometry(tm.cfg, plan, num_blocks=16, block_base=4,
                           layout="striped")
    with pytest.raises(ValueError, match="recurrent rows"):
        build_serve_step(tm, mode, striped, phase="prefill")
    step, _ = build_serve_step(tm, mode, striped, phase="decode")
    with pytest.raises(ValueError, match="meta tensors only"):
        step(None, None, {"tokens": torch.zeros((1, 1), dtype=torch.int32)})


def test_layers_refuse_serving_without_state(zoo):
    """A prefill or decode call needs the layer's recurrent rows; train
    mode takes none."""
    _, _, tm, tp = zoo("mamba2-2.7b")
    layer = {k: v[0] for k, v in tp["groups"][0][0]["mixer"].items()}
    x = torch.zeros((1, 2, tm.cfg.d_model))
    state = tm.recurrent_state(("mamba", "none"), ctx=SINGLE, batch=1)
    for mode, st in (("prefill", None), ("decode", None), ("train", state)):
        with pytest.raises(ValueError):
            mamba2.mamba2_layer(tm.cfg, layer, x, SINGLE, st, mode=mode)
