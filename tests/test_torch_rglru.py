"""The port's RecurrentGemma slice against the JAX package's, on the CPU.

Inputs come from numpy with a seed, in fp32, and go through both
packages. The plain RG-LRU recurrence (``kernels/rglru_scan``, what K7
runs on the card) is held against the JAX package's ``rglru_scan_ref``
and its Pallas kernel in interpret mode at ``tests/test_kernels.py``'s
shapes, the ragged (1, 100, 96) among them, with ``a`` drawn as that
test draws it and within 1e-3 of 1 (so the carry over all of T
matters): rtol = atol = 2e-5, as the JAX test holds the kernel (the
Pallas scan multiplies in another order). Its gradients, through the
autograd op and the plain backward alike, are held against ``jax.grad``
of ``rglru_scan_ref`` at rtol 2e-5 and an atol of 2e-5 times the
gradient's largest entry (da sums up to T products). The RG-LRU block
in train mode and its gradients are held against the JAX block on the
same weights (the gates and decay drawn at random, not at their
constant init) at rtol 1e-4 and an atol of 1e-4 times each output's
largest entry; in bf16 against the fp32 block no less closely than the
JAX bf16 block. The plain dense attention (K5's plain version) at head
dim 256, multi-query, with a window shorter than T, is held against the
JAX package's ``flash_prefill`` (its Pallas kernel in interpret mode) at
atol 1e-5 and its gradients against ``jax.vjp`` at atol 1e-4, as
``tests/test_torch_kernels.py`` holds them at hd 64 and 128. The
parameter tree of the 4-layer test config (one super-layer of two RG-LRU
layers and a local-attention layer, then one more RG-LRU layer) converts
and checkpoints both ways in the JAX layout, fp32 leaves in a bf16 model
included; and every serving entry point refuses the hybrid config.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.views import SINGLE as JSINGLE
from repro.kernels.flash_prefill.ops import flash_prefill as jax_flash
from repro.kernels.flash_prefill.ref import flash_prefill_ref as jax_fref
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref
from repro.models import rglru as jrglru
from repro.models.model import build_model as jax_build
from repro.training import checkpoint as jax_ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.views import SINGLE
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_prefill import ops as fops
from repro_torch.kernels.rglru_scan import ops as rops
from repro_torch.kernels.rglru_scan import ref as rref
from repro_torch.models import rglru
from repro_torch.models.common import gelu
from repro_torch.models.model import build_model
from repro_torch.models.transformer import stack_plan
from repro_torch.training import checkpoint as ckpt

SCAN_TOL = dict(rtol=2e-5, atol=2e-5)
# test_kernels.py::test_rglru_scan's shapes and Pallas tiles
SHAPES = [(2, 64, 128, 32, 64), (1, 100, 96, 32, 32), (2, 256, 256, 128, 128)]
ARCH = "recurrentgemma-9b"


def _draw(B, T, C, near_one: bool, seed=0):
    """a as test_rglru_scan draws it (sigmoid of a normal) or within 1e-3
    of 1; g = 0.5 N(0, 1)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((B, T, C)).astype(np.float32)
    a = 1.0 - 1e-3 * rng.random((B, T, C)) if near_one \
        else 1.0 / (1.0 + np.exp(-z))
    g = 0.5 * rng.standard_normal((B, T, C))
    return a.astype(np.float32), g.astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _test_config(jax_side: bool = False):
    """The 4-layer test config: one whole super-layer (rglru, rglru,
    local attention) plus one rglru layer, hd 64, H 4, KV 1, window 64."""
    base = (jax_config if jax_side else get_config)(ARCH).reduced()
    return dataclasses.replace(base, num_layers=4)


# ---------------------------------------------------------------------------
# the recurrence (K7's plain version)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("near_one", [False, True])
@pytest.mark.parametrize("B,T,C,bt,bc", SHAPES)
def test_plain_scan_matches_jax(B, T, C, bt, bc, near_one):
    a, g = _draw(B, T, C, near_one)
    y, hT = rops.rglru_scan(_t(a), _t(g))
    assert y.shape == (B, T, C) and hT.shape == (B, C)
    assert y.dtype == hT.dtype == torch.float32
    zero = jnp.zeros((B, C), jnp.float32)
    for wy, wh in (jax_rglru_ref(jnp.asarray(a), jnp.asarray(g), zero),
                   jax_rglru_scan(jnp.asarray(a), jnp.asarray(g), blk_t=bt,
                                  blk_c=bc)):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **SCAN_TOL)
        np.testing.assert_allclose(hT.numpy(), np.asarray(wh), **SCAN_TOL)
    np.testing.assert_array_equal(hT.numpy(), y[:, -1].numpy())


@pytest.mark.parametrize("near_one", [False, True])
@pytest.mark.parametrize("B,T,C,bt,bc", SHAPES)
def test_plain_backward_matches_jax(B, T, C, bt, bc, near_one):
    """Gradients in a and g of a random readout of y."""
    a, g = _draw(B, T, C, near_one, seed=1)
    w = np.random.default_rng(2).standard_normal((B, T, C)).astype(
        np.float32)
    zero = jnp.zeros((B, C), jnp.float32)
    wants = jax.grad(
        lambda a_, g_: jnp.sum(jax_rglru_ref(a_, g_, zero)[0] * w),
        argnums=(0, 1))(jnp.asarray(a), jnp.asarray(g))
    leaves = [_t(x).requires_grad_(True) for x in (a, g)]
    y, _ = rops.rglru_scan(*leaves)
    gots = torch.autograd.grad((y * _t(w)).sum(), leaves)
    direct = rref.rglru_scan_bwd_ref(_t(a), y.detach(), _t(w))
    for name, got, d, want in zip("ag", gots, direct, wants):
        want = np.asarray(want)
        assert got.shape == (B, T, C) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5,
                                   atol=2e-5 * np.abs(want).max(),
                                   err_msg=f"d{name}")
        assert torch.equal(got, d)


def test_plain_scan_keeps_bf16_inputs_in_fp32():
    """bf16 a and g are upcast (as the TPU kernel upcasts them); the
    backward returns gradients in their dtype."""
    a, g = _draw(2, 40, 24, False, seed=3)
    ab, gb = _t(a).to(torch.bfloat16), _t(g).to(torch.bfloat16)
    y, hT = rops.rglru_scan(ab, gb)
    wy, wh = rref.rglru_scan_ref(ab.float(), gb.float())
    assert torch.equal(y, wy) and torch.equal(hT, wh)
    leaves = [ab.clone().requires_grad_(True), gb.clone().requires_grad_(True)]
    y, _ = rops.rglru_scan(*leaves)
    da, dg = torch.autograd.grad(y.sum(), leaves)
    assert da.dtype == dg.dtype == torch.bfloat16


def test_op_dispatch_and_final_state_gradient():
    """CPU tensors launch no kernel; any other device raises; the final
    state has no gradient (the training path discards it); a and g of
    two shapes or dtypes are refused."""
    a, g = (_t(x) for x in _draw(1, 30, 16, False))
    _lib.reset_launches()
    leaves = [a.clone().requires_grad_(True), g.clone().requires_grad_(True)]
    y, hT = rops.rglru_scan(*leaves)
    torch.autograd.grad(y.sum(), leaves)
    assert _lib.LAUNCHES["rglru_scan"] == _lib.LAUNCHES["rglru_scan_bwd"] \
        == 0
    with pytest.raises(NotImplementedError):
        torch.autograd.grad(hT.sum(), leaves)
    with pytest.raises(ValueError):
        rops.rglru_scan(a.to("meta"), g.to("meta"))
    with pytest.raises(ValueError):
        rops.rglru_scan(a, g[:, :-1])
    with pytest.raises(ValueError):
        rops.rglru_scan(a, g.double())


def test_gelu_is_jax_tanh_gelu():
    x = np.concatenate([np.linspace(-12, 12, 481),
                        [0.0, 3.0, -3.0, 40.0]]).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    got = gelu(xt)
    (gr,) = torch.autograd.grad(got.sum(), xt)
    want = jax.nn.gelu(jnp.asarray(x), approximate=True)
    want_g = jax.grad(lambda v: jnp.sum(jax.nn.gelu(v, approximate=True)))(
        jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    # PyTorch differentiates the formula by its own closed form, JAX by
    # autodiff of the expression: they round differently, by up to 3e-6
    np.testing.assert_allclose(gr.numpy(), np.asarray(want_g), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# K5's plain version at RecurrentGemma's attention shape
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,T,H,KV,window", [(1, 80, 4, 1, 24),
                                             (2, 64, 2, 1, 16)])
def test_hd256_window_attention_matches_jax(B, T, H, KV, window):
    """hd 256, multi-query, a window shorter than T: the plain forward
    against the Pallas kernel in interpret mode and the jnp reference,
    its gradients against ``jax.vjp`` of the reference."""
    rng = np.random.default_rng(5)
    q, do = (rng.standard_normal((B, T, H, 256)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, T, KV, 256)).astype(np.float32)
            for _ in range(2))
    ins = [_t(x).requires_grad_(True) for x in (q, k, v)]
    got = fops.flash_prefill(*ins, window=window)
    js = tuple(map(jnp.asarray, (q, k, v)))
    for want in (jax_flash(*js, window=window, blk=32),
                 jax_fref(*js, window=window)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
    grads = torch.autograd.grad(got, ins, _t(do))
    _, vjp = jax.vjp(lambda *x: jax_fref(*x, window=window), *js)
    for g, w in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4,
                                   rtol=0.0)


# ---------------------------------------------------------------------------
# the block and the parameter tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid():
    """The 4-layer test config: the JAX model and its init(key(0))
    params, and the port's config, model and converted params."""
    jm = jax_build(_test_config(jax_side=True), jnp.float32)
    jp = jm.init(jax.random.key(0))
    cfg = _test_config()
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    return jm, jp, cfg, build_model(cfg, torch.float32, "cpu"), tp


def _random_gates(layer, seed=7):
    """The first layer's block with Lambda and the gates drawn at random
    (their init makes the gates constant), numpy leaves."""
    rng = np.random.default_rng(seed)
    out = {k: np.asarray(v, np.float32) for k, v in layer.items()}
    w = out["lam"].shape[0]
    out["lam"] = rng.uniform(-1.0, 2.0, w).astype(np.float32)
    for n in ("gate_a_w", "gate_i_w", "gate_a_b", "gate_i_b"):
        out[n] = rng.standard_normal(w).astype(np.float32)
    out["conv_b"] = 0.1 * rng.standard_normal(w).astype(np.float32)
    return out


def _block_inputs(hybrid, T, seed=6):
    jm, jp, cfg, _, _ = hybrid
    layer = _random_gates(jax.tree.map(
        lambda a: np.asarray(a[0]), jp["groups"][0][0]["mixer"]))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((2, T, cfg.d_model)).astype(np.float32)
    return layer, x, dy


def _jax_block_grads(jcfg, layer, x, dy):
    def f(x_, p_):
        return jrglru.rglru_block(jcfg, p_, x_, JSINGLE, None,
                                  mode="train")[0]
    y, vjp = jax.vjp(f, x, layer)
    dx, dp = vjp(dy.astype(y.dtype))
    return y, dx, dp


@pytest.mark.parametrize("T", [96, 37])
def test_rglru_block_matches_jax(hybrid, T):
    jm, _, cfg, _, _ = hybrid
    layer, x, dy = _block_inputs(hybrid, T)
    want, wdx, wdp = _jax_block_grads(
        jm.cfg, jax.tree.map(jnp.asarray, layer), jnp.asarray(x),
        jnp.asarray(dy))
    tl = {k: _t(v).requires_grad_(True) for k, v in layer.items()}
    tx = _t(x).requires_grad_(True)
    got, st = rglru.rglru_block(cfg, tl, tx, SINGLE, None, mode="train")
    assert st is None
    names = sorted(tl)
    grads = torch.autograd.grad(got, [tx] + [tl[n] for n in names], _t(dy))
    pairs = [("y", got, want), ("dx", grads[0], wdx)] + [
        (f"d{n}", g, wdp[n]) for n, g in zip(names, grads[1:])]
    for name, g, w in pairs:
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)
    for mode in ("prefill", "decode"):
        with pytest.raises(NotImplementedError):
            rglru.rglru_block(cfg, tl, tx, SINGLE, None, mode=mode)


@pytest.mark.parametrize("T", [96, 37])
def test_rglru_block_in_bf16_is_as_close_to_fp32_as_jax(hybrid, T):
    """The block with bf16 parameters and input (Lambda and the gates
    stay fp32): its output and its gradients for x and every leaf, held
    against the fp32 block on the same values. The yardstick is the JAX
    bf16 block's own error: the port's may exceed it by at most half."""
    jm, _, cfg, _, _ = hybrid
    layer, x, dy = _block_inputs(hybrid, T, seed=8)
    drawn = rglru.init_rglru(torch.Generator(), cfg, torch.bfloat16, "cpu")
    keep = {k for k, v in drawn.items() if v.dtype == torch.float32}
    assert keep == {"lam", "gate_a_w", "gate_a_b", "gate_i_w", "gate_i_b"}
    bf = jnp.bfloat16
    jl16 = {k: jnp.asarray(v, jnp.float32 if k in keep else bf)
            for k, v in layer.items()}
    # the same values in both precisions: the bf16 ones, upcast
    jl32 = jax.tree.map(lambda a: a.astype(jnp.float32), jl16)
    x16, dy16 = jnp.asarray(x, bf), jnp.asarray(dy, bf)
    want = _jax_block_grads(jm.cfg, jl32, x16.astype(jnp.float32),
                            dy16.astype(jnp.float32))
    ref = _jax_block_grads(jm.cfg, jl16, x16, dy16)
    names = sorted(layer)

    def flat(out):
        y, dx, dp = out
        return [np.asarray(a.astype(jnp.float32))
                for a in [y, dx] + [dp[n] for n in names]]
    want, ref = flat(want), flat(ref)
    tl = {k: torch.from_numpy(np.array(v.astype(jnp.float32))).to(
        torch.float32 if k in keep else torch.bfloat16).requires_grad_(True)
        for k, v in jl16.items()}
    tx = torch.from_numpy(np.array(x16.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    y, _ = rglru.rglru_block(cfg, tl, tx, SINGLE, None, mode="train")
    grads = torch.autograd.grad(
        y, [tx] + [tl[n] for n in names],
        torch.from_numpy(np.array(dy16.astype(jnp.float32))).to(y.dtype))
    got = [t.detach().float().numpy() for t in (y,) + grads]
    for name, g, r, w in zip(["y", "dx"] + names, got, ref, want):
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        bar = np.linalg.norm(r - w) / np.linalg.norm(w)
        assert err <= 1.5 * bar, f"{name}: {err:.2e} vs JAX's {bar:.2e}"


def test_test_config_has_every_kind(hybrid):
    jm, _, cfg, tm, _ = hybrid
    want = [((("rglru", "gelu_mlp"), ("rglru", "gelu_mlp"),
              ("gqa_win", "gelu_mlp")), 1), ((("rglru", "gelu_mlp"),), 1)]
    assert stack_plan(cfg) == tm.plan == want
    assert (cfg.resolved_head_dim, cfg.num_heads, cfg.num_kv_heads,
            cfg.hybrid.window) == (64, 4, 1, 64)
    assert rglru.width(cfg) == jrglru.width(jm.cfg) == cfg.d_model
    # the full config's: 12 super-layers and a remainder of two rglru
    full = stack_plan(get_config(ARCH))
    assert [n for _, n in full] == [12, 1] and len(full[1][0]) == 2


def test_seeded_init_keeps_the_jax_tree_and_dtypes(hybrid):
    """The port's own bf16 init: the JAX bf16 tree's shapes and dtypes
    leaf for leaf (fp32 Lambda and gates), its scales and constants."""
    jm, jp, cfg, _, _ = hybrid
    j16 = jax.eval_shape(jax_build(_test_config(jax_side=True),
                                   jnp.bfloat16).init, jax.random.key(0))
    ours = build_model(cfg, torch.bfloat16, "cpu").init(
        torch.Generator().manual_seed(0))
    got = [(tuple(t.shape), str(t.dtype).split(".")[-1])
           for t in ckpt.tree_leaves(ours)]
    want = [(tuple(a.shape), str(a.dtype)) for a in jax.tree.leaves(j16)]
    assert got == want
    m = ours["groups"][0][0]["mixer"]
    assert torch.equal(m["lam"], torch.full_like(m["lam"], 0.7))
    assert torch.equal(m["gate_a_b"], torch.full_like(m["gate_a_b"], 2.0))
    assert float(m["w_x"].float().abs().max()) <= cfg.d_model ** -0.5
    assert abs(float(m["conv_w"].float().std()) - 0.5) < 0.05
    assert set(ours["groups"][0][2]) == {"norm1", "attn", "norm2", "ffn"}
    assert set(ours["groups"][0][2]["ffn"]) == {"w_up", "w_down"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_tree_converts_and_checkpoints_both_ways(hybrid, tmp_path,
                                                        dtype):
    """In a bf16 model the JAX package keeps Lambda and the gates in
    fp32; ``params_from_numpy(dtype=None)`` and the checkpoints carry
    every leaf over in its own dtype, bit for bit."""
    _, _, cfg, tm, _ = hybrid
    jp = jax_build(_test_config(jax_side=True),
                   getattr(jnp, dtype)).init(jax.random.key(0))
    port = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    for a, b in zip(ckpt.tree_leaves(port), jax.tree.leaves(jp)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))
    assert len(ckpt.tree_leaves(port)) == len(jax.tree.leaves(jp))
    bad = jax.tree.map(np.asarray, jp)
    bad["groups"][0][0]["mixer"]["lam"] = \
        bad["groups"][0][0]["mixer"]["lam"][..., :3]
    with pytest.raises(ValueError):
        params_from_numpy(cfg, bad)
    path = os.path.join(tmp_path, "jax_ck")
    jax_ckpt.save(path, jp, step=3)
    like = build_model(cfg, getattr(torch, dtype), "cpu").init(
        torch.Generator().manual_seed(1))
    got, step = ckpt.restore(path, like)
    assert step == 3
    for a, b in zip(ckpt.tree_leaves(got), ckpt.tree_leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    path2 = os.path.join(tmp_path, "port_ck")
    ckpt.save(path2, got, step=4)
    back, step2 = jax_ckpt.restore(path2, jp)
    assert step2 == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        # the JAX package restores bf16 leaves as raw 2-byte words
        assert np.asarray(a).itemsize == np.asarray(b).itemsize
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


def test_serving_refuses_the_hybrid_stack(hybrid):
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.launch.serve import ServeConfig, build_stack
    _, _, cfg, tm, tp = hybrid
    for kind in (("rglru", "gelu_mlp"), ("gqa_win", "gelu_mlp")):
        with pytest.raises(NotImplementedError):
            tm.layer_state(kind, ctx=SINGLE, num_blocks=4, page=4)
    with pytest.raises(NotImplementedError):
        tm.check_serving()
    with pytest.raises(NotImplementedError):
        tm.init_states(ctx=SINGLE, num_blocks=4, page=4)
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    with pytest.raises(NotImplementedError):
        FlyingEngine(tm, plan, PoolGeometry(cfg, plan, num_blocks=16,
                                            block_base=4), tp,
                     device="cpu")
    with pytest.raises(NotImplementedError):
        build_stack(ServeConfig(arch=ARCH, reduced=True, device="cpu",
                                dtype="float32"))
