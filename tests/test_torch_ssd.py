"""The port's Mamba-2 slice against the JAX package's, on the CPU.

Inputs come from numpy with a seed, in fp32, and go through both
packages. The plain SSD scan (``kernels/ssd_scan``: the chunked form
forward, autograd through it backward) is held against the Pallas
kernel in interpret mode, the model's ``ssd_chunked`` and the sequential
oracle at ``tests/test_kernels.py``'s shapes plus a ragged T: rtol =
atol = 1e-4, as the JAX tests hold the scan (the products sum in another
order). Its gradients are held against ``jax.grad`` of ``ssd_chunked`` at
rtol 1e-4 and an atol of 1e-4 times the gradient's largest entry: dA and
dt sum thousands of terms that cancel, so their fp32 error scales with
the terms, not the result (both packages lie within 1e-3 of a float64
oracle on dA entries of 1.5 beside entries of 90). The
Mamba-2 layer in train mode is held against the JAX layer on the
reduced mamba2-2.7b weights at the same tolerance, and in bf16 against
the fp32 layer no less closely than the JAX layer; the parameter tree
converts and checkpoints both ways in the JAX layout; and the engine and
the launcher serve an SSM config but refuse a mixed step and a prefix
cache for it.
"""
import dataclasses
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.views import SINGLE as JSINGLE
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jax_ssd_ref
from repro.models import mamba2 as jmamba
from repro.models.model import build_model as jax_build
from repro.training import checkpoint as jax_ckpt
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.views import SINGLE
from repro_torch.kernels import _lib
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.models import mamba2
from repro_torch.models.common import softplus
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt

TOL = dict(rtol=1e-4, atol=1e-4)
SHAPES = [(2, 64, 4, 32, 16, 32), (1, 96, 2, 64, 128, 32),
          (2, 128, 8, 64, 64, 64), (2, 100, 3, 32, 32, 32)]   # last: ragged


def _inputs(Bs, T, H, hd, S, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((Bs, T, H, hd)).astype(np.float32)
    dt = np.array(jax.nn.softplus(
        rng.standard_normal((Bs, T, H)).astype(np.float32)))
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    B = (rng.standard_normal((Bs, T, S)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((Bs, T, S)) * 0.5).astype(np.float32)
    return x, dt, A, B, C


def _jax_chunked(x, dt, A, B, C, chunk):
    """The JAX model's chunked form from h0 = 0, T padded with zeros up
    to a multiple of min(chunk, T) as the model pads it."""
    Bs, T, H, hd = x.shape
    ch = min(chunk, T)
    pad = (-T) % ch
    x = jnp.pad(x, ((0, 0), (0, pad), (0, 0), (0, 0)))
    dt, B, C = (jnp.pad(a, ((0, 0), (0, pad), (0, 0))) for a in (dt, B, C))
    y, hT = jmamba.ssd_chunked(x, dt, A, B, C,
                               jnp.zeros((Bs, H, hd, B.shape[-1])), ch)
    return y[:, :T], hT


@pytest.mark.parametrize("Bs,T,H,hd,S,chunk", SHAPES)
def test_plain_forward_matches_jax(Bs, T, H, hd, S, chunk):
    ins = _inputs(Bs, T, H, hd, S)
    y, hT = sops.ssd_scan(*map(torch.from_numpy, ins), chunk=chunk)
    h0 = np.zeros((Bs, H, hd, S), np.float32)
    wants = [jax_ssd_scan(*map(jnp.asarray, ins), chunk=chunk),
             _jax_chunked(*map(jnp.asarray, ins), chunk),
             jax_ssd_ref(*map(jnp.asarray, ins), jnp.asarray(h0)),
             sref.ssd_scan_ref(*map(torch.from_numpy, ins),
                               torch.from_numpy(h0))]
    assert y.shape == (Bs, T, H, hd) and hT.shape == (Bs, H, hd, S)
    assert y.dtype == hT.dtype == torch.float32
    for wy, wh in wants:
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(hT.numpy(), np.asarray(wh), **TOL)


@pytest.mark.parametrize("Bs,T,H,hd,S,chunk", SHAPES)
def test_plain_backward_matches_jax(Bs, T, H, hd, S, chunk):
    """Gradients in x, dt, A, B, C of a random readout of y."""
    ins = _inputs(Bs, T, H, hd, S, seed=1)
    w = np.random.default_rng(2).standard_normal(
        (Bs, T, H, hd)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(_jax_chunked(*a, chunk)[0] * w)
    wants = jax.grad(jloss, argnums=tuple(range(5)))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in ins]
    y, _ = sops.ssd_scan(*leaves, chunk=chunk)
    gots = torch.autograd.grad((y * torch.from_numpy(w)).sum(), leaves)
    for name, leaf, g, want in zip(("x", "dt", "A", "B", "C"), leaves,
                                   gots, wants):
        want = np.asarray(want)
        assert g.shape == leaf.shape
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("Bs,T,H,hd,S,chunk,group", [
    (2, 64, 4, 32, 32, 32, 8), (1, 96, 10, 64, 128, 32, 4),
    (2, 128, 8, 64, 32, 64, 3), (1, 256, 5, 32, 128, 128, 2),
    (2, 100, 3, 32, 32, 32, 2)])                          # last: ragged
def test_chunk_parallel_backward_algebra(Bs, T, H, hd, S, chunk, group):
    """``ssd_scan_bwd_chunks_ref``, the bf16 backward kernels' algebra
    (the reverse carry, G = C B^T shared by a head group, dloga in its
    four pair parts), against autograd through the chunked form and
    against ``jax.grad`` of the JAX model's chunked form, on inputs
    padded as the op pads them; the tolerance of the gradients above."""
    ins = _inputs(Bs, T, H, hd, S, seed=3)
    w = np.random.default_rng(4).standard_normal(
        (Bs, T, H, hd)).astype(np.float32)

    def jloss(*a):
        return jnp.sum(_jax_chunked(*a, chunk)[0] * w)
    jax_grads = jax.grad(jloss, argnums=tuple(range(5)))(
        *map(jnp.asarray, ins))
    ch = min(chunk, T)
    pad = (-T) % ch

    def padded(a):
        a = torch.from_numpy(a)
        return torch.nn.functional.pad(a, (0, 0) * (a.dim() - 2) + (0, pad)) \
            if a.dim() > 1 else a
    x, dt, A, B, C = map(padded, ins)
    dy = padded(w)
    got = sref.ssd_scan_bwd_chunks_ref(x, dt, A, B, C, dy, chunk=ch,
                                       group=group)
    want = sref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk=ch)
    for name, g, wt, jg, src in zip(("x", "dt", "A", "B", "C"), got, want,
                                    jax_grads, (x, dt, A, B, C)):
        assert g.shape == src.shape and g.dtype == src.dtype
        np.testing.assert_allclose(g.numpy(), wt.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(wt.abs().max()),
                                   err_msg=f"d{name} vs autograd")
        g = g[:, :T] if g.dim() > 1 else g
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max(),
                                   err_msg=f"d{name} vs jax.grad")


@pytest.mark.parametrize("Bs,T,H,hd,S,chunk,group", [
    (2, 64, 4, 32, 32, 32, 8), (1, 96, 10, 64, 128, 32, 4),
    (2, 128, 7, 64, 32, 64, 3), (1, 256, 5, 32, 128, 128, 2),
    (2, 96, 6, 32, 32, 16, 4)])
def test_chunk_parallel_forward_algebra(Bs, T, H, hd, S, chunk, group):
    """``ssd_scan_fwd_chunks_ref``, the bf16 forward kernels' algebra
    (each chunk's own state written a slot ahead, the forward pass in
    place, G = C B^T once per head group, ragged groups among them),
    against JAX's sequential ``ssd_scan_ref`` and the Pallas kernel in
    interpret mode: y and hT of the whole sequence, and the state before
    each chunk as their final state after the chunks before it; the
    tolerance of ``test_plain_forward_matches_jax``."""
    ins = _inputs(Bs, T, H, hd, S, seed=8)
    y, hT, states = sref.ssd_scan_fwd_chunks_ref(
        *map(torch.from_numpy, ins), chunk=chunk, group=group)
    nc = T // chunk
    assert y.shape == (Bs, T, H, hd) and hT.shape == (Bs, H, hd, S)
    assert states.shape == (Bs, H, nc, hd, S)
    assert torch.equal(states[:, :, 0], torch.zeros(Bs, H, hd, S))

    def jax_runs(n):
        """(y, hT) of the first n rows by the JAX oracle and the Pallas
        kernel."""
        part = [jnp.asarray(a[:, :n] if a.ndim > 1 else a) for a in ins]
        h0 = jnp.zeros((Bs, H, hd, S), jnp.float32)
        return [jax_ssd_ref(*part, h0), jax_ssd_scan(*part, chunk=chunk)]
    for wy, wh in jax_runs(T):
        np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
        np.testing.assert_allclose(hT.numpy(), np.asarray(wh), **TOL)
    for c in range(1, nc):
        for _, wh in jax_runs(c * chunk):
            np.testing.assert_allclose(states[:, :, c].numpy(),
                                       np.asarray(wh), **TOL,
                                       err_msg=f"state before chunk {c}")


def test_chunked_form_keeps_an_initial_state():
    """``ssd_chunked`` with h0 != 0 is the JAX model's (the serving
    slice will carry one)."""
    Bs, T, H, hd, S = 2, 64, 3, 32, 16
    ins = _inputs(Bs, T, H, hd, S, seed=3)
    h0 = np.random.default_rng(4).standard_normal(
        (Bs, H, hd, S)).astype(np.float32)
    y, hT = sref.ssd_chunked(*map(torch.from_numpy, ins),
                             torch.from_numpy(h0), 32)
    wy, wh = jmamba.ssd_chunked(*map(jnp.asarray, ins), jnp.asarray(h0), 32)
    np.testing.assert_allclose(y.numpy(), np.asarray(wy), **TOL)
    np.testing.assert_allclose(hT.numpy(), np.asarray(wh), **TOL)


def test_forward_states_are_the_carry():
    """The forward's per-chunk states (what the backward kernel reads)
    are the state before each chunk: zero, then the oracle's state at
    each chunk boundary."""
    Bs, T, H, hd, S, ch = 1, 96, 2, 32, 32, 32
    ins = [torch.from_numpy(a) for a in _inputs(Bs, T, H, hd, S, seed=5)]
    _, hT, states = sref.ssd_scan_fwd_ref(*ins, chunk=ch)
    assert states.shape == (Bs, H, T // ch, hd, S)
    assert torch.equal(states[:, :, 0], torch.zeros(Bs, H, hd, S))
    for c in range(1, T // ch):
        _, h = sref.ssd_scan_ref(*(t[:, :c * ch] for t in ins[:2]), ins[2],
                                 *(t[:, :c * ch] for t in ins[3:]),
                                 torch.zeros(Bs, H, hd, S))
        torch.testing.assert_close(states[:, :, c], h, **TOL)


def test_op_dispatch_and_final_state_gradient():
    """CPU tensors launch no kernel; meta tensors take the meta route
    (the dry run's: outputs of the CPU call's shapes and dtypes, no
    launch); any other device raises; the final state has no gradient
    (the training path discards it)."""
    ins = [torch.from_numpy(a) for a in _inputs(1, 40, 2, 32, 32)]
    _lib.reset_launches()
    leaves = [t.clone().requires_grad_(True) for t in ins]
    y, hT = sops.ssd_scan(*leaves, chunk=32)
    torch.autograd.grad(y.sum(), leaves)
    assert _lib.LAUNCHES["ssd_scan"] == _lib.LAUNCHES["ssd_scan_bwd"] == 0
    with pytest.raises(NotImplementedError):
        torch.autograd.grad(hT.sum(), leaves)
    on_meta = sops.ssd_scan(*(t.to("meta") for t in ins), chunk=32)
    assert [(t.device.type, t.shape, t.dtype) for t in on_meta] == \
        [("meta", t.shape, t.dtype) for t in (y, hT)]
    assert _lib.LAUNCHES["ssd_scan"] == 0
    with pytest.raises(ValueError):
        sops.route(types.SimpleNamespace(device=torch.device("xpu")))


def test_softplus_is_jax_softplus():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [0.0, 19.9, 20.0, 20.1, 88.0]]).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = softplus(xt)
    (g,) = torch.autograd.grad(got.sum(), xt)
    want_g = jax.grad(lambda a: jnp.sum(jax.nn.softplus(a)))(jnp.asarray(x))
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# the layer and the parameter tree
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mamba():
    """Reduced mamba2-2.7b: the JAX model and its init(key(0)) params, and
    the port's config, model and converted params."""
    jm = jax_build(jax_config("mamba2-2.7b").reduced(), jnp.float32)
    jp = jm.init(jax.random.key(0))
    cfg = get_config("mamba2-2.7b").reduced()
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jm, jp, cfg, build_model(cfg, torch.float32, "cpu"), tp


def test_reduced_config_is_the_jax_one(mamba):
    jm, _, cfg, _, _ = mamba
    assert cfg.ssm == cfg.ssm.__class__(d_state=32, head_dim=32, expand=2,
                                        chunk=32, conv_width=4)
    for f in ("d_state", "head_dim", "expand", "chunk", "conv_width"):
        assert getattr(cfg.ssm, f) == getattr(jm.cfg.ssm, f)
    assert (cfg.d_model, cfg.num_layers, cfg.vocab_size) == (
        jm.cfg.d_model, jm.cfg.num_layers, jm.cfg.vocab_size)
    assert mamba2.dims(cfg) == jmamba.dims(jm.cfg)


@pytest.mark.parametrize("T", [64, 40])          # 40: the padded path
def test_mamba2_layer_matches_jax(mamba, T):
    jm, jp, cfg, _, tp = mamba
    x = np.random.default_rng(6).standard_normal(
        (2, T, cfg.d_model)).astype(np.float32)
    jlayer = jax.tree.map(lambda a: a[0], jp["groups"][0][0]["mixer"])
    want, st = jmamba.mamba2_layer(jm.cfg, jlayer, jnp.asarray(x), JSINGLE,
                                   None, mode="train")
    layer = {k: v[0] for k, v in tp["groups"][0][0]["mixer"].items()}
    got, tst = mamba2.mamba2_layer(cfg, layer, torch.from_numpy(x), SINGLE,
                                   None, mode="train")
    assert st is None and tst is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for mode in ("prefill", "decode"):   # serving needs the carried rows
        with pytest.raises(ValueError):
            mamba2.mamba2_layer(cfg, layer, torch.from_numpy(x), SINGLE,
                                None, mode=mode)


@pytest.mark.parametrize("T", [64, 40])
def test_mamba2_layer_in_bf16_is_as_close_to_fp32_as_jax(T):
    """The layer with bf16 parameters and input (A_log, dt_bias and D
    stay fp32): its output and its gradients for x, A_log, dt_bias, D,
    w_dt, w_x and conv_x, held against the fp32 layer on the same
    values. bf16 alone moves them by 0.5-15% (relative L2 norm), so the
    yardstick is the JAX layer's own bf16 error: the port's may exceed it
    by at most half."""
    names = ["A_log", "dt_bias", "D", "w_dt", "w_x", "conv_x"]
    jm = jax_build(jax_config("mamba2-2.7b").reduced(), jnp.bfloat16)
    jl = jax.tree.map(lambda a: a[0],
                      jm.init(jax.random.key(0))["groups"][0][0]["mixer"])
    cfg = get_config("mamba2-2.7b").reduced()
    tl = {k: torch.from_numpy(np.asarray(v.astype(jnp.float32))).to(
        torch.bfloat16 if v.dtype == jnp.bfloat16 else torch.float32)
        for k, v in jl.items()}
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, T, cfg.d_model)),
                    jnp.bfloat16)
    dy = jnp.asarray(rng.standard_normal((2, T, cfg.d_model)),
                     jnp.bfloat16)

    def jax_layer(base):
        def f(x, sub):
            return jmamba.mamba2_layer(jm.cfg, {**base, **sub}, x, JSINGLE,
                                       None, mode="train")[0]
        return f

    @jax.jit
    def jax_grads(base, x):
        y, vjp = jax.vjp(jax_layer(base), x, {n: base[n] for n in names})
        dx, dp = vjp(dy.astype(y.dtype))
        return [a.astype(jnp.float32) for a in [y, dx] + [dp[n] for n in names]]

    def jax_out(base, x):
        return [np.asarray(a) for a in jax_grads(base, x)]
    want = jax_out(jax.tree.map(lambda a: a.astype(jnp.float32), jl),
                   x.astype(jnp.float32))
    ref = jax_out(jl, x)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    leaves = {n: tl[n].clone().requires_grad_(True) for n in names}
    y, _ = mamba2.mamba2_layer(cfg, {**tl, **leaves}, tx, SINGLE, None,
                               mode="train")
    grads = torch.autograd.grad(
        y, [tx] + [leaves[n] for n in names],
        torch.from_numpy(np.asarray(dy.astype(jnp.float32))).to(y.dtype))
    got = [t.detach().float().numpy() for t in (y,) + grads]
    for name, g, r, w in zip(["y", "dx"] + names, got, ref, want):
        err = np.linalg.norm(g - w) / np.linalg.norm(w)
        bar = np.linalg.norm(r - w) / np.linalg.norm(w)
        assert err <= 1.5 * bar, f"{name}: {err:.2e} vs JAX's {bar:.2e}"


def test_seeded_mamba_init_keeps_the_jax_scales_and_tree(mamba):
    jm, jp, cfg, tm, _ = mamba
    ours = tm.init(torch.Generator().manual_seed(0))
    assert [tuple(t.shape) for t in ckpt.tree_leaves(ours)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    p = ours["groups"][0][0]
    assert set(p) == {"norm1", "mixer"}
    m = p["mixer"]
    assert torch.equal(m["D"], torch.ones_like(m["D"]))
    torch.testing.assert_close(
        m["A_log"][0], torch.from_numpy(np.asarray(
            jp["groups"][0][0]["mixer"]["A_log"][0])), rtol=1e-6, atol=1e-6)
    assert float(m["w_z"].abs().max()) <= cfg.d_model ** -0.5
    cw = cfg.ssm.conv_width
    assert abs(float(m["conv_x"].std()) - cw ** -0.5) < 0.05


def test_mamba_tree_converts_in_jax_flatten_order(mamba, tmp_path):
    jm, jp, cfg, tm, tp = mamba
    for a, b in zip(ckpt.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(ckpt.tree_leaves(tp)) == len(jax.tree.leaves(jp))
    bad = jax.tree.map(np.asarray, jp)
    bad["groups"][0][0]["mixer"]["w_dt"] = \
        bad["groups"][0][0]["mixer"]["w_dt"][..., :3]
    with pytest.raises(ValueError):
        params_from_numpy(cfg, bad, device="cpu")
    # checkpoints both ways
    path = os.path.join(tmp_path, "jax_ck")
    jax_ckpt.save(path, jp, step=3)
    got, step = ckpt.restore(path, tm.init(torch.Generator().manual_seed(1)))
    assert step == 3
    for a, b in zip(ckpt.tree_leaves(got), ckpt.tree_leaves(tp)):
        assert torch.equal(a, b)
    path2 = os.path.join(tmp_path, "port_ck")
    ckpt.save(path2, got, step=4)
    back, step2 = jax_ckpt.restore(path2, jp)
    assert step2 == 4
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_serving_refuses_ssm(mamba):
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.launch.serve import ServeConfig, build_stack
    _, _, cfg, tm, tp = mamba
    # the stack serves at step level (tests/test_torch_recurrent.py): a
    # layer's state is its recurrent rows, no pool
    conv, ssm = tm.layer_state(("mamba", "none"), ctx=SINGLE, num_blocks=4,
                               page=4, batch=2)["mixer"]
    d_in, nh, hd, S, cw = mamba2.dims(cfg)
    assert conv.shape == (2, cw - 1, d_in + 2 * S)
    assert ssm.shape == (2, nh, hd, S) and ssm.dtype == torch.float32
    tm.init_states(ctx=SINGLE, num_blocks=4, page=4, batch=2)
    # the engine and the launcher serve it, each request keeping its
    # rows, and refuse what would split or share them: the mixed step and
    # a prefix cache (tests/test_torch_recurrent_engine.py)
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    eng = FlyingEngine(tm, plan, PoolGeometry(cfg, plan, num_blocks=16,
                                              block_base=4), tp,
                       device="cpu")
    assert eng.has_request_rows() and not eng.supports_mixed()
    sc = ServeConfig(arch="mamba2-2.7b", real=True, reduced=True,
                     device="cpu", dtype="float32")
    build_stack(sc, weights=(tm, tp))
    with pytest.raises(ValueError, match="never a recurrent state"):
        build_stack(dataclasses.replace(sc, prefix_cache=True),
                    weights=(tm, tp))
