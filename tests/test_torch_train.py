"""The port's training path against the JAX package's, on the CPU.

Inputs come from numpy with a seed, in fp32, and go through both
packages: the data pipeline (bit-identical), the cross entropy and its
gradient (atol 1e-5), AdamW over several steps (atol 1e-6: the same fp32
arithmetic in another order), checkpoints in the JAX package's layout
(exact), and the whole slice: reduced llama3-8b, reduced mamba2-2.7b and
the 4-layer RecurrentGemma test config (reduced recurrentgemma-9b with 4
layers: one super-layer of two RG-LRU layers and a local-attention
layer, then one more RG-LRU layer; at 128 tokens its window of 64 masks
keys) each trained three steps by the JAX package's ``build_train_step``
and by the port's, from the same converted weights and batches. There
the losses agree within rtol 1e-4, before each step the gradients at
the same parameters within atol 1e-4, and the parameters after the
steps within atol 1e-4. Adam's first steps move a weight by about
lr * sign(g), so a gradient element within float rounding of zero moves
its weight up to 2 lr apart in the two packages: reduced mamba2-2.7b
has some 600 such elements a step (both gradients at most 1e-6 in
size, a hundredth of their atol), so its steps start from a common
state and its parameter check leaves them out. Each config's train-mode
logits match the JAX model's at atol = rtol = 1e-4.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.modes import ParallelPlan as JaxPlan
from repro.core.views import SINGLE as JSINGLE
from repro.models.cache import TrainBackend as JaxTrainBackend
from repro.models.model import build_model as jax_build
from repro.models.transformer import tp_cross_entropy as jax_ce
from repro.training import checkpoint as jax_ckpt
from repro.training.data import DataConfig as JaxDataConfig
from repro.training.data import batches as jax_batches
from repro.training.optimizer import AdamW as JaxAdamW
from repro.training.optimizer import AdamWState as JaxAdamWState
from repro.training.train_step import build_train_step as jax_train_step
from repro.training.train_step import train_mesh
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.modes import ParallelPlan
from repro_torch.core.views import SINGLE
from repro_torch.kernels.flash_prefill import ref as fref
from repro_torch.kernels.rglru_scan import ref as rref
from repro_torch.kernels.ssd_scan import ref as sref
from repro_torch.models import transformer as tfm
from repro_torch.models.cache import TrainBackend
from repro_torch.models.model import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, batches
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import build_train_step


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


ARCHS = ["llama3-8b", "mamba2-2.7b", "recurrentgemma-9b"]
# the plain versions of each architecture's training kernels, with the
# mixers whose layers run them: (module, forward, backward, mixers)
_FLASH = (fref, "flash_prefill_fwd_ref", "flash_prefill_bwd_ref")
TRAIN_REFS = {
    "llama3-8b": [(*_FLASH, ("gqa",))],
    "mamba2-2.7b": [(sref, "ssd_scan_fwd_ref", "ssd_scan_bwd_ref",
                     ("mamba",))],
    "recurrentgemma-9b": [(rref, "rglru_scan_ref", "rglru_scan_bwd_ref",
                           ("rglru",)), (*_FLASH, ("gqa_win",))]}
# tokens a sequence in the forward test: past the hybrid's window of 64
SEQ = {"recurrentgemma-9b": 160}


def _test_config(get, arch):
    """The arch's reduced config; RecurrentGemma's with 4 layers, so that
    its stack has a local-attention layer (its own reduced() has two
    RG-LRU layers only)."""
    cfg = get(arch).reduced()
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, num_layers=4)
    return cfg


@pytest.fixture(scope="module")
def zoo():
    """``zoo(arch)``: the test config's JAX model, its init(key(0))
    params, and the port's config and model, built once."""
    built = {}

    def get(arch):
        if arch not in built:
            jm = jax_build(_test_config(jax_config, arch), jnp.float32)
            cfg = _test_config(get_config, arch)
            built[arch] = (jm, jm.init(jax.random.key(0)), cfg,
                           build_model(cfg, torch.float32, "cpu"))
        return built[arch]
    return get


@pytest.fixture(scope="module")
def reduced(zoo):
    """Reduced llama3-8b (see ``zoo``)."""
    return zoo("llama3-8b")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vocab,seq,batch,period", [
    (0, 512, 32, 4, 64), (3, 100, 64, 2, 16), (7, 128256, 16, 3, 8)])
def test_batches_bit_identical(seed, vocab, seq, batch, period):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed,
              copy_period=period)
    ours, theirs = batches(DataConfig(**kw)), jax_batches(JaxDataConfig(**kw))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_gradient_match_jax(masked):
    cfg = get_config("llama3-8b").reduced()
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, cfg.vocab_size)) * 3).astype(
        np.float32)
    labels = rng.integers(0, cfg.vocab_size, (3, 7)).astype(np.int32)
    labels[0, 0] = -1                       # outside the vocab: gold 0
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None

    def jloss(lg):
        return jax_ce(cfg, lg, jnp.asarray(labels), JSINGLE,
                      mask=None if mask is None else jnp.asarray(mask))
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = tfm.tp_cross_entropy(
        cfg, lt, torch.from_numpy(labels), SINGLE,
        mask=None if mask is None else torch.from_numpy(mask))
    (got_g,) = torch.autograd.grad(got, lt)
    np.testing.assert_allclose(float(got.detach()), float(want), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g),
                               atol=1e-5, rtol=0.0)


def test_lm_head_gradient_through_vocab_chunks():
    """A bf16 head wider than one upcast chunk: the logits filled slice by
    slice are the per-chunk fp32 products bit for bit (the same GEMM
    shapes: one product over the whole width may take another reduction
    order, as multithreaded MKL does), and carry the same gradient as one
    fp32 product (x's gradient sums its V products in one partial sum per
    chunk, so it differs in the last bits: atol 1e-3 against entries of
    about 1e2)."""
    cfg = get_config("llama3-8b").reduced()
    V = 2 * tfm._HEAD_CHUNK + 100
    rng = np.random.default_rng(1)
    w0 = torch.from_numpy(rng.standard_normal((16, V)).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal((2, 3, 16)).astype(np.float32))
    dl = torch.from_numpy(rng.standard_normal((2, 3, V)).astype(np.float32))
    w = w0.to(torch.bfloat16).requires_grad_(True)
    x = x0.clone().requires_grad_(True)
    got = tfm.lm_head(cfg, {"head": w}, x, SINGLE)
    gx, gw = torch.autograd.grad(got, (x, w), dl)
    w2 = w0.to(torch.bfloat16).requires_grad_(True)
    x2 = x0.clone().requires_grad_(True)
    want = x2 @ w2.float()
    wx, ww = torch.autograd.grad(want, (x2, w2), dl)
    assert got.dtype == torch.float32
    C = tfm._HEAD_CHUNK
    chunks = torch.cat([x0 @ w0.to(torch.bfloat16)[:, i:i + C].float()
                        for i in range(0, V, C)], dim=-1)
    torch.testing.assert_close(got, chunks, atol=0.0, rtol=0.0)
    torch.testing.assert_close(gx, wx, atol=1e-3, rtol=1e-5)
    torch.testing.assert_close(gw, ww, atol=0.0, rtol=0.0)


def test_adamw_matches_jax_over_steps():
    rng = np.random.default_rng(2)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": (2, 2, 2)}}

    def draw(scale):
        return jax.tree.map(
            lambda s: (rng.standard_normal(s) * scale).astype(np.float32),
            shapes, is_leaf=lambda s: isinstance(s, tuple))
    p0 = draw(1.0)
    grads = [draw(g) for g in (1.0, 0.1, 30.0, 0.5)]   # one step clips
    kw = dict(lr=0.05, weight_decay=0.1, grad_clip=1.0, warmup=3)
    jopt, opt = JaxAdamW(**kw), AdamW(**kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    tp = jax.tree.map(torch.from_numpy, p0)
    ts = opt.init(tp)
    for g in grads:
        jp, js = jopt.update(jp, jax.tree.map(jnp.asarray, g), js)
        tp, ts = opt.update(tp, jax.tree.map(torch.from_numpy, g), ts)
    assert ts.step == int(js.step) == len(grads)
    for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(ckpt.tree_leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=1e-6)


def test_adamw_descends_quadratic_and_clips():
    """``tests/test_training.py``'s optimizer properties, on the port."""
    opt = AdamW(lr=0.1, weight_decay=0.0, warmup=1)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state = opt.update(params, {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 1e-2
    opt = AdamW(lr=1.0, grad_clip=1.0, weight_decay=0.0, warmup=1)
    params = {"w": torch.zeros(3)}
    p2, _ = opt.update(params, {"w": torch.tensor([1e6, 0.0, 0.0])},
                       opt.init(params))
    assert torch.isfinite(p2["w"]).all()
    assert float(p2["w"].abs().max()) <= 1.0 + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_checkpoint_restores_into_the_port(reduced, tmp_path, dtype):
    jm, jp, cfg, tm = reduced
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    path = os.path.join(tmp_path, "jax_ck")
    jax_ckpt.save(path, jp, step=17)
    like = tm.init(torch.Generator().manual_seed(0))
    like = ckpt.tree_map(lambda t: t.to(getattr(torch, dtype)), like)
    got, step = ckpt.restore(path, like)
    want = params_from_numpy(cfg, _np_tree(jp), device="cpu")
    assert step == 17 == ckpt.latest_step(path)
    for a, b in zip(ckpt.tree_leaves(got), ckpt.tree_leaves(want)):
        assert a.dtype == b.dtype == getattr(torch, dtype)
        assert torch.equal(a, b)
    # and back: the port's checkpoint restores into the JAX package
    path2 = os.path.join(tmp_path, "port_ck")
    ckpt.save(path2, got, step=18)
    back, step2 = jax_ckpt.restore(path2, jp)
    assert step2 == 18
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      np.asarray(b).view(np.uint8))


def test_tree_order_is_jax_flatten_order(reduced):
    _, jp, cfg, _ = reduced
    port = params_from_numpy(cfg, _np_tree(jp), device="cpu")
    for a, b in zip(ckpt.tree_leaves(port), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert len(ckpt.tree_leaves(port)) == len(jax.tree.leaves(jp))
    rebuilt = ckpt.tree_unflatten(port, ckpt.tree_leaves(port))
    assert ckpt.tree_leaves(rebuilt) == ckpt.tree_leaves(port)


# ---------------------------------------------------------------------------
# train mode of the model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_jax(zoo, arch):
    jm, jp, cfg, tm = zoo(arch)
    from repro.models.cache import TrainBackend as JTrain
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             (2, SEQ.get(arch, 24)))
    want, _, _ = jm.forward(jp, JSINGLE, mode="train",
                            tokens=jnp.asarray(toks, jnp.int32),
                            backend=JTrain())
    params = ckpt.tree_map(lambda t: t.requires_grad_(True),
                           params_from_numpy(cfg, _np_tree(jp), device="cpu"))
    got, st, aux = tm.forward(params, SINGLE, mode="train",
                              tokens=torch.from_numpy(toks),
                              backend=TrainBackend())
    assert st is None and aux == 0.0 and got.requires_grad
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):
        tm.forward(params_from_numpy(cfg, _np_tree(jp), device="cpu"), SINGLE,
                   mode="train", tokens=torch.from_numpy(toks),
                   backend=TrainBackend(), states=[])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_each_layer_once(zoo, arch, monkeypatch):
    """Per-layer remat: each mixer's kernel forward (attention, the SSD
    scan or the RG-LRU recurrence) runs twice per layer of that mixer
    (the forward pass and its recomputation in the backward), its
    backward once; the gradients equal those without remat. On the card
    these are the K5, K6 and K7 launch counts of a training step."""
    _, jp, cfg, tm = zoo(arch)
    refs = TRAIN_REFS[arch]
    calls = {}
    for mod, fwd_name, bwd_name, _ in refs:
        for name in (fwd_name, bwd_name):
            def wrapped(*a, _fn=getattr(mod, name), _name=name, **kw):
                calls[_name] += 1
                return _fn(*a, **kw)
            monkeypatch.setattr(mod, name, wrapped)
    layers = [k[0] for seq, n in tm.plan for _ in range(n) for k in seq]
    toks = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 16)))
    grads = {}
    for remat in (True, False):
        tm.remat = remat
        params = params_from_numpy(cfg, _np_tree(jp), device="cpu")
        leaves = ckpt.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        calls.update({n: 0 for _, f, b, _ in refs for n in (f, b)})
        logits, _, _ = tm.forward(params, SINGLE, mode="train", tokens=toks,
                                  backend=TrainBackend())
        grads[remat] = torch.autograd.grad(logits.square().mean(), leaves)
        want = {}
        for _, fwd_name, bwd_name, mixers in refs:
            L = sum(m in mixers for m in layers)
            assert L > 0
            want.update({fwd_name: 2 * L if remat else L, bwd_name: L})
        assert calls == want
    tm.remat = True
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)


# ---------------------------------------------------------------------------
# the whole slice
# ---------------------------------------------------------------------------

def test_three_train_steps_match_jax(reduced):
    """Reduced llama3-8b, fp32, batch 4 x 32 tokens, AdamW(lr 1e-3, warmup
    5) as ``tests/test_training.py`` sets it up: the JAX package's
    ``build_train_step`` and the port's, from the same weights and
    batches."""
    _three_steps_match_jax(*reduced, seq=32)


def test_three_mamba2_train_steps_match_jax(zoo):
    """Reduced mamba2-2.7b, fp32, batch 4 x 64 tokens (two chunks of 32),
    the same set-up: SSD scan, conv, gated norm and all. Its parameters
    are held after every step from a common state, outside the elements
    whose gradient rounds near zero."""
    _three_steps_match_jax(*zoo("mamba2-2.7b"), seq=64, near_zero=1e-6)


def test_three_recurrentgemma_train_steps_match_jax(zoo):
    """The 4-layer RecurrentGemma test config, fp32, batch 4 x 128 tokens
    (twice the window), the same set-up: RG-LRU blocks, local attention
    with its window, GeLU MLPs and the embedding scale."""
    _three_steps_match_jax(*zoo("recurrentgemma-9b"), seq=128)


def _gradient_fns(jm, cfg, tm):
    """Each package's gradient of the training loss (cross entropy plus
    0.01 x the auxiliary loss, as both train steps take it) at given
    parameters: ``jgrad(jax params, batch)`` and ``tgrad(port params,
    batch)``, both as lists of numpy leaves in the JAX flatten order."""
    def jloss(p, b):
        logits, _, aux = jm.forward(p, JSINGLE, mode="train",
                                    tokens=b["tokens"],
                                    backend=JaxTrainBackend())
        return jax_ce(jm.cfg, logits, b["labels"], JSINGLE) + 0.01 * aux
    jg = jax.jit(jax.grad(jloss))

    def jgrad(p, b):
        return [np.asarray(g) for g in jax.tree.leaves(
            jg(p, {k: jnp.asarray(v) for k, v in b.items()}))]

    def tgrad(params, b):
        leaves = [p.requires_grad_(True) for p in ckpt.tree_leaves(params)]
        logits, _, aux = tm.forward(params, SINGLE, mode="train",
                                    tokens=torch.as_tensor(b["tokens"]),
                                    backend=TrainBackend())
        loss = tfm.tp_cross_entropy(cfg, logits,
                                    torch.as_tensor(b["labels"]), SINGLE)
        return [g.numpy() for g in torch.autograd.grad(loss + 0.01 * aux,
                                                        leaves)]
    return jgrad, tgrad


def _three_steps_match_jax(jm, jp, cfg, tm, *, seq, near_zero=0.0):
    """Both train steps, three times from the same weights and batches:
    the losses agree at every step (rtol 1e-4), the parameters and the
    first Adam moments after the last (atol 1e-4 and 1e-5). Before each
    step both packages take the gradient at the port's current
    parameters, which agree within atol 1e-4.

    ``near_zero`` > 0 starts the JAX step from the port's parameters and
    Adam state at every step, and holds the parameters after each step,
    leaving out each element whose gradient there is at most
    ``near_zero`` in size in both packages and not the same in both (at
    most 1% of the elements). Adam moves a weight by about lr * sign(g)
    while its moments are young, so a gradient within float rounding of
    zero (reduced mamba2-2.7b has some, of about 1e-7 with opposite signs
    in the two packages) moves its weight up to 2 lr apart, whatever the
    thread count; left to run on, the two trajectories then differ by
    more than rounding in the next steps' near-zero gradients too."""
    jgrad, tgrad = _gradient_fns(jm, cfg, tm)
    treedef = jax.tree.structure(jp)
    plan = JaxPlan(engine_rows=1, tp_base=1, data_rows=1)
    jopt = JaxAdamW(lr=1e-3, warmup=5)
    jstep, psh, osh, _ = jax_train_step(jm, plan, train_mesh(plan),
                                        opt=jopt, donate=False)
    jcarry = (jax.device_put(jp, psh),
              jax.jit(jopt.init, out_shardings=osh)(jp))
    opt = AdamW(lr=1e-3, warmup=5)
    step = build_train_step(tm, ParallelPlan(1, 1, 1), opt=opt)
    params = params_from_numpy(cfg, _np_tree(jp), device="cpu")
    carry = (params, opt.init(params))
    it = batches(DataConfig(cfg.vocab_size, seq, 4, seed=0))

    def as_jax(tree):                   # copies: the port updates in place
        return jax.tree.unflatten(treedef, [
            jnp.array(t.detach().numpy(), copy=True)
            for t in ckpt.tree_leaves(tree)])

    def params_match(masks):
        leaves = list(zip(ckpt.tree_leaves(carry[0]),
                          jax.tree.leaves(jcarry[0])))
        if masks is None:
            masks = [np.zeros(a.shape, bool) for a, _ in leaves]
        assert sum(m.sum() for m in masks) \
            <= 0.01 * sum(m.size for m in masks)
        for (a, b), m in zip(leaves, masks):
            np.testing.assert_allclose(a.detach().numpy()[~m],
                                       np.asarray(b)[~m], atol=1e-4, rtol=0.0)

    for _ in range(3):
        b = next(it)
        here = as_jax(params)
        grads = list(zip(tgrad(params, b), jgrad(here, b)))
        for a, w in grads:
            np.testing.assert_allclose(a, w, atol=1e-4, rtol=0.0)
        if near_zero:
            state = carry[1]
            jcarry = (jax.device_put(here, psh), jax.device_put(JaxAdamWState(
                step=jnp.int32(state.step), m=as_jax(state.m),
                v=as_jax(state.v)), osh))
        jcarry, jm_ = jstep(jcarry, {k: jnp.asarray(v) for k, v in b.items()})
        carry, m_ = step(carry, b)
        np.testing.assert_allclose(float(m_["loss"]), float(jm_["loss"]),
                                   rtol=1e-4, atol=0.0)
        np.testing.assert_allclose(float(m_["total"]), float(jm_["total"]),
                                   rtol=1e-4, atol=0.0)
        if near_zero:
            params_match([(np.abs(a) <= near_zero) & (np.abs(w) <= near_zero)
                          & (a != w) for a, w in grads])
    assert carry[0] is params                  # updated in place
    if not near_zero:
        params_match(None)
    for a, b in zip(ckpt.tree_leaves(carry[1].m),
                    jax.tree.leaves(jcarry[1].m)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=0.0)


def test_launcher_trains_on_the_cpu_when_asked(capsys, tmp_path):
    _launch_on_the_cpu(capsys, tmp_path, "llama3-8b")


def test_launcher_trains_mamba2_on_the_cpu(capsys, tmp_path):
    _launch_on_the_cpu(capsys, tmp_path, "mamba2-2.7b")


def test_launcher_trains_recurrentgemma_on_the_cpu(capsys, tmp_path):
    _launch_on_the_cpu(capsys, tmp_path, "recurrentgemma-9b")


def _launch_on_the_cpu(capsys, tmp_path, arch):
    from repro_torch.launch import train
    path = os.path.join(tmp_path, "ck")
    train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                "8", "--batch", "2", "--seq", "32", "--log-every", "4",
                "--ckpt", path, "--ckpt-every", "4"])
    out = capsys.readouterr().out
    assert "tok/s" in out and "ms/step" in out and "OK" in out
    assert ckpt.latest_step(path) == 8


@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b"])
def test_bf16_training_tracks_fp32_on_the_cpu(arch):
    """The reduced config (RecurrentGemma's with 4 layers) trained three
    bf16 steps and three fp32 steps on the CPU from the same bf16 weights
    and batches: the losses part, so bf16 really rounds, and by less than
    one bf16 unit (2^-8) relative. This drift is the yardstick of the
    card's bf16 training check (``tests/test_torch_cuda.py``)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model

    cfg = get_config(arch).reduced()
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, num_layers=4)
    params = build_model(cfg, torch.bfloat16, "cpu").init(
        torch.Generator().manual_seed(0))
    kw = dict(steps=3, batch=4, seq=128, device="cpu", log=lambda s: 0)
    b = train(cfg, dtype=torch.bfloat16,
              params=ckpt.tree_map(lambda x: x.clone(), params), **kw)
    f = train(cfg, dtype=torch.float32,
              params=ckpt.tree_map(lambda x: x.float(), params), **kw)
    drift = max(abs(x - y) / abs(y) for x, y in zip(b.losses, f.losses))
    assert 0.0 < drift < 2.0 ** -8
