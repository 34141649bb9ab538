"""The port's whisper-base (encoder, cross-attention, cross caches) and
internvl2-1b (vision projector, patch prefix) against the JAX package's,
on the CPU.

The reduced configs with the SAME parameters (the JAX package's
``model.init(jax.random.key(0))``, carried over by
``repro_torch.convert.params_from_numpy``) and the same inputs, drawn
with numpy from a seed in fp32: the sinusoidal table, the encoder with
and without a ``frame_len`` mask, the cross-attention with ``enc_len``
masking frames, the whole train-mode ``Model.forward``, prefill then
decode through ``build_serve_step`` on one rank (the cross caches
written by the prefill and read by the decode steps), and three training
steps of both packages' ``build_train_step``; at atol = rtol = 1e-4
unless a test says otherwise (check_serve_consistency's 3e-3 would also
do). Then the refusals: the engine and the launcher refuse both
families (engine-level serving is ROADMAP Queue 1 item 3), the mixed,
live and striped steps refuse whisper, and a decoder position past
whisper's 448 raises.
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

from repro.configs import get_config as jax_config
from repro.core.modes import ParallelPlan as JaxPlan
from repro.core.views import SINGLE as JSINGLE
from repro.models import transformer as jtfm
from repro.models.cache import TrainBackend as JaxTrainBackend
from repro.models.common import sinusoidal_positions as jax_sinusoidal
from repro.models.model import build_model as jax_build
from repro.training.optimizer import AdamW as JaxAdamW
from repro.training.train_step import build_train_step as jax_train_step
from repro.training.train_step import train_mesh
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.kv_adaptor import KVCacheAdaptor, PoolGeometry
from repro_torch.core.modes import FlyingMode, ParallelPlan
from repro_torch.core.steps import build_serve_step, fresh_states
from repro_torch.core.views import SINGLE
from repro_torch.models import transformer as tfm
from repro_torch.models.cache import TrainBackend
from repro_torch.models.common import sinusoidal_positions
from repro_torch.models.model import Model, build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, batches
from repro_torch.training.optimizer import AdamW
from repro_torch.training.train_step import build_train_step

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["whisper-base", "internvl2-1b"]
TOL = dict(atol=1e-4, rtol=1e-4)
B, T = 4, 10


@pytest.fixture(scope="module")
def zoo():
    """``zoo(arch)``: the reduced config's JAX model and its init(key(0))
    params, the port's model and those params converted, built once."""
    built = {}

    def get(arch):
        if arch not in built:
            jm = jax_build(jax_config(arch).reduced(), jnp.float32)
            jp = jm.init(jax.random.key(0))
            cfg = get_config(arch).reduced()
            built[arch] = (jm, jp, build_model(cfg, torch.float32, "cpu"),
                           params_from_numpy(cfg, jax.tree.map(np.asarray,
                                                               jp),
                                             device="cpu"))
        return built[arch]
    return get


def _inputs(cfg, seed=0, batch=B, seq=T + 1):
    """Tokens [batch, seq], the frontend's embeddings [batch, num_embeds,
    width] (N(0, 1) x 0.1) and, for whisper, ``enc_len`` masking some
    rows' last frames; numpy, fp32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    w = cfg.frontend.embed_width or cfg.d_model
    fe = (rng.standard_normal((batch, cfg.frontend.num_embeds, w))
          * 0.1).astype(np.float32)
    F = cfg.frontend.num_embeds
    enc_len = None
    if cfg.enc_dec is not None:
        enc_len = np.array([F, F - 7, F, 3][:batch], np.int32)
    return toks, fe, enc_len


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,d", [(448, 512), (1500, 512), (64, 256)])
def test_sinusoidal_positions_match_jax(n, d):
    """[sin | cos] of the same fp32 angles, concatenated: the halves are
    the sines and cosines of pos x 10000^(-2i/d) in fp32, and the table
    is the JAX package's within the angle's rounding. XLA's fp32 exp is
    not correctly rounded (one unit off for about a tenth of the
    frequencies), and the angle carries that unit times the position,
    so the tables agree within n x 2^-23, not bit for bit."""
    got = sinusoidal_positions(n, d)
    assert got.dtype == torch.float32 and got.shape == (n, d)
    ang = torch.arange(n, dtype=torch.float32)[:, None] * torch.exp(
        -np.log(10000.0) * torch.arange(0, d, 2, dtype=torch.float32)[None]
        / d)
    assert torch.equal(got, torch.cat([ang.sin(), ang.cos()], -1))
    want = np.asarray(jax_sinusoidal(n, d))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=n * 2**-23)


@pytest.mark.parametrize("masked", [False, True])
def test_encode_matches_jax(zoo, masked):
    jm, jp, tm, tp = zoo("whisper-base")
    cfg = tm.cfg
    _, fe, enc_len = _inputs(cfg)
    if not masked:
        enc_len = None
    jo = jtfm.encode(jm.cfg, jp["encoder"], jnp.asarray(fe), JSINGLE,
                     frame_len=None if enc_len is None
                     else jnp.asarray(enc_len))
    to = tfm.encode(cfg, tp["encoder"], torch.from_numpy(fe), SINGLE,
                    frame_len=None if enc_len is None
                    else torch.from_numpy(enc_len))
    assert to.shape == (B, cfg.frontend.num_embeds, cfg.d_model)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)


def test_cross_attention_masks_frames_as_jax(zoo):
    """The first decoder layer's cross-attention over K/V projected from
    random encoder outputs, with ``enc_len`` masking 7 and 13 frames of
    two rows: the JAX package's output, and a masked frame's K/V do not
    move it."""
    jm, jp, tm, tp = zoo("whisper-base")
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    F = cfg.frontend.num_embeds
    x = rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((B, F, cfg.d_model)).astype(np.float32)
    enc_len = np.array([F, F - 7, F, 3], np.int32)
    jcross = jax.tree.map(lambda a: a[0], jp["groups"][0][0]["cross"])
    tcross = {k: v[0] for k, v in tp["groups"][0][0]["cross"].items()}
    jkv = tuple((jnp.asarray(enc) @ jcross[w]).reshape(
        B, F, cfg.num_kv_heads, -1) for w in ("wk", "wv"))
    tkv = tfm.make_cross_kv(cfg, tcross, torch.from_numpy(enc), SINGLE)
    for a, b in zip(tkv, jkv):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    jo = jtfm.cross_attention(jm.cfg, jcross, jnp.asarray(x), JSINGLE, jkv,
                              enc_len=jnp.asarray(enc_len))
    to = tfm.cross_attention(cfg, tcross, torch.from_numpy(x), SINGLE, tkv,
                             enc_len=torch.from_numpy(enc_len))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    noisy = tuple(t.clone() for t in tkv)
    for t in noisy:
        t[3, 3:] = 1e3
    again = tfm.cross_attention(cfg, tcross, torch.from_numpy(x), SINGLE,
                                noisy, enc_len=torch.from_numpy(enc_len))
    assert torch.equal(again[3], to[3])


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_takes_the_reference_tree(zoo, arch):
    """The reference's tree converts as it is (whisper's ``encoder``
    layer list beside the groups, each layer's ``norm_x`` and ``cross``;
    internvl2-1b's ``embed.projector``), and so do its flattened leaves
    put back into the port's structure (how the rank tests load them)."""
    jm, jp, tm, tp = zoo(arch)
    cfg = tm.cfg
    leaves = [np.asarray(a) for a in jax.tree.leaves(jp)]
    like = Model(cfg, torch.float32, torch.device("meta")).init(
        torch.Generator())
    again = params_from_numpy(cfg, ckpt.tree_unflatten(like, leaves),
                              device="cpu")
    assert [t.shape for t in ckpt.tree_leaves(again)] == \
        [a.shape for a in leaves]
    for a, b in zip(ckpt.tree_leaves(again), ckpt.tree_leaves(tp)):
        assert torch.equal(a, b)
    if cfg.enc_dec is not None:
        assert len(tp["encoder"]["layers"]) == cfg.enc_dec.enc_layers
        assert {"norm_x", "cross"} <= set(tp["groups"][0][0])
    else:
        assert tp["embed"]["projector"].shape == (
            cfg.frontend.embed_width, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("plan", [(1, 2, 4), (1, 4, 2)])
def test_storage_rules_match_jax_specs(arch, plan):
    """Each leaf's storage shards are the JAX package's serving partition
    specs, dim for dim (the encoder's and the cross sub-blocks' heads
    split like the decoder's; the projector replicated); at plan (1, 2,
    4) rank 0's and rank 1's storage shards of the encoder's and the
    cross sub-block's query projections are the two halves of the whole
    one, and the projector is the tensor itself."""
    from repro.core.weights_manager import WeightsManager as JWM
    from repro_torch.core.weights_manager import WeightsManager
    jcfg = jax_config(arch).reduced()
    jm = jax_build(jcfg, jnp.float32)
    specs = jax.tree.leaves(JWM(jcfg, JaxPlan(*plan)).partition_specs(
        jm.param_specs()), is_leaf=lambda s: isinstance(
            s, jax.sharding.PartitionSpec))
    flat = jax.tree_util.tree_flatten_with_path(jm.param_specs())[0]
    cfg = get_config(arch).reduced()
    wm = WeightsManager(cfg, ParallelPlan(*plan))
    sharded = []
    for (path, shape), spec in zip(flat, specs):
        keys = tuple(str(k.key) for k in path if hasattr(k, "key"))
        want = list(tuple(spec) + (None,) * (len(shape.shape) - len(spec)))
        got = [None] * len(shape.shape)
        for d, _, ax in wm.shard_dims(keys, tuple(shape.shape)):
            got[d] = {"ed,model": ("ed", "model") if plan[0] > 1
                      else "model"}.get(ax, ax)
            sharded.append(keys)
        assert got == want, (keys, shape.shape)
    if plan != (1, 2, 4):
        return
    params = Model(cfg, torch.float32, torch.device("cpu")).init(
        torch.Generator().manual_seed(0))
    s0, s1 = (wm.storage_shard(params, r) for r in (0, 1))
    if cfg.enc_dec is not None:
        assert ("encoder", "layers", "attn", "wq") in sharded
        assert ("groups", "cross", "wk") in sharded
        for get, dim in (
                (lambda p: p["encoder"]["layers"][1]["attn"]["wq"], -1),
                (lambda p: p["encoder"]["layers"][1]["ffn"]["w_down"], -2),
                (lambda p: p["groups"][0][0]["cross"]["wk"], -1),
                (lambda p: p["groups"][0][0]["cross"]["wo"], -2)):
            assert get(s0).shape[dim] * 2 == get(params).shape[dim]
            assert torch.equal(torch.cat([get(s0), get(s1)], dim),
                               get(params))
    else:
        assert s0["embed"]["projector"] is params["embed"]["projector"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_jax(zoo, arch):
    jm, jp, tm, tp = zoo(arch)
    toks, fe, enc_len = _inputs(tm.cfg)
    jl = jm.forward(jp, JSINGLE, mode="train", tokens=jnp.asarray(toks),
                    backend=JaxTrainBackend(),
                    frontend_embeds=jnp.asarray(fe),
                    enc_len=None if enc_len is None
                    else jnp.asarray(enc_len))[0]
    tl = tm.forward(tp, SINGLE, mode="train", tokens=torch.from_numpy(toks),
                    backend=TrainBackend(),
                    frontend_embeds=torch.from_numpy(fe),
                    enc_len=None if enc_len is None
                    else torch.from_numpy(enc_len))[0]
    prefix = tm.cfg.frontend.num_embeds if tm.cfg.enc_dec is None else 0
    assert tl.shape == (B, T + 1 + prefix, tm.cfg.vocab_size)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), **TOL)


def _serve_tables(cfg, geom, Tp):
    """One request a row: the prefill's slots over prefix and prompt,
    then two decode tokens' slots, with their block tables."""
    ad = KVCacheAdaptor(geom)
    ad.switch_mode(1)
    mb = -(-(Tp + 2) // geom.capacity(1)) + 1
    slots = np.stack([ad.append_slots(f"r{b}", Tp) for b in range(B)])
    btab = np.stack([ad.block_table(f"r{b}", mb) for b in range(B)])
    dec = []
    for _ in range(2):
        s = np.stack([ad.append_slots(f"r{b}", 1)[0] for b in range(B)])
        dec.append((s, np.stack([ad.block_table(f"r{b}", mb)
                                 for b in range(B)])))
    return slots, btab, dec


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_match_jax_forward(zoo, arch):
    """One prefill (the stub embeddings; whisper's ``enc_len`` masking
    frames of two rows) and two decode steps through ``build_serve_step``
    at ``ParallelPlan(1, 1, 1)``: each step's logits are the JAX
    package's train-mode forward's at that position; whisper's cross
    caches hold the JAX model's cross K/V, and the decode steps change
    neither them nor the pools' storage."""
    jm, jp, tm, tp = zoo(arch)
    cfg = tm.cfg
    toks, fe, enc_len = _inputs(cfg, seq=T + 2)
    kw = {} if enc_len is None else {"enc_len": jnp.asarray(enc_len)}
    ref = np.asarray(jm.forward(jp, JSINGLE, mode="train",
                                tokens=jnp.asarray(toks),
                                backend=JaxTrainBackend(),
                                frontend_embeds=jnp.asarray(fe), **kw)[0])
    prefix = cfg.frontend.num_embeds if cfg.enc_dec is None else 0
    Tp = T + prefix
    plan = ParallelPlan(1, 1, 1)
    mode = FlyingMode(plan, 1)
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    slots, btab, dec = _serve_tables(cfg, geom, Tp)
    F = cfg.frontend.num_embeds if cfg.enc_dec is not None else 0
    states = fresh_states(tm, mode, geom, batch=B, enc_frames=F)
    ptrs = [t.data_ptr() for g in states for st in g for leaves in
            st.values() for t in leaves]
    prefill, _ = build_serve_step(tm, mode, geom, phase="prefill")
    decode, _ = build_serve_step(tm, mode, geom, phase="decode")
    i32 = torch.int32
    extra = {} if enc_len is None else {"enc_len": torch.from_numpy(enc_len)}
    lp, states = prefill(tp, states, {
        "tokens": torch.from_numpy(toks[:, :T]),
        "positions": torch.arange(Tp, dtype=i32)[None].expand(B, Tp),
        "slots": torch.from_numpy(slots).to(i32),
        "block_table": torch.from_numpy(btab).to(i32),
        "prior_len": torch.zeros((B,), dtype=i32),
        "frontend_embeds": torch.from_numpy(fe), **extra})
    np.testing.assert_allclose(lp.numpy(), ref[:, Tp - 1], **TOL)
    if cfg.enc_dec is not None:
        enc = jtfm.encode(jm.cfg, jp["encoder"], jnp.asarray(fe), JSINGLE,
                          frame_len=jnp.asarray(enc_len))
        jcross = jax.tree.map(lambda a: a[1], jp["groups"][0][0]["cross"])
        for got, w in zip(states[0][0]["cross"], ("wk", "wv")):
            want = (enc @ jcross[w]).reshape(got.shape[1:])
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want),
                                       **TOL)
        cross = [t.clone() for t in states[0][0]["cross"]]
    for i, (s, bt) in enumerate(dec):
        ld, states = decode(tp, states, {
            "tokens": torch.from_numpy(toks[:, T + i:T + i + 1]),
            "positions": torch.full((B, 1), Tp + i, dtype=i32),
            "slots": torch.from_numpy(s).to(i32),
            "block_table": torch.from_numpy(bt).to(i32),
            "context_len": torch.full((B,), Tp + i + 1, dtype=i32),
            **extra})
        np.testing.assert_allclose(ld.numpy(), ref[:, Tp + i], **TOL)
    if cfg.enc_dec is not None:
        assert all(torch.equal(a, b)
                   for a, b in zip(cross, states[0][0]["cross"]))
    assert ptrs == [t.data_ptr() for g in states for st in g for leaves in
                    st.values() for t in leaves]


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(zoo, arch):
    """Both packages' ``build_train_step``, three steps from the same
    weights, token batches and stub embeddings (whisper's 16 frames;
    internvl2-1b's 16 patches, whose logits the loss leaves out): the
    losses agree at every step (rtol 1e-4), the parameters after the
    last within atol 1e-4, the first Adam moments within 1e-5 (an
    encoder layer's unused cross sub-block gets a zero gradient in
    both)."""
    jm, jp, tm, _ = zoo(arch)
    cfg = tm.cfg
    plan = JaxPlan(engine_rows=1, tp_base=1, data_rows=1)
    jopt = JaxAdamW(lr=1e-3, warmup=5)
    jstep, psh, osh, _ = jax_train_step(jm, plan, train_mesh(plan),
                                        opt=jopt, donate=False)
    jcarry = (jax.device_put(jp, psh),
              jax.jit(jopt.init, out_shardings=osh)(jp))
    opt = AdamW(lr=1e-3, warmup=5)
    step = build_train_step(tm, ParallelPlan(1, 1, 1), opt=opt)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                               device="cpu")
    carry = (params, opt.init(params))
    it = batches(DataConfig(cfg.vocab_size, 32, 2, seed=0))
    _, fe, _ = _inputs(cfg, batch=2)
    for _ in range(3):
        b = dict(next(it), frontend_embeds=fe)
        jcarry, jm_ = jstep(jcarry, {k: jnp.asarray(v) for k, v in b.items()})
        carry, m_ = step(carry, b)
        np.testing.assert_allclose(float(m_["loss"]), float(jm_["loss"]),
                                   rtol=1e-4, atol=0.0)
    assert carry[0] is params
    for a, w in zip(ckpt.tree_leaves(carry[0]), jax.tree.leaves(jcarry[0])):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(w),
                                   atol=1e-4, rtol=0.0)
    for a, w in zip(ckpt.tree_leaves(carry[1].m),
                    jax.tree.leaves(jcarry[1].m)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0.0)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_with_stub_embeddings(capsys, arch):
    """``launch.train`` on the CPU feeds the stub embeddings and its loss
    falls; whisper's sequence past its decoder context is refused."""
    from repro_torch.launch import train
    train.main(["--arch", arch, "--reduced", "--device", "cpu", "--steps",
                "8", "--batch", "2", "--seq", "32", "--log-every", "4"])
    assert "OK" in capsys.readouterr().out
    if arch == "whisper-base":
        with pytest.raises(ValueError, match="448"):
            train.train(get_config(arch).reduced(), steps=1, batch=1,
                        seq=449, device="cpu", dtype=torch.float32)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_refuses_the_frontend_families(zoo, arch):
    from repro_torch.core.engine import FlyingEngine
    _, _, tm, tp = zoo(arch)
    plan = ParallelPlan(1, 1, 1)
    geom = PoolGeometry(tm.cfg, plan, num_blocks=16, block_base=4)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        FlyingEngine(tm, plan, geom, tp, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_the_frontend_families(arch):
    """The launcher's real path exits non-zero, naming the ROADMAP item,
    where it used to serve internvl2-1b as a text-only model."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--reduced",
         "--device", "cpu", "--dtype", "float32", "--arch", arch,
         "--requests", "2", "--num-blocks", "64", "--prompt-range", "8",
         "16", "--output-range", "2", "4", "--prefill-chunk", "8",
         "--max-blocks-per-req", "8"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "NotImplementedError" in proc.stderr
    assert "Queue 1 item 3" in proc.stderr
    assert "requests done" not in proc.stdout


def test_steps_refuse_whisper_where_the_reference_does(zoo):
    """The mixed step and the live lanes refuse an enc-dec model, as the
    JAX package asserts; a striped pool refuses both families' prefill
    and whisper's decode; internvl2-1b's striped decode step builds (the
    dry run counts it on meta tensors) and refuses to run on CPU
    tensors, which no reference run holds."""
    _, _, tm, _ = zoo("whisper-base")
    plan = ParallelPlan(1, 1, 2)
    mode = FlyingMode(plan, 2)
    geom = PoolGeometry(tm.cfg, plan, num_blocks=16, block_base=4)
    with pytest.raises(ValueError, match="enc-dec"):
        build_serve_step(tm, mode, geom, phase="mixed")
    with pytest.raises(ValueError, match="cross caches"):
        build_serve_step(tm, mode, geom, phase="decode", live=(2,))
    for arch in ARCHS:
        model = zoo(arch)[2]
        striped = PoolGeometry(model.cfg, plan, num_blocks=16,
                               block_base=4, layout="striped")
        for phase in ("prefill", "decode"):
            if phase == "decode" and model.cfg.enc_dec is None:
                step, _ = build_serve_step(model, mode, striped,
                                           phase=phase)
                with pytest.raises(ValueError, match="striped"):
                    step(None, None, {"tokens": torch.zeros(
                        (1, 1), dtype=torch.int32)})
                continue
            with pytest.raises(ValueError, match="striped"):
                build_serve_step(model, mode, striped, phase=phase)


def test_decoder_position_past_the_table_raises(zoo):
    """whisper-base's decoder has 448 sinusoidal positions; position 448
    raises (JAX would clamp the gather to row 447) in every mode."""
    _, _, tm, tp = zoo("whisper-base")
    cfg = tm.cfg
    _, fe, _ = _inputs(cfg, batch=1)
    with pytest.raises(ValueError, match="448"):
        tm.forward(tp, SINGLE, mode="train", backend=TrainBackend(),
                   tokens=torch.zeros((1, 449), dtype=torch.int32),
                   frontend_embeds=torch.from_numpy(fe))
    plan = ParallelPlan(1, 1, 1)
    mode = FlyingMode(plan, 1)
    geom = PoolGeometry(cfg, plan, num_blocks=16, block_base=4)
    states = fresh_states(tm, mode, geom, batch=1,
                          enc_frames=cfg.frontend.num_embeds)
    decode, _ = build_serve_step(tm, mode, geom, phase="decode")
    i32 = torch.int32
    batch = {"tokens": torch.zeros((1, 1), dtype=i32),
             "positions": torch.full((1, 1), 448, dtype=i32),
             "slots": torch.zeros((1,), dtype=i32),
             "block_table": torch.zeros((1, 2), dtype=i32),
             "context_len": torch.ones((1,), dtype=i32)}
    with pytest.raises(ValueError, match="448"):
        decode(tp, states, batch)
    batch["positions"] -= 1
    decode(tp, states, batch)


def test_model_refuses_mismatched_frontend_inputs(zoo):
    """Embeddings in another dtype than the model's, a model without a
    frontend, a whisper train step without its frames, and cross caches
    of another batch than the step's are refused."""
    _, _, tm, tp = zoo("whisper-base")
    cfg = tm.cfg
    toks, fe, _ = _inputs(cfg, batch=2, seq=4)
    kw = dict(mode="train", backend=TrainBackend(),
              tokens=torch.from_numpy(toks))
    with pytest.raises(ValueError, match="dtype|float64"):
        tm.forward(tp, SINGLE, frontend_embeds=torch.from_numpy(fe)
                   .double(), **kw)
    with pytest.raises(ValueError, match="frontend_embeds"):
        tm.forward(tp, SINGLE, **kw)
    llama = Model(get_config("llama3-8b").reduced(), torch.float32,
                  torch.device("cpu"))
    with pytest.raises(ValueError, match="no modality frontend"):
        llama.forward(None, SINGLE, frontend_embeds=torch.from_numpy(fe),
                      **kw)
    plan = ParallelPlan(1, 1, 1)
    mode = FlyingMode(plan, 1)
    geom = PoolGeometry(cfg, plan, num_blocks=16, block_base=4)
    states = fresh_states(tm, mode, geom, batch=3,
                          enc_frames=cfg.frontend.num_embeds)
    prefill, _ = build_serve_step(tm, mode, geom, phase="prefill")
    i32 = torch.int32
    with pytest.raises(ValueError, match="cross cache"):
        prefill(tp, states, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.arange(4, dtype=i32)[None].expand(2, 4),
            "slots": torch.arange(8, dtype=i32).reshape(2, 4),
            "block_table": torch.arange(4, dtype=i32).reshape(2, 2),
            "prior_len": torch.zeros((2,), dtype=i32),
            "frontend_embeds": torch.from_numpy(fe)})
