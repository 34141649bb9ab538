"""The port's model against the JAX package's, on the CPU.

Reduced llama3-8b with the SAME parameters (the JAX package's
``model.init(jax.random.key(0))``, carried over by
``repro_torch.convert.params_from_numpy``): ``Model.forward`` logits in
chunked prefill (a fresh chunk, then a chunk over prior context with a
ragged, padded row) and in decode, fp32, atol = rtol = 1e-4 (the matmuls
sum in another order than XLA's)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.views import SINGLE as JSINGLE
from repro.models.cache import DecodeBackend as JDecode
from repro.models.cache import PrefillBackend as JPrefill
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.views import SINGLE
from repro_torch.models.cache import DecodeBackend, PrefillBackend
from repro_torch.models.model import build_model

TOL = dict(atol=1e-4, rtol=1e-4)
PAGE, NBLK, MB = 4, 32, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jax_config("llama3-8b").reduced()
    jm = jax_build(jcfg, jnp.float32)
    jp = jm.init(jax.random.key(0))
    cfg = get_config("llama3-8b").reduced()
    tm = build_model(cfg, torch.float32, device="cpu")
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    return jm, jp, tm, tp


def _steps():
    """Two chunked-prefill steps and one decode step for two requests
    (prompts 16 and 12 tokens, chunk 8; blocks 0-7 and 8-15)."""
    rng = np.random.default_rng(3)
    bt = np.arange(2 * MB, dtype=np.int32).reshape(2, MB)
    prompts = [rng.integers(0, 512, 16), rng.integers(0, 512, 12)]

    def slots_of(pos, live):
        s = bt[np.arange(2)[:, None], pos // PAGE] * PAGE + pos % PAGE
        return np.where(live, s, -1).astype(np.int32)

    steps = []
    for prior in (0, 8):
        T = 8
        pos = prior + np.arange(T)[None].repeat(2, 0)
        n_real = np.array([min(8, len(p) - prior) for p in prompts])
        live = np.arange(T)[None] < n_real[:, None]
        toks = np.zeros((2, T), np.int32)
        for b, p in enumerate(prompts):
            toks[b, :n_real[b]] = p[prior:prior + n_real[b]]
        steps.append(("prefill", dict(
            tokens=toks, positions=pos.astype(np.int32),
            slots=slots_of(pos, live), block_table=bt,
            prior_len=np.full(2, prior, np.int32),
            last_pos=(n_real - 1).astype(np.int32))))
    pos = np.array([[16], [12]])
    steps.append(("decode", dict(
        tokens=rng.integers(0, 512, (2, 1)).astype(np.int32),
        positions=pos.astype(np.int32),
        slots=slots_of(pos, True)[:, 0], block_table=bt,
        context_len=np.array([17, 13], np.int32))))
    return steps


def test_forward_logits_match_jax(models):
    jm, jp, tm, tp = models
    jst = jm.init_states(ctx=JSINGLE, batch=2, num_blocks=NBLK, page=PAGE)
    tst = tm.init_states(ctx=SINGLE, num_blocks=NBLK, page=PAGE)
    ptrs = [t.data_ptr() for g in tst for st in g for t in st["mixer"]]
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
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the pools were written in place, and hold what the JAX states hold
    # (but for the scratch row, where parked rows land)
    assert ptrs == [t.data_ptr() for g in tst for st in g
                    for t in st["mixer"]]
    for got, want in zip(tst[0][0]["mixer"], jst[0][0]["mixer"]):
        rows = got.shape[1] * got.shape[2]
        np.testing.assert_allclose(
            got.numpy().reshape(got.shape[0], rows, -1)[:, :-1],
            np.asarray(want).reshape(got.shape[0], rows, -1)[:, :-1], **TOL)


def test_convert_rejects_a_foreign_tree(models):
    _, jp, _, _ = models
    bad = jax.tree.map(np.asarray, jp)
    bad["embed"]["tok"] = bad["embed"]["tok"][:, :8]
    with pytest.raises(ValueError):
        params_from_numpy(get_config("llama3-8b").reduced(), bad)


def test_seeded_init_keeps_the_jax_scales():
    cfg = get_config("llama3-8b").reduced()
    m = build_model(cfg, torch.float32, device="cpu")
    a = m.init(torch.Generator().manual_seed(0))
    b = m.init(torch.Generator().manual_seed(0))
    wq = a["groups"][0][0]["attn"]["wq"]
    assert torch.equal(wq, b["groups"][0][0]["attn"]["wq"])
    assert wq.shape == (cfg.num_layers, cfg.d_model,
                        cfg.num_heads * cfg.resolved_head_dim)
    assert float(wq.abs().max()) <= cfg.d_model ** -0.5
    assert abs(float(a["embed"]["tok"].std()) - 0.02) < 2e-3


def test_entry_points_run_on_the_card_unless_asked():
    """No card and no explicit device: raise, never fall back."""
    cfg = get_config("llama3-8b").reduced()
    if torch.cuda.is_available():
        assert build_model(cfg, torch.float32).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            build_model(cfg, torch.float32)
    assert build_model(cfg, torch.float32, "cpu").device.type == "cpu"


def test_unported_paths_raise():
    from repro_torch.models.transformer import sample_tokens
    with pytest.raises(NotImplementedError):
        sample_tokens(None, torch.zeros(1, 4), SINGLE, temperature=0.7)
    for arch in ("deepseek-v2-236b", "phi3.5-moe-42b-a6.6b"):  # MLA, MoE
        with pytest.raises(NotImplementedError):
            build_model(get_config(arch).reduced(), torch.float32,
                        "cpu").plan
    for arch in ("mamba2-2.7b", "recurrentgemma-9b"):  # trains, not serves
        with pytest.raises(NotImplementedError):
            build_model(get_config(arch).reduced(), torch.float32,
                        "cpu").check_serving()
