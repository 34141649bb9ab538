"""The port's token sampling (``repro_torch.serving.sampling``) against
jax.random, on the CPU.

The JAX package draws row ``b`` with
``jax.random.categorical(jax.random.PRNGKey(seeds[b]), row)`` inside
its step (``repro.models.transformer.sample_tokens``). The port writes
threefry2x32, jax's uniform and Gumbel noise and the Gumbel-max draw as
torch ops. Held here:

- threefry's random bits: bit-identical to ``jax.random.bits`` for 32
  seeds (the edges 0, 1, 2**31 and 2**32 - 1 among them) at V 50, 1000
  and 128256 (llama3-8b's vocab), and to Random123's known answers;
- the uniforms under the Gumbel noise: bit-identical;
- the Gumbel noise: within 2 fp32 ulps of ``max(|g|, 1)``. Both sides
  take two logs of their own (XLA's and ATen's differ by up to an ulp),
  and ``-log(w)`` for ``w`` near 1 turns one ulp of ``w`` into one ulp of
  1 in ``g``: so the error is bounded against the scale the noise is
  added to (logits of order 1 and up), not against ``g`` near 0;
- the drawn tokens: identical to the JAX package's ``sample_tokens``,
  with top-k off, 1 and 20, at two temperatures.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.views import TPContext
from repro.models.transformer import sample_tokens as jax_sample_tokens
from repro_torch.configs import get_config
from repro_torch.core.views import make_serving_ctx
from repro_torch.models.transformer import sample_tokens
from repro_torch.serving import sampling

VOCABS = (50, 1000, 128256)
SEEDS = np.array([0, 1, 2, 7, 2**31, 2**32 - 1] + list(
    np.random.default_rng(0).integers(0, 2**32, 26)), np.uint64)


def _jax_rows(fn, seeds, V):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(seeds, jnp.uint32))
    return np.asarray(jax.vmap(lambda k: fn(k, V))(keys))


def _seeds_t():
    return torch.from_numpy(SEEDS.astype(np.int64))


def test_threefry_known_answers():
    """Random123's known-answer vectors for threefry2x32 with 20
    rounds (as jax's own tests use them)."""
    cases = [((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
             ((0xffffffff,) * 2, (0xffffffff,) * 2,
              (0x1cb996fc, 0xbb002be7)),
             ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
              (0xc4923a9c, 0x483df7a0))]
    for (k1, k2), (x1, x2), want in cases:
        got = sampling.threefry2x32(k1, k2, torch.tensor([x1]),
                                    torch.tensor([x2]))
        assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("V", VOCABS)
def test_random_bits_match_jax(V):
    want = _jax_rows(lambda k, n: jax.random.bits(k, (n,), jnp.uint32),
                     SEEDS, V)
    got = sampling.random_bits(_seeds_t(), V).numpy()
    assert got.shape == (len(SEEDS), V)
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("V", VOCABS)
def test_uniform_and_gumbel_match_jax(V):
    tiny = np.finfo(np.float32).tiny
    want_u = _jax_rows(lambda k, n: jax.random.uniform(
        k, (n,), jnp.float32, minval=tiny, maxval=1.0), SEEDS, V)
    got_u = sampling.uniform(_seeds_t(), V).numpy()
    np.testing.assert_array_equal(got_u, want_u)
    want = _jax_rows(lambda k, n: jax.random.gumbel(k, (n,), jnp.float32),
                     SEEDS, V)
    got = sampling.gumbel(_seeds_t(), V).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    scale = np.spacing(np.maximum(np.abs(want), np.float32(1.0)))
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= 2 * scale).all(), float((err / scale).max())


@pytest.mark.parametrize("V", (1000, 128256))
@pytest.mark.parametrize("top_k", (0, 1, 20))
@pytest.mark.parametrize("temperature", (0.8, 1.3))
def test_draws_match_jax(V, top_k, temperature):
    """``sample_tokens`` of both packages on the same logits and seeds:
    the same tokens, and the same as ``jax.random.categorical``
    itself."""
    rng = np.random.default_rng(V + top_k)
    logits = (rng.standard_normal((len(SEEDS), V)) * 4).astype(np.float32)
    cfg = get_config("llama3-8b").reduced()
    want = np.asarray(jax_sample_tokens(
        jax_config("llama3-8b").reduced(), jnp.asarray(logits), TPContext(),
        temperature=temperature, top_k=top_k,
        seeds=jnp.asarray(SEEDS, jnp.uint32)))
    got = sample_tokens(cfg, torch.from_numpy(logits),
                        make_serving_ctx(1, 1, 1), temperature=temperature,
                        top_k=top_k, seeds=_seeds_t())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if top_k == 1:
        np.testing.assert_array_equal(want, logits.argmax(-1))
    if top_k == 0:
        direct = [int(jax.random.categorical(
            jax.random.PRNGKey(np.uint32(s)), row / np.float32(temperature)))
            for s, row in zip(SEEDS, logits)]
        assert list(want) == direct


def test_greedy_and_missing_seeds():
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 100)).astype(np.float32))
    got = sampling.sample(logits)
    assert got.dtype == torch.int32
    assert got.tolist() == logits.argmax(-1).tolist()
    with pytest.raises(ValueError):
        sampling.sample(logits, temperature=0.5)
