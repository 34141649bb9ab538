"""The port's MoE layer and Phi-3.5-MoE against the JAX package's, on
the CPU.

The MoE layer of both reduced MoE configs (DeepSeek-V2: 4 experts, top
2, one shared expert; Phi-3.5-MoE: 4 experts, top 2, none shared) with
the JAX package's ``init_moe`` parameters, on tokens drawn from a seeded
numpy generator:

- ``route``: the same experts in the same order (ties to the lower
  index, as ``lax.top_k``), weights and aux loss at fp32 atol = rtol =
  1e-6; ``_positions_in_expert`` equal;
- ``moe_ffn`` at the reduced capacity factor (4: nothing drops) and
  shrunk to 0.5 (tokens drop): the same dropped (token, choice) entries,
  outputs at atol = rtol = 1e-5 (the products sum in another order);
  without drops it equals ``dense_moe_ref``, which equals the JAX one;
- Phi-3.5-MoE's logits over ``tests/test_torch_model.py``'s chunked
  prefill and decode steps at atol = rtol = 1e-4, and its scheduler
  runs under HARD, SOFT and SEQUENTIAL token-identical to the JAX
  engine's (``tests/test_torch_mla.py``'s trace and clock);
- the router stays fp32 in a bf16 model, as in the JAX package.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.views import SINGLE as JSINGLE
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.views import SINGLE
from repro_torch.models import moe
from repro_torch.models.model import build_model
from test_torch_engine import jax_mesh_shim  # noqa: F401
from test_torch_mla import (STRATEGIES, both_models, forward_steps,
                            sched_run)

ARCHS = ("deepseek-v2-236b", "phi3.5-moe-42b-a6.6b")
PHI = "phi3.5-moe-42b-a6.6b"
TOL = dict(atol=1e-5, rtol=1e-5)


def _layer(arch, capacity_factor=None):
    """(JAX cfg, port cfg, JAX params, port params, x [2, 24, d] numpy)
    of the reduced config's MoE layer."""
    jcfg, cfg = jax_config(arch).reduced(), get_config(arch).reduced()
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    jp = jmoe.init_moe(jax.random.key(0), jcfg, jnp.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    x = np.random.default_rng(7).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jp, tp, x


@pytest.mark.parametrize("arch", ARCHS)
def test_route_and_positions_match_jax(arch):
    jcfg, cfg, jp, tp, x = _layer(arch)
    tok = x.reshape(-1, cfg.d_model)
    je, jw, jaux = jmoe.route(jp["router"], jnp.asarray(tok), cfg.moe.top_k)
    te, tw, taux = moe.route(tp["router"], torch.from_numpy(tok),
                             cfg.moe.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6,
                               rtol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6,
                               rtol=1e-6)
    flat = np.array(je).reshape(-1)
    np.testing.assert_array_equal(
        moe._positions_in_expert(torch.from_numpy(flat),
                                 cfg.moe.num_experts).numpy(),
        np.asarray(jmoe._positions_in_expert(jnp.asarray(flat),
                                             cfg.moe.num_experts)))
    # ties go to the lower expert index, as lax.top_k orders them
    even = torch.zeros((1, cfg.moe.num_experts))
    assert moe.route(torch.eye(cfg.moe.num_experts), even,
                     2)[0].tolist() == [[0, 1]]


def _dropped(cfg, experts):
    """(token, choice) entries past their expert's capacity."""
    E, k = cfg.moe.num_experts, cfg.moe.top_k
    N = experts.shape[0]
    pos = np.asarray(jmoe._positions_in_expert(
        jnp.asarray(experts.reshape(-1)), E))
    cap = max(8, int(math.ceil(N * k / E * cfg.moe.capacity_factor)))
    cap = -(-cap // 8) * 8
    return pos >= cap


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, capacity_factor):
    jcfg, cfg, jp, tp, x = _layer(arch, capacity_factor)
    jy, jaux = jmoe.moe_ffn(jcfg, jp, jnp.asarray(x), JSINGLE)
    ty, taux = moe.moe_ffn(cfg, tp, torch.from_numpy(x), SINGLE)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6)
    # the same entries drop in both packages
    tok = x.reshape(-1, cfg.d_model)
    je, _, _ = jmoe.route(jp["router"], jnp.asarray(tok), cfg.moe.top_k)
    te, _, _ = moe.route(tp["router"], torch.from_numpy(tok), cfg.moe.top_k)
    drop_j = _dropped(jcfg, np.asarray(je))
    drop_t = (moe._positions_in_expert(te.reshape(-1), cfg.moe.num_experts)
              >= moe.capacity(cfg, tok.shape[0])).numpy()
    np.testing.assert_array_equal(drop_t, drop_j)
    dense, _ = moe.dense_moe_ref(cfg, tp, torch.from_numpy(x))
    jdense, _ = jmoe.dense_moe_ref(jcfg, jp, jnp.asarray(x))
    np.testing.assert_allclose(dense.numpy(), np.asarray(jdense), **TOL)
    if capacity_factor is None:       # the reduced factor drops nothing
        assert not drop_t.any()
        np.testing.assert_allclose(ty.numpy(), dense.numpy(), **TOL)
    else:                             # shrunk: a dropped token differs
        assert drop_t.any()
        assert not np.allclose(ty.numpy(), dense.numpy(), **TOL)


def test_router_stays_fp32():
    cfg = get_config(PHI).reduced()
    m = build_model(cfg, torch.bfloat16, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    ffn = p["groups"][0][0]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["e_gate"].dtype == torch.bfloat16
    # an fp32 tree cast to bf16 on the way in keeps its router fp32
    tree = jax.tree.map(lambda t: t.float().numpy(), p)
    tp = params_from_numpy(cfg, tree, dtype=torch.bfloat16, device="cpu")
    assert tp["groups"][0][0]["ffn"]["router"].dtype == torch.float32
    assert tp["groups"][0][0]["ffn"]["e_up"].dtype == torch.bfloat16


@pytest.fixture(scope="module")
def models():
    return both_models(PHI)


def test_moe_logits_match_jax(models):
    steps, _, _ = forward_steps(models)
    for mode, jl, tl in steps:
        assert tl.dtype == torch.float32 and tl.shape == jl.shape
        np.testing.assert_allclose(tl.numpy(), jl, atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def jax_sched(models, jax_mesh_shim):  # noqa: F811
    return {s: sched_run(PHI, "jax", s, models) for s in STRATEGIES}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_moe_scheduler_runs_match_jax(models, jax_sched, strategy):
    got = sched_run(PHI, "torch", strategy, models)
    assert len(got["done"]) == 6
    assert {"prefill", "mixed", "decode"} <= set(got["phases"])
    assert got == jax_sched[strategy]
