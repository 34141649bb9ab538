"""The port's kernels (PyTorch/CUDA) against the JAX package's.

On the CPU each wrapper runs its plain PyTorch version; those are held
here against the JAX package's jnp references AND its Pallas kernels run
in interpret mode, on the same numpy inputs: fp32, atol = rtol = 1e-5
(summation order differs between the frameworks), appends exactly
equal. Shapes are small (H=8, KV=2, hd=64), with pages of 4 and 16,
ragged context lengths including 0, windows, LSE outputs, prior-only
sweeps and parked slots; the decode and prefill attentions also at rep =
H/KV of 7 (H=14, KV=2, hd=64) and 12 (H=24, KV=2, hd=128), with T=11. The dense causal kernel (K5) is held against
the JAX package's ``ops.flash_prefill`` (its Pallas kernel in interpret
mode) and ``flash_prefill_ref`` at atol 1e-5, and its plain backward
against ``jax.vjp`` of ``flash_prefill_ref`` at atol 1e-4 (gradients sum
T products more than the forward does). The tests marked ``gpu`` launch
the CUDA kernels against the plain versions and skip without a card.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.flash_prefill import kernel as jfk
from repro.kernels.flash_prefill import ref as jfr
from repro.kernels.paged_attention import kernel as jpk
from repro.kernels.paged_attention import ref as jpr
from repro_torch.kernels import _lib
from repro_torch.kernels.flash_prefill import ops as fops
from repro_torch.kernels.flash_prefill import ref as tfr
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.paged_attention import ref as tpr
from repro_torch.models.cache import (attention_with_lse, merge_attention,
                                      paged_gather)

H, KV, HD = 8, 2, 64
TOL = dict(atol=1e-5, rtol=1e-5)


def _case(page, B=3, MB=6, T=8, seed=0, H=H, KV=KV, HD=HD):
    """Seeded inputs: pools, disjoint block tables (the serving
    invariant), queries and new K/V rows."""
    rng = np.random.default_rng(seed)
    nblk = B * MB + 2
    f = np.float32
    return dict(
        kp=rng.standard_normal((nblk, page, KV, HD)).astype(f),
        vp=rng.standard_normal((nblk, page, KV, HD)).astype(f),
        bt=rng.permutation(nblk - 1)[:B * MB].reshape(B, MB).astype(
            np.int32),
        q1=rng.standard_normal((B, H, HD)).astype(f),
        qT=rng.standard_normal((B, T, H, HD)).astype(f),
        new1=rng.standard_normal((2, B, KV, HD)).astype(f),
        newT=rng.standard_normal((2, B, T, KV, HD)).astype(f),
        rng=rng, B=B, MB=MB, T=T, page=page, nblk=nblk)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(port, want, **tol):
    np.testing.assert_allclose(np.asarray(port, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


# ---------------------------------------------------------------------------
# K1 / K3: appends (exactly equal, parked rows on the scratch row)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [4, 16])
def test_append_token_matches_jax(page):
    c = _case(page)
    B, rng = c["B"], c["rng"]
    slots = (c["bt"][:, 0] * page + rng.integers(0, page, B)).astype(
        np.int32)
    slots[1] = -1                                   # parked
    pools = (_t(c["kp"]), _t(c["vp"]))
    ptrs = [p.data_ptr() for p in pools]
    out = pops.paged_append_token(pools, (_t(c["new1"][0]),
                                          _t(c["new1"][1])), _t(slots))
    assert [p.data_ptr() for p in out] == ptrs      # written in place
    want_ref = jpr.paged_append_token_ref(
        (jnp.asarray(c["kp"]), jnp.asarray(c["vp"])),
        tuple(jnp.asarray(x) for x in c["new1"]), jnp.asarray(slots))
    want_ker = jpk.paged_append_token_kernel(
        (jnp.asarray(c["kp"]), jnp.asarray(c["vp"])),
        tuple(jnp.asarray(x) for x in c["new1"]), jnp.asarray(slots),
        interpret=True)
    for got, wr, wk in zip(out, want_ref, want_ker):
        np.testing.assert_array_equal(got.numpy(), np.asarray(wr))
        np.testing.assert_array_equal(got.numpy(), np.asarray(wk))


@pytest.mark.parametrize("page", [4, 16])
def test_append_chunk_matches_jax(page):
    c = _case(page)
    B, T = c["B"], c["T"]
    prior = np.array([0, 5, 13], np.int64)[:B]
    pos = prior[:, None] + np.arange(T)[None]
    slots = (c["bt"][np.arange(B)[:, None], pos // page] * page
             + pos % page).astype(np.int32)
    slots[0, -1] = -1                               # parked
    slots[2, -3:] = -1                              # a padded tail
    pools = (_t(c["kp"]), _t(c["vp"]))
    out = pops.paged_append_chunk(pools, (_t(c["newT"][0]),
                                          _t(c["newT"][1])), _t(slots))
    want_ref = jpr.paged_append_chunk_ref(
        (jnp.asarray(c["kp"]), jnp.asarray(c["vp"])),
        tuple(jnp.asarray(x) for x in c["newT"]), jnp.asarray(slots))
    want_ker = jpk.paged_append_chunk_kernel(
        (jnp.asarray(c["kp"]), jnp.asarray(c["vp"])),
        tuple(jnp.asarray(x) for x in c["newT"]), jnp.asarray(slots),
        interpret=True)
    for got, wr, wk in zip(out, want_ref, want_ker):
        flat = got.numpy().reshape(-1, KV * HD)
        # duplicate parked writes race for the scratch row in every
        # implementation: compare everything else exactly
        np.testing.assert_array_equal(
            flat[:-1], np.asarray(wr).reshape(-1, KV * HD)[:-1])
        np.testing.assert_array_equal(
            flat[:-1], np.asarray(wk).reshape(-1, KV * HD)[:-1])


# ---------------------------------------------------------------------------
# K2: paged decode attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_matches_jax(page, window):
    c = _case(page)
    ctx = np.array([0, 1, c["MB"] * page - 3], np.int32)   # ragged, incl. 0
    args = (c["q1"], c["kp"], c["vp"], c["bt"], ctx)
    got = pops.paged_attention(*map(_t, args), window=window)
    got_o, got_l = pops.paged_attention_with_lse(*map(_t, args),
                                                 window=window)
    ker_o, ker_l = jpk.paged_attention_kernel(
        *map(jnp.asarray, args), window=window, return_lse=True,
        interpret=True)
    ref_o, ref_l = jpr.paged_attention_with_lse_ref(*map(jnp.asarray, args),
                                                    window=window)
    ref_plain = jpr.paged_attention_ref(*map(jnp.asarray, args),
                                        window=window)
    for o in (got, got_o):
        _close(o, ker_o)
        _close(o, ref_o)
        # the jnp oracle without LSE averages V over an empty row; every
        # row with a live key must agree
        _close(o[1:], np.asarray(ref_plain)[1:])
    assert float(got_o[0].abs().max()) == 0.0       # no key: out 0
    _close(got_l, ker_l)
    _close(got_l, ref_l)


# rep = H/KV of 7 and 12: (H, KV, hd)
REPS = {"rep7": (14, 2, 64), "rep12": (24, 2, 128)}


@pytest.mark.parametrize("heads", list(REPS))
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_attention_any_rep_matches_jax(heads, page, window):
    Hr, KVr, hd = REPS[heads]
    c = _case(page, T=11, seed=1, H=Hr, KV=KVr, HD=hd)
    ctx = np.array([0, 1, c["MB"] * page], np.int32)   # 0, 1 and all
    args = (c["q1"], c["kp"], c["vp"], c["bt"], ctx)
    got = pops.paged_attention(*map(_t, args), window=window)
    got_o, got_l = pops.paged_attention_with_lse(*map(_t, args),
                                                 window=window)
    ker_o, ker_l = jpk.paged_attention_kernel(
        *map(jnp.asarray, args), window=window, return_lse=True,
        interpret=True)
    ref_o, ref_l = jpr.paged_attention_with_lse_ref(*map(jnp.asarray, args),
                                                    window=window)
    for o in (got, got_o):
        _close(o, ker_o)
        _close(o, ref_o)
    assert float(got_o[0].abs().max()) == 0.0
    _close(got_l, ker_l)
    _close(got_l, ref_l)


def test_decode_fused_append_matches_jax():
    c = _case(16)
    B, page = c["B"], 16
    ctx = np.array([3, 17, 40], np.int32)
    p = ctx - 1
    slots = (c["bt"][np.arange(B), p // page] * page + p % page).astype(
        np.int32)
    out, kp, vp = pops.paged_attention_decode(
        _t(c["q1"]), _t(c["new1"][0]), _t(c["new1"][1]), _t(c["kp"]),
        _t(c["vp"]), _t(slots), _t(c["bt"]), _t(ctx))
    from repro.kernels.paged_attention.ops import paged_attention_decode
    jo, jk, jv = paged_attention_decode(
        jnp.asarray(c["q1"]), jnp.asarray(c["new1"][0]),
        jnp.asarray(c["new1"][1]), jnp.asarray(c["kp"]),
        jnp.asarray(c["vp"]), jnp.asarray(slots), jnp.asarray(c["bt"]),
        jnp.asarray(ctx), impl="interpret")
    _close(out, jo)
    np.testing.assert_array_equal(kp.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(vp.numpy(), np.asarray(jv))


# ---------------------------------------------------------------------------
# K4: paged flash prefill
# ---------------------------------------------------------------------------

def _jax_sweep(c, q, prior, *, window, prior_only):
    """The Pallas kernel in interpret mode, in its [B,H,T,hd] layout."""
    out, lse = jfk.paged_flash_prefill_kernel(
        jnp.moveaxis(jnp.asarray(q), 1, 2), jnp.asarray(c["kp"]),
        jnp.asarray(c["vp"]), jnp.asarray(c["bt"]), jnp.asarray(prior),
        window=window, blk_q=c["T"], prior_only=prior_only,
        return_lse=True, interpret=True)
    return jnp.moveaxis(out, 2, 1), lse


@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window", [None, 6])
def test_prefill_sweep_matches_jax(page, window):
    c = _case(page)
    prior = np.array([0, 5, c["MB"] * page - c["T"]], np.int32)
    args = (c["qT"], c["kp"], c["vp"], c["bt"], prior)
    got = fops.paged_prefill_sweep_with_lse(*map(_t, args), window=window)
    plain = tfr.paged_flash_prefill_ref(*map(_t, args), window=window)
    ker = _jax_sweep(c, c["qT"], prior, window=window, prior_only=False)
    ref = jfr.paged_prefill_sweep_with_lse_ref(*map(jnp.asarray, args),
                                               window=window)
    ref_plain = jfr.paged_flash_prefill_ref(*map(jnp.asarray, args),
                                            window=window)
    for g, k, r in zip(got, ker, ref):
        _close(g, k)
        _close(g, r)
    _close(plain, ref_plain)


@pytest.mark.parametrize("page", [4, 16])
def test_prefill_prior_only_matches_jax(page):
    c = _case(page)
    prior = np.array([0, 6, 19], np.int32)     # row 0: nothing to attend
    args = (c["qT"], c["kp"], c["vp"], c["bt"], prior)
    got_o, got_l = fops.paged_prefill_sweep_with_lse(*map(_t, args),
                                                     prior_only=True)
    ker_o, ker_l = _jax_sweep(c, c["qT"], prior, window=None,
                              prior_only=True)
    ref_o, ref_l = jfr.paged_prefill_sweep_with_lse_ref(
        *map(jnp.asarray, args), prior_only=True)
    for g, k, r in ((got_o, ker_o, ref_o), (got_l, ker_l, ref_l)):
        _close(g, k)
        _close(g, r)
    assert float(got_o[0].abs().max()) == 0.0


@pytest.mark.parametrize("heads", list(REPS))
@pytest.mark.parametrize("page", [4, 16])
@pytest.mark.parametrize("window,prior_only", [(None, False), (6, False),
                                               (None, True)])
def test_prefill_any_rep_matches_jax(heads, page, window, prior_only):
    """Rep 7 and 12 at a T of 11: the port's sweep (and its plain causal
    op) against the Pallas kernel in interpret mode and the jnp ref."""
    Hr, KVr, hd = REPS[heads]
    c = _case(page, T=11, seed=1, H=Hr, KV=KVr, HD=hd)
    prior = np.array([0, 5, c["MB"] * page - c["T"]], np.int32)
    args = (c["qT"], c["kp"], c["vp"], c["bt"], prior)
    got = fops.paged_prefill_sweep_with_lse(*map(_t, args), window=window,
                                            prior_only=prior_only)
    ker = _jax_sweep(c, c["qT"], prior, window=window,
                     prior_only=prior_only)
    ref = jfr.paged_prefill_sweep_with_lse_ref(
        *map(jnp.asarray, args), window=window, prior_only=prior_only)
    for g, k, r in zip(got, ker, ref):
        _close(g, k)
        _close(g, r)
    if prior_only:
        assert float(got[0][0].abs().max()) == 0.0    # row 0: no prior
    else:
        _close(tfr.paged_flash_prefill_ref(*map(_t, args), window=window),
               jfr.paged_flash_prefill_ref(*map(jnp.asarray, args),
                                           window=window))


def test_paged_flash_prefill_appends_then_sweeps():
    """The serving op: chunk append + causal sweep, against the JAX op
    on its Pallas-interpret path (pools exactly equal)."""
    from repro.kernels.flash_prefill.ops import paged_flash_prefill
    c = _case(4)
    B, T, page = c["B"], c["T"], 4
    prior = np.array([0, 5, 13], np.int32)
    pos = prior[:, None].astype(np.int64) + np.arange(T)[None]
    slots = (c["bt"][np.arange(B)[:, None], pos // page] * page
             + pos % page).astype(np.int32)
    args = (c["qT"], c["newT"][0], c["newT"][1], c["kp"], c["vp"], slots,
            c["bt"], prior)
    out = fops.paged_flash_prefill(*map(_t, args))
    jo, jk, jv = paged_flash_prefill(*map(jnp.asarray, args), blk_q=T,
                                     impl="interpret")
    _close(out, jo)
    # the port appended in place into the tensors it was handed
    kp_t = _t(c["kp"])
    fops.paged_flash_prefill(_t(c["qT"]), _t(c["newT"][0]),
                             _t(c["newT"][1]), kp_t, _t(c["vp"]),
                             _t(slots), _t(c["bt"]), _t(prior))
    np.testing.assert_array_equal(kp_t.numpy(), np.asarray(jk))


def test_causal_sweep_is_chunk_plus_prior_merge():
    """The JAX package's reference chunked prefill: in-chunk causal
    attention LSE-merged with a prior-only sweep. The port's single
    causal sweep must equal that merge."""
    c = _case(16)
    B, T = c["B"], c["T"]
    prior = np.array([1, 9, 30], np.int32)
    pos = prior[:, None].astype(np.int64) + np.arange(T)[None]
    slots = (c["bt"][np.arange(B)[:, None], pos // 16] * 16
             + pos % 16).astype(np.int32)
    kp, vp = _t(c["kp"]), _t(c["vp"])
    k_new, v_new = _t(c["newT"][0]), _t(c["newT"][1])
    tpr.paged_append_chunk_ref((kp, vp), (k_new, v_new), _t(slots))
    q, bt, pr = _t(c["qT"]), _t(c["bt"]), _t(prior)
    one, _ = fops.paged_prefill_sweep_with_lse(q, kp, vp, bt, pr)
    inmask = torch.tril(torch.ones(T, T, dtype=torch.bool))[None, None]
    part_chunk = attention_with_lse(q, k_new, v_new, inmask, HD ** -0.5)
    part_prior = fops.paged_prefill_sweep_with_lse(q, kp, vp, bt, pr,
                                                   prior_only=True)
    _close(one, merge_attention([part_chunk, part_prior]))
    assert paged_gather(kp, bt).shape == (B, c["MB"] * 16, KV, HD)


# ---------------------------------------------------------------------------
# K5: dense causal flash attention, forward and backward
# ---------------------------------------------------------------------------

# (B, T, H, KV, hd, window): rep 1 and 4, T not a multiple of 64, windows,
# hd 64 and 128
DENSE_CASES = [(2, 100, 4, 4, 64, None), (2, 100, 8, 2, 64, 16),
               (1, 128, 8, 2, 128, None), (1, 70, 4, 1, 128, 24)]


def _dense(B, T, H, KV, hd, seed=0):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, T, H, hd)).astype(f),
            rng.standard_normal((B, T, KV, hd)).astype(f),
            rng.standard_normal((B, T, KV, hd)).astype(f),
            rng.standard_normal((B, T, H, hd)).astype(f))


@pytest.mark.parametrize("B,T,H,KV,hd,window", DENSE_CASES)
def test_flash_prefill_forward_matches_jax(B, T, H, KV, hd, window):
    from repro.kernels.flash_prefill.ops import flash_prefill as jax_op
    q, k, v, _ = _dense(B, T, H, KV, hd)
    got = fops.flash_prefill(_t(q), _t(k), _t(v), window=window)
    _close(got, jax_op(*map(jnp.asarray, (q, k, v)), window=window,
                       blk=32))
    _close(got, jfr.flash_prefill_ref(*map(jnp.asarray, (q, k, v)),
                                      window=window))
    # the plain forward's lse is the paged sweep's over a one-page table
    out, lse = tfr.flash_prefill_fwd_ref(_t(q), _t(k), _t(v),
                                         window=window)
    _close(out, got)
    bt = np.arange(B, dtype=np.int32)[:, None]
    _, want_lse = jfr.paged_prefill_sweep_with_lse_ref(
        *map(jnp.asarray, (q, k, v, bt, np.zeros(B, np.int32))),
        window=window)
    _close(lse, want_lse)


@pytest.mark.parametrize("B,T,H,KV,hd,window", DENSE_CASES)
def test_flash_prefill_backward_matches_jax(B, T, H, KV, hd, window):
    q, k, v, do = _dense(B, T, H, KV, hd, seed=1)
    ins = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = fops.flash_prefill(*ins, window=window)
    got = torch.autograd.grad(out, ins, _t(do))
    _, vjp = jax.vjp(lambda *a: jfr.flash_prefill_ref(*a, window=window),
                     *map(jnp.asarray, (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        _close(g, w, atol=1e-4, rtol=0.0)
    # the autograd op's backward is the plain formula
    o, lse = tfr.flash_prefill_fwd_ref(*map(_t, (q, k, v)), window=window)
    for g, w in zip(got, tfr.flash_prefill_bwd_ref(
            *map(_t, (q, k, v)), o, lse, _t(do), window=window)):
        _close(g, w, atol=0.0, rtol=0.0)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain versions and launch nothing
# ---------------------------------------------------------------------------

def test_cpu_dispatch_launches_no_kernel():
    _lib.reset_launches()
    c = _case(4)
    ctx = np.array([2, 3, 4], np.int32)
    pops.paged_attention(_t(c["q1"]), _t(c["kp"]), _t(c["vp"]), _t(c["bt"]),
                         _t(ctx))
    q, k, v, do = (_t(x).requires_grad_(True)
                   for x in _dense(1, 9, 4, 1, 64))
    torch.autograd.grad(fops.flash_prefill(q, k, v), (q, k, v), do)
    assert all(n == 0 for n in _lib.LAUNCHES.values())
    with pytest.raises(ValueError):
        pops.on_cuda(torch.empty(1, device="meta"))
