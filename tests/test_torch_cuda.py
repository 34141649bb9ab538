"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card: the kernels have no CPU mode. Each
decides inside its fixture whether a card is present and skips when
not. The file imports no JAX, so it also runs where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: fp32 atol = rtol = 1e-5 (the kernels sum in another order
than the plain versions), 1e-4 for the dense backward's gradients (each
sums T products of products); bf16 atol 1e-3, rtol 1e-2 (both sides
accumulate in fp32 and round once, so they may differ by one bf16 unit,
a relative 2^-8 to 2^-7); appends bit-exact. The SSD scan (K6) in fp32
at rtol 1e-4 and an atol of 1e-4 times the largest entry of each output
(dA and dt sum many terms that cancel, so fp32 error scales with the
terms, not the result); with bf16 x, B and C its fp32 outputs at the
same tolerance (both sides compute in fp32 from the same bf16 values),
its bf16 gradients one bf16 unit (rtol 1e-2, atol 1e-2 of the largest
entry). The RG-LRU recurrence (K7) at rtol 1e-4 and an atol of 1e-4
times each output's largest entry (da sums up to T products), its bf16
gradients one bf16 unit (rtol 2^-7) more; K6's and K7's forwards from a
carried h0 (serving) at the same tolerances. K5's bf16 kernels run on the
tensor cores with P and dS as bf16 hi + lo halves (16 bits), so they
too round about once: the bf16 tolerance above. Their tile products
and the bf16 training runs state their own bounds. The paged decode (K2,
split-K) and prefill (K4; bf16 on the tensor cores, every other dtype
pair on the CUDA cores) kernels are held at rep = H/KV of 1, 4, 7 and
12, hd 64 and 128 (and hd 256 at rep 16 on one kv head, with a window),
pages of 4, 16 and 128, all four q/pool dtype pairs:
their outputs at the tolerance of q's dtype, their lse (from fp32 q, or
from bf16 q with exact bf16 products) at the fp32 one. The MLA decode
kernel (K2 at MLA width: KV 1, fp32 q over a bf16 or fp32 compressed
pool, fp32 out) at atol = rtol = 1e-4: each score sums W (up to 576)
products and each output up to 4096 weighted keys in another order, and
the scores of the full-width case reach about 25 before the softmax; on
a bf16 pool the tensor cores take q and P as bf16 hi + lo halves (about
16 bits each), whose margin at this tolerance tests/test_torch_mla.py
shows on the CPU (a quarter of it used with q times 4); its LSE at the
same tolerance. The striped pools' stripe partials on the card (K2 and
``mla_decode`` with their LSE) against the plain partials on the CPU:
over fp32 pools the outputs at fp32's tolerance; over bf16 pools at an
atol of 2^-8 of the largest value read (the plain partials round p to
bf16, the kernels do not), lse at fp32's (1e-4: bf16 scores sum exact
products in another order).
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.flash_prefill import kernel as fker
from repro_torch.kernels.flash_prefill import ops as fops
from repro_torch.kernels.flash_prefill import ref as fref
from repro_torch.kernels.paged_attention import ops as pops
from repro_torch.kernels.paged_attention import ref as pref
from repro_torch.kernels.rglru_scan import kernel as rker
from repro_torch.kernels.rglru_scan import ops as rops
from repro_torch.kernels.rglru_scan import ref as rref
from repro_torch.kernels.ssd_scan import kernel as sker
from repro_torch.kernels.ssd_scan import ops as sops
from repro_torch.kernels.ssd_scan import ref as sref

H, KV, HD, B, MB, T = 8, 2, 64, 3, 6, 8


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


def _case(dev, dtype, page, seed=0):
    rng = np.random.default_rng(seed)
    nblk = B * MB + 2

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
    bt = rng.permutation(nblk - 1)[:B * MB].reshape(B, MB)
    return dict(kp=t((nblk, page, KV, HD)), vp=t((nblk, page, KV, HD)),
                q1=t((B, H, HD)), qT=t((B, T, H, HD)),
                new1=(t((B, KV, HD)), t((B, KV, HD))),
                newT=(t((B, T, KV, HD)), t((B, T, KV, HD))),
                bt=torch.from_numpy(bt.astype(np.int32)).to(dev))


def _tol(dtype):
    return dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=1e-3, rtol=1e-2)


def _same_rows(got, want):
    """Pools equal but for the scratch row (parked rows race there)."""
    for g, w in zip(got, want):
        assert torch.equal(g.view(-1, KV * HD)[:-1], w.view(-1, KV * HD)[:-1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 5])
def test_decode_kernels_match_plain(cuda, dtype, window):
    c = _case(cuda, dtype, 16)
    ctx = torch.tensor([0, 1, 93], dtype=torch.int32, device=cuda)
    got = pops.paged_attention_with_lse(c["q1"], c["kp"], c["vp"], c["bt"],
                                        ctx, window=window)
    want = pref.paged_attention_with_lse_ref(c["q1"].float(), c["kp"],
                                             c["vp"], c["bt"], ctx,
                                             window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(torch.float32))
    slots = torch.tensor([5, -1, 77], dtype=torch.int32, device=cuda)
    ptr = c["kp"].data_ptr()
    got = pops.paged_append_token((c["kp"].clone(), c["vp"].clone()),
                                  c["new1"], slots)
    want = pref.paged_append_token_ref((c["kp"].clone(), c["vp"].clone()),
                                       c["new1"], slots)
    _same_rows(got, want)
    out, kp, _ = pops.paged_attention_decode(
        c["q1"], *c["new1"], c["kp"], c["vp"], slots, c["bt"], ctx + 1,
        window=window)
    assert kp.data_ptr() == ptr                     # written in place
    torch.testing.assert_close(
        out, pref.paged_attention_ref(c["q1"], c["kp"], c["vp"], c["bt"],
                                      ctx + 1, window=window),
        **_tol(dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,prior_only", [(None, False), (6, False),
                                               (None, True)])
def test_prefill_kernels_match_plain(cuda, dtype, window, prior_only):
    c = _case(cuda, dtype, 4)
    prior = torch.tensor([0, 5, 13], dtype=torch.int32, device=cuda)
    got = fops.paged_prefill_sweep_with_lse(
        c["qT"], c["kp"], c["vp"], c["bt"], prior, window=window,
        prior_only=prior_only)
    want = fref.paged_prefill_sweep_with_lse_ref(
        c["qT"].float(), c["kp"], c["vp"], c["bt"], prior, window=window,
        prior_only=prior_only)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **_tol(torch.float32))
    pos = prior[:, None].long() + torch.arange(T, device=cuda)
    slots = (c["bt"].long().gather(1, pos // 4) * 4 + pos % 4).int()
    slots[0, -1] = -1
    got = pops.paged_append_chunk((c["kp"].clone(), c["vp"].clone()),
                                  c["newT"], slots)
    want = pref.paged_append_chunk_ref((c["kp"].clone(), c["vp"].clone()),
                                       c["newT"], slots)
    _same_rows(got, want)


# rep = H/KV of 1, 4, 7 and 12 at hd 64 and 128: (H, KV)
ANY_REP = {"rep1": (4, 4), "rep4": (8, 2), "rep7": (14, 2), "rep12": (24, 2)}
DTYPE_PAIRS = {"f32-f32": (torch.float32, torch.float32),
               "f32-bf16": (torch.float32, torch.bfloat16),
               "bf16-f32": (torch.bfloat16, torch.float32),
               "bf16-bf16": (torch.bfloat16, torch.bfloat16)}
# pages and block-table widths: 160 to 384 key positions a request
PAGES = ((4, 40), (16, 20), (128, 3))


def _paged(dev, H_, KV_, hd, page, MB_, qdt, kvdt, T_=1, seed=2):
    """Seeded pools (3 requests, disjoint tables), q [3,H,hd] and qT
    [3,T,H,hd]."""
    rng = np.random.default_rng(seed)
    nblk = 3 * MB_ + 2

    def t(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape)).to(dev, dtype)
    bt = rng.permutation(nblk - 1)[:3 * MB_].reshape(3, MB_)
    return dict(kp=t((nblk, page, KV_, hd), kvdt),
                vp=t((nblk, page, KV_, hd), kvdt), q1=t((3, H_, hd), qdt),
                qT=t((3, T_, H_, hd), qdt),
                bt=torch.from_numpy(bt.astype(np.int32)).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(DTYPE_PAIRS))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("heads", list(ANY_REP))
def test_decode_any_rep_matches_plain(cuda, heads, hd, pair):
    """K2 against its plain version: contexts 0, 1 and MB * page (the
    whole table), with and without a window of 37, with lse, split as
    the wrapper splits (several splits here) and unsplit."""
    from repro_torch.kernels.paged_attention import kernel as pker
    H_, KV_ = ANY_REP[heads]
    qdt, kvdt = DTYPE_PAIRS[pair]
    for page, MB_ in PAGES:
        c = _paged(cuda, H_, KV_, hd, page, MB_, qdt, kvdt)
        ctx = torch.tensor([0, 1, MB_ * page], dtype=torch.int32,
                           device=cuda)
        assert pker.decode_splits(3, KV_, H_ // KV_, MB_ * page,
                                  cuda)[0] > 1
        for window in (None, 37):
            args = (c["q1"], c["kp"], c["vp"], c["bt"], ctx)
            for splits in (None, 1):
                got = pker.paged_attention_kernel(*args, window=window,
                                                  splits=splits)
                want = pref.paged_attention_ref(*args, window=window)
                torch.testing.assert_close(got, want, **_tol(qdt))
                assert float(got[0].abs().max()) == 0.0
                o, lse = pker.paged_attention_kernel(
                    *args, window=window, splits=splits, return_lse=True)
                wo, wl = pref.paged_attention_with_lse_ref(
                    c["q1"].float(), *args[1:], window=window)
                torch.testing.assert_close(o.float(), wo, **_tol(qdt))
                torch.testing.assert_close(lse, wl, **_tol(torch.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(DTYPE_PAIRS))
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("heads", list(ANY_REP))
def test_prefill_any_rep_matches_plain(cuda, heads, hd, pair):
    """K4 against its plain version at a ragged T of 70 (rep * 70 packed
    rows: 70 to 840, never a multiple of 64), priors 0, 5 and MB * page
    - T (the last request's context is the whole table): the causal
    sweep, a window of 37, and prior_only (nothing to attend for the
    first request), each with its lse."""
    H_, KV_ = ANY_REP[heads]
    qdt, kvdt = DTYPE_PAIRS[pair]
    T_ = 70
    for page, MB_ in PAGES:
        c = _paged(cuda, H_, KV_, hd, page, MB_, qdt, kvdt, T_=T_)
        prior = torch.tensor([0, 5, MB_ * page - T_], dtype=torch.int32,
                             device=cuda)
        args = (c["qT"], c["kp"], c["vp"], c["bt"], prior)
        for window, prior_only in ((None, False), (37, False), (None, True)):
            o, lse = fker.paged_flash_prefill_kernel(
                *args, window=window, prior_only=prior_only,
                return_lse=True)
            wo, wl = fref.paged_prefill_sweep_with_lse_ref(
                c["qT"].float(), *args[1:], window=window,
                prior_only=prior_only)
            assert o.dtype == qdt
            torch.testing.assert_close(o.float(), wo, **_tol(qdt))
            torch.testing.assert_close(lse, wl, **_tol(torch.float32))
            if prior_only:
                assert float(o[0].abs().max()) == 0.0
                assert bool((lse[0] < -1e38).all())
            else:
                torch.testing.assert_close(
                    fker.paged_flash_prefill_kernel(*args, window=window),
                    fref.paged_flash_prefill_ref(*args, window=window),
                    **_tol(qdt))


@pytest.mark.gpu
def test_paged_attention_kernels_are_deterministic(cuda):
    """Two calls of each give the same bits: K2's split merge sums the
    partials in split order, whichever block takes the last ticket, and
    K4 has no atomics. K2's split and unsplit results agree to fp32
    rounding."""
    from repro_torch.kernels.paged_attention import kernel as pker
    c = _paged(cuda, 32, 8, 128, 16, 24, torch.bfloat16, torch.bfloat16,
               T_=100)
    ctx = torch.tensor([383, 1, 170], dtype=torch.int32, device=cuda)
    args = (c["q1"], c["kp"], c["vp"], c["bt"], ctx)
    assert pker.decode_splits(3, 8, 4, 24 * 16, cuda)[0] > 1
    a = pker.paged_attention_kernel(*args, return_lse=True)
    b = pker.paged_attention_kernel(*args, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    split = pker.paged_attention_kernel(c["q1"].float(), *args[1:],
                                        return_lse=True)
    whole = pker.paged_attention_kernel(c["q1"].float(), *args[1:],
                                        return_lse=True, splits=1)
    for x, y in zip(split, whole):
        torch.testing.assert_close(x, y, **_tol(torch.float32))
    prior = torch.tensor([0, 200, 284], dtype=torch.int32, device=cuda)
    pargs = (c["qT"], c["kp"], c["vp"], c["bt"], prior)
    a = fker.paged_flash_prefill_kernel(*pargs, return_lse=True)
    b = fker.paged_flash_prefill_kernel(*pargs, return_lse=True)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
def test_empty_lanes_never_reach_a_live_row(cuda):
    """The live lanes' empty rows: K2's ``return_lse`` row at context 0
    and K4's ``prior_only`` row at prior 0 give out 0 and an lse at most
    NEG_INF / 2; ``_seg_scatter`` masks such rows to exactly 0 and
    NEG_INF whatever the kernel wrote (NaN and +inf included), so a row
    merged with a live lane equals that lane alone; and a live decode
    over two lanes, each empty in some rows, gives on the card what the
    plain versions give on the CPU."""
    from repro_torch.core.views import TPContext
    from repro_torch.models.cache import (NEG_INF, LiveDecodeBackend,
                                          _merge_sweeps, _seg_scatter)
    H_, KV_, hd, page, MB_ = 8, 2, 64, 4, 5
    c = _paged(cuda, H_, KV_, hd, page, MB_, torch.float32, torch.bfloat16,
               T_=3)
    zero = torch.zeros(3, dtype=torch.int32, device=cuda)
    live = torch.tensor([0, 9, 0], dtype=torch.int32, device=cuda)
    full = torch.tensor([5, 3, 7], dtype=torch.int32, device=cuda)

    def k2(n):
        return pops.paged_attention_with_lse(c["q1"], c["kp"], c["vp"],
                                             c["bt"], n)

    def k4(n):
        return fops.paged_prefill_sweep_with_lse(
            c["qT"], c["kp"], c["vp"], c["bt"], n, prior_only=True)
    for name, sweep, axis in (("K2", k2, 1), ("K4", k4, 2)):
        o, lse = sweep(live)
        empty = live == 0
        assert float(o[empty].abs().max()) == 0.0, name
        assert bool((lse[empty] <= NEG_INF / 2).all()), name
        # the worst a kernel could leave in an empty row
        bad_o, bad_l = o.clone(), lse.clone()
        bad_o[empty], bad_l[empty] = float("nan"), float("inf")
        parts = [_seg_scatter(x, l, zero, live > 0, H_, axis)
                 for x, l in ((bad_o, bad_l), (o, lse))]
        for x, l in parts:
            assert bool((x[empty] == 0).all()) and \
                bool((l[empty] == NEG_INF).all()), name
        other = _seg_scatter(*sweep(full), zero, full > 0, H_, axis)
        m, ws, den = _merge_sweeps([parts[0], other])
        w = ws if axis == 1 else ws.transpose(2, 3)
        merged = sum(x * wi[..., None] for (x, _), wi in
                     zip([parts[0], other], w))
        ln = den if axis == 1 else den.transpose(1, 2)
        merged = merged / ln[..., None]
        assert bool(torch.isfinite(merged).all()), name
        torch.testing.assert_close(merged[empty], other[0][empty],
                                   **_tol(torch.float32))

    def decode(dev):
        bt = c["bt"].to(dev)
        lanes = ((1, bt[:, :2], torch.tensor([0, 6, 8]), ),
                 (1, bt[:, 2:], torch.tensor([7, 0, 5]), ))
        segs = tuple((t, b, n.to(dev, torch.int32),
                      torch.zeros(3, dtype=torch.int32, device=dev))
                     for t, b, n in lanes)
        backend = LiveDecodeBackend(
            ctx=TPContext(), slots=torch.tensor(
                [-1, int(bt[1, 1]) * page + 2, -1], dtype=torch.int32,
                device=dev), segs=segs, merge=1, block_base=page)
        kp, vp = c["kp"].to(dev).clone(), c["vp"].to(dev).clone()
        new = torch.randn((3, 1, KV_, hd), generator=torch.Generator(
            ).manual_seed(9)).to(dev)
        out, _ = backend.attend((kp, vp), c["q1"].to(dev)[:, None], new,
                                -new, positions=None)
        return out, kp
    _lib.reset_launches()
    on_card, kp_card = decode(cuda)
    assert _lib.LSE_LAUNCHES["paged_attention"] == 2
    on_cpu, kp_cpu = decode("cpu")
    assert bool(torch.isfinite(on_card).all())
    torch.testing.assert_close(on_card.cpu(), on_cpu, **_tol(torch.float32))
    n = kp_card.shape[0] - 1
    assert torch.equal(kp_card[:n].cpu(), kp_cpu[:n])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bd,Td,Hd,KVd,hdd,window", [
    (2, 100, 8, 2, 64, None), (2, 100, 8, 2, 64, 16),
    (1, 130, 4, 4, 128, None), (1, 70, 4, 1, 128, 24),
    (2, 100, 16, 1, 256, None), (1, 150, 16, 1, 256, 40),
    (2, 1, 8, 8, 128, None), (2, 63, 8, 1, 128, None),
    (3, 65, 8, 2, 64, None), (2, 200, 16, 2, 128, 24),
    (2, 65, 16, 1, 256, 40), (2, 200, 8, 1, 256, None),
    (2, 100, 14, 2, 64, None), (2, 130, 96, 8, 128, 40)])
def test_dense_flash_kernels_match_plain(cuda, dtype, Bd, Td, Hd, KVd, hdd,
                                         window):
    """K5 forward and backward against their plain versions (fp32: the
    CUDA-core kernels; bf16: the tensor-core kernels): T of 1, 63, 65,
    70, 100, 130, 150 and 200, so that 64-row tiles are ragged and, with
    B >= 2, a tile's rows would run into the next batch row; rep 1, 4, 8
    and 16 (at hd 256 with one kv head the bf16 dK/dV kernel splits the
    heads into groups of partial sums); windows of 16, 24 and 40 that cut
    inside a 64-key tile; hd 64, 128 and 256; rep 7 (H 14, KV 2, hd 64)
    and 12 (H 96, KV 8, hd 128), which do not divide a block's 64 rows,
    so that the fp32 kernels' blocks idle their last rows (64 - 63 and
    64 - 60). The backward from the same
    (out, lse), and through the autograd op (one launch of each, the
    same gradients to the bit: the backward has no atomics)."""
    rng = np.random.default_rng(1)

    def t(shape):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dtype)
    q, do = t((Bd, Td, Hd, hdd)), t((Bd, Td, Hd, hdd))
    k, v = t((Bd, Td, KVd, hdd)), t((Bd, Td, KVd, hdd))
    out, lse = fker.flash_prefill_kernel(q, k, v, window=window)
    want_o, want_l = fref.flash_prefill_fwd_ref(q, k, v, window=window)
    torch.testing.assert_close(out, want_o, **_tol(dtype))
    torch.testing.assert_close(lse, want_l, **_tol(torch.float32))
    got = fker.flash_prefill_bwd_kernel(q, k, v, out, lse, do, window=window)
    want = fref.flash_prefill_bwd_ref(q, k, v, out, lse, do, window=window)
    for g, w in zip(got, want):
        torch.testing.assert_close(
            g, w, **(dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
                     else _tol(dtype)))
    _lib.reset_launches()
    ins = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fops.flash_prefill(*ins, window=window)
    for g, w in zip(torch.autograd.grad(o, ins, do), got):
        torch.testing.assert_close(g, w, atol=0.0, rtol=0.0)
    assert _lib.LAUNCHES["flash_prefill"] == 1
    assert _lib.LAUNCHES["flash_prefill_bwd"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("H,hd,rows", [(65, 64, 64), (33, 256, 32)])
def test_dense_flash_fp32_refuses_rep_above_a_block(cuda, H, hd, rows):
    """K5's fp32 route holds every query head of a kv head in one block
    of 64 rows (32 at hd 256): a rep above that raises, naming it; the
    bf16 route takes it."""
    q = torch.zeros((1, 4, H, hd), device=cuda)
    k = torch.zeros((1, 4, 1, hd), device=cuda)
    with pytest.raises(ValueError, match=f"at most {rows}"):
        fker.flash_prefill_kernel(q, k, k)
    out, _ = fker.flash_prefill_kernel(q.bfloat16(), k.bfloat16(),
                                       k.bfloat16())
    assert out.shape == q.shape


@pytest.mark.gpu
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_tile_products_match_matmul(cuda, hd):
    """The bf16 K5 kernels' tile machinery (csrc/hopper.cuh) on one tile
    pair against torch.matmul in fp32: a b^T with both operands K-major
    in swizzled shared memory (S = Q K^T, dP = dO V^T), and a b with a
    split into bf16 hi + lo register fragments and b N-major (P V, dS K,
    P^T dO, dS^T Q). Each entry is held to a bound on its rounding: the
    bf16 operands' products are exact in fp32, so a b^T may differ only
    by fp32 summation, hd units of 2^-24 of sum |a||b|; hi + lo keeps 16
    bits of a, so a b may differ by 2^-16 of sum |a||b| (twice the
    splitting's 2^-17)."""
    rng = np.random.default_rng(3)

    def t(shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dtype)
    a, b = t((64, hd)), t((64, hd))
    got = fker.flash_tile_check(a, b, 0)
    want = a.float() @ b.float().T
    lim = (a.float().abs() @ b.float().abs().T) * hd * 2.0 ** -24
    assert ((got - want).abs() <= lim).all()
    a = t((64, 64), torch.float32)
    got = fker.flash_tile_check(a, b, 1)
    want = a @ b.float()
    lim = (a.abs() @ b.float().abs()) * 2.0 ** -16
    assert ((got - want).abs() <= lim).all()


def _ssd_close(got, want):
    """chip_smoke.py's K6 tolerance: atol 1e-4 of the largest entry, and
    rtol 1e-4 in fp32 or 2**-7 (one bf16 unit at most) for bf16 outputs."""
    scale = float(want.float().abs().max())
    rtol = 1e-4 if got.dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                               atol=1e-4 * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bs,T,H,hd,S,chunk", [
    (2, 100, 3, 32, 32, 32), (1, 96, 2, 64, 128, 128),
    (2, 256, 4, 64, 128, 128), (1, 64, 2, 32, 128, 16)])
def test_ssd_kernels_match_plain(cuda, dtype, Bs, T, H, hd, S, chunk):
    """K6 forward (y, hT, per-chunk states) and backward (dx, ddt, dA,
    dB, dC) against their plain versions, then through the autograd op
    with T padded (one launch of each)."""
    rng = np.random.default_rng(7)
    ch = min(chunk, T)
    Tp = T + (-T) % ch

    def t(shape, scale=1.0, dt_=dtype):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            cuda, dt_)
    x, B, C = t((Bs, Tp, H, hd)), t((Bs, Tp, S), 0.5), t((Bs, Tp, S), 0.5)
    dt = torch.nn.functional.softplus(t((Bs, Tp, H), dt_=torch.float32))
    A = -torch.exp(t((H,), dt_=torch.float32))
    dy = t((Bs, Tp, H, hd), dt_=torch.float32)
    y, hT, st = sker.ssd_scan_kernel(x, dt, A, B, C, chunk=ch)
    wy, wh, wst = sref.ssd_scan_fwd_ref(x, dt, A, B, C, chunk=ch)
    for g, w in ((y, wy), (hT, wh), (st, wst)):
        torch.testing.assert_close(g, w.contiguous(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()))
    got = sker.ssd_scan_bwd_kernel(x, dt, A, B, C, st, dy, chunk=ch)
    want = sref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk=ch)
    for g, w, src in zip(got, want, (x, dt, A, B, C)):
        assert g.dtype == src.dtype and g.shape == src.shape
        _ssd_close(g, w)
    _lib.reset_launches()
    ins = [a[:, :T].clone().requires_grad_(True) if a.dim() > 1
           else a.clone().requires_grad_(True) for a in (x, dt, A, B, C)]
    yo, _ = sops.ssd_scan(*ins, chunk=chunk)
    torch.testing.assert_close(yo, y[:, :T], rtol=0.0, atol=0.0)
    torch.autograd.grad(yo, ins, dy[:, :T])
    assert _lib.LAUNCHES["ssd_scan"] == 1
    assert _lib.LAUNCHES["ssd_scan_bwd"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("Bs,T,H,hd,S,chunk,group", [
    (2, 512, 12, 64, 128, 128, 4), (1, 384, 7, 32, 32, 128, 3),
    (2, 200, 5, 64, 32, 100, 2), (1, 256, 6, 32, 128, 64, None)])
def test_ssd_bf16_backward_matches_plain(cuda, Bs, T, H, hd, S, chunk,
                                         group):
    """K6's bf16 backward (the tensor-core kernels) at several chunks and
    head groups, a ragged head group among them, against autograd
    through the chunked form and against the plain mirror of its own
    algebra (``ssd_scan_bwd_chunks_ref``), at ``_ssd_close``; dy in fp32
    (its lo halves nonzero) and in bf16 values (none), as in training."""
    rng = np.random.default_rng(11)

    def t(shape, scale=1.0, dt_=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            cuda, dt_)
    x, B, C = t((Bs, T, H, hd)), t((Bs, T, S), 0.5), t((Bs, T, S), 0.5)
    dt = torch.nn.functional.softplus(t((Bs, T, H), dt_=torch.float32))
    A = -torch.exp(t((H,), dt_=torch.float32))
    for dy in (t((Bs, T, H, hd), dt_=torch.float32),
               t((Bs, T, H, hd)).float()):
        _, _, st = sker.ssd_scan_kernel(x, dt, A, B, C, chunk=chunk)
        got = sker.ssd_scan_bwd_kernel(x, dt, A, B, C, st, dy, chunk=chunk,
                                       group=group)
        want = sref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk=chunk)
        mirror = sref.ssd_scan_bwd_chunks_ref(x, dt, A, B, C, dy,
                                              chunk=chunk, group=group or 8)
        for g, w, m, src in zip(got, want, mirror, (x, dt, A, B, C)):
            assert g.dtype == src.dtype and g.shape == src.shape
            _ssd_close(g, w)
            _ssd_close(g, m)


@pytest.mark.gpu
@pytest.mark.parametrize("Bs,T,H,hd,S,chunk,group", [
    (2, 512, 12, 64, 128, 128, 4), (1, 384, 7, 32, 32, 128, 3),
    (2, 200, 5, 64, 32, 100, 2), (1, 256, 6, 32, 128, 64, None)])
def test_ssd_bf16_forward_matches_plain(cuda, Bs, T, H, hd, S, chunk,
                                        group):
    """K6's bf16 forward (the tensor-core kernels) at several chunks and
    head groups, a ragged head group among them: y, hT and the per-chunk
    states against the chunked form and against the plain mirror of its
    own algebra (``ssd_scan_fwd_chunks_ref``), at ``_ssd_close``; then the
    bf16 backward fed those states, against autograd."""
    rng = np.random.default_rng(13)

    def t(shape, scale=1.0, dt_=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            cuda, dt_)
    x, B, C = t((Bs, T, H, hd)), t((Bs, T, S), 0.5), t((Bs, T, S), 0.5)
    dt = torch.nn.functional.softplus(t((Bs, T, H), dt_=torch.float32))
    A = -torch.exp(t((H,), dt_=torch.float32))
    dy = t((Bs, T, H, hd), dt_=torch.float32)
    got = sker.ssd_scan_kernel(x, dt, A, B, C, chunk=chunk, group=group)
    want = sref.ssd_scan_fwd_ref(x, dt, A, B, C, chunk=chunk)
    mirror = sref.ssd_scan_fwd_chunks_ref(x, dt, A, B, C, chunk=chunk,
                                          group=group or 8)
    for g, w, m in zip(got, want, mirror):
        assert g.dtype == torch.float32 and g.shape == w.shape
        _ssd_close(g, w)
        _ssd_close(g, m)
    grads = sker.ssd_scan_bwd_kernel(x, dt, A, B, C, got[2], dy,
                                     chunk=chunk, group=group)
    wants = sref.ssd_scan_bwd_ref(x, dt, A, B, C, dy, chunk=chunk)
    for g, w in zip(grads, wants):
        _ssd_close(g, w)


@pytest.mark.gpu
def test_ssd_bf16_forward_is_deterministic(cuda):
    """Two calls of K6's bf16 forward give the same bits: every sum in a
    fixed order, no atomics."""
    rng = np.random.default_rng(14)
    Bs, T, H, hd, S = 2, 512, 10, 64, 128

    def t(shape, dt_=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt_)
    x, B, C = t((Bs, T, H, hd)), t((Bs, T, S)), t((Bs, T, S))
    dt = torch.nn.functional.softplus(t((Bs, T, H), torch.float32))
    A = -torch.exp(t((H,), torch.float32))
    a = sker.ssd_scan_kernel(x, dt, A, B, C, chunk=128, group=3)
    b = sker.ssd_scan_kernel(x, dt, A, B, C, chunk=128, group=3)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.gpu
def test_ssd_bf16_backward_is_deterministic(cuda):
    """Two calls of K6's bf16 backward give the same bits: dB and dC sum
    the head groups' parts in group order, dA the chunks' parts in a
    fixed order; no atomics."""
    rng = np.random.default_rng(12)
    Bs, T, H, hd, S = 2, 512, 10, 64, 128

    def t(shape, dt_=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dt_)
    x, B, C = t((Bs, T, H, hd)), t((Bs, T, S)), t((Bs, T, S))
    dt = torch.nn.functional.softplus(t((Bs, T, H), torch.float32))
    A = -torch.exp(t((H,), torch.float32))
    dy = t((Bs, T, H, hd), torch.float32)
    _, _, st = sker.ssd_scan_kernel(x, dt, A, B, C, chunk=128)
    a = sker.ssd_scan_bwd_kernel(x, dt, A, B, C, st, dy, chunk=128, group=3)
    b = sker.ssd_scan_bwd_kernel(x, dt, A, B, C, st, dy, chunk=128, group=3)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("vdt,pdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16), (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("KV_,hd_", [(2, 64), (8, 128), (3, 12)])
def test_appends_bit_exact_at_odd_rows(cuda, vdt, pdt, KV_, hd_):
    """K1 and K3 at odd row counts (7 tokens; 3 x 5 chunk rows) with
    parked rows, every value/pool dtype pair (the casts round as torch's
    ``.to``), rows of 128 elements (several rows a block), of 1024 and of
    36 (not a multiple of a 16-byte vector: the scalar route): bit-exact
    against the plain versions, but for the scratch row."""
    from repro_torch.kernels.paged_attention import kernel as pker
    rng = np.random.default_rng(13)
    nblk, page = 9, 4
    w = KV_ * hd_

    def t(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dtype)
    for kern, plain, shape in (
            (pker.paged_append_token_kernel, pref.paged_append_token_ref,
             (7,)),
            (pker.paged_append_chunk_kernel, pref.paged_append_chunk_ref,
             (3, 5))):
        n = int(np.prod(shape))
        s = rng.choice((nblk - 1) * page, size=n, replace=False)
        s[[1, n - 2]] = -1                                  # parked rows
        slots = torch.from_numpy(s.reshape(shape).astype(np.int32)).to(cuda)
        vals = (t(shape + (KV_, hd_), vdt), t(shape + (KV_, hd_), vdt))
        base = (t((nblk, page, KV_, hd_), pdt), t((nblk, page, KV_, hd_), pdt))
        got = kern(tuple(p.clone() for p in base), vals, slots)
        want = plain(tuple(p.clone() for p in base), vals, slots)
        for g, wt in zip(got, want):
            assert torch.equal(g.view(-1, w)[:-1], wt.view(-1, w)[:-1])


@pytest.mark.gpu
@pytest.mark.parametrize("vdt,pdt", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("w", [576, 80, 48, 36])
def test_one_pool_appends_bit_exact(cuda, vdt, pdt, w):
    """K1 and K3's one-pool form (the compressed MLA cache, entries of
    width 576, 80 and 48; 36 takes the scalar route) with parked rows:
    bit-exact against the plain versions, but for the scratch row."""
    from repro_torch.kernels.paged_attention import kernel as pker
    rng = np.random.default_rng(17)
    nblk, page = 9, 16

    def t(shape, dtype):
        return torch.from_numpy(rng.standard_normal(shape)).to(cuda, dtype)
    for kern, plain, shape in (
            (pker.paged_append_token_kernel, pref.paged_append_token_ref,
             (7,)),
            (pker.paged_append_chunk_kernel, pref.paged_append_chunk_ref,
             (3, 5))):
        n = int(np.prod(shape))
        s = rng.choice((nblk - 1) * page, size=n, replace=False)
        s[[1, n - 2]] = -1                                  # parked rows
        slots = torch.from_numpy(s.reshape(shape).astype(np.int32)).to(cuda)
        vals = (t(shape + (w,), vdt),)
        base = t((nblk, page, w), pdt)
        (got,) = kern((base.clone(),), vals, slots)
        (want,) = plain((base.clone(),), vals, slots)
        assert torch.equal(got.view(-1, w)[:-1], want.view(-1, w)[:-1])


def mla_case(dev, B, H, W, page, max_ctx, pdt, seed=0, scale=None):
    """Inputs of the MLA decode kernel: q_cat [B,H,W] fp32 N(0, 1), a
    compressed pool [nblk,page,W] of N(0, 1) entries in ``pdt``, disjoint
    block tables and contexts drawn in [1, max_ctx] (the last row at
    max_ctx)."""
    rng = np.random.default_rng(seed)
    MB_ = -(-max_ctx // page)
    nblk = B * MB_ + 1
    q = torch.from_numpy(rng.standard_normal((B, H, W))).float().to(dev)
    pool = torch.from_numpy(rng.standard_normal((nblk, page, W))).to(
        dev, pdt)
    bt = rng.permutation(nblk - 1)[:B * MB_].reshape(B, MB_)
    ctx = rng.integers(1, max_ctx + 1, B)
    ctx[-1] = max_ctx
    return (q, pool, torch.from_numpy(bt.astype(np.int32)).to(dev),
            torch.from_numpy(ctx.astype(np.int32)).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize(
    "B_,H_,W,R,page,max_ctx,window,splits,q_mul,ctx0", [
        (8, 128, 576, 512, 16, 4096, None, None, 1, False),  # DeepSeek-V2
        (8, 128, 576, 512, 16, 4096, 700, None, 1, False),
        (3, 128, 576, 576, 32, 300, None, 3, 1, False),  # R = W
        (4, 4, 80, 64, 16, 100, None, None, 1, False),   # the reduced config
        (2, 8, 48, 32, 8, 32, None, 1, 1, False),        # the Pallas test's
        (5, 40, 96, 64, 16, 333, 50, 4, 1, False),       # ragged head groups
        (3, 8, 40, 24, 16, 200, None, 2, 1, False),      # W off the k step
        (4, 64, 576, 512, 16, 1000, None, None, 1, False),  # a merge-2 rank
        (2, 129, 576, 512, 16, 500, None, 2, 1, False),  # 1 head in a block
        (4, 16, 576, 512, 16, 300, 45, 3, 1, False),     # window mid-tile
        (3, 16, 576, 512, 16, 200, None, 2, 1, True),    # a row at context 0
        (8, 128, 576, 512, 16, 4096, None, None, 4, False),  # wide scores
    ])
def test_mla_decode_matches_plain(cuda, pdt, B_, H_, W, R, page, max_ctx,
                                  window, splits, q_mul, ctx0):
    """K2 at MLA width (the one compressed pool viewed as KV 1, fp32 q,
    out [B,H,R]) against ``paged_mla_attention_ref``, with and without a
    window, split and whole; bf16 pools run ``decode_tc`` (tensor cores),
    fp32 pools ``decode`` (CUDA cores). The cases reach the tensor-core
    kernel's edges: W not a multiple of its k step of 16, 64 heads (one
    block), 129 (one live head in the last block), a window that starts
    inside a 32-key tile, a row with no key (zeros), q times 4 (scores
    wide enough to test the hi + lo split of q). The ticket counters are
    left zero."""
    from repro_torch.kernels.paged_attention import kernel as pker
    q, pool, bt, ctx = mla_case(cuda, B_, H_, W, page, max_ctx, pdt)
    q = q * q_mul
    if ctx0:
        ctx[0] = 0
    scale = W ** -0.5
    got = pker.paged_mla_attention_kernel(q, pool, bt, ctx, R=R,
                                          window=window,
                                          softmax_scale=scale, splits=splits)
    want = pref.paged_mla_attention_ref(q, pool, bt, ctx, R=R, window=window,
                                        softmax_scale=scale)
    torch.cuda.synchronize()
    assert got.shape == (B_, H_, R) and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    if ctx0:
        assert int(got[0].count_nonzero()) == 0
    counters = pker._COUNTERS.get(q.device)
    assert counters is None or int(counters.abs().sum()) == 0


@pytest.mark.gpu
@pytest.mark.parametrize("pdt,want,other", [
    (torch.bfloat16, ("decode_tc",), ("mla::decode<", "mla6decodeI")),
    (torch.float32, ("mla::decode<", "mla6decodeI"), ("decode_tc",))])
def test_mla_decode_route_by_pool_dtype(cuda, pdt, want, other):
    """A bf16 pool runs the tensor-core kernel and nothing else, an fp32
    pool the CUDA-core one: the kernel names in torch.profiler's CUDA
    events (demangled or not) over three calls."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.paged_attention import kernel as pker
    q, pool, bt, ctx = mla_case(cuda, 2, 128, 576, 16, 300, pdt)
    pker.paged_mla_attention_kernel(q, pool, bt, ctx, R=512)
    torch.cuda.synchronize()
    _lib.reset_launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            pker.paged_mla_attention_kernel(q, pool, bt, ctx, R=512)
        torch.cuda.synchronize()
    assert _lib.LAUNCHES["mla_decode"] == 3
    names = [e.key for e in prof.key_averages()]
    assert [n for n in names if any(w in n for w in want)], names
    assert not [n for n in names if any(o in n for o in other)], names


@pytest.mark.gpu
def test_mla_decode_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels.paged_attention import kernel as pker
    q, pool, bt, ctx = mla_case(cuda, 2, 4, 80, 16, 40, torch.bfloat16)
    for kw, what in ((dict(q_cat=q.bfloat16(), R=64), TypeError),
                     (dict(q_cat=q, R=60), ValueError),
                     (dict(q_cat=q, R=88), ValueError)):
        with pytest.raises(what):
            pker.paged_mla_attention_kernel(kw["q_cat"], pool, bt, ctx,
                                            R=kw["R"])
    wide = torch.zeros((3, 16, 584), device=cuda)
    with pytest.raises(ValueError):
        pker.paged_mla_attention_kernel(
            torch.zeros((2, 4, 584), device=cuda), wide, bt, ctx, R=512)


@pytest.mark.gpu
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B_,H_,W,R,page,max_ctx,window,splits,ctx0", [
    (8, 128, 576, 512, 16, 4096, None, None, False),  # DeepSeek-V2, split
    (4, 64, 576, 512, 16, 300, 45, 1, True),  # whole, window, empty row
    (4, 4, 80, 64, 16, 100, None, 2, False),  # the reduced config
    (2, 129, 576, 512, 16, 500, None, 2, True),  # 1 head in a block
])
def test_mla_decode_lse_matches_plain(cuda, pdt, B_, H_, W, R, page, max_ctx,
                                      window, splits, ctx0):
    """``mla_decode`` with ``return_lse`` on both routes (bf16 pools:
    ``decode_tc``; fp32: ``decode``), whole and split: its lse against
    ``paged_mla_attention_ref(return_lse=True)`` at the kernel's
    tolerance, NEG_INF and zeros for a row with no key, and its output
    bit for bit the output of the same call without the LSE; the LSE
    launch counted apart."""
    from repro_torch.kernels.paged_attention import kernel as pker
    from repro_torch.models.cache import NEG_INF
    q, pool, bt, ctx = mla_case(cuda, B_, H_, W, page, max_ctx, pdt, seed=3)
    if ctx0:
        ctx[0] = 0
    scale = W ** -0.5
    _lib.reset_launches()
    got, lse = pker.paged_mla_attention_kernel(
        q, pool, bt, ctx, R=R, window=window, softmax_scale=scale,
        splits=splits, return_lse=True)
    plain = pker.paged_mla_attention_kernel(
        q, pool, bt, ctx, R=R, window=window, softmax_scale=scale,
        splits=splits)
    want, wlse = pref.paged_mla_attention_ref(
        q, pool, bt, ctx, R=R, window=window, softmax_scale=scale,
        return_lse=True)
    torch.cuda.synchronize()
    assert _lib.LAUNCHES["mla_decode"] == 2
    assert _lib.LSE_LAUNCHES["mla_decode"] == 1
    assert lse.shape == (B_, H_) and lse.dtype == torch.float32
    assert torch.equal(got, plain)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=1e-4)
    if ctx0:
        assert int(got[0].count_nonzero()) == 0
        assert bool((lse[0] == NEG_INF).all())


def _stripe_case(dev, pdt, F, seed, width):
    """Random stripe pools of ``width`` ([KV, hd] or [W]) in ``pdt``, their
    local block tables and whole contexts (one of them 1 token: most
    stripes of that row are empty), on the card and on the CPU."""
    rng = np.random.default_rng(seed)
    Bn, page, MB_ = 4, 16, 6
    nblk = Bn * MB_ + 2
    pools = [torch.from_numpy(rng.standard_normal(
        (nblk, page) + width)).to(pdt) for _ in range(2)]
    bt = torch.from_numpy(rng.permutation(nblk - 1)[:Bn * MB_].reshape(
        Bn, MB_).astype(np.int32))
    cl = torch.from_numpy(np.array([1, 37, 200, MB_ * page * F], np.int32))
    return pools, bt, cl, [x.to(dev) for x in pools], bt.to(dev), cl.to(dev)


def _merge(parts):
    m_g = torch.stack([m for _, _, m in parts]).amax(0)
    num = sum(a * torch.exp(m - m_g)[..., None] for a, _, m in parts)
    den = sum(l * torch.exp(m - m_g) for _, l, m in parts)
    return num / den[..., None]


@pytest.mark.gpu
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("F", [2, 4])
def test_striped_partials_match_plain(cuda, pdt, F):
    """The striped pools' stripe partials on the card (K2 with its LSE
    for GQA at llama3-8b's merge-2 width, ``mla_decode`` with its LSE at
    DeepSeek-V2's) against ``_partial_attention`` and the plain MLA
    partial on the CPU, stripe by stripe (out = acc / l, lse = m + log l
    where the stripe holds a key) and merged over the F stripes. fp32
    pools: the outputs at fp32's tolerance (1e-4 for MLA's wide scores).
    bf16 pools: the plain partials round p to bf16 before the value
    product, as the JAX package does, where the kernels keep P to 16 bits
    or more, so an output moves by at most 2^-9 of the largest value it
    reads: atol 2^-8 of that, rtol 1e-2. The lse at fp32's tolerance."""
    from repro_torch.models import striped as TS

    def tol(values, f32_atol):
        if pdt == torch.float32:
            return dict(atol=f32_atol, rtol=f32_atol)
        return dict(atol=float(values.float().abs().max()) / 256, rtol=1e-2)
    (kc, vc), bt, cl, (kg, vg), btg, clg = _stripe_case(cuda, pdt, F, 7,
                                                        (8, 128))
    q = torch.randn((4, 32, 128), generator=torch.Generator().manual_seed(
        1)).to(pdt)
    cpu, card = [], []
    for s in range(F):
        acc, l, m = TS.stripe_partial(q, kc, vc, bt, cl, s, F)
        out, one, lse = TS.stripe_partial(q.to(cuda), kg, vg, btg, clg, s, F)
        live = l > 0
        torch.testing.assert_close(out.cpu()[live],
                                   (acc / l[..., None])[live],
                                   **tol(vc, 1e-5))
        torch.testing.assert_close(lse.cpu()[live],
                                   (m + torch.log(l))[live], atol=1e-4,
                                   rtol=1e-5)
        assert bool((out.cpu()[~live] == 0).all()) and bool((one == 1).all())
        cpu.append((acc, l, m))
        card.append((out.cpu(), one.cpu(), lse.cpu()))
    torch.testing.assert_close(_merge(card), _merge(cpu), **tol(vc, 1e-5))

    R, Rr = 512, 64
    (pc, _), bt, cl, (pg, _), btg, clg = _stripe_case(cuda, pdt, F, 8,
                                                      (R + Rr,))
    g = torch.Generator().manual_seed(2)
    qa = (torch.randn((4, 64, R), generator=g) * 0.05).to(pdt)
    qp = (torch.randn((4, 64, Rr), generator=g) * 0.05).to(pdt)
    cpu, card = [], []
    for s in range(F):
        acc, l, m = TS.stripe_partial_mla(qa, qp, pc, bt, cl, s, F, R=R)
        out, one, lse = TS.stripe_partial_mla(qa.to(cuda), qp.to(cuda), pg,
                                              btg, clg, s, F, R=R)
        live = l > 0
        torch.testing.assert_close(out.cpu()[live],
                                   (acc / l[..., None])[live],
                                   **tol(pc[..., :R], 1e-4))
        torch.testing.assert_close(lse.cpu()[live],
                                   (m + torch.log(l))[live], atol=1e-4,
                                   rtol=1e-4)
        cpu.append((acc, l, m))
        card.append((out.cpu(), one.cpu(), lse.cpu()))
    torch.testing.assert_close(_merge(card), _merge(cpu),
                               **tol(pc[..., :R], 1e-4))


@pytest.mark.gpu
def test_striped_window_refused_on_the_card(cuda):
    """A windowed stripe partial on the card raises instead of falling to
    the plain version: K2 takes no per-row stripe-local bound."""
    from repro_torch.models import striped as TS
    _, _, _, (kg, vg), btg, clg = _stripe_case(cuda, torch.float32, 2, 9,
                                               (2, 64))
    q = torch.zeros((4, 4, 64), device=cuda)
    with pytest.raises(NotImplementedError):
        TS.stripe_partial(q, kg, vg, btg, clg, 0, 2, window=8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C,near_one", [
    (2, 64, 128, False), (1, 100, 96, False), (2, 300, 200, True),
    (3, 5, 130, True)])
def test_rglru_kernels_match_plain(cuda, dtype, B, T, C, near_one):
    """K7 forward (y, hT) and backward (da, dg) against their plain
    versions: ragged T and C (a partial block of channels, T shorter than
    the steps a thread keeps in flight), a within 1e-3 of 1; then through
    the autograd op (one launch of each)."""
    rng = np.random.default_rng(9)
    z = rng.standard_normal((B, T, C))
    a = 1.0 - 1e-3 * rng.random((B, T, C)) if near_one \
        else 1.0 / (1.0 + np.exp(-z))
    a = torch.from_numpy(a).to(cuda, dtype)
    g = torch.from_numpy(0.5 * rng.standard_normal((B, T, C))).to(cuda,
                                                                 dtype)
    dy = torch.from_numpy(rng.standard_normal((B, T, C))).to(
        cuda, torch.float32)
    y, hT = rker.rglru_scan_kernel(a, g)
    wy, wh = rref.rglru_scan_ref(a, g)
    for got, want in ((y, wy), (hT, wh)):
        assert got.dtype == torch.float32
        _ssd_close(got, want)
    got = rker.rglru_scan_bwd_kernel(a, y, dy)
    want = rref.rglru_scan_bwd_ref(a, y, dy)
    for gr, w in zip(got, want):
        assert gr.dtype == dtype and gr.shape == a.shape
        _ssd_close(gr, w)
    _lib.reset_launches()
    ins = [a.clone().requires_grad_(True), g.clone().requires_grad_(True)]
    yo, _ = rops.rglru_scan(*ins)
    torch.testing.assert_close(yo, y, rtol=0.0, atol=0.0)
    for gr, w in zip(torch.autograd.grad(yo, ins, dy), got):
        torch.testing.assert_close(gr, w, rtol=0.0, atol=0.0)
    assert _lib.LAUNCHES["rglru_scan"] == 1
    assert _lib.LAUNCHES["rglru_scan_bwd"] == 1


@pytest.mark.gpu
def test_mamba2_training_on_the_card_matches_the_cpu(cuda):
    """Reduced mamba2-2.7b trained three fp32 steps on the card (K6
    forward and backward launched, twice and once per layer and step)
    and on the CPU from the same weights: the losses agree."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map

    cfg = get_config("mamba2-2.7b").reduced()
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    on_card_params = tree_map(lambda x: x.to(cuda), params)
    kw = dict(steps=3, batch=2, seq=80, dtype=torch.float32, log=lambda s: 0)
    _lib.reset_launches()
    card = train(cfg, device="cuda", params=on_card_params, **kw)
    assert _lib.LAUNCHES["ssd_scan"] == 3 * 2 * cfg.num_layers
    assert _lib.LAUNCHES["ssd_scan_bwd"] == 3 * cfg.num_layers
    cpu = train(cfg, device="cpu", params=params, **kw)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)


@pytest.mark.gpu
def test_recurrentgemma_training_on_the_card_matches_the_cpu(cuda):
    """The 4-layer RecurrentGemma test config trained three fp32 steps on
    the card (K7 launched twice and once per RG-LRU layer and step, K5
    per local-attention layer) and on the CPU from the same weights: the
    losses agree."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map

    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(),
                              num_layers=4)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    on_card_params = tree_map(lambda x: x.to(cuda), params)
    kw = dict(steps=3, batch=2, seq=130, dtype=torch.float32,
              log=lambda s: 0)
    _lib.reset_launches()
    card = train(cfg, device="cuda", params=on_card_params, **kw)
    assert _lib.LAUNCHES["rglru_scan"] == 3 * 2 * 3
    assert _lib.LAUNCHES["rglru_scan_bwd"] == 3 * 3
    assert _lib.LAUNCHES["flash_prefill"] == 3 * 2
    assert _lib.LAUNCHES["flash_prefill_bwd"] == 3
    cpu = train(cfg, device="cpu", params=params, **kw)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)


@pytest.mark.gpu
def test_training_on_the_card_matches_the_cpu(cuda):
    """Reduced llama3-8b trained three fp32 steps on the card (K5 forward
    and backward launched) and on the CPU from the same weights: the
    losses agree."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map

    cfg = get_config("llama3-8b").reduced()
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))
    on_card_params = tree_map(lambda x: x.to(cuda), params)
    kw = dict(steps=3, batch=2, seq=64, dtype=torch.float32, log=lambda s: 0)
    _lib.reset_launches()
    card = train(cfg, device="cuda", params=on_card_params, **kw)
    assert _lib.LAUNCHES["flash_prefill"] == 3 * 2 * cfg.num_layers
    assert _lib.LAUNCHES["flash_prefill_bwd"] == 3 * cfg.num_layers
    cpu = train(cfg, device="cpu", params=params, **kw)
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4)


def _reduced(arch):
    """The reduced config of ``arch``; RecurrentGemma's with 4 layers,
    so that a local-attention layer (K5 at hd 256) runs."""
    import dataclasses

    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    if arch == "recurrentgemma-9b":
        cfg = dataclasses.replace(cfg, num_layers=4)
    return cfg


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama3-8b", "recurrentgemma-9b"])
def test_bf16_training_on_the_card_matches_the_cpu(cuda, arch):
    """Three bf16 steps of the reduced config (the bf16 K5 kernels) on
    the card and on the CPU (the plain versions) from the same bf16
    weights. Tolerance: the two runs round at different places (the
    kernels' tiles and split fragments, cuBLAS against the CPU's
    GEMMs), each by about as much as bf16 rounding moves a run from its
    fp32 counterpart; so the card's losses may differ from the CPU's by
    twice the CPU's own largest relative bf16-vs-fp32 drift over the
    same steps from the same weights (measured in the test)."""
    from repro_torch.launch.train import train
    from repro_torch.models.model import build_model
    from repro_torch.training.checkpoint import tree_map

    cfg = _reduced(arch)
    params = build_model(cfg, torch.bfloat16, "cpu").init(
        torch.Generator().manual_seed(0))
    kw = dict(steps=3, batch=4, seq=128, log=lambda s: 0)
    _lib.reset_launches()
    card = train(cfg, device="cuda", dtype=torch.bfloat16,
                 params=tree_map(lambda x: x.to(cuda), params), **kw)
    # every llama layer attends; RecurrentGemma's third layer does
    n_attn = cfg.num_layers if arch == "llama3-8b" else 1
    assert _lib.LAUNCHES["flash_prefill"] == 3 * 2 * n_attn
    assert _lib.LAUNCHES["flash_prefill_bwd"] == 3 * n_attn
    cpu = train(cfg, device="cpu", dtype=torch.bfloat16,
                params=tree_map(lambda x: x.clone(), params), **kw)
    f32 = train(cfg, device="cpu", dtype=torch.float32,
                params=tree_map(lambda x: x.float(), params), **kw)
    drift = max(abs(b - f) / abs(f) for b, f in zip(cpu.losses, f32.losses))
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=2 * drift,
                               atol=0.0)


@pytest.mark.gpu
def test_engine_on_the_card_matches_the_cpu(cuda):
    """The reduced llama3-8b served on the card (every kernel launched)
    gives the CPU's greedy tokens, pools never move."""
    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model

    cfg = get_config("llama3-8b").reduced()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    params = build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))

    def serve(device):
        geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
        eng = FlyingEngine(build_model(cfg, torch.float32, device), plan,
                           geom, params, batch_per_engine=2,
                           max_blocks_per_req=16, device=device)
        pools = [p.data_ptr() for g in eng.islands[0].states for st in g
                 for p in st["mixer"]]
        reqs = []
        for i, plen in enumerate((13, 8)):
            r = Request(req_id=f"q{i}", arrival=0.0, prompt_len=plen,
                        output_len=1 << 30)
            r.engine_group = 0
            eng.adaptors[0].append_slots(r.req_id, plen)
            reqs.append(r)
        eng.prefill(reqs, 1, 16)
        for _ in range(6):
            for r in reqs:
                eng.adaptors[0].append_slots(r.req_id, 1)
            eng.decode(reqs, 1)
        stats = copy.copy(eng.sync_stats)
        assert pools == [p.data_ptr() for g in eng.islands[0].states
                         for st in g for p in st["mixer"]]
        return {r.req_id: eng.generated_tokens(r.req_id) for r in reqs}, \
            stats

    _lib.reset_launches()
    on_card, stats = serve("cuda")
    serving = ("paged_append_token", "paged_attention", "paged_append_chunk",
               "paged_flash_prefill")
    assert all(_lib.LAUNCHES[k] > 0 for k in serving)
    assert stats.host_argmax == 0 and stats.d2h_batched == 0
    assert on_card == serve("cpu")[0]


def _serve_reduced(device, params, *, stream=False, **kw):
    """Requests 'a' (24-token prompt) and 'b' through the scheduler over
    the reduced llama3-8b in fp32 on ``device``, steps reporting a fixed
    10 ms (so both devices schedule alike); offline, or streamed through
    the async loop in virtual pace. Returns (tokens, sync stats)."""
    import asyncio

    from repro_torch.configs import get_config
    from repro_torch.core.engine import FlyingEngine
    from repro_torch.core.kv_adaptor import PoolGeometry
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
    from repro_torch.core.task_pool import Request
    from repro_torch.models.model import build_model
    from repro_torch.serving.asyncloop import AsyncServeLoop
    from repro_torch.serving.frontdoor import FrontDoor, FrontDoorConfig
    from repro_torch.serving.loadgen import drive_inprocess

    cfg = get_config("llama3-8b").reduced()
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=1)
    geom = PoolGeometry(cfg, plan, num_blocks=64, block_base=4)
    eng = FlyingEngine(build_model(cfg, torch.float32, device), plan, geom,
                       params, batch_per_engine=2, max_blocks_per_req=16,
                       device=device, **kw)

    class FixedClock:
        def __getattr__(self, k):
            return getattr(eng, k)

        def prefill(self, *a):
            eng.prefill(*a)
            return 0.01

        def decode(self, *a):
            eng.decode(*a)
            return 0.01

        def mixed(self, *a):
            eng.mixed(*a)
            return 0.01

    sched = DynamicScheduler(plan, geom, FixedClock(), SchedulerConfig(
        strategy="hard", max_batch_per_group=2, prefill_chunk=8))
    reqs = [Request(req_id="a", arrival=0.0, prompt_len=24, output_len=6),
            Request(req_id="b", arrival=0.001, prompt_len=8, output_len=8)]
    if stream:
        loop = AsyncServeLoop(FrontDoor(sched, FrontDoorConfig()),
                              pace="virtual")
        out = asyncio.run(drive_inprocess(loop, reqs, collect_tokens=True))
        toks = {rec["req_id"]: rec["tokens"] for rec in out["records"]}
    else:
        for r in reqs:
            sched.submit(r)
        sched.run(max_steps=400)
        toks = {r.req_id: eng.generated_tokens(r.req_id) for r in reqs}
    return toks, copy.copy(eng.sync_stats)


def _reduced_params():
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config("llama3-8b").reduced()
    return build_model(cfg, torch.float32, "cpu").init(
        torch.Generator().manual_seed(0))


@pytest.mark.gpu
@pytest.mark.parametrize("V", (1000, 128256))
def test_sampling_on_the_card_matches_the_cpu(cuda, V):
    """threefry's bits on the card equal the CPU's; the Gumbel noise
    agrees within 2 fp32 ulps of max(|g|, 1) (each device's own log);
    the draws on the same logits are the same tokens."""
    from repro_torch.serving import sampling
    seeds = torch.tensor([0, 1, 7, 2**31, 2**32 - 1] + list(range(11, 38)),
                         dtype=torch.int64)
    assert torch.equal(sampling.random_bits(seeds.to(cuda), V).cpu(),
                       sampling.random_bits(seeds, V))
    g_card = sampling.gumbel(seeds.to(cuda), V).cpu().double()
    g_cpu = sampling.gumbel(seeds, V).double()
    scale = torch.from_numpy(np.spacing(np.maximum(
        np.abs(g_cpu.numpy()), 1.0).astype(np.float32)).astype(np.float64))
    assert ((g_card - g_cpu).abs() <= 2 * scale).all()
    logits = torch.from_numpy(np.random.default_rng(V).standard_normal(
        (len(seeds), V)).astype(np.float32) * 4)
    for top_k in (0, 20):
        on_card = sampling.sample(logits.to(cuda), seeds=seeds.to(cuda),
                                  temperature=0.8, top_k=top_k)
        assert on_card.is_cuda
        assert torch.equal(on_card.cpu(), sampling.sample(
            logits, seeds=seeds, temperature=0.8, top_k=top_k))


@pytest.mark.gpu
@pytest.mark.parametrize("seed_mode", ("fleet", "request"))
def test_temperature_serving_on_the_card_matches_the_cpu(cuda, seed_mode):
    """A seeded fp32 reduced run at temperature 0.8 (top-k 20) samples
    the same tokens on the card (K1-K4, sampling in the step) and on the
    CPU, with no token read back one at a time."""
    params = _reduced_params()
    kw = dict(temperature=0.8, top_k=20, seed_mode=seed_mode)
    _lib.reset_launches()
    on_card, stats = _serve_reduced("cuda", params, **kw)
    assert all(_lib.LAUNCHES[k] > 0 for k in (
        "paged_append_token", "paged_attention", "paged_append_chunk",
        "paged_flash_prefill"))
    assert stats.host_argmax == 0
    on_cpu, _ = _serve_reduced("cpu", params, **kw)
    assert on_card == on_cpu
    assert on_card != _serve_reduced("cpu", params)[0]


@pytest.mark.gpu
def test_async_stream_on_the_card_matches_offline(cuda):
    """The async loop (virtual pace) streams the card engine's greedy
    tokens: the offline run's, the CPU's, with no extra host reads
    (``host_argmax`` 0) while tokens are harvested every 2 steps."""
    params = _reduced_params()
    offline, _ = _serve_reduced("cuda", params)
    _lib.reset_launches()
    streamed, stats = _serve_reduced("cuda", params, stream=True,
                                     harvest_limit=2)
    assert _lib.LAUNCHES["paged_attention"] > 0
    assert streamed == offline == _serve_reduced("cpu", params)[0]
    assert all(len(v) > 0 for v in streamed.values())
    assert stats.host_argmax == 0 and stats.d2h_batched > 0


@pytest.mark.gpu
def test_island_trace_on_the_card_matches_the_cpu(cuda, tmp_path):
    """Two ranks share the one card over gloo (``chip_smoke.py`` phase 14
    (a)): the reduced llama3-8b in fp32 served by ``ParallelPlan(1, 1,
    2)`` through DP -> TP2 -> DP rebinds, every rebind zero-copy checked,
    streams the same tokens, on the same schedule, on the card as on the
    CPU, on both ranks, and finishes every request."""
    import json
    import sys
    from pathlib import Path

    from repro_torch.launch.ranks import spawn
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    out = str(tmp_path / "trace")
    spawn(chip_smoke.islands_trace_rank, 2, (out,), device_type="cuda",
          timeout=300)
    runs = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            runs.append(json.load(f))
    got = chip_smoke.check_islands_trace(runs)
    assert got["rebinds"] == 2 and "gloo" in got["backend"]


@pytest.mark.gpu
def test_live_sp_fault_traces_on_the_card_match_the_cpu(cuda, tmp_path):
    """``chip_smoke.py`` phase 14 (d) on two ranks sharing the card over
    gloo: the reduced llama3-8b with 2 KV heads in fp32 at
    ``ParallelPlan(1, 1, 2)``: a LIVE DP -> TP2 merge-up with decodes and
    a chunked prefill in flight (nothing paused or recomputed), a pure-SP
    island serving a context over one engine's pool, and a KILL of
    engine 1 mid-decode recovered onto engine 0 (the fault-free stream):
    on the card as on the CPU, on both ranks."""
    import json
    import sys
    from pathlib import Path

    from repro_torch.launch.ranks import spawn
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    out = str(tmp_path / "live")
    spawn(chip_smoke.live_runs_rank, 2, (out,), device_type="cuda",
          timeout=300)
    runs = []
    for r in range(2):
        with open(f"{out}.{r}.json") as f:
            runs.append(json.load(f))
    got = chip_smoke.check_live_runs(runs)
    assert got["live"]["preempt"]["live_riders"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("Bs,T,H,hd,S,chunk", [
    (2, 100, 3, 32, 32, 32), (2, 512, 4, 64, 128, 128)])
def test_ssd_scan_from_h0_matches_plain(cuda, dtype, Bs, T, H, hd, S,
                                        chunk):
    """K6's forward from a nonzero h0 (a serving prefill's later chunk)
    through ``ops.ssd_scan_from`` (T padded) against ``ref.ssd_chunked``
    from the same h0: y and hT at K6's tolerance, one launch counted as
    ``ssd_scan_from`` and none as the training route's ``ssd_scan``."""
    rng = np.random.default_rng(11)
    ch = min(chunk, T)
    Tp = T + (-T) % ch

    def t(shape, scale=1.0, dt_=dtype):
        return torch.from_numpy(rng.standard_normal(shape) * scale).to(
            cuda, dt_)
    x, B, C = t((Bs, Tp, H, hd)), t((Bs, Tp, S), 0.5), t((Bs, Tp, S), 0.5)
    dt = torch.nn.functional.softplus(t((Bs, Tp, H), dt_=torch.float32))
    dt[:, T:] = 0.0                       # the op's pad: identity steps
    A = -torch.exp(t((H,), dt_=torch.float32))
    h0 = t((Bs, H, hd, S), dt_=torch.float32)
    _lib.reset_launches()
    y, hT = sops.ssd_scan_from(x[:, :T], dt[:, :T], A, B[:, :T], C[:, :T],
                               h0, chunk=chunk)
    assert _lib.LAUNCHES["ssd_scan_from"] == 1
    assert _lib.LAUNCHES["ssd_scan"] == 0
    wy, wh = sref.ssd_chunked(x, dt, A, B, C, h0, ch)
    _ssd_close(y, wy[:, :T])
    _ssd_close(hT, wh)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C", [(2, 64, 128), (3, 5, 130), (1, 1, 96)])
def test_rglru_scan_from_h0_matches_plain(cuda, dtype, B, T, C):
    """K7's forward from a nonzero h0 (a within 1e-3 of 1, so h0 reaches
    every step) against the plain recurrence from it, one launch counted
    as ``rglru_scan_from``."""
    rng = np.random.default_rng(12)
    a = torch.from_numpy(1.0 - 1e-3 * rng.random((B, T, C))).to(cuda, dtype)
    g = torch.from_numpy(0.5 * rng.standard_normal((B, T, C))).to(cuda,
                                                                 dtype)
    h0 = torch.from_numpy(rng.standard_normal((B, C))).to(cuda,
                                                          torch.float32)
    _lib.reset_launches()
    y, hT = rops.rglru_scan_from(a, g, h0)
    assert _lib.LAUNCHES["rglru_scan_from"] == 1
    assert _lib.LAUNCHES["rglru_scan"] == 0
    wy, wh = rref.rglru_scan_ref(a, g, h0)
    _ssd_close(y, wy)
    _ssd_close(hT, wh)


@pytest.mark.gpu
@pytest.mark.parametrize("pair", list(DTYPE_PAIRS))
def test_paged_kernels_at_hd256_match_plain(cuda, pair):
    """K2 and K4 at RecurrentGemma's local attention (16 heads of 256 on
    one kv head) over contexts past a window of 37, at page 16 and 4:
    K2 split and unsplit with its lse, K4 at a ragged T of 70 (the causal
    sweep with and without the window, and prior_only), against their
    plain versions."""
    from repro_torch.kernels.paged_attention import kernel as pker
    qdt, kvdt = DTYPE_PAIRS[pair]
    T_ = 70
    for page, MB_ in ((16, 20), (4, 40)):
        c = _paged(cuda, 16, 1, 256, page, MB_, qdt, kvdt, T_=T_)
        ctx = torch.tensor([0, 1, MB_ * page], dtype=torch.int32,
                           device=cuda)
        args = (c["q1"], c["kp"], c["vp"], c["bt"], ctx)
        for window in (None, 37):
            for splits in (None, 1):
                torch.testing.assert_close(
                    pker.paged_attention_kernel(*args, window=window,
                                                splits=splits),
                    pref.paged_attention_ref(*args, window=window),
                    **_tol(qdt))
                o, lse = pker.paged_attention_kernel(
                    *args, window=window, splits=splits, return_lse=True)
                wo, wl = pref.paged_attention_with_lse_ref(
                    c["q1"].float(), *args[1:], window=window)
                torch.testing.assert_close(o.float(), wo, **_tol(qdt))
                torch.testing.assert_close(lse, wl, **_tol(torch.float32))
        prior = torch.tensor([0, 5, MB_ * page - T_], dtype=torch.int32,
                             device=cuda)
        args = (c["qT"], c["kp"], c["vp"], c["bt"], prior)
        for window, prior_only in ((None, False), (37, False), (None, True)):
            o, lse = fker.paged_flash_prefill_kernel(
                *args, window=window, prior_only=prior_only,
                return_lse=True)
            wo, wl = fref.paged_prefill_sweep_with_lse_ref(
                c["qT"].float(), *args[1:], window=window,
                prior_only=prior_only)
            torch.testing.assert_close(o.float(), wo, **_tol(qdt))
            torch.testing.assert_close(lse, wl, **_tol(torch.float32))


@pytest.mark.gpu
def test_recurrent_steps_on_the_card_match_the_cpu(cuda):
    """``chip_smoke.py`` phase 18 (a): the reduced mamba2-2.7b and the
    3-layer reduced recurrentgemma-9b in fp32, 4 prompts of 80 tokens in
    two prefill chunks (the second from the carried state) and 4 decode
    steps, on the card and on the CPU: greedy tokens equal, logits within
    1e-4, K6 or K7 from h0 (and K1-K4) launched as many times as the
    layers and steps say."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.recurrent_reduced(torch, np)
