"""The port's sharded training step on 4 gloo ranks against the JAX
package's GSPMD step at the same plan, on the CPU.

The JAX side runs in three subprocesses, this file's ``__main__``,
each with 4 forced host devices: ``build_train_step`` and ``train_mesh`` at each
case's plan, from ``model.init(jax.random.key(0))`` (drawn here and
handed to both sides), on seeded numpy batches of 8 x 32 tokens
(``training/data.py``), AdamW(lr 1e-3, warmup 5), 3 steps; before each
step it takes the gradient of the step's own loss (the same function
under the same shardings) at its current parameters. The port's side
runs the same cases on 4 gloo ranks in one spawn, from the same
parameters (``params_from_numpy``'s tree), each rank keeping its shards
(``WeightsManager.train_shard``) and gathering them back
(``gather_train``). They all run at once.

The cases: ``ParallelPlan(engine_rows=1, tp_base=2, data_rows=2)`` for
reduced llama3-8b (one KV head: K/V replicated over TP), Phi-3.5-MoE
(experts over 'model', each data shard one dispatch group: its losses
differ from the one-rank run's, through the groups' aux losses),
mamba2-2.7b and the 4-layer RecurrentGemma of ``test_torch_train.py``;
``(2, 2, 2)`` for llama3-8b and deepseek-v2-236b reduced with d_model
1024, where ZeRO-3 shards leaves over 'data' (MLA and MoE for the
latter). Held: each leaf's training spec equals the JAX package's; the
losses within rtol 1e-4; before step 1 each leaf's gradient, gathered
to its logical shape, within atol 1e-4; the parameters after the steps
within atol 1e-4 (mamba2-2.7b, as in ``test_torch_train.py``, from a
common state at each step, the JAX step's, which the ranks wait for,
leaving out the elements whose gradient rounds near zero in both
packages); the ranks equal to each other; a sharded checkpoint
restores every rank's shards bit for bit. In the same spawn each TP
group of 2 computes ``tp_cross_entropy`` over vocab halves, held with
its gradient against the JAX function under ``shard_map`` at tp 2.

In this process: MoE training at ``ParallelPlan(1, 1, 1)`` against the
JAX step, the MoE layer on each data shard's rows alone against the
JAX layer's per-data-shard dispatch, the launcher on 4 CPU ranks (a
falling loss, printed as one rank's, its checkpoint the logical tree in
the JAX package's layout), and the refusals.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
WORLD, STEPS, BATCH, SEQ = 4, 3, 8, 32
NEAR_ZERO = 1e-6
SPAWN_S = 240.0
# the arch whose steps start from a common state: the JAX step's, which
# the JAX side writes before each step and the ranks wait for
COMMON = "mamba2-2.7b"


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str
    plan: tuple                 # (engine_rows, tp_base, data_rows)
    d_model: int = 0            # 0: the reduced config's
    layers: int = 0             # 0: the reduced config's

    @property
    def name(self) -> str:
        tail = f"-d{self.d_model}" if self.d_model else ""
        return f"{self.arch}{tail}@{'x'.join(map(str, self.plan))}"


CASES = (Case("llama3-8b", (1, 2, 2)),
         Case("phi3.5-moe-42b-a6.6b", (1, 2, 2)),
         Case("mamba2-2.7b", (1, 2, 2)),
         Case("recurrentgemma-9b", (1, 2, 2), layers=4),
         Case("llama3-8b", (2, 2, 2), d_model=1024),
         Case("deepseek-v2-236b", (2, 2, 2), d_model=1024))
NAMES = [c.name for c in CASES]
# leaves ZeRO-3 shards over 'data' at d_model 1024, of all leaves
ZERO_LEAVES = {"llama3-8b-d1024@2x2x2": (12, 12),
               "deepseek-v2-236b-d1024@2x2x2": (23, 33)}


def case_config(get, case: Case):
    cfg = get(case.arch).reduced()
    kw = {}
    if case.d_model:
        kw["d_model"] = case.d_model
    if case.layers:
        kw["num_layers"] = case.layers
    return dataclasses.replace(cfg, **kw) if kw else cfg


def ce_inputs(vocab: int):
    """The cross entropy's logits [3, 7, vocab] and labels (one outside
    the vocab) and mask, from numpy with a seed."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, vocab)) * 3).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[0, 0] = -1
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32)
    return logits, labels, mask


def _load_leaves(path):
    with np.load(path) as z:
        return [z[f"leaf_{i}"] for i in range(len(z.files))]


def _save_leaves(path, leaves) -> None:
    np.savez(path, **{f"leaf_{i}": np.asarray(a)
                      for i, a in enumerate(leaves)})


# ---------------------------------------------------------------------------
# the JAX side: ``python tests/test_torch_train_ranks.py DIR``
# ---------------------------------------------------------------------------

# the JAX side's subprocesses, run at once: part i takes the cases i,
# i + PARTS, ... (the common-state case first), part 0 the cross entropy
PARTS = 3


def reference_main(d: str, part: int) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config as jax_config
    from repro.core.modes import ParallelPlan as JaxPlan
    from repro.core.views import SINGLE, TPContext
    from repro.core.weights_manager import WeightsManager
    from repro.models.cache import TrainBackend
    from repro.models.model import build_model
    from repro.models.transformer import tp_cross_entropy
    from repro.training.data import DataConfig, batches
    from repro.training.optimizer import AdamW
    from repro.training.train_step import build_train_step, train_mesh

    for case in sorted(CASES[part::PARTS], key=lambda c: c.arch != COMMON):
        cfg = case_config(jax_config, case)
        plan = JaxPlan(*case.plan)
        jm = build_model(cfg, jnp.float32)
        treedef = jax.tree.structure(jax.eval_shape(jm.init,
                                                    jax.random.key(0)))
        params = jax.tree.unflatten(treedef, [
            jnp.asarray(a) for a in _load_leaves(f"{d}/{case.name}.npz")])
        mesh = train_mesh(plan)
        opt = AdamW(lr=1e-3, warmup=5)
        step, psh, osh, bsh = build_train_step(jm, plan, mesh, opt=opt,
                                               donate=False)
        specs = WeightsManager(cfg, plan).partition_specs(
            params, train=True)
        # the step's own loss (build_train_step's loss_fn), for its
        # gradient at the step's parameters
        groups = plan.pods * plan.data_rows if cfg.moe is not None else 1
        tctx = TPContext(moe_groups=groups) if groups > 1 else SINGLE

        def loss_fn(p, b):
            logits, _, aux = jm.forward(p, tctx, mode="train",
                                        tokens=b["tokens"],
                                        backend=TrainBackend())
            if cfg.vocab_size % plan.tp_base == 0:
                logits = jax.lax.with_sharding_constraint(
                    logits, NamedSharding(mesh, P(("pod", "data"), None,
                                                  "model")))
            return tp_cross_entropy(cfg, logits, b["labels"], SINGLE) \
                + 0.01 * aux
        grad = jax.jit(jax.grad(loss_fn), in_shardings=(psh, bsh))
        carry = (jax.device_put(params, psh),
                 jax.jit(opt.init, out_shardings=osh)(params))
        it = batches(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0))
        out = {"losses": [], "totals": [],
               "specs": [[a if a is None else str(a) for a in s]
                         for s in jax.tree.leaves(
                             specs, is_leaf=lambda x: isinstance(x, P))]}
        for s in range(STEPS):
            b = {k: jnp.asarray(v) for k, v in next(it).items()}
            if case.arch == COMMON:
                p, o = carry
                _save_leaves(f"{d}/{case.name}.jax.state{s}.tmp.npz",
                             jax.tree.leaves((p, o.m, o.v)))
                os.replace(f"{d}/{case.name}.jax.state{s}.tmp.npz",
                           f"{d}/{case.name}.jax.state{s}.npz")
            _save_leaves(f"{d}/{case.name}.jax.grads{s}.npz",
                         jax.tree.leaves(grad(carry[0], b)))
            carry, mets = step(carry, b)
            out["losses"].append(float(mets["loss"]))
            out["totals"].append(float(mets["total"]))
            _save_leaves(f"{d}/{case.name}.jax.params{s}.npz",
                         jax.tree.leaves(carry[0]))
        with open(f"{d}/{case.name}.jax.json", "w") as f:
            json.dump(out, f)

    if part:
        return
    # tp_cross_entropy at tp 2 under shard_map, vocab halves over
    # 'model' (JAX has no differentiation rule for its pmax: the
    # gradient is the tp 1 function's, the same function of the logits)
    cfg = jax_config("llama3-8b").reduced()
    logits, labels, mask = (jnp.asarray(a) for a in ce_inputs(
        cfg.vocab_size))
    ctx = TPContext(tp=2, tp_axes=("model",))
    mesh2 = Mesh(np.asarray(jax.devices()[:2]), ("model",))
    ce = {}
    for masked in (False, True):
        mk = mask if masked else None
        sm = jax.shard_map(
            lambda lg, lb: tp_cross_entropy(cfg, lg, lb, ctx, mask=mk),
            mesh=mesh2, in_specs=(P(None, None, "model"), P()),
            out_specs=P(), check_vma=False)
        one, g = jax.value_and_grad(
            lambda lg: tp_cross_entropy(cfg, lg, labels, SINGLE, mask=mk))(
                logits)
        ce[str(masked)] = [float(sm(logits, labels)), float(one)]
        np.save(f"{d}/ce.jax.grad.{masked}.npy", np.asarray(g))
    with open(f"{d}/ce.jax.json", "w") as f:
        json.dump(ce, f)


# ---------------------------------------------------------------------------
# the port's side: one spawn of 4 gloo ranks
# ---------------------------------------------------------------------------

def common_state(path: str, like, wm, mesh, carry) -> None:
    """Set this rank's shards of the parameters and of Adam's moments to
    the JAX step's state at ``path`` (waiting for the JAX side to write
    it), in place."""
    import time

    from repro_torch.training import checkpoint as ckpt
    deadline = time.monotonic() + SPAWN_S
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} was not written")
        time.sleep(0.2)
    leaves = [torch.from_numpy(a) for a in _load_leaves(path)]
    n = len(ckpt.tree_leaves(like))
    params, opt_state = carry
    for tree, part in zip((params, opt_state.m, opt_state.v),
                          (leaves[:n], leaves[n:2 * n], leaves[2 * n:])):
        cut = wm.train_shard(ckpt.tree_unflatten(like, part), mesh.pod,
                             mesh.data, mesh.model)
        with torch.no_grad():
            for dst, src in zip(ckpt.tree_leaves(tree),
                                ckpt.tree_leaves(cut)):
                dst.copy_(src)


def train_rank(rank: int, world: int, d: str) -> None:
    from repro_torch.configs import get_config
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.views import make_train_ctx
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.models import transformer as tfm
    from repro_torch.models.model import Model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.data import DataConfig, batches
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import (build_train_step,
                                                 logical_specs, train_mesh)
    cpu = torch.device("cpu")
    # the common-state case last: by then the JAX side has written it
    for case in sorted(CASES, key=lambda c: c.arch == COMMON):
        cfg = case_config(get_config, case)
        plan = ParallelPlan(*case.plan)
        mesh = train_mesh(plan)
        model = Model(cfg, torch.float32, cpu)
        like = Model(cfg, torch.float32, torch.device("meta")).init(
            torch.Generator(device="cpu"))
        logical = ckpt.tree_unflatten(like, [
            torch.from_numpy(a) for a in _load_leaves(f"{d}/{case.name}.npz")])
        wm = WeightsManager(cfg, plan)
        specs = logical_specs(model, plan)
        shards = wm.train_shard(logical, mesh.pod, mesh.data, mesh.model)
        opt = AdamW(lr=1e-3, warmup=5)
        step = build_train_step(model, plan, opt=opt, mesh=mesh)
        carry = (shards, opt.init(shards))
        it = batches(DataConfig(cfg.vocab_size, SEQ, BATCH, seed=0))
        out = {"losses": [], "totals": [],
               "specs": [list(s.axes) for s in ckpt.tree_leaves(specs)],
               "coord": [mesh.pod, mesh.data, mesh.model]}
        for s in range(STEPS):
            b = next(it)
            if case.arch == COMMON:
                common_state(f"{d}/{case.name}.jax.state{s}.npz", like, wm,
                             mesh, carry)
            grads, _, _ = step.gradients(carry[0], b)
            whole = wm.gather_train(ckpt.tree_unflatten(shards, grads),
                                    specs, mesh.groups)
            _save_leaves(f"{d}/{case.name}.port{rank}.grads{s}.npz",
                         [g.numpy() for g in ckpt.tree_leaves(whole)])
            carry, mets = step(carry, b)
            out["losses"].append(float(mets["loss"]))
            out["totals"].append(float(mets["total"]))
            whole = wm.gather_train(carry[0], specs, mesh.groups)
            _save_leaves(f"{d}/{case.name}.port{rank}.params{s}.npz",
                         [p.detach().numpy()
                          for p in ckpt.tree_leaves(whole)])
        assert carry[0] is shards                   # updated in place
        path = f"{d}/{case.name}.ckpt"
        ckpt.save_sharded(path, carry[0], mesh, model, step=STEPS)
        back, at = ckpt.restore_sharded(path, carry[0], mesh, model)
        out["restored"] = at == STEPS and all(
            torch.equal(a, b_) for a, b_ in zip(ckpt.tree_leaves(back),
                                               ckpt.tree_leaves(carry[0])))
        with open(f"{d}/{case.name}.port{rank}.json", "w") as f:
            json.dump(out, f)

    # tp_cross_entropy over the TP groups of 2 (ranks 0-1 and 2-3)
    cfg = get_config("llama3-8b").reduced()
    mesh = train_mesh(ParallelPlan(1, 2, 2))
    ctx = make_train_ctx(2, mesh.groups["model"])
    logits, labels, mask = ce_inputs(cfg.vocab_size)
    off, Vl = tfm.vocab_offset(cfg, ctx)
    ce = {}
    for masked in (False, True):
        lt = torch.from_numpy(logits[..., off:off + Vl]).requires_grad_(True)
        loss = tfm.tp_cross_entropy(cfg, lt, torch.from_numpy(labels), ctx,
                                    mask=torch.from_numpy(mask) if masked
                                    else None)
        # a vocab slice's gradient is whole on its rank: the backward is
        # seeded with 1 / tp, as the train step seeds it
        (g,) = torch.autograd.grad(loss, lt,
                                   grad_outputs=torch.tensor(0.5))
        ce[str(masked)] = [float(loss.detach()), off]
        np.save(f"{d}/ce.port{rank}.grad.{masked}.npy", g.numpy())
    with open(f"{d}/ce.port{rank}.json", "w") as f:
        json.dump(ce, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides' outputs: the parameters drawn here, then the JAX
    subprocess and the port's spawn at once."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.model import build_model
    from repro_torch.launch.ranks import spawn
    d = tmp_path_factory.mktemp("train_ranks")
    for case in CASES:
        jm = build_model(case_config(jax_config, case), jnp.float32)
        _save_leaves(d / f"{case.name}.npz",
                     jax.tree.leaves(jm.init(jax.random.key(0))))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(d), str(i)],
                              env=env, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True)
             for i in range(PARTS)]
    try:
        spawn(train_rank, WORLD, (str(d),), device_type="cpu",
              timeout=SPAWN_S, threads=1)
        for proc in procs:
            _, err = proc.communicate(timeout=SPAWN_S)
            assert proc.returncode == 0, err[-4000:]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    return d


def _json(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("name", NAMES)
def test_train_specs_are_the_jax_packages(runs, name):
    """Every leaf's training partition spec is the JAX package's
    ``partition_specs(train=True)``; at d_model 1024 ZeRO-3 shards the
    leaves the JAX package shards."""
    port = _json(runs / f"{name}.port0.json")["specs"]
    assert port == _json(runs / f"{name}.jax.json")["specs"]
    if name in ZERO_LEAVES:
        assert (sum("data" in s for s in port), len(port)) == \
            ZERO_LEAVES[name]
    else:
        assert not any("data" in s for s in port)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_steps_match_jax(runs, name):
    """Losses and totals at every step (rtol 1e-4), each leaf's gathered
    gradient before step 1 (atol 1e-4), the gathered parameters after
    the last step (atol 1e-4), on rank 0. mamba2-2.7b's steps each start
    from the JAX step's state, as in ``test_torch_train.py``: its
    parameters are held after every step, leaving out the elements
    whose gradient there is at most 1e-6 in size in both packages and
    not the same in both (at most 1% of them)."""
    jx, port = _json(runs / f"{name}.jax.json"), \
        _json(runs / f"{name}.port0.json")
    for key in ("losses", "totals"):
        np.testing.assert_allclose(port[key], jx[key], rtol=1e-4, atol=0.0)
    grads = [(_load_leaves(runs / f"{name}.port0.grads{s}.npz"),
              _load_leaves(runs / f"{name}.jax.grads{s}.npz"))
             for s in range(STEPS)]
    for a, w in zip(*grads[0]):
        assert a.shape == w.shape
        np.testing.assert_allclose(a, w, atol=1e-4, rtol=0.0)
    common = name.startswith(COMMON)
    for s in range(STEPS) if common else (STEPS - 1,):
        got = _load_leaves(runs / f"{name}.port0.params{s}.npz")
        want = _load_leaves(runs / f"{name}.jax.params{s}.npz")
        masks = [np.zeros(a.shape, bool) for a in got]
        if common:
            for m, a, w in zip(masks, *grads[s]):
                m |= (np.abs(a) <= NEAR_ZERO) & (np.abs(w) <= NEAR_ZERO) \
                    & (a != w)
        assert sum(m.sum() for m in masks) \
            <= 0.01 * sum(m.size for m in masks)
        for a, w, m in zip(got, want, masks):
            np.testing.assert_allclose(a[~m], w[~m], atol=1e-4, rtol=0.0)


@pytest.mark.parametrize("name", NAMES)
def test_ranks_agree(runs, name):
    """Every rank reports the same losses and gathers the same gradients
    and parameters, bit for bit; each sits at its own mesh coordinate
    and restores its shards from the sharded checkpoint exactly."""
    outs = [_json(runs / f"{name}.port{r}.json") for r in range(WORLD)]
    assert [o["coord"] for o in outs] == \
        [[0, r // 2, r % 2] for r in range(WORLD)]
    for o in outs:
        assert o["restored"]
        assert (o["losses"], o["totals"]) == \
            (outs[0]["losses"], outs[0]["totals"])
    for what in (f"params{STEPS - 1}", "grads0"):
        ref = _load_leaves(runs / f"{name}.port0.{what}.npz")
        for r in range(1, WORLD):
            for a, b in zip(_load_leaves(runs / f"{name}.port{r}.{what}.npz"),
                            ref):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("masked", [False, True])
def test_tp2_cross_entropy_matches_jax(runs, masked):
    """``tp_cross_entropy`` over vocab halves at tp 2 (each TP group of
    the spawn) against the JAX function under ``shard_map`` at tp 2: the
    loss (atol 1e-5); and each rank's slice of the logits' gradient
    against the JAX function's at tp 1, whose loss equals its tp 2 loss
    (atol 1e-5)."""
    want, one = _json(runs / "ce.jax.json")[str(masked)]
    np.testing.assert_allclose(one, want, atol=1e-5, rtol=1e-6)
    want_g = np.load(runs / f"ce.jax.grad.{masked}.npy")
    offs = set()
    for r in range(WORLD):
        loss, off = _json(runs / f"ce.port{r}.json")[str(masked)]
        g = np.load(runs / f"ce.port{r}.grad.{masked}.npy")
        np.testing.assert_allclose(loss, want, atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(g, want_g[..., off:off + g.shape[-1]],
                                   atol=1e-5, rtol=0.0)
        offs.add((off, g.shape[-1]))
    assert offs == {(0, want_g.shape[-1] // 2),
                    (want_g.shape[-1] // 2, want_g.shape[-1] // 2)}


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def test_moe_trains_on_one_rank_as_the_jax_step():
    """Reduced Phi-3.5-MoE at ``ParallelPlan(1, 1, 1)``: three steps of
    both packages' train steps (``test_torch_train.py``'s set-up and
    tolerances), the aux loss in both totals."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.model import build_model as jax_build
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from test_torch_train import _three_steps_match_jax
    arch = "phi3.5-moe-42b-a6.6b"
    jm = jax_build(jax_config(arch).reduced(), jnp.float32)
    cfg = get_config(arch).reduced()
    _three_steps_match_jax(jm, jm.init(jax.random.key(0)), cfg,
                           build_model(cfg, torch.float32, "cpu"), seq=32)


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "deepseek-v2-236b"])
def test_moe_group_dispatch_matches_jax(arch):
    """The port's per-data-shard dispatch against the JAX layer's at
    ``TPContext(moe_groups=2)``: each half of the batch (one data rank's
    rows) through the port's layer alone, the outputs side by side and
    the aux loss their mean (as the train step averages the data ranks'
    losses), with the full capacity factor cut to 1.0 so that each
    group drops its own entries: output, aux loss and the gradients of
    both (atol 1e-5)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.core.views import TPContext as JaxCtx
    from repro.models.moe import init_moe, moe_ffn as jax_moe
    from repro_torch.configs import get_config
    from repro_torch.core.views import SINGLE
    from repro_torch.models.moe import moe_ffn
    from repro_torch.training.checkpoint import tree_leaves

    def cut(cfg):
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=1.0))
    jcfg, cfg = cut(jax_config(arch).reduced()), cut(get_config(arch).reduced())
    jp = init_moe(jax.random.key(1), jcfg, jnp.float32)
    x = np.random.default_rng(2).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32)
    dy = np.random.default_rng(3).standard_normal(x.shape).astype(
        np.float32)

    def jloss(p, xx):
        y, aux = jax_moe(jcfg, p, xx, JaxCtx(moe_groups=2))
        return jnp.sum(y * dy) + aux, (y, aux)
    (_, (jy, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    p = jax.tree.map(lambda a: torch.from_numpy(np.array(a))
                     .requires_grad_(True), jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    halves = [moe_ffn(cfg, p, xh, SINGLE) for xh in xt.split(2)]
    y = torch.cat([yh for yh, _ in halves])
    aux = (halves[0][1] + halves[1][1]) / 2
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux,
                                [xt] + tree_leaves(p))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=0.0)
    np.testing.assert_allclose(float(aux.detach()), float(jaux), atol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), atol=1e-5)
    for g, w in zip(grads[1:], jax.tree.leaves(jgp)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # one group over all the tokens routes and drops otherwise
    _, aux1 = moe_ffn(cfg, p, xt, SINGLE)
    assert float(aux1.detach()) != float(aux.detach())


def test_launcher_trains_on_four_cpu_ranks(tmp_path, capsys):
    """``--ranks 4 --reduced --device cpu``: ParallelPlan(1, 2, 2), a
    falling loss that prints as the same run's on one rank prints it
    (within one unit of the last printed digit),
    and a checkpoint of the logical tree in the JAX package's layout:
    the JAX package restores it into its model's tree, leaf for leaf
    as the port restores it."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_config
    from repro.models.model import build_model as jax_build
    from repro.training import checkpoint as jax_ckpt
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import Model
    from repro_torch.training import checkpoint as ckpt
    args = ["--reduced", "--device", "cpu", "--steps", "8", "--batch", "8",
            "--seq", "32", "--log-every", "4", "--ckpt-every", "8"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    path = str(tmp_path / "ck")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--ranks", "4",
         "--ckpt", path] + args, env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "4 ranks: tp_base 2 x data_rows 2" in proc.stdout
    assert "OK" in proc.stdout
    train.main(args)
    one = capsys.readouterr().out

    def losses(out):
        return [float(line.split("loss")[1].split()[0]) for line in
                out.splitlines() if line.startswith("step ")]
    # printed to 4 decimals: losses within float rounding of each other
    # can print one unit apart
    assert len(losses(one)) == 3
    np.testing.assert_allclose(losses(proc.stdout), losses(one),
                               atol=1.5e-4, rtol=0.0)
    jm = jax_build(jax_config("llama3-8b").reduced(), jnp.float32)
    got, step = jax_ckpt.restore(path, jm.init(jax.random.key(0)))
    like = Model(get_config("llama3-8b").reduced(), torch.float32,
                 torch.device("cpu")).init(torch.Generator().manual_seed(1))
    port, step2 = ckpt.restore(path, like)
    assert step == step2 == 8
    for a, b in zip(jax.tree.leaves(got), ckpt.tree_leaves(port)):
        assert a.dtype == jnp.float32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_sharded_training_refuses_what_it_cannot_run():
    """No fallback: a plan whose rank count is not the world's, a mesh
    of another plan, a coordinate off the mesh and a leaf that does not
    split raise; the one-rank plan still trains."""
    from repro_torch.configs import get_config
    from repro_torch.core.modes import ParallelPlan
    from repro_torch.core.weights_manager import WeightsManager
    from repro_torch.models.model import Model, build_model
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_step import build_train_step, train_mesh
    cfg = get_config("llama3-8b").reduced()
    model = build_model(cfg, torch.float32, "cpu")
    for plan in (ParallelPlan(1, 2, 2), ParallelPlan(1, 1, 2),
                 ParallelPlan(2, 2, 2), ParallelPlan(1, 2, 1)):
        with pytest.raises(ValueError, match="trains on"):
            build_train_step(model, plan)
    one = ParallelPlan(1, 1, 1)
    with pytest.raises(ValueError, match="a mesh of"):
        build_train_step(model, one, mesh=dataclasses.replace(
            train_mesh(one), plan=ParallelPlan(2, 1, 1)))
    params = model.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="off the mesh"):
        WeightsManager(cfg, one).train_shard(params, 0, 1, 0)
    big = dataclasses.replace(cfg, d_model=1024)
    meta = Model(big, torch.float32, torch.device("meta")).init(
        torch.Generator(device="cpu"))
    meta["embed"]["head"] = torch.zeros((1024, cfg.vocab_size - 1))
    with pytest.raises(ValueError, match="does not split"):
        WeightsManager(big, ParallelPlan(2, 2, 2)).train_shard(meta, 0, 0, 0)
    opt = AdamW()
    toks = np.zeros((3, 8), np.int32)
    _, mets = build_train_step(model, one, opt=opt)(
        (params, opt.init(params)), {"tokens": toks, "labels": toks})
    assert np.isfinite(float(mets["loss"]))


if __name__ == "__main__":
    reference_main(sys.argv[1], int(sys.argv[2]))
