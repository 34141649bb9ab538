"""The port's serving slice against the JAX package's, on the CPU.

``DynamicScheduler`` over each package's ``FlyingEngine`` (reduced
llama3-8b, the same parameters, ``ParallelPlan(1, 1, 1)``): the greedy
token streams, the phase log (mixed steps included), the runner key
sets and the ``SyncStats`` counters must be identical. Backends are
wrapped so every step reports the same fixed duration: the scheduler's
clock, and so its phase decisions, then depend on nothing measured.
Runs over a pool small enough that decode growth finds it full, and runs
under a scripted ``POOL_EXHAUST`` window, take the scheduler's
backpressure path: the evicted request is recovered with its produced
tokens folded into its prompt, and both packages must recover the same
requests and then stream the same tokens.

The JAX engine needs its step meshes; on this jax (0.9) ``AbstractMesh``
takes ``(axis_sizes, axis_names)`` where the JAX package passes
``((name, size), ...)`` pairs. A module-scoped fixture patches in a
subclass that accepts the pair form and restores the original after.
"""
import ast
import copy
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.core.engine import FlyingEngine as JaxEngine
from repro.core.faults import FaultInjector as JaxInjector
from repro.core.faults import FaultSpec as JaxSpec
from repro.core.kv_adaptor import PoolGeometry as JaxGeometry
from repro.core.modes import ParallelPlan as JaxPlan
from repro.core.scheduler import DynamicScheduler as JaxScheduler
from repro.core.scheduler import SchedulerConfig as JaxSchedConfig
from repro.core.task_pool import Request as JaxRequest
from repro.models.model import build_model as jax_build
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.engine import FlyingEngine
from repro_torch.core.faults import (KILL, POOL_EXHAUST, FaultInjector,
                                     FaultSpec)
from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import ParallelPlan
from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
from repro_torch.core.task_pool import Request
from repro_torch.models.model import build_model

REPO = Path(__file__).resolve().parents[1]
COUNTERS = ("steps", "host_argmax", "d2h_batched", "drains")
# recovery runs: (pool blocks, POOL_EXHAUST window)
RECOVERY = {"backpressure": (12, False), "pool_exhaust": (64, True)}


class _PairAbstractMesh(jax.sharding.AbstractMesh):
    """``AbstractMesh`` that also takes the ``((name, size), ...)`` form."""

    def __init__(self, axis_sizes, axis_names=None, *args, **kw):
        if axis_names is None:
            axis_names = tuple(n for n, _ in axis_sizes)
            axis_sizes = tuple(s for _, s in axis_sizes)
        super().__init__(axis_sizes, axis_names, *args, **kw)


@pytest.fixture(scope="module")
def jax_mesh_shim():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.sharding, "AbstractMesh", _PairAbstractMesh)
    yield
    mp.undo()


class _FixedClock:
    """Backend proxy whose steps all report 10 ms."""

    def __init__(self, eng):
        self.eng = eng

    def __getattr__(self, k):
        return getattr(self.eng, k)

    def prefill(self, *a):
        self.eng.prefill(*a)
        return 0.01

    def decode(self, *a):
        self.eng.decode(*a)
        return 0.01

    def mixed(self, *a):
        self.eng.mixed(*a)
        return 0.01


@pytest.fixture(scope="module")
def stacks():
    """Both packages' (model, params, plan, geometry/engine/... types)."""
    jm = jax_build(jax_config("llama3-8b").reduced(), jnp.float32)
    jp = jm.init(jax.random.key(0))
    cfg = get_config("llama3-8b").reduced()
    tm = build_model(cfg, torch.float32, device="cpu")
    tp = params_from_numpy(cfg, jax.tree.map(np.asarray, jp))
    return {
        "jax": dict(model=jm, params=jp, Plan=JaxPlan, Geom=JaxGeometry,
                    Engine=JaxEngine, Sched=JaxScheduler,
                    SConf=JaxSchedConfig, Req=JaxRequest, Inj=JaxInjector,
                    Spec=JaxSpec, kw={}),
        "torch": dict(model=tm, params=tp, Plan=ParallelPlan,
                      Geom=PoolGeometry, Engine=FlyingEngine,
                      Sched=DynamicScheduler, SConf=SchedulerConfig,
                      Req=Request, Inj=FaultInjector, Spec=FaultSpec,
                      kw=dict(device="cpu")),
    }


def _engine(s, *, num_blocks=64, block_base=4, max_blocks=16, **kw):
    plan = s["Plan"](engine_rows=1, tp_base=1, data_rows=1)
    geom = s["Geom"](s["model"].cfg, plan, num_blocks=num_blocks,
                     block_base=block_base)
    eng = s["Engine"](s["model"], plan, geom, s["params"],
                      batch_per_engine=2, max_blocks_per_req=max_blocks,
                      **s["kw"], **kw)
    return plan, geom, eng


def run_sched(s, *, mixed):
    """Mirror of tests/test_prefill_attention.py::run_sched: staggered
    requests 'a' (24-token prompt, chunk 8, 6 out) and 'b'."""
    plan, geom, eng = _engine(s, mixed_step=mixed)
    sched = s["Sched"](plan, geom, _FixedClock(eng), s["SConf"](
        strategy="hard", max_batch_per_group=2, prefill_chunk=8))
    sched.submit(s["Req"](req_id="a", arrival=0.0, prompt_len=24,
                          output_len=6))
    sched.submit(s["Req"](req_id="b", arrival=0.001, prompt_len=8,
                          output_len=8))
    sched.run(max_steps=200)
    stats = copy.copy(eng.sync_stats)
    toks = {rid: eng.generated_tokens(rid) for rid in ("a", "b")}
    return dict(toks=toks, phases=[l.phase for l in sched.log],
                keys=set(eng.pool._runners),
                stats={k: getattr(stats, k) for k in COUNTERS}, eng=eng,
                reqs=list(sched.pool.all.values()))


def run_backpressure(s, *, num_blocks, fault):
    """Four staggered requests (prompts 12-24, 10 tokens out) two at a
    time over a ``num_blocks`` x 4-token pool; with ``fault``, every free
    block is seized from tick 6 for 8 ticks."""
    inj = s["Inj"]([s["Spec"](kind=POOL_EXHAUST, tick=6, blocks=-1,
                              duration=8)]) if fault else None
    plan, geom, eng = _engine(s, num_blocks=num_blocks, injector=inj)
    sched = s["Sched"](plan, geom, _FixedClock(eng), s["SConf"](
        strategy="hard", max_batch_per_group=2, prefill_chunk=8))
    for i in range(4):
        sched.submit(s["Req"](req_id=f"r{i}", arrival=0.001 * i,
                              prompt_len=12 + 4 * i, output_len=10))
    sched.run(max_steps=400)
    reqs = sorted(sched.pool.all.values(), key=lambda r: r.req_id)
    return dict(toks={r.req_id: eng.generated_tokens(r.req_id)
                      for r in reqs},
                phases=[l.phase for l in sched.log],
                degraded=[l.degraded for l in sched.log],
                recovered=sched.preempt_stats["recovered"],
                incidents=[(i["tick"], i["kind"], i.get("req"),
                            i.get("kept_tokens")) for i in sched.incidents],
                folds={r.req_id: (r.state, r.prompt_len, r.folded)
                       for r in reqs},
                seized=dict(sched._seized), eng=eng)


def chunked_prefill(s, prompt_len, chunk, decode_steps=2):
    """Mirror of tests/test_prefill_attention.py::chunked_prefill."""
    _, _, eng = _engine(s, block_base=16, max_blocks=64)
    r = s["Req"](req_id=f"long{prompt_len}", arrival=0.0,
                 prompt_len=prompt_len, output_len=1 << 30)
    r.engine_group = 0
    while r.prefilled < prompt_len:
        c = min(chunk, prompt_len - r.prefilled)
        eng.adaptors[0].append_slots(r.req_id, c)
        eng.prefill([r], 1, chunk)
        r.prefilled += c
    eng.adaptors[0].append_slots(r.req_id, 1)
    for _ in range(decode_steps):
        eng.decode([r], 1)
        eng.adaptors[0].append_slots(r.req_id, 1)
    return eng, eng.generated_tokens(r.req_id)


@pytest.fixture(scope="module")
def jax_runs(stacks, jax_mesh_shim):
    s = stacks["jax"]
    return {"mixed": run_sched(s, mixed=True),
            "sequential": run_sched(s, mixed=False),
            "chunk64": chunked_prefill(s, 512, 64),
            **{v: run_backpressure(s, num_blocks=n, fault=f)
               for v, (n, f) in RECOVERY.items()}}


@pytest.mark.parametrize("variant", ["mixed", "sequential"])
def test_run_sched_matches_jax(stacks, jax_runs, variant):
    want = jax_runs[variant]
    got = run_sched(stacks["torch"], mixed=variant == "mixed")
    assert got["toks"] == want["toks"]
    assert got["phases"] == want["phases"]
    assert ("mixed" in got["phases"]) == (variant == "mixed")
    assert got["keys"] == want["keys"]
    assert got["stats"] == want["stats"]
    assert got["stats"]["host_argmax"] == 0


@pytest.mark.parametrize("variant", ["backpressure", "pool_exhaust"])
def test_recovery_matches_jax(stacks, jax_runs, variant):
    """A full pool (12 blocks) and a POOL_EXHAUST window (64 blocks, all
    seized for 8 ticks): decode growth evicts a resident, which is
    recovered with its produced tokens pinned into its prompt. The
    token streams, phases, degraded ticks, recoveries (with the tokens
    each kept) and the folded prompts are the JAX engine's."""
    want = jax_runs[variant]
    n, fault = RECOVERY[variant]
    got = run_backpressure(stacks["torch"], num_blocks=n, fault=fault)
    assert got["recovered"] == want["recovered"] > 0
    assert got["toks"] == want["toks"]
    assert got["phases"] == want["phases"]
    assert got["degraded"] == want["degraded"] and any(got["degraded"])
    assert got["incidents"] == want["incidents"]
    assert got["folds"] == want["folds"]
    assert all(st == "done" and len(got["toks"][rid]) == 10
               for rid, (st, _, _) in got["folds"].items())
    assert got["seized"] == {}              # every seized block came back
    eng = got["eng"]
    for rid, (_, plen, folded) in got["folds"].items():
        if folded:
            pinned = eng._pinned_prompts[rid]
            assert len(pinned) == plen
            assert list(pinned[plen - folded:]) == got["toks"][rid][:folded]
    assert eng.sync_stats.host_argmax == 0


def test_abort_drops_the_pinned_prompt(stacks):
    """The abort hook retires a recovered request's pinned prompt, its
    prompt cache entry and its buffered tokens, as the reference's
    does."""
    got = run_backpressure(stacks["torch"], num_blocks=12, fault=False)
    eng = got["eng"]
    rid = next(r for r, (_, _, f) in got["folds"].items() if f)
    r = Request(req_id=rid, arrival=0.0, prompt_len=got["folds"][rid][1],
                output_len=10)
    assert len(eng.prompt_tokens(r)) == r.prompt_len
    eng.abort_request(r)
    assert rid not in eng._pinned_prompts
    assert rid not in eng._prompt_cache
    assert eng._token_buf.get(rid) is None
    eng.drain()
    assert not eng._retired


@pytest.mark.parametrize("variant", ["mixed", "sequential"])
def test_summary_matches_jax(stacks, jax_runs, variant):
    """``summarize`` over the same scheduler run gives the JAX package's
    TTFT, TPOT, queue time, throughput and makespan."""
    from repro.serving.metrics import summarize as jax_summarize
    from repro_torch.serving.metrics import summarize
    got = summarize(run_sched(stacks["torch"], mixed=variant == "mixed")[
        "reqs"]).row()
    want = jax_summarize(jax_runs[variant]["reqs"]).row()
    assert got.keys() == want.keys()
    np.testing.assert_allclose([got[k] for k in got],
                               [want[k] for k in got], rtol=1e-12)
    assert got["total_tokens"] == 14


@pytest.mark.parametrize("seed", [0, 7])
def test_workload_matches_jax(seed):
    """The port's Poisson trace is the JAX package's, request for
    request."""
    from repro.serving.workload import WorkloadSpec as JaxSpec
    from repro.serving.workload import generate as jax_generate
    from repro_torch.serving.workload import WorkloadSpec, generate
    kw = dict(n_requests=50, seed=seed, prompt_range=(256, 2048),
              output_range=(32, 64), rate=20.0)
    got = generate(WorkloadSpec(**kw))
    want = jax_generate(JaxSpec(arrival="poisson", **kw))
    assert [(r.req_id, r.arrival, r.prompt_len, r.output_len)
            for r in got] == \
        [(r.req_id, r.arrival, r.prompt_len, r.output_len) for r in want]


def test_chunk_size_invariance_matches_jax(stacks, jax_runs):
    """A 512-token prompt in 64-token chunks gives the JAX package's
    stream, runner keys and counters, and the same stream as 256-token
    chunks; chunk 64 keys T=64 only."""
    e64, t64 = chunked_prefill(stacks["torch"], 512, 64)
    _, t256 = chunked_prefill(stacks["torch"], 512, 256)
    j64, jt64 = jax_runs["chunk64"]
    assert t64 == jt64 == t256
    assert len(t64) == 3
    assert set(e64.pool._runners) == set(j64.pool._runners)
    assert all(getattr(e64.sync_stats, k) == getattr(j64.sync_stats, k)
               for k in COUNTERS)
    assert e64.sync_stats.host_argmax == 0
    assert all(k[5] <= 64 for k in e64.pool._runners if k[1] == "prefill")


def _drive(eng, reqs, steps, prompt=8):
    for r in reqs:
        eng.adaptors[0].append_slots(r.req_id, prompt)
    eng.prefill(reqs, 1, prompt)
    for r in reqs:
        eng.adaptors[0].append_slots(r.req_id, 1)
    for _ in range(steps):
        eng.decode(reqs, 1)
        for r in reqs:
            eng.adaptors[0].append_slots(r.req_id, 1)


def _reqs(n=2):
    out = []
    for i in range(n):
        r = Request(req_id=f"q{i}", arrival=0.0, prompt_len=8,
                    output_len=1 << 30)
        r.engine_group = 0
        out.append(r)
    return out


def test_steps_keep_pool_storage(stacks):
    """The port writes the pools in place where JAX donated them: no
    step moves a pool's storage."""
    _, _, eng = _engine(stacks["torch"])
    pools = [t for g in eng.islands[0].states for st in g
             for t in st["mixer"]]
    ptrs = [t.data_ptr() for t in pools]
    before = [t.clone() for t in pools]
    _drive(eng, _reqs(), 5)
    after = [t for g in eng.islands[0].states for st in g
             for t in st["mixer"]]
    assert [t.data_ptr() for t in after] == ptrs
    assert all(not torch.equal(a, b) for a, b in zip(after, before))


def test_fused_sampling_matches_host_argmax(stacks):
    """Greedy fused device argmax == the legacy host argmax; the fused
    path never reads a token back per request."""
    _, _, fused = _engine(stacks["torch"])
    _, _, host = _engine(stacks["torch"], fused_sampling=False,
                         async_window=0)
    rf, rh = _reqs(), _reqs()
    _drive(fused, rf, 6)
    _drive(host, rh, 6)
    sf = copy.copy(fused.sync_stats)
    assert {r.req_id: fused.generated_tokens(r.req_id) for r in rf} == \
        {r.req_id: host.generated_tokens(r.req_id) for r in rh}
    assert sf.host_argmax == 0 and sf.d2h_batched == 0 and sf.drains == 0
    assert host.sync_stats.host_argmax == 2 * 7


def test_staging_mutation_after_upload(stacks):
    """A reused host staging buffer may be mutated as soon as a step is
    launched: each upload is a snapshot. Garbage written into every
    staging buffer between the upload and the step's execution must not
    change a token."""
    _, _, clean = _engine(stacks["torch"])
    _, _, raced = _engine(stacks["torch"])
    make_runner = raced.pool.runner

    def racing_runner(*a, **kw):
        real = make_runner(*a, **kw)

        def run(params, states, batch):
            saved = {k: {n: b.copy() for n, b in bufs.items()}
                     for k, bufs in raced._host_bufs.items()}
            for bufs in raced._host_bufs.values():
                for b in bufs.values():
                    b.fill(7)
            try:
                return real(params, states, batch)
            finally:
                for k, bufs in raced._host_bufs.items():
                    for n, b in bufs.items():
                        b[...] = saved[k][n]
        return run

    raced.pool.runner = racing_runner
    rc, rr = _reqs(), _reqs()
    _drive(clean, rc, 6)
    _drive(raced, rr, 6)
    assert {r.req_id: clean.generated_tokens(r.req_id) for r in rc} == \
        {r.req_id: raced.generated_tokens(r.req_id) for r in rr}


def test_unported_engine_paths_raise(stacks):
    _, _, eng = _engine(stacks["torch"])
    assert eng.rebind(1) == 0.0
    with pytest.raises(NotImplementedError):
        _engine(stacks["torch"], injector=FaultInjector(
            [FaultSpec(kind=KILL, tick=3, engines=(0,))]))
    with pytest.raises(NotImplementedError):
        FlyingEngine(eng.model, ParallelPlan(tp_base=2, data_rows=1),
                     eng.geom, eng.params, device="cpu")
    assert eng.live_readable() is False


def test_launcher_serves_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import serve
    serve.main(["--real", "--reduced", "--device", "cpu", "--dtype",
                "float32", "--requests", "3", "--num-blocks", "128",
                "--prompt-range", "16", "48", "--output-range", "3", "6",
                "--prefill-chunk", "16", "--max-blocks-per-req", "16"])
    out = capsys.readouterr().out
    assert "requests done : 3/3" in out
    assert "host_argmax=0" in out


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_is_self_contained():
    """Nothing in the port, nor chip_smoke.py, imports jax or the JAX
    package (``repro``)."""
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
