"""The port's engine serving mamba2-2.7b and recurrentgemma-9b on 4 gloo
ranks across rebinds, against the JAX package's step level, on the CPU.

Four one-rank engines (``ParallelPlan(1, 1, 4)``) serve 12 requests
(prompts of 24-88 tokens in prefill chunks of 32, outputs of 12-20,
greedy) with the reduced mamba2-2.7b and the 3-layer recurrentgemma-9b
of ``tests/test_torch_recurrent_engine.py`` (fp32, the JAX package's
init with ``SLOW_DECAY``). A scripted layout policy rebinds mid-decode
from four DP islands to ``[TP2 | DP | DP]`` (a TP2 island over engines 0
and 1) and back, once under HARD and once under LIVE; every step and
rebind reports 10 ms. A reshape rebuilds the reshaped island's recurrent
rows, so its requests are drained and re-prefilled from a folded prompt
(the scheduler's recovery fold), never paused nor carried; requests on
the untouched islands keep their rows. Held: every request's tokens
equal the JAX package's ``build_serve_step`` run for it alone at batch 1
(``test_torch_recurrent_engine.jax_reference``); the ranks agree; the
reshaped islands' requests were recomputed (``recomputed_tokens`` > 0)
and nothing was paused or carried as a live rider; the untouched
islands show 0 drains before the final readout and none of their
requests was recovered; a TP2 island holds ``bpe * 2`` rows a rank of
half the heads (channels). One spawn runs both archs and both
strategies.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.engine import FlyingEngine
from repro_torch.core.kv_adaptor import PoolGeometry
from repro_torch.core.modes import FleetLayout, ParallelPlan
from repro_torch.core.scheduler import DynamicScheduler, SchedulerConfig
from repro_torch.core.task_pool import Request, prompt_token_ids
from repro_torch.models.model import Model
from test_torch_islands import FixedClock, _read_json, _spawn, _write_json

ARCHS = ("mamba2-2.7b", "recurrentgemma-9b")
STRATEGIES = ("hard", "live")
WORLD, BPE, CHUNK = 4, 2, 32
# (prompt, output) of each request, all arriving at once: two per engine,
# then four more as rows free up
TRACE = ((24, 16), (56, 20), (88, 12), (40, 18), (72, 14), (24, 20),
         (88, 16), (40, 12), (56, 14), (24, 12), (72, 16), (40, 20))
# the scheduler ticks of the two rebinds: all eight first admissions
# decoding at the first, the TP2 island's re-prefilled requests decoding
# at the second
TICKS = (6, 16)


def _layouts(plan):
    """Four one-engine DP islands, and a TP2 island carved over engines 0
    and 1 beside the other two."""
    dp = FleetLayout.of(plan, [(1, 1)] * WORLD)
    return dp, dp.carve(0, 2, 2)


class _Script:
    """Layout policy: ``at[tick]`` at the scripted ticks, else the
    current layout; records the lead engine of every bound request at
    each scripted tick, before the transition."""

    def __init__(self, at):
        self.at = at
        self.placed = []

    def decide(self, sched):
        if sched._tick in self.at:
            self.placed.append({r.req_id: r.engine_group
                                for r in sched.running + sched.waiting
                                if r.engine_group >= 0})
        return self.at.get(sched._tick, sched.layout)


class _Probe(FixedClock):
    """FixedClock that records the recurrent leaves' shapes of the
    islands holding this rank after each rebind, and each island's
    drains before the final readout."""

    def __init__(self, eng):
        super().__init__(eng)
        self.shapes, self.drains = [], None

    def rebind(self, layout):
        out = super().rebind(layout)
        self.shapes.append({
            f"{rt.island.start},{rt.island.n_engines},{rt.island.merge}":
                [list(t.shape) for t in self.eng._row_leaves(rt.states)]
            for rt in self.eng.islands if rt.seat is not None})
        return out

    def drain(self):
        self.drains = {f"{rt.island.start},{rt.island.n_engines},"
                       f"{rt.island.merge}": rt.stats.drains
                       for rt in self.eng.islands}
        self.eng.drain()


def engine_rank(rank, world, params_dir, out):
    """Both archs under HARD and LIVE on this rank: tokens, the original
    prompts, the scheduler's counters and incidents, and the probe's
    records."""
    res = {}
    plan = ParallelPlan(engine_rows=1, tp_base=1, data_rows=WORLD)
    dp, tp2 = _layouts(plan)
    for arch in ARCHS:
        cfg, params = torch.load(f"{params_dir}/{arch}.pt",
                                 weights_only=False)
        model = Model(cfg, torch.float32, torch.device("cpu"))
        geom = PoolGeometry(cfg, plan, num_blocks=128, block_base=4)
        for strategy in STRATEGIES:
            eng = FlyingEngine(model, plan, geom, params,
                               batch_per_engine=BPE, max_blocks_per_req=32,
                               device="cpu", check_zero_copy=True)
            probe = _Probe(eng)
            # tick 0 splits the scheduler's uniform start into the four
            # DP islands, before any request is bound
            script = _Script({0: dp, TICKS[0]: tp2, TICKS[1]: dp})
            sched = DynamicScheduler(
                plan, geom, probe, SchedulerConfig(
                    strategy=strategy, max_batch_per_group=BPE,
                    prefill_chunk=CHUNK), policy=script)
            reqs = [Request(req_id=f"q{i}", arrival=0.0, prompt_len=p,
                            output_len=o) for i, (p, o) in enumerate(TRACE)]
            prompts = {r.req_id: prompt_token_ids(r, cfg.vocab_size).tolist()
                       for r in reqs}
            for r in reqs:
                sched.submit(r)
            sched.run(max_steps=2000)
            res[f"{arch}/{strategy}"] = {
                "tokens": {r.req_id: list(map(int, eng.generated_tokens(
                    r.req_id))) for r in reqs},
                "prompts": prompts,
                "outputs": {r.req_id: r.output_len for r in reqs},
                "done": all(r.state == "done" for r in reqs),
                "stats": dict(sched.preempt_stats),
                "switches": sched.switches,
                "recovered": [(i["req"], i["why"], i["tick"])
                              for i in sched.incidents
                              if i["kind"] == "recover"],
                "placed": script.placed, "shapes": probe.shapes,
                "drains": probe.drains,
                "held": sum(len(rt.held) for rt in eng.islands)}
    _write_json(f"{out}.{rank}.json", res)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's parameters (init(key(0)), ``SLOW_DECAY``)
    converted and saved for the ranks, the spawn, and each request's
    step-level reference tokens from its prompt as the ranks drew it."""
    import jax
    import jax.numpy as jnp

    from repro.core.kv_adaptor import PoolGeometry as JaxGeometry
    from repro.core.modes import FlyingMode as JaxMode
    from repro.core.modes import ParallelPlan as JaxPlan
    from repro.core.steps import build_serve_step as jax_serve_step
    from repro.models.model import build_model as jax_build
    from repro_torch.convert import params_from_numpy
    from test_torch_recurrent import _configs, slow_decay
    from test_torch_recurrent_engine import BLOCK_BASE, jax_reference
    d = tmp_path_factory.mktemp("recurrent_engine_ranks")
    jax_side = {}
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        jm = jax_build(jcfg, jnp.float32)
        jp = slow_decay(jm.init(jax.random.key(0)))
        torch.save((cfg, params_from_numpy(
            cfg, jax.tree.map(np.asarray, jp), device="cpu")),
            d / f"{arch}.pt")
        jax_side[arch] = (jm, jp)
    _spawn(engine_rank, WORLD, str(d), str(d / "out"))
    per_rank = [_read_json(d / f"out.{r}.json") for r in range(WORLD)]
    refs = {}
    for arch, (jm, jp) in jax_side.items():
        jmode = JaxMode(JaxPlan(1, 1, 1), 1)
        jgeom = JaxGeometry(jm.cfg, JaxPlan(1, 1, 1), num_blocks=64,
                            block_base=BLOCK_BASE)
        steps = (jax.jit(jax_serve_step(jm, jmode, jgeom, phase="prefill",
                                        chunked=True)[0]),
                 jax.jit(jax_serve_step(jm, jmode, jgeom,
                                        phase="decode")[0]))
        run = per_rank[0][f"{arch}/{STRATEGIES[0]}"]
        refs[arch] = {rid: jax_reference(jm, jp, steps, prompt,
                                         run["outputs"][rid])
                      for rid, prompt in run["prompts"].items()}
    return per_rank, refs


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tokens_equal_the_step_level_reference(runs, arch, strategy):
    """Every request done, its tokens equal to the JAX step run for it
    alone, on every rank; the scheduler's three rebinds; every row
    released."""
    per_rank, refs = runs
    res = [dict(r[f"{arch}/{strategy}"]) for r in per_rank]
    for r in res:
        r.pop("shapes")             # each rank's own islands
    assert all(r == res[0] for r in res[1:])
    res = res[0]
    assert res["done"] and res["switches"] == 3 and res["held"] == 0
    assert res["prompts"] == per_rank[0][f"{arch}/hard"]["prompts"]
    assert res["tokens"] == refs[arch]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_reshaped_islands_re_prefill_and_untouched_keep_serving(
        runs, arch, strategy):
    """At each rebind the requests on engines 0 and 1 (the reshaped
    islands) are recovered by the fold, tokens recomputed, none paused
    or ridden; requests on engines 2 and 3 are not recovered, and their
    islands were never drained before the readout."""
    res = runs[0][0][f"{arch}/{strategy}"]
    stats = res["stats"]
    assert stats["paused"] == 0 and stats["live_riders"] == 0
    assert stats["recomputed_tokens"] > 0
    assert all(why == "reshape" for _, why, _ in res["recovered"])
    assert stats["recovered"] == len(res["recovered"])
    assert len(res["placed"]) == 3 and not res["placed"][0]
    for tick, placed in zip(TICKS, res["placed"][1:]):
        on = {g: {rid for rid, e in placed.items() if e == g}
              for g in range(WORLD)}
        assert on[0] and on[2] and on[3]
        assert {rid for rid, _, t in res["recovered"] if t == tick} == \
            on[0] | on[1]
    assert {t for _, _, t in res["recovered"]} == set(TICKS)
    assert res["drains"]["2,1,1"] == 0 and res["drains"]["3,1,1"] == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_tp2_island_rows_hold_half_the_heads(runs, arch):
    """After the first rebind, ranks 0 and 1 hold the TP2 island's rows:
    ``bpe * 2`` rows of half the heads (Mamba-2: conv channels of half
    the heads plus the replicated B and C; RG-LRU: half the channels);
    ranks 2 and 3 keep their one-engine islands' ``bpe`` full rows."""
    per_rank = runs[0]
    full = per_rank[2][f"{arch}/hard"]["shapes"][1]["2,1,1"]
    for rank in (0, 1):
        tp = per_rank[rank][f"{arch}/hard"]["shapes"][1]["0,2,2"]
        assert len(tp) == len(full)
        for got, one in zip(tp, full):
            assert got[1] == 2 * BPE and one[1] == BPE
            if len(one) == 5:                        # Mamba-2's ssm [n,
                assert got[2] * 2 == one[2]          # rows, heads, hd, S]
                assert got[3:] == one[3:]
            elif len(one) == 3:                      # RG-LRU's h
                assert got[2] * 2 == one[2]
