"""The port's host-side serving stack against the JAX package's, on the
CPU: every scenario of the reference's scheduler, simulator, layout and
policy, fault, allocator, prefix-cache, front-door and async-serving
tests, run through both packages.

Each reference test file is loaded twice from its own source: once as
it is, and once with ``repro.`` renamed ``repro_torch.``, so that one
scenario function drives either package. Each case runs both copies of
one test (with the same parameters; fixtures are built per package)
while every ``DynamicScheduler``, ``KVCacheAdaptor`` and ``FrontDoor``
that the scenario builds is recorded. Both copies must pass their own
assertions, and then their fingerprints must be identical:

- per scheduler: every field of every ``StepLog``, every request (all
  fields: state, generated, arrival, first-token and finish times, token
  times...), ``switches``, ``preempt_stats``, the lifecycle counters, the
  layout, incidents, ``tier_report`` and the prefix cache's counters;
- per adaptor: its whole state (block tables, free lists, prefix-cache
  index and refcounts), with block ids as they are;
- per front door: its counters, rejections and requests.

Floats compare exactly: both packages run the same host code on the same
inputs. Scenarios whose schedule follows the wall clock or a socket
(``NONDETERMINISTIC``) differ between two runs of the same package, so
for them only the outcome per request is compared. The three
reference scenarios that drive the JAX engine are held against it in
``tests/test_torch_engine.py`` instead.
"""
from __future__ import annotations

import dataclasses
import importlib
import inspect
import itertools
import re
import types
from contextlib import ExitStack, contextmanager
from pathlib import Path

import numpy as np
import pytest

TESTS = Path(__file__).resolve().parent
FILES = ("test_scheduler", "test_simulator", "test_fleet_layout",
         "test_faults", "test_kv_adaptor", "test_prefix_cache",
         "test_frontdoor", "test_async_serving")
# scenarios that drive the JAX engine: tests/test_torch_engine.py holds
# them (temperature, prefix cache, streaming) against the port's engine
ENGINE_CASES = {
    ("test_prefix_cache", "test_cached_tokens_identical_greedy"),
    ("test_prefix_cache", "test_cached_tokens_identical_temperature"),
    ("test_async_serving", "test_real_engine_stream_token_identity"),
}
# schedules that follow the wall clock or a socket's timing
NONDETERMINISTIC = {
    ("test_async_serving", "test_http_server_streams_completion_and_metrics"),
    ("test_async_serving", "test_http_disconnect_aborts_request"),
    ("test_async_serving", "test_http_loadgen_replay"),
}
RECORDED = (("core.scheduler", "DynamicScheduler", "sched"),
            ("core.kv_adaptor", "KVCacheAdaptor", "adaptor"),
            ("serving.frontdoor", "FrontDoor", "door"))

_MODS: dict = {}


def _clone(stem: str, pkg: str) -> types.ModuleType:
    """The reference test module ``stem``, its imports pointed at
    ``pkg``."""
    mod = _MODS.get((stem, pkg))
    if mod is None:
        src = (TESTS / f"{stem}.py").read_text()
        if pkg == "repro_torch":
            src = re.sub(r"\brepro\.", "repro_torch.", src)
        mod = types.ModuleType(f"_{pkg}_{stem}")
        mod.__file__ = str(TESTS / f"{stem}.py")
        exec(compile(src, mod.__file__, "exec"), mod.__dict__)
        _MODS[(stem, pkg)] = mod
    return mod


def _grid(fn):
    """The parametrize marks of ``fn`` as a list of (argnames, values)."""
    out = []
    for m in reversed(getattr(fn, "pytestmark", [])):
        if m.name != "parametrize":
            continue
        names, values = m.args[0], list(m.args[1])
        if isinstance(names, str):
            names = [n.strip() for n in names.split(",")]
        out.append((list(names), values))
    return out


def _params(fn, index):
    """kwargs of the parametrize cell ``index`` (one value index a
    mark)."""
    kw = {}
    for (names, values), i in zip(_grid(fn), index):
        v = values[i]
        v = v.values if hasattr(v, "values") and hasattr(v, "marks") else v
        if len(names) == 1:
            kw[names[0]] = v
        else:
            kw.update(zip(names, v))
    return kw


def _cases():
    out = []
    for stem in FILES:
        mod = _clone(stem, "repro")
        for name, fn in vars(mod).items():
            if not name.startswith("test_") or not callable(fn) \
                    or (stem, name) in ENGINE_CASES:
                continue
            grid = _grid(fn)
            for index in itertools.product(
                    *[range(len(values)) for _, values in grid]):
                kw = _params(fn, index)
                tag = "-".join(str(v) for v in kw.values())
                out.append(pytest.param(
                    stem, name, index,
                    id=f"{stem}::{name}" + (f"[{tag}]" if tag else "")))
    return out


# ---------------------------------------------------------------------------
# fixtures of the reference scenarios, built per package
# ---------------------------------------------------------------------------

def _call(mod, fn, kw, stack: ExitStack, tmp: Path, cache: dict):
    """Call ``fn`` with ``kw`` plus its fixtures: pytest's ``tmp_path``
    and ``monkeypatch``, or the module's own fixtures (module-scoped:
    built once a package)."""
    for p in inspect.signature(fn).parameters:
        if p in kw:
            continue
        if p == "tmp_path":
            tmp.mkdir(parents=True, exist_ok=True)
            kw[p] = tmp
        elif p == "monkeypatch":
            mp = pytest.MonkeyPatch()
            stack.callback(mp.undo)
            kw[p] = mp
        else:
            key = (mod.__name__, p)
            if key not in cache:
                fix = getattr(mod, p)._get_wrapped_function()
                cache[key] = _call(mod, fix, {}, stack, tmp, cache)
            kw[p] = cache[key]
    if hasattr(fn, "hypothesis"):
        # property scenarios: the same examples in both packages
        import hypothesis
        fn = hypothesis.seed(0)(fn)
    return fn(**kw)


@contextmanager
def _record(pkg: str):
    """Every instance of the recorded classes that ``pkg`` builds while
    the block runs, by kind, in creation order."""
    seen = {kind: [] for _, _, kind in RECORDED}
    undo = []
    for modname, clsname, kind in RECORDED:
        cls = getattr(importlib.import_module(f"{pkg}.{modname}"), clsname)
        orig = cls.__init__

        def init(self, *a, _orig=orig, _kind=kind, **kw):
            _orig(self, *a, **kw)
            seen[_kind].append(self)
        cls.__init__ = init
        undo.append((cls, orig))
    try:
        yield seen
    finally:
        for cls, orig in undo:
            cls.__init__ = orig


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def _dump(x, refs, depth=0, root=False):
    """A comparable, package-free rendering of ``x``: primitives as they
    are (floats by repr, so NaNs compare), containers element by element,
    objects of either package by class name and attributes; an object in
    ``refs`` (a recorded instance) by its class and index, unless it is
    the ``root`` being rendered."""
    if x is None or isinstance(x, (bool, int, str)):
        return x
    if isinstance(x, float):
        return repr(x)
    if isinstance(x, np.generic):
        return _dump(x.item(), refs, depth)
    if isinstance(x, np.ndarray):
        return ("ndarray", x.dtype.str, x.shape, repr(x.tolist()))
    if depth > 24:
        raise RecursionError("fingerprint too deep")
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,
                tuple(_dump(v, refs, depth + 1) for v in x))
    if isinstance(x, (set, frozenset)):
        return ("set", tuple(sorted(repr(_dump(v, refs, depth + 1))
                                    for v in x)))
    if isinstance(x, dict):
        return ("dict", tuple(sorted(
            (repr(_dump(k, refs, depth + 1)), _dump(v, refs, depth + 1))
            for k, v in x.items())))
    cls = type(x)
    if not cls.__module__.startswith(("repro.", "repro_torch.")):
        return ("object", cls.__name__)
    if id(x) in refs and not root:
        return ("ref", cls.__name__, refs[id(x)])
    if dataclasses.is_dataclass(x):
        names = [f.name for f in dataclasses.fields(x)]
    else:
        names = sorted(getattr(x, "__dict__", {}))
        for c in cls.__mro__:
            names += [s for s in getattr(c, "__slots__", ())
                      if hasattr(x, s)]
    return (cls.__name__, tuple(
        (n, _dump(getattr(x, n), refs, depth + 1)) for n in names))


def _requests(reqs):
    return sorted(reqs, key=lambda r: r.req_id)


def _fingerprint(pkg: str, seen, outcome_only: bool):
    metrics = importlib.import_module(f"{pkg}.serving.metrics")
    refs = {id(a): ("adaptor", i) for i, a in enumerate(seen["adaptor"])}
    refs.update({id(s): ("sched", i) for i, s in enumerate(seen["sched"])})
    if outcome_only:
        return [[(r.req_id, r.state, r.generated, r.output_len)
                 for r in _requests(s.pool.all.values())]
                for s in seen["sched"]]
    fp = {"sched": [], "adaptor": [], "door": []}
    for s in seen["sched"]:
        reqs = _requests(s.pool.all.values())
        pc = s.prefix_cache
        fp["sched"].append(_dump(dict(
            log=[dataclasses.astuple(rec) for rec in s.log],
            reqs=reqs, now=s.now, switches=s.switches,
            preempt=s.preempt_stats, lifecycle=s.lifecycle,
            layout=s.layout.describe(), quarantined=s.quarantined,
            incidents=s.incidents, tiers=metrics.tier_report(reqs),
            prefix=None if pc is None else pc.stats), refs))
    for a in seen["adaptor"]:
        fp["adaptor"].append(_dump(a, refs, root=True))
    for d in seen["door"]:
        fp["door"].append(_dump(dict(
            counters=d.counters, rejected=d.reject_reasons,
            reqs=_requests(d.requests.values())), refs))
    return fp


def run_scenario(stem: str, name: str, index, pkg: str, tmp: Path):
    """Run one reference scenario through ``pkg``; its fingerprint."""
    mod = _clone(stem, pkg)
    fn = getattr(mod, name)
    cache: dict = {}
    with ExitStack() as stack, _record(pkg) as seen:
        _call(mod, fn, _params(fn, index), stack, tmp, cache)
    return _fingerprint(pkg, seen,
                        (stem, name) in NONDETERMINISTIC)


@pytest.mark.parametrize("stem, name, index", _cases())
def test_reference_scenario_matches(stem, name, index, tmp_path):
    want = run_scenario(stem, name, index, "repro", tmp_path / "repro")
    got = run_scenario(stem, name, index, "repro_torch",
                       tmp_path / "repro_torch")
    assert got == want


def test_every_reference_scenario_is_held():
    """The case list covers each test function of the reference files,
    but for the engine scenarios held elsewhere, and each cell of its
    parameter grid."""
    names = {(c.values[0], c.values[1]) for c in _cases()}
    for stem in FILES:
        mod = _clone(stem, "repro")
        tests = {n for n, f in vars(mod).items()
                 if n.startswith("test_") and callable(f)}
        assert {(stem, n) for n in tests} - ENGINE_CASES <= names
    assert len(_cases()) > 120
    port = _clone("test_async_serving", "repro_torch")
    assert port.AsyncServeLoop.__module__ == "repro_torch.serving.asyncloop"


# the launcher: ``--sim`` prints the JAX package's summary byte for byte
LAUNCHER_ARGS = {
    "plain": ["--requests", "60"],
    "frontdoor": ["--requests", "60", "--frontdoor", "--priority-frac",
                  "0.2", "--prefix-cache", "--arrival", "bursty"],
    "deepseek": ["--requests", "60", "--arch", "deepseek-v2-236b"],
    "phi-moe": ["--requests", "60", "--arch", "phi3.5-moe-42b-a6.6b"],
}


@pytest.mark.parametrize("args", LAUNCHER_ARGS.values(),
                         ids=LAUNCHER_ARGS.keys())
def test_sim_launcher_prints_the_reference_summary(args, capsys):
    """``--sim`` runs the simulator (the JAX package's default) and
    prints what the JAX package's launcher prints for the same flags;
    the note that its times are the TPU v5e cost model's goes to
    standard error."""
    ref = importlib.import_module("repro.launch.serve")
    port = importlib.import_module("repro_torch.launch.serve")
    ref.main(list(args))
    want = capsys.readouterr().out
    port.main(["--sim", *args])
    got = capsys.readouterr()
    assert got.out == want
    assert "requests done : 60/60" in want
    assert "simulated TPU v5e" in got.err


def test_launcher_runs_on_the_card_unless_asked():
    """The port's launcher builds its engine on the card by default: the
    simulator, and the CPU, are each asked for by a flag, and without a
    card the default raises instead of falling back."""
    import torch
    serve = importlib.import_module("repro_torch.launch.serve")
    assert serve.parse_config([]).real is True
    assert serve.parse_config(["--sim"]).real is False
    assert serve.ServeConfig().device == ""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve.main(["--requests", "2"])
