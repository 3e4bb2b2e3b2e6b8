"""Port parity: ``repro_torch.telemetry`` — ``Tracer``, ``RunReport``,
``profile_phases``, ``roofline`` — and the traced ``fit`` / serving paths,
against ``repro.telemetry`` on the same numpy inputs, the port on the CPU.

Each case names the reference test it mirrors (``tests/test_trace.py``
unless said otherwise).  A traced fit must return the untraced fit's bits
(θ, trajectory, ledger).  Span names, counter names and counter values
must equal the JAX run's for the same fit or serving stream; the JAX runs
here set ``REPRO_PROGRAM_CACHE=0``, so the reference tags each dispatch
``uncached`` as the port always does (``ROADMAP.md`` queue 3, item 20).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from collections import Counter, deque

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.ml.linear import lsq_loss as j_lsq  # noqa: E402
from repro.serve import MicroBatcher as JBatcher  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro.telemetry import RunReport as JReport  # noqa: E402
from repro.telemetry import Tracer as JTracer  # noqa: E402
from repro.telemetry import roofline as j_roofline  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.ml.linear import lsq_loss as t_lsq  # noqa: E402
from repro_torch.serve import MicroBatcher, ServeEngine, ServeMetrics  # noqa: E402
from repro_torch.telemetry import RunReport, Tracer, roofline  # noqa: E402
from repro_torch.telemetry import trace as trace_mod  # noqa: E402

K, NK, N, STEPS = 8, 12, 5, 25
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(K, NK, N)).astype(np.float32)
    w = rng.normal(size=(N,)).astype(np.float32)
    y = np.asarray(jnp.einsum("kni,i->kn", jnp.asarray(X), jnp.asarray(w)))
    return X, y


#: the three fits the exactness and parity cases run: local × a kernel
#: wire, a sweep, and a §5 server transport
FITS = {
    "local-topk": dict(transport="allreduce", wire="topk:0.01+ef", steps=STEPS),
    "sweep": dict(transport="allreduce", steps=STEPS, executor="sweep",
                  sweep={"lr": [0.02, 0.1]}),
    "server": dict(transport="sequential_server", wire="topk:0.5+ef",
                   schedule=list(range(K)) * 2),
}


def t_fit(data, spec, **kw):
    return tapi.fit(tapi.GradientDescent(t_lsq, lr=0.05), data, device="cpu",
                    **{**FITS[spec], **kw})


def j_fit(data, spec, **kw):
    spec = dict(FITS[spec])
    if "sweep" in spec:
        spec["sweep"] = {k: jnp.asarray(v) for k, v in spec["sweep"].items()}
    if "schedule" in spec:
        spec["schedule"] = jnp.asarray(spec["schedule"], jnp.int32)
    X, y = data
    return japi.fit(japi.GradientDescent(j_lsq, lr=0.05), (jnp.asarray(X), jnp.asarray(y)),
                    **spec, **kw)


def same_bits(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


def same_fit(a, b) -> bool:
    ledgers = (a.ledger, b.ledger) if isinstance(a.ledger, list) else ([a.ledger], [b.ledger])
    return (same_bits(a.theta, b.theta) and same_bits(a.trajectory, b.trajectory)
            and [x.summary() for x in ledgers[0]] == [x.summary() for x in ledgers[1]]
            and [x.events for x in ledgers[0]] == [x.events for x in ledgers[1]])


# ----------------------------------------------------------------------------
# Exactness (TestExactness)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("spec", list(FITS))
def test_traced_fit_is_bitwise_untraced(problem, spec):
    """Mirrors ``TestExactness::test_tracer_off_bitwise_identical`` /
    ``test_trace_phases_bit_exact``: no tracer, a disabled one, a live one
    and ``trace="phases"`` give the same bits."""
    base = t_fit(problem, spec)
    for kw in ({"tracer": Tracer(enabled=False)}, {"tracer": Tracer()},
               {"tracer": Tracer(), "trace": "phases"}):
        assert same_fit(base, t_fit(problem, spec, **kw)), kw


def test_disabled_tracer_records_nothing(problem):
    """Mirrors ``TestExactness::test_disabled_tracer_records_nothing``."""
    t = Tracer(enabled=False)
    t_fit(problem, "local-topk", tracer=t)
    t.count("x")
    t.gauge("g", 1)
    with t.span("s"):
        pass
    assert t.spans == [] and t.counters == {} and t.gauges == {}


def test_trace_argument_checks_as_reference(problem):
    """Mirrors ``TestExactness::test_trace_phases_requires_tracer``: the same
    ValueError texts."""
    for kw in ({"trace": "phases"}, {"trace": "rounds", "tracer": Tracer()}):
        with pytest.raises(ValueError) as et:
            t_fit(problem, "local-topk", **kw)
        jkw = dict(kw)
        if "tracer" in jkw:
            jkw["tracer"] = JTracer()
        with pytest.raises(ValueError) as ej:
            j_fit(problem, "local-topk", **jkw)
        assert str(et.value) == str(ej.value)


# ----------------------------------------------------------------------------
# The same timeline as the reference's
# ----------------------------------------------------------------------------


def _names(tracer) -> Counter:
    return Counter(s["name"] for s in tracer.spans)


#: the port's spans of a round's phases, which the reference does not record
ROUND_SPANS = ("fit/round/update", "fit/round/wire", "fit/round/aggregate",
               "fit/round/metric")


def _reference_names(port, ref) -> Counter:
    """The port's span names less its round spans, which the reference
    must not record either."""
    assert not set(ROUND_SPANS) & set(_names(ref))
    return Counter({k: n for k, n in _names(port).items() if k not in ROUND_SPANS})


def _rounds(tracer) -> dict:
    """How many times the tracer recorded each round span."""
    names = _names(tracer)
    return {k: names[k] for k in ROUND_SPANS}


def _each(n) -> dict:
    return dict.fromkeys(ROUND_SPANS, n)


@pytest.mark.parametrize("spec", list(FITS))
def test_fit_spans_and_counters_match_jax(problem, spec, monkeypatch):
    """Mirrors ``TestExactness::test_trace_phases_bit_exact``'s span names:
    a traced ``trace="phases"`` fit records the JAX run's span names (each
    as many times), counters (names and values) and skipped probes."""
    monkeypatch.setenv("REPRO_PROGRAM_CACHE", "0")
    jt, tt = JTracer(), Tracer()
    j_fit(problem, spec, tracer=jt, trace="phases")
    t_fit(problem, spec, tracer=tt, trace="phases")
    assert _reference_names(tt, jt) == _names(jt)
    assert _rounds(tt) == _each(0 if spec == "server" else STEPS)
    assert tt.counters == jt.counters
    assert tt.gauges == jt.gauges
    for name in ("fit/loop", "phase/local_step", "phase/encode"):
        assert name in _names(tt)
    dispatch = [s for s in tt.spans if s["name"].startswith("dispatch/")]
    assert [s["tags"] for s in dispatch] == [
        s["tags"] for s in jt.spans if s["name"].startswith("dispatch/")]
    loop = next(s for s in tt.spans if s["name"] == "fit/loop")["tags"]
    assert loop == next(s for s in jt.spans if s["name"] == "fit/loop")["tags"]


@pytest.mark.parametrize("executor", ["mesh", "multipod"])
def test_mesh_phases_match_jax_on_one_device(problem, executor, monkeypatch):
    """Mirrors ``TestMultipodEightDevices::test_per_hop_spans`` on one
    device (a port mesh without a process group is a world of one): the
    per-hop probes and the statistics completion, as the JAX run names
    them, and the traced fit bitwise the untraced one."""
    monkeypatch.setenv("REPRO_PROGRAM_CACHE", "0")
    X, y = problem
    kw = dict(transport="allreduce", steps=5, executor=executor, wire="topk:0.5+ef")
    jt, tt = JTracer(), Tracer()
    japi.fit(japi.GradientDescent(j_lsq, lr=0.05), (jnp.asarray(X), jnp.asarray(y)),
             tracer=jt, trace="phases", **kw)
    base = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.05), (X, y), device="cpu", **kw)
    res = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.05), (X, y), device="cpu", tracer=tt,
                   trace="phases", **kw)
    assert same_fit(base, res)
    assert _reference_names(tt, jt) == _names(jt)
    assert _rounds(tt) == _each(5)
    assert tt.counters == jt.counters and tt.gauges == jt.gauges
    assert "phase/stats_completion" in _names(tt)
    hops = {s["name"]: s["tags"] for s in tt.spans if s["name"].startswith("hop/")}
    assert hops == {s["name"]: s["tags"] for s in jt.spans if s["name"].startswith("hop/")}


def test_inapplicable_probe_is_skipped_with_its_reason(problem):
    """``_fenced`` against the reference's own (``src/repro/telemetry/
    phases.py:47-59``; no reference test): a probe that raises bumps
    ``phases/skipped`` and records the exception's type under
    ``<name>/skipped``."""
    from repro.telemetry import phases as j_phases
    from repro_torch.telemetry import phases as t_phases

    def boom(*a):
        raise KeyError("x")

    for mod, tr in ((t_phases, Tracer()), (j_phases, JTracer())):
        assert mod._fenced(tr, "phase/x", boom) is False
        assert tr.counters == {"phases/skipped": 1}
        assert tr.gauges == {"phase/x/skipped": "KeyError"} and tr.spans == []


def _serve_stream(engine_cls, batcher_cls, tracer_cls, theta, n):
    now = [0.0]
    t = tracer_cls()
    strategy = (tapi if engine_cls is ServeEngine else japi).GradientDescent(
        t_lsq if engine_cls is ServeEngine else j_lsq)
    eng = engine_cls(strategy, theta, tracer=t)
    b = batcher_cls(eng, max_batch=4, timeout_s=0.5, clock=lambda: now[0], tracer=t)
    rng = np.random.default_rng(3)
    for step in range(11):
        b.submit(rng.normal(size=(n,)).astype(np.float32))
        now[0] += 0.125 * (step % 3)
        b.poll()
    b.flush()
    eng.predict(np.zeros((2, n), np.float32))
    eng.swap(theta)
    return t, eng


def test_serving_spans_and_counters_match_jax():
    """Mirrors ``TestServeTracing::test_engine_spans_and_counters``: one
    serving stream (submits, clock ticks, polls, a direct predict, a swap)
    records the JAX run's spans, batch tags and counters, queue waits
    included."""
    theta = np.random.default_rng(2).normal(size=(N,)).astype(np.float32)
    jt, je = _serve_stream(JEngine, JBatcher, JTracer, jnp.asarray(theta), N)
    tt, te = _serve_stream(ServeEngine, MicroBatcher, Tracer, torch.from_numpy(theta), N)
    assert _names(tt) == _names(jt)
    assert tt.counters == pytest.approx(jt.counters)
    assert set(tt.counters) == {"serve/requests", "serve/padded_slots", "batcher/requests",
                                "batcher/padded_slots", "batcher/queue_wait_s"}
    for name in ("batcher/serve", "serve/predict"):
        assert [s["tags"] for s in tt.spans if s["name"] == name] == \
            [s["tags"] for s in jt.spans if s["name"] == name]
    assert te.ledger.summary() == je.ledger.summary()


def test_batcher_queue_wait():
    """Mirrors ``TestServeTracing::test_batcher_queue_wait``."""
    now = [0.0]
    t = Tracer()
    mb = MicroBatcher(lambda X: X * 2.0, max_batch=4, clock=lambda: now[0], tracer=t)
    mb.submit(np.zeros(3, np.float32))
    now[0] = 1.0
    mb.submit(np.zeros(3, np.float32))
    now[0] = 5.0
    mb.flush()
    (serve_span,) = [s for s in t.spans if s["name"] == "batcher/serve"]
    assert serve_span["tags"]["queue_wait_ms"] == pytest.approx(5000.0)
    assert serve_span["tags"]["valid"] == 2 and serve_span["tags"]["bucket"] == 2
    assert t.counters["batcher/queue_wait_s"] == pytest.approx(9.0)
    assert t.counters["batcher/requests"] == 2


def test_engine_captures_ambient_tracer(problem):
    """Mirrors ``TestServeTracing::test_engine_captures_ambient_tracer``."""
    t = Tracer()
    res = t_fit(problem, "local-topk", executor="serve", tracer=t)
    eng = res.metrics["serve_engine"]
    assert eng.tracer is t
    eng.predict(np.zeros((2, N), np.float32))
    assert t.counters["serve/requests"] == 2
    assert "serve/swap" in _names(t) and "dispatch/serve-update" in _names(t)


def test_continuous_engine_records_into_the_ambient_tracer():
    """Mirrors ``TestServeTracing::test_engine_captures_ambient_tracer`` for
    the continuous engine: ``tracer=`` defaults to the ambient tracer
    (as ``src/repro/serve/continuous.py:236``): one ``serve/decode_step``
    span a decode step, one ``serve/requests`` count a request, and the
    same greedy ids as an untraced engine."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ContinuousLMEngine

    cfg = get_config("tinyllama-1.1b").reduced()
    params = tf.init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32) for n in (5, 9, 3)]

    def serve():
        eng = ContinuousLMEngine(cfg, params, n_slots=2, page_size=4, max_seq=16,
                                 device="cpu")
        tickets = [eng.submit(p, max_new=4) for p in prompts]
        steps = eng.run_until_idle()
        return eng, steps, [t.result() for t in tickets]

    plain, _, ids = serve()
    assert plain.tracer is None
    t = Tracer()
    with trace_mod.activated(t):
        eng, steps, traced = serve()
    assert eng.tracer is t
    assert all((a == b).all() for a, b in zip(ids, traced))
    assert _names(t)["serve/decode_step"] == steps == eng.metrics.decode_steps
    assert t.counters["serve/requests"] == 3
    assert t.counters["serve/decode_tokens"] == eng.stats()["tokens"]
    d = RunReport.from_serve(eng).as_dict()
    assert d["decode_kernel_hits"] == {"cuda": 0, "plain": eng.stats()["tokens"]}
    assert "serve/decode_step" in d["spans"]


# ----------------------------------------------------------------------------
# Tracer (TestTracer)
# ----------------------------------------------------------------------------


def test_span_nesting_and_summary():
    """Mirrors ``TestTracer::test_span_nesting_and_summary``."""
    t = Tracer()
    with t.span("outer", round=1):
        with t.span("inner"):
            pass
        with t.span("inner"):
            pass
    agg = t.summary()
    assert agg["inner"]["count"] == 2 and agg["outer"]["count"] == 1
    assert agg["outer"]["total_s"] >= agg["inner"]["total_s"]
    assert t.wall_s("outer") == agg["outer"]["total_s"]
    assert set(agg["outer"]) == {"count", "total_s", "max_s", "mean_s"}


def test_counters_and_gauges():
    """Mirrors ``TestTracer::test_counters_and_gauges``."""
    t = Tracer()
    t.count("hits")
    t.count("hits", 2)
    t.gauge("depth", 7)
    t.gauge("depth", 3)
    assert t.counters == {"hits": 3} and t.gauges == {"depth": 3}


def test_span_tags_mutable_inside():
    """Mirrors ``TestTracer::test_span_tags_mutable_inside``."""
    t = Tracer()
    with t.span("s", a=1) as rec:
        rec["tags"]["b"] = 2
    assert t.spans[0]["tags"] == {"a": 1, "b": 2}


def test_ambient_span_noop_without_tracer():
    """Mirrors ``TestTracer::test_ambient_span_noop_without_tracer``."""
    assert trace_mod.current_tracer() is None
    with trace_mod.span("nothing"):
        pass


def test_ambient_activation():
    """Mirrors ``TestTracer::test_ambient_activation``; a disabled tracer is
    no ambient tracer."""
    t = Tracer()
    with trace_mod.activated(t):
        assert trace_mod.current_tracer() is t
        with trace_mod.span("ambient"):
            pass
        with trace_mod.activated(None):
            assert trace_mod.current_tracer() is None
    assert trace_mod.current_tracer() is None
    assert [s["name"] for s in t.spans] == ["ambient"]
    with trace_mod.activated(Tracer(enabled=False)):
        assert trace_mod.current_tracer() is None


def test_threads_get_their_own_track():
    """The ``Tracer`` docstring's thread contract (no reference test): each
    thread's spans carry their own ``tid``."""
    import threading

    t = Tracer()

    def work():
        with t.span("worker"):
            pass

    with t.span("main"):
        th = threading.Thread(target=work)
        th.start()
        th.join()
    tids = {s["name"]: s["tid"] for s in t.spans}
    assert tids["main"] != tids["worker"]


def _event_fields(events) -> dict:
    out: dict = {}
    for e in events:
        out.setdefault(e["ph"], set()).update(e)
    return out


def test_chrome_export_schema_matches_jax(problem, tmp_path, monkeypatch):
    """Mirrors ``TestTracer::test_chrome_export_schema``: valid JSON under a
    ``traceEvents`` root, the reference's fields on each kind of event, one
    complete event a closed span, a counter sample a counter."""
    monkeypatch.setenv("REPRO_PROGRAM_CACHE", "0")
    jt, tt = JTracer(), Tracer()
    j_fit(problem, "local-topk", tracer=jt, trace="phases")
    t_fit(problem, "local-topk", tracer=tt, trace="phases")
    for t in (jt, tt):
        t.count("custom", 3)
    path = tt.export_chrome(str(tmp_path / "run.trace.json"))
    with open(path) as f:
        payload = json.load(f)
    assert set(payload) == {"traceEvents", "displayTimeUnit"}
    events = payload["traceEvents"]
    assert _event_fields(events) == _event_fields(jt.chrome_events())
    for e in events:
        assert {"ph", "ts", "pid", "tid", "name"} <= set(e) and e["ph"] in ("X", "C", "M")
        if e["ph"] == "X":
            assert e["dur"] >= 0
    complete = [e for e in events if e["ph"] == "X"]
    assert len(complete) == len(tt.spans)
    names = Counter(e["name"] for e in complete)
    assert Counter({k: n for k, n in names.items() if k not in ROUND_SPANS}) == _names(jt)
    assert {k: names[k] for k in ROUND_SPANS} == _each(STEPS)
    assert any(e["ph"] == "C" and e["name"] == "custom" and e["args"]["value"] == 3
               for e in events)


def test_traceview_cli_reads_the_port_trace(problem, tmp_path):
    """Mirrors ``TestTracer::test_traceview_cli``."""
    t = Tracer()
    t_fit(problem, "local-topk", tracer=t)
    path = t.export_chrome(str(tmp_path / "run.trace.json"))
    proc = subprocess.run([sys.executable, os.path.join(REPO, "tools", "traceview.py"), path],
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "fit/loop" in proc.stdout and "dispatch/local-update" in proc.stdout


def test_device_trace_writes_a_profile(tmp_path):
    """No reference test (``jax.profiler.trace`` there; ROADMAP queue 3,
    item 21): ``device_trace`` nests ``torch.profiler`` under a ``device_trace``
    span and writes its Chrome trace; on the CPU the profile holds the CPU
    operations of the block."""
    t = Tracer()
    with t.device_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert [s["name"] for s in t.spans] == ["device_trace"]
    assert t.spans[0]["tags"]["logdir"] == str(tmp_path / "prof")
    with open(tmp_path / "prof" / "device_trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "aten::mm" in names
    assert any(a.key == "aten::mm" for a in prof.key_averages())


# ----------------------------------------------------------------------------
# The port's own spans: a round's phases, an EM iteration's steps (no
# reference test: the reference records none of them)
# ----------------------------------------------------------------------------

ROUND_FITS = {
    "local-allreduce": dict(transport="allreduce", wire="topk:0.25+ef"),
    "local-delay_line": dict(transport="delay_line", staleness=2, wire="topk:0.25+ef"),
    "sweep-allreduce": dict(transport="allreduce", executor="sweep",
                            sweep={"lr": [0.02, 0.05, 0.1]}),
    "sweep-delay_line": dict(transport="delay_line", staleness=1, executor="sweep",
                             sweep={"lr": [0.02, 0.1]}),
    "mesh-allreduce": dict(transport="allreduce", executor="mesh", wire="topk:0.25+ef"),
    "mesh-delay_line": dict(transport="delay_line", staleness=1, executor="mesh"),
}


@pytest.mark.parametrize("spec", list(ROUND_FITS))
def test_round_spans_open_once_a_round(problem, spec):
    """Each round span opens exactly once a round inside the executor's
    ``dispatch`` span, in the round's order, under the local loop, a sweep
    (once a round, not once a scenario) and a mesh of one rank; the traced
    fit is bitwise the untraced one."""
    steps = 7
    kw = dict(ROUND_FITS[spec], steps=steps, device="cpu")
    base = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.05), problem, **kw)
    t = Tracer()
    res = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.05), problem, tracer=t, **kw)
    assert same_fit(base, res)
    assert _rounds(t) == _each(steps)
    (loop,) = [s for s in t.spans if s["name"].startswith("dispatch/")]
    rounds = [s for s in t.spans if s["name"] in ROUND_SPANS]
    assert [s["name"] for s in rounds] == list(ROUND_SPANS) * steps
    for a, b in zip(rounds, rounds[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    assert all(loop["ts"] <= s["ts"] and s["ts"] + s["dur"] <= loop["ts"] + loop["dur"]
               for s in rounds)
    assert all(s["tags"] == {} for s in rounds)


def test_kmeans_spans_and_bits():
    """A traced ``distributed_kmeans`` records one ``kmeans/estep`` and one
    ``kmeans/mstep`` an iteration and one ``kmeans/assign``, and returns the
    untraced call's bits."""
    from repro_torch.ml.clustering import distributed_kmeans

    g = torch.Generator().manual_seed(4)
    Xs = torch.randn((4, 50, 3), generator=g)
    C0 = Xs[0, :6].clone()
    base = distributed_kmeans(Xs, C0, num_clusters=6, iters=5)
    t = Tracer()
    with trace_mod.activated(t):
        res = distributed_kmeans(Xs, C0, num_clusters=6, iters=5)
    assert same_bits(res.centroids, base.centroids)
    assert torch.equal(res.assignments, base.assignments)
    assert same_bits(res.inertia, base.inertia)
    assert [s["name"] for s in t.spans] == ["kmeans/estep", "kmeans/mstep"] * 5 + [
        "kmeans/assign"]


@pytest.mark.parametrize("executor", ["local", "sweep"])
def test_spans_are_profiler_ranges_only_under_the_profiler(problem, monkeypatch, executor):
    """Under ``torch.profiler`` every span is also a ``record_function``
    range of its name, a user annotation, once for each span (inside the
    sweep's ``vmap`` too); without the profiler no range is opened."""
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.ml.clustering import distributed_kmeans

    kw = {} if executor == "local" else dict(executor="sweep", sweep={"lr": [0.02, 0.1]})

    def run(tracer):
        tapi.fit(tapi.GradientDescent(t_lsq, lr=0.05), problem, transport="allreduce",
                 steps=3, device="cpu", tracer=tracer, **kw)
        with trace_mod.activated(tracer):
            distributed_kmeans(torch.from_numpy(problem[0]), torch.from_numpy(problem[0][0, :3]),
                               num_clusters=3, iters=2)

    opened = []
    real = autograd_profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(autograd_profiler, "record_function", counting)
    run(Tracer())
    assert opened == []
    t = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(t)
    assert Counter(opened) == _names(t)
    ranges = Counter(e.name for e in prof.events() if e.is_user_annotation)
    assert ranges == _names(t)
    assert _rounds(t) == _each(3) and _names(t)["kmeans/estep"] == 2


# ----------------------------------------------------------------------------
# RunReport (TestRunReport)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("spec", list(FITS))
def test_run_report_from_fit_matches_jax(problem, spec, monkeypatch):
    """Mirrors ``TestRunReport::test_from_fit_joins_everything`` /
    ``test_sweep_fit_report``: the reference's keys, equal ``comm``, the
    dispatch counts, wire kernel hits with the port's launch counts, one
    JSON-serializable dict, a markdown rendering."""
    monkeypatch.setenv("REPRO_PROGRAM_CACHE", "0")
    jt, tt = JTracer(), Tracer()
    rj = j_fit(problem, spec, tracer=jt, trace="phases")
    rt = t_fit(problem, spec, tracer=tt, trace="phases")
    dj = JReport.from_fit(rj, tracer=jt).as_dict()
    rep = RunReport.from_fit(rt, tracer=tt)
    d = rep.as_dict()
    assert set(d) == set(dj)
    assert d["config"] == dj["config"]
    assert d["comm"] == dj["comm"]
    assert set(dj["program_cache"]) <= set(d["program_cache"])
    assert d["program_cache"]["uncached"] >= 1
    assert set(d["spans"]) - set(ROUND_SPANS) == set(dj["spans"])
    assert {k: d["spans"][k]["count"] for k in ROUND_SPANS if k in d["spans"]} == (
        {} if spec == "server" else _each(STEPS))
    assert d["counters"] == dj["counters"]
    if "wire_kernel_hits" in dj:
        hits = dict(d["wire_kernel_hits"])
        assert hits.pop("launches") == {}  # the CPU takes the plain versions
        assert hits == dj["wire_kernel_hits"]
    json.dumps(d)
    json.loads(rep.to_json())
    md = rep.to_markdown()
    assert "RunReport (fit)" in md and "fit/loop" in md and "uncached dispatches" in md


def test_run_report_from_serve_matches_jax(problem):
    """Mirrors ``TestRunReport::test_from_serve``."""
    rj, rt = j_fit(problem, "local-topk"), t_fit(problem, "local-topk")
    jt, tt = JTracer(), Tracer()
    je = JEngine.from_fit(rj, japi.GradientDescent(j_lsq, lr=0.05), tracer=jt)
    te = ServeEngine.from_fit(rt, tapi.GradientDescent(t_lsq, lr=0.05), tracer=tt)
    je.predict(np.zeros((3, N), np.float32))
    te.predict(np.zeros((3, N), np.float32))
    dj, rep = JReport.from_serve(je).as_dict(), RunReport.from_serve(te)
    d = rep.as_dict()
    assert set(d) == set(dj) and d["comm"] == dj["comm"]
    assert set(dj["serve"]) <= set(d["serve"])
    assert d["serve"]["requests"] == 3 and "serve/predict" in d["spans"]
    assert d["counters"] == dj["counters"]
    assert "RunReport (serve)" in rep.to_markdown()


def test_metrics_json(problem):
    """Mirrors ``TestRunReport::test_metrics_json``."""
    res = t_fit(problem, "local-topk", executor="serve")
    m = res.metrics_json()
    assert "carry" not in m and m["serve_engine"] == "<ServeEngine>"
    assert m["transport"] == "allreduce"
    json.dumps(m)
    with pytest.raises(TypeError):
        json.dumps(res.metrics)


# ----------------------------------------------------------------------------
# ServeMetrics (TestServeMetricsWindow) and the roofline (test_telemetry.py)
# ----------------------------------------------------------------------------


def test_p99_key():
    """Mirrors ``TestServeMetricsWindow::test_p99_key``."""
    s = ServeMetrics().summary()
    assert "p99_latency_ms" in s and s["p99_latency_ms"] == 0.0


def test_window_evicts_oldest_first():
    """Mirrors ``TestServeMetricsWindow::test_window_evicts_oldest_first``."""
    m = ServeMetrics(latencies_s=deque(maxlen=4))
    z = np.zeros(1, np.float32)
    for lat in (1.0, 2.0, 3.0, 4.0, 5.0, 6.0):
        m.record_batch(1, 1, lat, z, z, tag="t")
    assert list(m.latencies_s) == [3.0, 4.0, 5.0, 6.0]
    s = m.summary()
    assert s["p99_latency_ms"] == pytest.approx(6000.0)
    assert s["p50_latency_ms"] == pytest.approx(5000.0)
    assert s["requests"] == 6 and s["batches"] == 6
    assert m.ledger.events == [("inference", "t", 6 * 8)]


def test_roofline_on_the_h100():
    """Mirrors ``tests/test_telemetry.py::test_roofline_terms`` /
    ``test_model_flops`` on the H100 SXM's constants: one second of each
    term at its rate, the dominant term, the useful share."""
    assert (roofline.PEAK_FLOPS_BF16, roofline.HBM_BW, roofline.NVLINK_BW) == \
        (989e12, 3.35e12, 450e9)
    r = roofline.roofline(flops_per_device=989e12, bytes_per_device=2 * 3.35e12,
                          collective_bytes_per_device=0.5 * 450e9, chips=4,
                          model_flops=2 * 989e12)
    assert (r.compute_s, r.memory_s, r.collective_s) == pytest.approx((1.0, 2.0, 0.5))
    assert r.dominant == "memory" and r.useful_ratio == pytest.approx(0.5)
    jr = j_roofline.roofline(flops_per_device=989e12, bytes_per_device=2 * 3.35e12,
                             collective_bytes_per_device=0.5 * 450e9, chips=4,
                             model_flops=2 * 989e12)
    assert set(r.to_dict()) == set(jr.to_dict()) and r.chips == jr.chips == 4
    assert roofline.model_flops_train(1e9, 1e6) == j_roofline.model_flops_train(1e9, 1e6)
    assert roofline.model_flops_decode(1e9, 10) == j_roofline.model_flops_decode(1e9, 10)


# ----------------------------------------------------------------------------
# docs/OBSERVABILITY.md's first block, read and run with repro → repro_torch
# ----------------------------------------------------------------------------


def test_observability_first_block_runs_on_the_port():
    """Mirrors ``tests/test_docs.py[docs/OBSERVABILITY.md]`` for the first
    block, with ``repro`` → ``repro_torch``: the same spans, tags,
    counters and gauges."""
    from tools.check_docs import PRELUDE

    with open(os.path.join(REPO, "docs", "OBSERVABILITY.md")) as f:
        lines = f.read().splitlines()
    i = next(k for k in range(17, len(lines)) if lines[k].strip() == "```python")
    j = next(k for k in range(i + 1, len(lines)) if lines[k].strip() == "```")
    src = "\n".join(lines[i + 1: j])
    port = src.replace("from repro.", "from repro_torch.")
    assert port != src and "repro_torch.telemetry" in port
    out = []
    for code in (src, port):
        ns: dict = {}
        exec(PRELUDE, ns)
        exec(compile(code, "OBSERVABILITY.md", "exec"), ns)
        t = ns["tracer"]
        out.append((type(t).__module__, t.counters, t.gauges,
                    {k: v["count"] for k, v in t.summary().items()},
                    [s["tags"] for s in t.spans]))
    assert out[1][0] == "repro_torch.telemetry.trace"
    assert out[0][1:] == out[1][1:]
