"""Port parity: ``repro_torch.serve`` — ``ServeEngine``, ``MicroBatcher``,
``ModelRegistry``, the ``serve`` executor and the microbatched LM and CLI
paths of ``repro_torch.launch.serve`` — against ``repro.serve`` and
``repro.launch.serve`` on the same numpy inputs, the port on the CPU.

Each case names the reference test it mirrors (``tests/test_serve.py``
unless said otherwise).  θ crosses with ``convert.theta_from_reference``
where both engines must serve the same parameters.  Tolerances: GD
predictions rtol 1e-6 / atol 1e-7 on the same θ (the two packages' matrix
products sum in another order); k-windows labels, greedy LM ids, ledgers
and registry bytes exactly; fits trained apart in the two packages at
``test_torch_fit.py``'s rtol 1e-5 / atol 1e-6.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import schedules as j_sched  # noqa: E402
from repro.ml import kwindows as jk  # noqa: E402
from repro.ml.linear import lasso_prox_builder as j_lasso_prox  # noqa: E402
from repro.ml.linear import lsq_loss as j_lsq  # noqa: E402
from repro.serve import MicroBatcher as JBatcher  # noqa: E402
from repro.serve import ModelRegistry as JRegistry  # noqa: E402
from repro.serve import ServeEngine as JEngine  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import params_from_reference, theta_from_reference  # noqa: E402
from repro_torch.core import schedules as t_sched  # noqa: E402
from repro_torch.ml import kwindows as tk  # noqa: E402
from repro_torch.ml.linear import lasso_prox_builder as t_lasso_prox  # noqa: E402
from repro_torch.ml.linear import lsq_loss as t_lsq  # noqa: E402
from repro_torch.serve import MicroBatcher, ModelRegistry, ServeEngine, ServeMetrics  # noqa: E402

P_RTOL, P_ATOL = 1e-6, 1e-7  # predictions on the same θ
F_RTOL, F_ATOL = 1e-5, 1e-6  # fits trained apart (tests/test_torch_fit.py)


def linear_problem(K=8, Nk=10, n=5, seed=0):
    """The reference's ``_linear_problem``, as f32 numpy."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(K, Nk, n)).astype(np.float32)
    w = rng.normal(size=(n,)).astype(np.float32)
    y = np.asarray(jnp.einsum("kni,i->kn", jnp.asarray(X), jnp.asarray(w)))
    return X, y, n


def kwindows_shards():
    """The reference fixture's data: 4 sites × 64 points of 3 blobs."""
    rng = np.random.default_rng(1)
    centers = rng.normal(size=(3, 2)) * 4.0
    Xs = (centers[rng.integers(0, 3, size=(4, 64))]
          + rng.normal(size=(4, 64, 2)) * 0.3).astype(np.float32)
    return Xs, centers.astype(np.float32)


@pytest.fixture(scope="module")
def gd_fit():
    X, y, n = linear_problem()
    js = japi.GradientDescent(j_lsq, lr=0.1)
    rj = japi.fit(js, (jnp.asarray(X), jnp.asarray(y)), transport="allreduce", steps=150)
    ts = tapi.GradientDescent(t_lsq, lr=0.1)
    rt = tapi.fit(ts, (X, y), transport="allreduce", steps=150, device="cpu")
    return js, rj, ts, rt, n


@pytest.fixture(scope="module")
def kwindows_fit():
    Xs, centers = kwindows_shards()
    js = jk.KWindowsStrategy(jax.random.key(0), num_windows=6, r=1.0)
    rj = japi.fit(js, jnp.asarray(Xs), transport="sequential_server",
                  schedule=j_sched.round_robin(4, 1))
    ts = tk.KWindowsStrategy(0, num_windows=6, r=1.0)
    return js, rj, ts, theta_from_reference(rj.theta, "cpu"), Xs, centers


def queries(n, rows=7, seed=2):
    return np.random.default_rng(seed).normal(size=(rows, n)).astype(np.float32)


def np_(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ----------------------------------------------------------------------------
# ServeEngine (TestServeEngine, TestInferenceLedger, TestPredictProtocol)
# ----------------------------------------------------------------------------


def test_gd_engine_predictions_match_jax(gd_fit):
    """Mirrors ``TestServeEngine::test_from_fit_predicts``: the same θ in
    both engines gives the same predictions."""
    js, rj, ts, _, n = gd_fit
    Xq = queries(n)
    want = np.asarray(JEngine.from_fit(rj, js).predict(jnp.asarray(Xq)))
    eng = ServeEngine(ts, theta_from_reference(rj.theta, "cpu"))
    got = eng.predict(Xq)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=P_RTOL, atol=P_ATOL)


def test_kwindows_engine_labels_match_jax(kwindows_fit):
    """Mirrors ``TestPredictProtocol::test_kwindows_cluster_assignment``:
    labels equal exactly, captured centers ≥ 0 and far points -1."""
    js, rj, ts, theta, Xs, centers = kwindows_fit
    Xq = np.concatenate([Xs[0], centers, np.full((2, 2), 100.0, np.float32)])
    want = np.asarray(JEngine(js, rj.theta).predict(jnp.asarray(Xq)))
    got = ServeEngine(ts, theta).predict(Xq).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[-5:-2] >= 0).all() and (got[-2:] == -1).all()


def test_from_fit_predicts(gd_fit):
    """Mirrors ``TestServeEngine::test_from_fit_predicts`` on the port's own
    fit: the engine answers X @ θ."""
    _, rj, ts, rt, n = gd_fit
    Xq = queries(n, seed=4)
    eng = ServeEngine.from_fit(rt, ts)
    assert torch.equal(eng.predict(Xq), torch.from_numpy(Xq) @ rt.theta)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=F_RTOL, atol=F_ATOL)


def test_inference_ledger_matches_jax(gd_fit):
    """Mirrors ``TestServeEngine::test_inference_bytes_metered`` /
    ``test_valid_rows_trimmed_and_metered`` and ``TestInferenceLedger``:
    bytes, events and padded slots equal the JAX engine's."""
    js, rj, ts, _, n = gd_fit
    je = JEngine.from_fit(rj, js, tag="q")
    te = ServeEngine(ts, theta_from_reference(rj.theta, "cpu"), tag="q")
    for rows, valid in ((6, None), (8, 3), (1, None)):
        Xq = queries(n, rows=rows, seed=rows)
        yj = je.predict(jnp.asarray(Xq), valid=valid)
        yt = te.predict(Xq, valid=valid)
        assert tuple(yt.shape) == tuple(yj.shape)
    assert te.ledger.summary() == je.ledger.summary()
    assert te.ledger.events == je.ledger.events
    assert [e[0] for e in te.ledger.events] == ["inference"]
    assert te.ledger.uplink_bytes == (6 + 3 + 1) * n * 4
    assert te.metrics.padded_slots == je.metrics.padded_slots == 5
    assert te.stats()["requests"] == je.stats()["requests"] == 10


def test_stats_keys_are_the_references(gd_fit):
    """Mirrors ``tests/test_trace.py::TestRunReport::test_from_serve``'s
    stats: ``stats()`` carries every key of the JAX engine's; the port adds
    only the time-to-first-token pair."""
    js, rj, ts, _, n = gd_fit
    sj = JEngine.from_fit(rj, js).stats()
    st = ServeEngine(ts, theta_from_reference(rj.theta, "cpu")).stats()
    assert set(sj) <= set(st)
    assert set(st) - set(sj) == {"p50_ttft_ms", "p95_ttft_ms"}


def test_swap_refuses_a_structure_change_as_reference(gd_fit):
    """Mirrors ``TestServeEngine::test_swap_rejects_structure_change``: the
    same ValueError text (the tree descriptions are each package's own)."""
    js, rj, ts, rt, _ = gd_fit
    with pytest.raises(ValueError) as ej:
        JEngine.from_fit(rj, js).swap({"w": rj.theta})
    with pytest.raises(ValueError) as et:
        ServeEngine.from_fit(rt, ts).swap({"w": rt.theta})
    prefix = "swap() needs the served pytree structure "
    assert str(ej.value).startswith(prefix) and str(et.value).startswith(prefix)
    assert ", got " in str(et.value)


def test_hot_swap_changes_predictions(gd_fit):
    """Mirrors ``TestServeEngine::test_hot_swap_changes_predictions``."""
    _, _, ts, rt, n = gd_fit
    eng = ServeEngine.from_fit(rt, ts)
    Xq = np.ones((2, n), np.float32)
    before = eng.predict(Xq).numpy()
    eng.swap(2.0 * rt.theta)
    np.testing.assert_allclose(eng.predict(Xq).numpy(), 2.0 * before, rtol=1e-6)


def test_shared_metrics_across_engines(gd_fit):
    """Mirrors ``TestServeEngine::test_shared_metrics_across_engines``."""
    _, _, ts, rt, n = gd_fit
    metrics = ServeMetrics()
    a = ServeEngine.from_fit(rt, ts, metrics=metrics, tag="a")
    b = ServeEngine.from_fit(rt, ts, metrics=metrics, tag="b")
    a.predict(np.zeros((2, n), np.float32))
    b.predict(np.zeros((3, n), np.float32))
    assert metrics.requests == 5 and metrics.batches == 2
    assert [e[1] for e in metrics.ledger.events] == ["a", "b"]


def test_fit_ledger_absorbs_serving_traffic(gd_fit):
    """Mirrors ``TestInferenceLedger::test_merges_with_training_ledger``."""
    _, _, ts, rt, n = gd_fit
    eng = ServeEngine.from_fit(rt, ts)
    eng.predict(np.zeros((2, n), np.float32))
    from repro_torch.core.allreduce import CommLedger

    total = CommLedger()
    total.merge(rt.ledger)
    total.merge(eng.ledger)
    assert total.uplink_bytes == rt.ledger.uplink_bytes + eng.ledger.uplink_bytes
    kinds = {e[0] for e in total.events}
    assert "inference" in kinds and len(kinds) > 1


def test_host_requests_are_canonicalized_as_jnp_asarray(gd_fit):
    """Mirrors ``TestServeEngine::test_inference_bytes_metered`` with a
    float64 numpy request: served and metered as float32, as
    ``jnp.asarray`` makes it in the JAX engine."""
    js, rj, ts, _, n = gd_fit
    Xq = queries(n).astype(np.float64)
    je = JEngine.from_fit(rj, js)
    te = ServeEngine(ts, theta_from_reference(rj.theta, "cpu"))
    np.testing.assert_allclose(te.predict(Xq).numpy(), np.asarray(je.predict(Xq)),
                               rtol=P_RTOL, atol=P_ATOL)
    assert te.ledger.uplink_bytes == je.ledger.uplink_bytes == 7 * n * 4


def test_engine_refuses_a_mesh_and_a_missing_gpu(gd_fit):
    """A mesh is served now: on the host mesh (a ``SoloMesh`` without a
    process group) the engine answers as the JAX engine on its host mesh,
    and a request batch of any size comes back whole
    (``tests/test_torch_sharding.py`` serves on 8 gloo ranks); a θ with no
    device raises without a GPU unless ``device="cpu"`` is asked for."""
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro_torch.launch.mesh import make_host_mesh

    js, rj, ts, rt, n = gd_fit
    Xq = queries(n)
    te = ServeEngine.from_fit(rt, ts, mesh=make_host_mesh())
    je = JEngine.from_fit(rj, js, mesh=j_host_mesh())
    np.testing.assert_allclose(np_(te.predict(Xq)), np_(je.predict(Xq)),
                               rtol=P_RTOL, atol=P_ATOL)
    assert te.ledger.uplink_bytes == je.ledger.uplink_bytes == 7 * n * 4
    if not torch.cuda.is_available():
        # numpy θ names no device: the default is the card, and there is none
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(ts, np.asarray(rj.theta))
    assert ServeEngine(ts, np.asarray(rj.theta), device="cpu").theta.device.type == "cpu"


def test_strategies_without_predict_are_not_servable():
    """Mirrors ``TestPredictProtocol::test_base_strategy_not_servable`` /
    ``test_optimizer_strategy_needs_predict_fn``."""
    with pytest.raises(NotImplementedError, match="cannot be served"):
        tapi.Strategy().predict(torch.zeros(3), torch.zeros((2, 3)))
    s = tapi.OptimizerStrategy(lambda t, b: 0.0, None)
    assert not s.predict_jit and tapi.GradientDescent(t_lsq).predict_jit
    with pytest.raises(NotImplementedError, match="predict_fn"):
        s.predict(torch.zeros(3), torch.zeros((2, 3)))


# ----------------------------------------------------------------------------
# MicroBatcher (TestMicroBatcher)
# ----------------------------------------------------------------------------

#: one scripted stream: ("submit", shape group) / ("tick", seconds) / ("poll",)
SCRIPT = [
    ("submit", 5), ("submit", 5), ("poll",), ("tick", 0.3), ("submit", 9), ("poll",),
    ("tick", 0.25), ("poll",), ("submit", 5), ("submit", 5), ("submit", 5), ("submit", 5),
    ("submit", 5), ("submit", 5), ("submit", 9), ("tick", 0.1), ("poll",), ("submit", 9),
    ("tick", 0.6), ("poll",), ("submit", 5), ("tick", 0.49), ("poll",), ("tick", 0.01),
    ("poll",),
]


def _play(batcher_cls, engine, rng_seed=7):
    now = [0.0]
    b = batcher_cls(engine, max_batch=4, timeout_s=0.5, clock=lambda: now[0])
    rng = np.random.default_rng(rng_seed)
    trace, tickets = [], []
    for op in SCRIPT:
        if op[0] == "submit":
            tickets.append(b.submit(rng.normal(size=(op[1],)).astype(np.float32)))
            trace.append(("submit", b.flushes, b.pending()))
        elif op[0] == "tick":
            now[0] += op[1]
        else:
            trace.append(("poll", b.poll(), b.flushes, b.pending()))
    b.flush()
    return b, trace, tickets


def test_batcher_script_matches_reference():
    """Mirrors ``TestMicroBatcher::test_timeout_flush_with_injected_clock``
    / ``test_max_batch_auto_flush`` / ``test_padded_slots_not_metered``:
    one scripted stream of submits, clock ticks and polls flushes the same
    groups at the same calls, with the same buckets, padded slots, ledger
    and answers as the JAX batcher's."""
    theta = np.random.default_rng(3).normal(size=(5,)).astype(np.float32)
    theta9 = np.random.default_rng(4).normal(size=(9,)).astype(np.float32)

    class Lin(tapi.GradientDescent):
        def predict(self, th, X):  # both shape groups: 5 and 9 features
            return X @ (th[:5] if X.shape[1] == 5 else th[5:])

    class JLin(japi.GradientDescent):
        def predict(self, th, X):
            return X @ (th[:5] if X.shape[1] == 5 else th[5:])

    th = np.concatenate([theta, theta9])
    je = JEngine(JLin(j_lsq), jnp.asarray(th))
    te = ServeEngine(Lin(t_lsq), torch.from_numpy(th))
    jb, jtrace, jt = _play(JBatcher, je)
    tb, ttrace, tt = _play(MicroBatcher, te)
    assert ttrace == jtrace
    assert tb.flushes == jb.flushes
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(np_(a.result()), np.asarray(b.result()),
                                   rtol=P_RTOL, atol=P_ATOL)
    assert te.metrics.padded_slots == je.metrics.padded_slots
    assert te.metrics.batches == je.metrics.batches
    assert te.ledger.summary() == je.ledger.summary()


def test_padding_invariance_bit_exact(gd_fit):
    """Mirrors ``TestMicroBatcher::test_padding_invariance_bit_exact``.  What
    padding holds cannot change a real answer: bitwise the same rows padded
    with zeros to the same bucket.  Against one predict a request, the
    products have other shapes (a matrix-vector product against a matrix
    product), so the last bits may differ: within rtol 1e-6 / atol 1e-7."""
    _, _, ts, rt, n = gd_fit
    rng = np.random.default_rng(5)
    for count in (1, 2, 3, 5, 7):
        eng = ServeEngine.from_fit(rt, ts)
        b = MicroBatcher(eng, max_batch=8)
        xs = [rng.normal(size=(n,)).astype(np.float32) for _ in range(count)]
        tickets = [b.submit(x) for x in xs]
        b.flush()
        got = torch.stack([t.result() for t in tickets])
        bucket = b.bucket_for(count)
        zero_pad = np.concatenate([np.stack(xs), np.zeros((bucket - count, n), np.float32)])
        assert torch.equal(got, eng.predict(zero_pad)[:count])
        one_by_one = torch.stack([eng.predict(x[None])[0] for x in xs])
        np.testing.assert_allclose(got.numpy(), one_by_one.numpy(), rtol=P_RTOL, atol=P_ATOL)
        assert eng.metrics.padded_slots == bucket - count


def test_failing_predict_fails_its_tickets():
    """Mirrors ``TestMicroBatcher::test_predict_failure_propagates_to_tickets``;
    a poll isolates the failing group."""

    def broken(X):
        raise RuntimeError("model exploded")

    b = MicroBatcher(broken, max_batch=8)
    t1, t2 = b.submit(np.zeros(3, np.float32)), b.submit(np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="exploded"):
        b.flush()
    assert t1.done and t2.done and b.pending() == 0
    with pytest.raises(RuntimeError, match="exploded"):
        t1.result()
    now = [0.0]
    b = MicroBatcher(broken, max_batch=8, timeout_s=0.1, clock=lambda: now[0])
    t = b.submit(np.zeros(2, np.float32))
    now[0] = 1.0
    assert b.poll() == 0 and t.done
    with pytest.raises(RuntimeError, match="exploded"):
        t.result()


def test_four_threads_lose_no_request(gd_fit):
    """Mirrors ``TestMicroBatcher::test_concurrent_clients_meter_exactly`` /
    ``test_concurrent_submits_never_overshoot_buckets``."""
    _, _, ts, rt, n = gd_fit
    eng = ServeEngine.from_fit(rt, ts)
    b = MicroBatcher(eng, max_batch=4)
    per_thread, n_threads = 25, 4
    barrier = threading.Barrier(n_threads)
    out: dict = {}

    def client(c):
        barrier.wait()
        out[c] = [b.submit(np.full((n,), c + i / 100, np.float32)) for i in range(per_thread)]

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=10)
    b.flush()
    total = per_thread * n_threads
    assert eng.metrics.requests == total
    assert eng.ledger.uplink_bytes == total * n * 4
    for c, tickets in out.items():
        for i, t in enumerate(tickets):
            x = torch.full((n,), c + i / 100, dtype=torch.float32)
            assert torch.allclose(t.result(), x @ rt.theta, rtol=1e-6)


def test_row_independent_callable():
    """Mirrors ``TestMicroBatcher::test_static_shape_set`` /
    ``test_ticket_result_forces_service`` with a plain callable."""
    seen = []

    def predict(X):
        seen.append(X.shape)
        return X.sum(axis=tuple(range(1, X.ndim)))

    b = MicroBatcher(predict, max_batch=4)
    rng = np.random.default_rng(6)
    for count in (1, 3, 2, 4, 3, 1):
        for _ in range(count):
            b.submit(rng.normal(size=(5,)).astype(np.float32))
        b.flush()
    for _ in range(3):
        b.submit(rng.normal(size=(9,)).astype(np.float32))
    b.flush()
    assert {s[0] for s in seen} <= {1, 2, 4}
    assert {s[1:] for s in seen} == {(5,), (9,)}
    t = MicroBatcher(lambda X: 2.0 * X, max_batch=8).submit(np.ones(3, np.float32))
    assert not t.done
    np.testing.assert_array_equal(np.asarray(t.result()), 2.0 * np.ones(3))


def test_buckets_as_reference():
    """Mirrors ``TestMicroBatcher::test_bucket_resolution`` /
    ``test_inconsistent_buckets_rejected``."""
    b, jb = MicroBatcher(lambda X: X, max_batch=8), JBatcher(lambda X: X, max_batch=8)
    assert b.buckets == jb.buckets == (1, 2, 4, 8)
    assert [b.bucket_for(k) for k in (1, 2, 3, 5, 8, 9)] == \
        [jb.bucket_for(k) for k in (1, 2, 3, 5, 8, 9)]
    with pytest.raises(ValueError, match="largest bucket"):
        MicroBatcher(lambda X: X, max_batch=16, buckets=(2, 4))
    b = MicroBatcher(lambda X: X, max_batch=4, buckets=(2, 4))
    assert b.buckets == (2, 4) and b.max_batch == 4


def test_predict_runs_outside_the_lock():
    """Mirrors ``TestMicroBatcher::test_predict_runs_outside_the_lock``."""
    started, release = threading.Event(), threading.Event()

    def slow(X):
        started.set()
        assert release.wait(timeout=5)
        return X

    b = MicroBatcher(slow, max_batch=8)
    t = b.submit(np.zeros(3, np.float32))
    flusher = threading.Thread(target=b.flush)
    flusher.start()
    try:
        assert started.wait(timeout=5)
        b.submit(np.zeros(5, np.float32))
        assert b.pending() == 1
        with pytest.raises(TimeoutError):
            t.result(timeout=0.05)  # in flight, not yet resolved
    finally:
        release.set()
        flusher.join(timeout=5)
    assert not flusher.is_alive()
    np.testing.assert_array_equal(np.asarray(t.result(timeout=5)), np.zeros(3))


# ----------------------------------------------------------------------------
# ModelRegistry (TestModelRegistry)
# ----------------------------------------------------------------------------


def _trees():
    rng = np.random.default_rng(8)
    w = rng.normal(size=(2, 3)).astype(np.float32)
    return {
        "bare": rng.normal(size=(7,)).astype(np.float32),
        "dict": {"a": {"w": w}, "b": np.arange(4, dtype=np.int32)},
    }


def _same_bits(a, b) -> bool:
    a, b = np_(a), np_(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("kind", ["bare", "dict"])
def test_registry_crosses_both_ways_bitwise(tmp_path, kind):
    """Mirrors ``TestModelRegistry::test_round_trip_bare_array`` /
    ``test_round_trip_dict_tree``: JAX publishes and the port loads, and the
    reverse, bit for bit (f32 and int32 leaves)."""
    tree = _trees()[kind]
    JRegistry(str(tmp_path / "j")).publish("m", jax.tree.map(jnp.asarray, tree))
    got = ModelRegistry(str(tmp_path / "j")).load("m", device="cpu")
    ModelRegistry(str(tmp_path / "t")).publish(
        "m", jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))
    back = JRegistry(str(tmp_path / "t")).load("m")
    for want, a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(
            jax.tree.map(np_, got)), jax.tree.leaves(back)):
        assert _same_bits(a, want) and _same_bits(np.asarray(b), want)


def test_registry_bf16_crosses_as_raw_bits(tmp_path):
    """As ``tests/test_torch_checkpoint.py``'s bf16 case (the reference has
    no bf16 registry test: its restore cannot read the leaf, ROADMAP queue
    3, item 14): the port reads the JAX package's bf16 leaf (stored as
    2-byte voids) through its 16 bits, and writes the same."""
    x = jnp.asarray(np.random.default_rng(9).normal(size=(6,)), jnp.bfloat16)
    JRegistry(str(tmp_path)).publish("b", {"x": x})
    got = ModelRegistry(str(tmp_path)).load("b", device="cpu")["x"]
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.view(torch.int16).numpy(), np.asarray(x).view(np.int16))
    ModelRegistry(str(tmp_path)).publish("b", {"x": got})
    with np.load(tmp_path / "b" / "step_00000002.npz") as f2, \
            np.load(tmp_path / "b" / "step_00000001.npz") as f1:
        assert f2["x"].tobytes() == f1["x"].tobytes() and f2["x"].dtype == f1["x"].dtype


def test_registry_namedtuple_with_like(tmp_path, kwindows_fit):
    """Mirrors ``TestModelRegistry::test_round_trip_namedtuple_with_like``:
    the JAX k-windows θ published there loads here into ``KWindows``."""
    _, rj, _, theta, _, _ = kwindows_fit
    JRegistry(str(tmp_path)).publish("kw", rj.theta)
    out = ModelRegistry(str(tmp_path)).load("kw", like=theta)
    assert type(out).__name__ == "KWindows"
    for a, b in zip(out, rj.theta):
        assert _same_bits(a, np.asarray(b))


def test_registry_bookkeeping_agrees(tmp_path):
    """Mirrors ``test_versioning_and_hot_swap`` / ``test_publish_without_
    activate_keeps_pointer`` / ``test_staged_only_model_is_not_served`` /
    ``test_publish_skips_claimed_versions`` / ``test_meta_and_models`` /
    ``test_missing_version_raises``: the same calls on the two packages'
    registries give the same versions, pointers, metadata and errors."""
    answers = []
    for reg, arr in ((JRegistry(str(tmp_path / "j")), jnp.asarray),
                     (ModelRegistry(str(tmp_path / "t")), torch.as_tensor)):
        out = [reg.publish("m", arr(np.zeros(3, np.float32)), meta={"transport": "allreduce"}),
               reg.publish("m", arr(np.ones(3, np.float32)))]
        out += [reg.versions("m"), reg.latest("m")]
        reg.set_latest("m", 1)
        with open(os.path.join(reg.root, "m", "LATEST")) as f:
            out.append(f.read().strip())
        out.append(reg.publish("m", arr(np.full(3, 2.0, np.float32)), activate=False))
        out += [reg.latest("m"), reg.resolve("m"), reg.resolve("m", 3)]
        open(os.path.join(reg.root, "m", "step_00000004.claim"), "w").close()
        out += [reg.publish("m", arr(np.zeros(3, np.float32))), reg.versions("m")]
        meta = reg.meta("m", 1)
        out += [meta["transport"], meta["name"], meta["version"], reg.models()]
        reg.publish("dark", arr(np.zeros(3, np.float32)), activate=False)
        out += [reg.latest("dark"), reg.models()]
        for bad in (lambda: reg.load("dark"), lambda: reg.load("ghost"),
                    lambda: reg.set_latest("m", 7), lambda: reg.resolve("m", 4)):
            with pytest.raises(FileNotFoundError) as e:
                bad()
            out.append(str(e.value))
        answers.append(out)
    assert answers[0] == answers[1]
    assert answers[1][:4] == [1, 2, [1, 2], 2]


def test_concurrent_publishes_claim_distinct_versions(tmp_path):
    """Mirrors ``TestModelRegistry::test_publish_skips_claimed_versions``
    with racing publishers: each of sixteen gets its own version.  A claim
    succeeds only where neither a sentinel nor a payload holds the number:
    the reference's ``_claim_version`` checks the sentinel alone, and under
    this race hands one version to two publishers (ROADMAP queue 3, item
    23)."""
    import sys

    reg = ModelRegistry(str(tmp_path))
    n = 16
    barrier = threading.Barrier(n)
    got = []

    def pub(i):
        barrier.wait()
        got.append(reg.publish("m", torch.full((4,), float(i))))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=pub, args=(i,)) for i in range(n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert sorted(got) == list(range(1, n + 1)) == reg.versions("m")
    assert not [f for f in os.listdir(tmp_path / "m") if f.endswith((".claim", ".tmp"))]
    values = {float(reg.load("m", v, device="cpu")[0]) for v in got}
    assert values == {float(i) for i in range(n)}


def test_engine_hot_swaps_from_registry(tmp_path, gd_fit):
    """Mirrors ``TestModelRegistry::test_engine_hot_swaps_from_registry``."""
    _, _, ts, rt, n = gd_fit
    reg = ModelRegistry(str(tmp_path))
    reg.publish("lin", rt.theta)
    eng = ServeEngine.from_registry(reg, "lin", ts, device="cpu")
    Xq = np.ones((2, n), np.float32)
    before = eng.predict(Xq).numpy()
    reg.publish("lin", 3.0 * rt.theta)
    eng.swap(reg.load("lin", device="cpu"))
    np.testing.assert_allclose(eng.predict(Xq).numpy(), 3.0 * before, rtol=1e-6)


# ----------------------------------------------------------------------------
# ServingExecutor (TestServingExecutor)
# ----------------------------------------------------------------------------


def test_serving_executor_gd_allreduce_matches_jax(gd_fit):
    """Mirrors ``TestServingExecutor::test_fit_returns_live_engine``."""
    X, y, n = linear_problem()
    rj = japi.fit(japi.GradientDescent(j_lsq, lr=0.1), (jnp.asarray(X), jnp.asarray(y)),
                  transport="allreduce", steps=150, executor="serve")
    rt = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (X, y), transport="allreduce",
                  steps=150, executor="serve", device="cpu")
    eng = rt.metrics["serve_engine"]
    assert isinstance(eng, ServeEngine) and rt.metrics["executor"] == "serve"
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=F_RTOL, atol=F_ATOL)
    assert rt.ledger.summary() == rj.ledger.summary()
    Xq = queries(n)
    want = np.asarray(rj.metrics["serve_engine"].predict(jnp.asarray(Xq)))
    got = eng.predict(Xq).numpy()
    np.testing.assert_allclose(got, want, rtol=F_RTOL, atol=F_ATOL)
    np.testing.assert_array_equal(got, (torch.from_numpy(Xq) @ rt.theta).numpy())
    m = rt.metrics_json()
    assert m["serve_engine"] == "<ServeEngine>" and "carry" not in m


def _patch_node_windows(monkeypatch, Xs, node_windows):
    """The port's ``init_windows`` returns the JAX package's windows of the
    node whose shard it is given (``jax.random`` cannot be matched; as in
    ``tests/test_torch_kwindows.py``)."""
    shards = [torch.from_numpy(np.array(x)) for x in Xs]

    def init(gen, X, K, r):
        k = next(i for i, s in enumerate(shards) if torch.equal(X, s))
        return tk.KWindows(*(torch.from_numpy(np.array(a)) for a in node_windows[k]))

    monkeypatch.setattr(tk, "init_windows", init)


def test_serving_executor_kwindows_sequential_server_matches_jax(monkeypatch):
    """Mirrors ``TestServingExecutor::test_server_transport_finalizes_through_
    executor``: the merged windows serve the JAX engine's labels."""
    Xs, centers = kwindows_shards()
    K, W, r = 4, 6, 1.0
    key = jax.random.key(3)
    keys = jax.random.split(key, K)
    node_windows = [jk.init_windows(keys[k], jnp.asarray(Xs[k]), W, r) for k in range(K)]
    rj = japi.fit(jk.KWindowsStrategy(key, num_windows=W, r=r), jnp.asarray(Xs),
                  transport="sequential_server", schedule=j_sched.round_robin(K, 1),
                  executor="serve")
    _patch_node_windows(monkeypatch, Xs, node_windows)
    rt = tapi.fit(tk.KWindowsStrategy(3, num_windows=W, r=r), Xs,
                  transport="sequential_server", schedule=t_sched.round_robin(K, 1),
                  executor="serve", device="cpu")
    assert rt.ledger.summary() == rj.ledger.summary()
    Xq = np.concatenate([Xs.reshape(-1, 2), centers])
    want = np.asarray(rj.metrics["serve_engine"].predict(jnp.asarray(Xq)))
    got = rt.metrics["serve_engine"].predict(Xq).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[-3:] >= 0).all()


def test_serving_executor_publishes(tmp_path):
    """Mirrors ``TestServingExecutor::test_publishes_when_given_registry`` /
    ``test_registry_needs_name``: the same ValueError both ways round."""
    X, y, n = linear_problem()
    reg = ModelRegistry(str(tmp_path))
    rt = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (X, y), transport="allreduce",
                  steps=20, executor=tapi.ServingExecutor(registry=reg, publish_as="lin"),
                  device="cpu")
    assert reg.latest("lin") == 1
    assert _same_bits(reg.load("lin", device="cpu"), rt.theta)
    assert _same_bits(np.asarray(JRegistry(str(tmp_path)).load("lin")), rt.theta)
    for kw in ({"registry": reg}, {"publish_as": "lin"}):
        with pytest.raises(ValueError) as et:
            tapi.ServingExecutor(**kw)
        with pytest.raises(ValueError) as ej:
            japi.ServingExecutor(**kw)
        assert str(et.value) == str(ej.value)


def test_admm_accepts_serving_executor(tmp_path):
    """Mirrors ``TestServingExecutor::test_admm_accepts_serving_executor``."""
    X, y, n = linear_problem(K=4)
    jreg, treg = JRegistry(str(tmp_path / "j")), ModelRegistry(str(tmp_path / "t"))
    rj = japi.fit(japi.ProxStrategy(j_lasso_prox), (jnp.asarray(X), jnp.asarray(y)),
                  transport="admm_consensus", steps=10, g="l1", g_lam=0.1,
                  executor=japi.ServingExecutor(registry=jreg, publish_as="lasso"))
    rt = tapi.fit(tapi.ProxStrategy(t_lasso_prox), (X, y), transport="admm_consensus",
                  steps=10, g="l1", g_lam=0.1, device="cpu",
                  executor=tapi.ServingExecutor(registry=treg, publish_as="lasso"))
    assert treg.latest("lasso") == jreg.latest("lasso") == 1
    assert "serve_engine" in rt.metrics
    assert _same_bits(treg.load("lasso", device="cpu"), rt.theta)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=F_RTOL, atol=F_ATOL)
    # ProxStrategy has no predict in either package: the engine stands, and
    # refuses to answer as the JAX one does
    for eng, X in ((rt.metrics["serve_engine"], queries(n)),
                   (rj.metrics["serve_engine"], jnp.asarray(queries(n)))):
        with pytest.raises(NotImplementedError, match="cannot be served"):
            eng.predict(X)


def test_registered_in_executor_table():
    """Mirrors ``TestServingExecutor::test_registered_in_executor_table``."""
    assert "serve" in tapi.EXECUTORS
    ex = tapi.make_executor("serve")
    assert isinstance(ex, tapi.ServingExecutor) and ex.name == "serve"
    assert ex.extra_metrics() == {} and tapi.make_executor("local").extra_metrics() == {}


# ----------------------------------------------------------------------------
# LM serving (TestVectorizedPrefill, TestLMServing), tinyllama-1.1b reduced
# ----------------------------------------------------------------------------


@pytest.fixture(scope="module")
def lm():
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as j_tf
    from repro_torch.configs import get_config as t_get_config

    jc = j_get_config("tinyllama-1.1b").reduced()
    tc = t_get_config("tinyllama-1.1b").reduced()
    assert jc.compute_dtype == tc.compute_dtype == "float32" and tc.num_layers == 2
    jp = j_tf.init_params(jax.random.key(0), jc)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    prompts = np.random.default_rng(1).integers(0, jc.vocab_size, size=(3, 8)).astype(np.int32)
    return jc, tc, jp, tp, prompts


@pytest.mark.parametrize("mode", ["batched", "loop"])
def test_prefill_and_decode_matches_jax(lm, mode):
    """Mirrors ``TestVectorizedPrefill::test_batched_matches_loop``: greedy
    ids equal the JAX package's, for both prefills."""
    from repro.launch import serve as jsv
    from repro_torch.launch import serve as tsv

    jc, tc, jp, tp, prompts = lm
    want = np.asarray(jsv.prefill_and_decode(jc, jp, jnp.asarray(prompts), gen=5,
                                             cache_len=14, prefill=mode))
    got = tsv.prefill_and_decode(tc, tp, torch.from_numpy(prompts), gen=5, cache_len=14,
                                 prefill=mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_prefill_equals_loop(lm):
    """Mirrors ``TestVectorizedPrefill::test_batched_matches_loop`` on the
    port alone (the recurrent stacks, which refuse batched prefill, are
    served by the loop: ``tests/test_torch_xlstm.py``)."""
    from repro_torch.launch import serve as tsv

    _, tc, _, tp, prompts = lm
    assert tsv.batched_prefill_supported(tc)
    p = torch.from_numpy(prompts)
    loop = tsv.prefill_and_decode(tc, tp, p, gen=6, cache_len=16, prefill="loop")
    batched = tsv.prefill_and_decode(tc, tp, p, gen=6, cache_len=16, prefill="batched")
    assert torch.equal(loop, batched)
    with pytest.raises(ValueError, match="unknown prefill"):
        tsv.prefill_and_decode(tc, tp, p, gen=1, cache_len=16, prefill="both")


def test_sampled_decode_is_padding_invariant(lm):
    """Mirrors ``TestVectorizedPrefill::test_sampled_decode_is_padding_invariant``
    with the port's counter-based stream (ROADMAP queue 3, item 22): a
    row's draws depend only on (seed, row, step)."""
    from repro_torch.launch import serve as tsv

    _, tc, _, tp, prompts = lm
    p = torch.from_numpy(prompts[:, :6].copy())
    padded = torch.cat([p, p[-1:]])
    a = tsv.prefill_and_decode(tc, tp, p, gen=4, cache_len=12, temperature=0.8, seed=5)
    b = tsv.prefill_and_decode(tc, tp, padded, gen=4, cache_len=12, temperature=0.8, seed=5)
    assert torch.equal(a, b[:3])
    c = tsv.prefill_and_decode(tc, tp, p, gen=4, cache_len=12, temperature=0.8, seed=6)
    greedy = tsv.prefill_and_decode(tc, tp, p, gen=4, cache_len=12)
    assert not torch.equal(a, c) or not torch.equal(a, greedy)


def test_lm_engine_with_batcher_matches_jax(lm):
    """Mirrors ``TestLMServing::test_lm_decode_engine_with_batcher`` (without
    its host mesh): ids equal ``strategy.predict`` on the whole batch and
    the JAX package's, ledger bytes its formula."""
    from repro.launch.serve import lm_predict_fn as j_lm_predict_fn
    from repro_torch.launch.serve import lm_predict_fn

    jc, tc, jp, tp, prompts = lm
    strategy = tapi.OptimizerStrategy(None, None, predict_fn=lm_predict_fn(tc, gen=3))
    assert not strategy.predict_jit
    eng = ServeEngine(strategy, tp)
    b = MicroBatcher(eng, max_batch=4)
    tickets = [b.submit(p) for p in prompts]
    b.flush()
    got = torch.stack([t.result() for t in tickets]).numpy()
    np.testing.assert_array_equal(got, strategy.predict(tp, torch.from_numpy(prompts)).numpy())
    want = np.asarray(j_lm_predict_fn(jc, gen=3)(jp, jnp.asarray(prompts)))
    np.testing.assert_array_equal(got, want)
    assert eng.ledger.uplink_bytes == 3 * 8 * 4
    assert eng.ledger.downlink_bytes == 3 * 3 * 4
    assert eng.metrics.padded_slots == 1


def test_serve_arch_cli_padding_contract(lm, capsys):
    """Mirrors ``TestLMServing::test_lm_decode_engine_with_batcher`` through
    the microbatched ``--arch`` CLI path: 7 requests in buckets of 4 (one
    padded slot); every answer equals the ids of a full, unpadded batch."""
    from repro_torch.launch import serve as tsv

    _, tc, _, _, _ = lm
    outs = tsv.main(["--arch", "tinyllama-1.1b", "--reduced", "--batch", "4",
                     "--requests", "7", "--prompt-len", "8", "--gen", "3", "--device", "cpu"])
    assert outs.shape == (7, 3) and outs.dtype == np.int32
    text = capsys.readouterr().out
    assert "batched prefill" in text and '"requests": 7' in text
    params = tsv.tf.init_params(torch.Generator().manual_seed(0), tc)
    prompts = np.random.default_rng(1).integers(0, tc.vocab_size, size=(7, 8)).astype(np.int32)
    whole = tsv.lm_predict_fn(tc, gen=3)(params, torch.from_numpy(prompts)).numpy()
    np.testing.assert_array_equal(outs, whole)


@pytest.mark.parametrize("strategy", ["gd", "kwindows"])
def test_strategy_cli_publishes_and_serves(tmp_path, strategy):
    """Mirrors ``TestServeCLI::test_strategy_path_publishes_and_serves``."""
    from repro_torch.launch import serve as tsv

    preds = tsv.main(["--strategy", strategy, "--registry", str(tmp_path), "--requests", "5",
                      "--batch", "4", "--device", "cpu"])
    assert len(preds) == 5
    assert ModelRegistry(str(tmp_path)).latest(strategy) == 1
    assert JRegistry(str(tmp_path)).meta(strategy)["transport"] == (
        "allreduce" if strategy == "gd" else "sequential_server")


def test_serve_cli_refuses_mesh(tmp_path):
    """The CLI's ``--mesh`` serves on a ``("data",)`` node mesh (a world of
    one here): the answers are the unmeshed run's, bitwise."""
    from repro_torch.launch import serve as tsv

    args = ["--strategy", "gd", "--requests", "5", "--batch", "4", "--device", "cpu"]
    meshed = tsv.main(args + ["--registry", str(tmp_path / "a"), "--mesh"])
    plain = tsv.main(args + ["--registry", str(tmp_path / "b")])
    np.testing.assert_array_equal(np.asarray(meshed), np.asarray(plain))


# ----------------------------------------------------------------------------
# docs/SERVING.md's quickstart, read and run with repro → repro_torch
# ----------------------------------------------------------------------------


def _first_python_block(path: str, start_line: int) -> str:
    with open(path) as f:
        lines = f.read().splitlines()
    i = next(k for k in range(start_line - 1, len(lines)) if lines[k].strip() == "```python")
    j = next(k for k in range(i + 1, len(lines)) if lines[k].strip() == "```")
    return "\n".join(lines[i + 1: j])


def _prelude():
    """The names ``tools/check_docs.py``'s PRELUDE defines, made from the
    same seed: JAX arrays for the reference, f32 CPU tensors for the port."""
    from tools.check_docs import PRELUDE

    ns: dict = {}
    exec(PRELUDE, ns)
    names = ("Xs", "ys", "Xq")
    return ({k: ns[k] for k in names},
            {k: torch.from_numpy(np.array(ns[k])) for k in names})


def test_serving_quickstart_runs_on_the_port(tmp_path, monkeypatch, capsys):
    """Mirrors ``tests/test_docs.py[docs/SERVING.md]`` for the first block:
    ``repro`` → ``repro_torch`` and ``device="cpu"``: the same predictions (fit tolerance) and the same
    inference ledger as the JAX run of the block."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    src = _first_python_block(os.path.join(root, "docs", "SERVING.md"), 13)
    port = src.replace("from repro", "from repro_torch").replace(
        "import jax.numpy as jnp\n", "")
    for old, new in (("steps=400)", 'steps=400, device="cpu")'),
                     ('"linreg", strategy)', '"linreg", strategy, device="cpu")')):
        assert old in port
        port = port.replace(old, new)
    jns, tns = _prelude()
    out = []
    for code, ns, sub in ((src, jns, "j"), (port, tns, "t")):
        d = tmp_path / sub
        d.mkdir()
        monkeypatch.chdir(d)
        exec(compile(code, f"SERVING.md[{sub}]", "exec"), ns)
        out.append(ns)
    capsys.readouterr()
    jy, ty = np.asarray(out[0]["y"]), out[1]["y"].numpy()
    np.testing.assert_allclose(ty, jy, rtol=F_RTOL, atol=F_ATOL)
    assert out[1]["engine"].ledger.summary() == out[0]["engine"].ledger.summary()
    assert os.path.exists(tmp_path / "t" / "registry" / "linreg" / "LATEST")
