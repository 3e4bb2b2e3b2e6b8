"""Port parity: ``repro_torch.ml.svm`` against ``repro.ml.svm`` on the same
numpy inputs (the blobs of ``tests/test_svm.py``), the port on the CPU.

Tolerances, each beside its test: dual variables and decision values to
rtol 1e-5 / atol 1e-6 (``tests/test_torch_fit.py:35``: the Gram products
and matrix-vector sums round in another order), SV masks, rounds and
ledgers exactly; the consensus iterates to rtol 1e-5 / atol 1e-6 as in
``tests/test_torch_admm.py``.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.ml import svm as js  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.ml import svm as ts  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def blobs():
    """tests/test_svm.py's blobs, in f32."""
    rng = np.random.default_rng(5)
    K, Nk, n = 4, 30, 2
    Xp = rng.normal(size=(K * Nk // 2, n)) + np.array([2.0, 2.0])
    Xm = rng.normal(size=(K * Nk // 2, n)) - np.array([2.0, 2.0])
    X = np.concatenate([Xp, Xm])
    y = np.concatenate([np.ones(len(Xp)), -np.ones(len(Xm))])
    perm = rng.permutation(len(X))
    X, y = X[perm].astype(np.float32), y[perm].astype(np.float32)
    return X.reshape(K, Nk, n), y.reshape(K, Nk), X, y


@pytest.fixture(scope="module")
def circles():
    """tests/test_svm.py's circle-in-circle, in f32."""
    rng = np.random.default_rng(7)
    r1 = rng.normal(size=(60, 2)) * 0.3
    theta = rng.uniform(0, 2 * np.pi, size=60)
    r2 = np.stack([3 * np.cos(theta), 3 * np.sin(theta)], 1) + 0.1 * rng.normal(size=(60, 2))
    X = np.concatenate([r1, r2]).astype(np.float32)
    y = np.concatenate([np.ones(60), -np.ones(60)]).astype(np.float32)
    return X, y


def test_kernels_match_reference(blobs):
    _, _, X, _ = blobs
    np.testing.assert_allclose(ts.linear_kernel(T(X), T(X[:7])).numpy(),
                               np.asarray(js.linear_kernel(jnp.asarray(X), jnp.asarray(X[:7]))),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        ts.rbf_kernel(T(X), T(X[:7]), 0.5).numpy(),
        np.asarray(js.rbf_kernel(jnp.asarray(X), jnp.asarray(X[:7]), 0.5)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_dual_svm_matches_reference(blobs, masked):
    _, _, X, y = blobs
    mask = (np.arange(len(X)) % 3 != 0).astype(np.float32) if masked else None
    mj = js.dual_svm(jnp.asarray(X), jnp.asarray(y), C=1.0,
                     mask=None if mask is None else jnp.asarray(mask))
    mt = ts.dual_svm(X, y, C=1.0, mask=mask, device="cpu")
    np.testing.assert_allclose(mt.alpha.numpy(), np.asarray(mj.alpha), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(mt.sv_mask.numpy(), np.asarray(mj.sv_mask))
    fj = np.asarray(js.decision_function(mj, jnp.asarray(X)))
    ft = ts.decision_function(mt, T(X)).numpy()
    np.testing.assert_allclose(ft, fj, rtol=RTOL, atol=ATOL)
    assert np.mean(np.sign(ft) == y) > 0.97  # tests/test_svm.py:31
    assert int(mt.sv_mask.sum()) < 0.3 * len(X)


def test_dual_svm_rbf_matches_reference(circles):
    X, y = circles

    def jk(a, b):
        return js.rbf_kernel(a, b, 0.5)

    def tk(a, b):
        return ts.rbf_kernel(a, b, 0.5)

    mj = js.dual_svm(jnp.asarray(X), jnp.asarray(y), C=5.0, kernel=jk, iters=800)
    mt = ts.dual_svm(X, y, C=5.0, kernel=tk, iters=800, device="cpu")
    np.testing.assert_allclose(mt.alpha.numpy(), np.asarray(mj.alpha), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(mt.sv_mask.numpy(), np.asarray(mj.sv_mask))
    ft = ts.decision_function(mt, T(X), kernel=tk).numpy()
    np.testing.assert_allclose(
        ft, np.asarray(js.decision_function(mj, jnp.asarray(X), kernel=jk)),
        rtol=RTOL, atol=ATOL)
    assert np.mean(np.sign(ft) == y) > 0.95  # tests/test_svm.py:99


def test_cascade_strategy_fit_matches_reference(blobs):
    """Through ``fit``: the SV masks per round and the final model exactly,
    α to rtol 1e-5 / atol 1e-6, the per-round SV-only bytes and the ledger
    exactly (the strategy's byte hooks)."""
    Xs, ys, _, _ = blobs
    rj = japi.fit(js.CascadeStrategy(C=1.0), (jnp.asarray(Xs), jnp.asarray(ys)),
                  transport="allreduce", steps=4, tag="cascade")
    rt = tapi.fit(ts.CascadeStrategy(C=1.0), (Xs, ys), transport="allreduce", steps=4,
                  tag="cascade", device="cpu")
    np.testing.assert_array_equal(rt.trajectory.numpy(), np.asarray(rj.trajectory))
    np.testing.assert_array_equal(rt.theta.sv_mask.numpy(), np.asarray(rj.theta.sv_mask))
    np.testing.assert_allclose(rt.theta.alpha.numpy(), np.asarray(rj.theta.alpha),
                               rtol=RTOL, atol=ATOL)
    for key in ("uplink_bytes_per_round", "downlink_bytes_per_round"):
        assert rt.metrics[key].dtype == np.asarray(rj.metrics[key]).dtype
        np.testing.assert_array_equal(rt.metrics[key], np.asarray(rj.metrics[key]))
    assert rt.ledger.summary() == rj.ledger.summary()
    assert rt.ledger.events == rj.ledger.events
    np.testing.assert_allclose(
        tapi.fit(ts.CascadeStrategy(), (Xs, ys), transport="allreduce", steps=1,
                 device="cpu").theta.alpha.numpy(),
        np.asarray(japi.fit(js.CascadeStrategy(), (jnp.asarray(Xs), jnp.asarray(ys)),
                            transport="allreduce", steps=1).theta.alpha),
        rtol=RTOL, atol=ATOL)


def test_cascade_strategy_refuses_faults_as_the_reference(blobs):
    Xs, ys, _, _ = blobs
    with pytest.raises(ValueError, match="SUM aggregate"):
        tapi.fit(ts.CascadeStrategy(), (Xs, ys), transport="allreduce", steps=1,
                 faults=tapi.FaultPlan(seed=0, dropout_p=0.1), device="cpu")


def test_cascade_svm_shim_matches_reference(blobs):
    """Rounds, SV counts and the ledger exactly; accuracy and stability as
    tests/test_svm.py:51-56."""
    Xs, ys, X, y = blobs
    with pytest.warns(DeprecationWarning, match="repro_torch.api.fit"):
        rt = ts.cascade_svm(Xs, ys, C=1.0, max_rounds=6, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rj = js.cascade_svm(jnp.asarray(Xs), jnp.asarray(ys), C=1.0, max_rounds=6)
    assert (rt.rounds, rt.sv_counts) == (rj.rounds, rj.sv_counts)
    assert rt.ledger.events == rj.ledger.events
    assert rt.ledger.summary() == rj.ledger.summary()
    assert np.mean(np.sign(ts.decision_function(rt.model, T(X)).numpy()) == y) > 0.97
    assert rt.sv_counts[-1] == rt.sv_counts[-2]
    assert rt.ledger.total_bytes < X.size * 4 + y.size * 4


def test_cascade_predict(blobs):
    Xs, ys, X, _ = blobs
    strategy = ts.CascadeStrategy()
    res = tapi.fit(strategy, (Xs, ys), transport="allreduce", steps=2, device="cpu")
    assert torch.equal(strategy.predict(res.theta, T(X)),
                       ts.decision_function(res.theta, T(X)))


def test_smooth_hinge_matches_reference():
    m = np.linspace(-1.0, 2.0, 301).astype(np.float32)
    np.testing.assert_allclose(ts.smooth_hinge(T(m)).numpy(),
                               np.asarray(js.smooth_hinge(jnp.asarray(m))), rtol=RTOL,
                               atol=ATOL)


def test_consensus_svm_shim_matches_reference(blobs):
    """60 ADMM iterations of 50 inner steps: z to rtol 1e-5 / atol 1e-6;
    accuracy as tests/test_svm.py:68."""
    Xs, ys, X, y = blobs
    with pytest.warns(DeprecationWarning, match="repro_torch.api.fit"):
        rt = ts.consensus_svm(Xs, ys, iters=60, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rj = js.consensus_svm(jnp.asarray(Xs), jnp.asarray(ys), iters=60)
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history), rtol=1e-4,
                               atol=1e-5 * float(np.abs(np.asarray(rj.z)).max()))
    assert np.mean(np.sign(X @ rt.z.numpy()) == y) > 0.97


def test_weighted_dual_consensus_matches_reference(blobs):
    Xs, ys, X, y = blobs
    weights = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    for w in (None, weights):
        aj, dj = js.weighted_dual_consensus(
            jnp.asarray(Xs), jnp.asarray(ys), node_weights=None if w is None else jnp.asarray(w))
        at, dt = ts.weighted_dual_consensus(Xs, ys, node_weights=w, device="cpu")
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=RTOL, atol=ATOL)
        ft = dt(T(X)).numpy()
        np.testing.assert_allclose(ft, np.asarray(dj(jnp.asarray(X))), rtol=RTOL, atol=ATOL)
        assert np.mean(np.sign(ft) == y) > 0.95  # tests/test_svm.py:75
