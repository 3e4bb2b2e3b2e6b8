"""Port parity: ``repro_torch.ml.gp`` against ``repro.ml.gp`` on the same
numpy inputs (the sine data of ``tests/test_gp.py`` and
``tests/test_sparse_gp_graphical.py``), the port on the CPU.

Tolerances, each beside its test:
* closed forms on the same inputs (the kernel, the four expert rules fed
  JAX's own expert predictions, the MoE assignment): rtol 1e-5 / atol 1e-6
  (``tests/test_torch_fit.py:35``), assignments exactly;
* whatever goes through an f32 Cholesky or solve of a kernel matrix, and
  the Adagrad hyper fits built on its gradient: rtol 1e-3 / atol 1e-4, the
  reference's own bound for one posterior reached two ways
  (``tests/test_gp.py:45-46``).  The kernel matrices of 1-D data are
  ill-conditioned: after 60 Adagrad steps JAX's and the port's hypers are
  each ≈ 6.4e-5 from a float64 run of the same fit and 1.3e-4 apart
  (measured on this test's data);
* where the noise is small enough that both packages' f32 results leave
  the float64 one by more than that bound (the likelihood gradient and
  the sparse posterior at the fitted hypers), the formula is checked in
  float64: the port's float64 result against the JAX package's float64
  result (``jax.enable_x64``) at rtol 1e-5 / atol 1e-6.  The port's f32
  result is then held within twice the JAX package's own f32 distance
  from JAX's float64 result (``ROADMAP.md`` queue 3, item 16), and the
  sparse posterior also to the reference's own atol 5e-2
  (``tests/test_sparse_gp_graphical.py:41``).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.allreduce import CommLedger as JLedger  # noqa: E402
from repro.ml import gp as jg  # noqa: E402
from repro_torch.core.allreduce import CommLedger as TLedger  # noqa: E402
from repro_torch.ml import gp as tg  # noqa: E402

EXACT = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_fit.py:35
CHOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_gp.py:45-46


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def thyp(h) -> tg.GPHypers:
    return tg.GPHypers(*(T(np.asarray(v)) for v in h))


@pytest.fixture(scope="module")
def sine():
    rng = np.random.default_rng(11)
    X = np.linspace(-3, 3, 64)[:, None].astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.05 * rng.normal(size=64)).astype(np.float32)
    Xq = np.linspace(-2.5, 2.5, 12)[:, None].astype(np.float32)
    hyp = jg.fit_hypers(jnp.asarray(X), jnp.asarray(y), steps=60)
    return X, y, Xq, hyp


@pytest.fixture(scope="module")
def sine2():
    """tests/test_sparse_gp_graphical.py's sine data (120 sorted points)."""
    rng = np.random.default_rng(5)
    X = np.sort(rng.uniform(-3, 3, size=(120, 1)), 0).astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.05 * rng.normal(size=120)).astype(np.float32)
    Xq = np.linspace(-2.5, 2.5, 15)[:, None].astype(np.float32)
    hyp = jg.fit_hypers(jnp.asarray(X), jnp.asarray(y), steps=120)
    return X, y, Xq, hyp


def test_rbf_and_default_hypers_match(sine):
    X, _, Xq, hyp = sine
    np.testing.assert_allclose(tg.rbf(thyp(hyp), T(Xq), T(X)).numpy(),
                               np.asarray(jg.rbf(hyp, jnp.asarray(Xq), jnp.asarray(X))),
                               **EXACT)
    d = tg.default_hypers(device="cpu")
    assert [float(v) for v in d] == [float(v) for v in jg.default_hypers()]


@pytest.mark.parametrize("fitted", [False, True])
def test_posterior_and_likelihood_match(sine, fitted):
    X, y, Xq, hyp = sine
    hj = hyp if fitted else jg.default_hypers()
    ht = thyp(hj)
    mj, vj = jg.gp_posterior(hj, jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xq))
    mt, vt = tg.gp_posterior(ht, T(X), T(y), T(Xq))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **CHOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **CHOL)
    np.testing.assert_allclose(
        float(tg.log_marginal_likelihood(ht, T(X), T(y))),
        float(jg.log_marginal_likelihood(hj, jnp.asarray(X), jnp.asarray(y))), **CHOL)


def f64_hyp(h) -> tg.GPHypers:
    return tg.GPHypers(*(T(np.asarray(v)).double() for v in h))


def jax64(fn, h, *arrays):
    """``fn(hypers, *arrays)`` of the JAX package in float64, as numpy."""
    with jax.enable_x64(True):
        out = fn(jg.GPHypers(*(jnp.asarray(np.asarray(v), jnp.float64) for v in h)),
                 *(jnp.asarray(np.asarray(a, np.float64)) for a in arrays))
        return jax.tree.map(lambda v: np.asarray(v, np.float64), out)


def within_twice_jax(port, jax_, exact):
    """The port's f32 result no farther from JAX's float64 one than twice
    the JAX package's f32 result is (max-norm)."""
    assert exact.dtype == np.float64
    port_err = np.abs(np.asarray(port, np.float64) - exact).max()
    jax_err = np.abs(np.asarray(jax_, np.float64) - exact).max()
    assert port_err <= 2 * jax_err, (port_err, jax_err)


@pytest.mark.parametrize("fitted", [False, True])
def test_likelihood_gradient_matches(sine, fitted):
    """At the default hypers to the Cholesky bound.  At the fitted ones
    (σ_n² = 2.2e-3, an ill-conditioned 64 × 64 Cholesky) JAX and the port
    are 5.6e-3 and 2.4e-3 from JAX's float64 gradient (max-abs) and 7.9e-3
    apart, past the bound: there the port's float64 gradient is held to
    JAX's float64 gradient at rtol 1e-5 / atol 1e-6 (measured 7.5e-12
    apart), and the port's f32 gradient within twice JAX's own distance
    from JAX's float64 one (queue 3, item 16)."""
    X, y, _, hyp = sine
    hj = hyp if fitted else jg.default_hypers()
    gj = np.array([float(v) for v in jax.grad(
        lambda h: -jg.log_marginal_likelihood(h, jnp.asarray(X), jnp.asarray(y)))(hj)])
    gt = np.array([float(v) for v in torch.func.grad(
        lambda h: -tg.log_marginal_likelihood(h, T(X), T(y)))(thyp(hj))])
    if not fitted:
        np.testing.assert_allclose(gt, gj, **CHOL)
        return
    gj64 = np.array(jax64(lambda h, X, y: jax.grad(
        lambda hh: -jg.log_marginal_likelihood(hh, X, y))(h), hj, X, y))
    gt64 = np.array([float(v) for v in torch.func.grad(
        lambda h: -tg.log_marginal_likelihood(h, T(X).double(), T(y).double()))(f64_hyp(hj))])
    np.testing.assert_allclose(gt64, gj64, **EXACT)
    within_twice_jax(gt, gj, gj64)


def test_fit_hypers_matches(sine):
    X, y, _, hyp = sine
    ht = tg.fit_hypers(X, y, steps=60, device="cpu")
    for a, b in zip(ht, hyp):
        np.testing.assert_allclose(float(a), float(b), **CHOL)
    assert float(tg.log_marginal_likelihood(ht, T(X), T(y))) > float(
        tg.log_marginal_likelihood(tg.default_hypers(device="cpu"), T(X), T(y)))


def test_fit_hypers_distributed_matches(sine):
    X, y, _, _ = sine
    Xs, ys = X.reshape(4, 16, 1), y.reshape(4, 16)
    lj, lt = JLedger(), TLedger()
    hj = jg.fit_hypers_distributed(jnp.asarray(Xs), jnp.asarray(ys), steps=60, ledger=lj)
    ht = tg.fit_hypers_distributed(Xs, ys, steps=60, ledger=lt, device="cpu")
    for a, b in zip(ht, hj):
        np.testing.assert_allclose(float(a), float(b), **CHOL)
    assert lt.summary() == lj.summary() and lt.events == lj.events


def test_expert_rules_match(sine):
    """The rules on JAX's own expert predictions: rtol 1e-5 / atol 1e-6;
    the predictions themselves at the Cholesky bound."""
    X, y, Xq, hyp = sine
    Xs, ys = X.reshape(4, 16, 1), y.reshape(4, 16)
    pj = jg.expert_predictions(hyp, jnp.asarray(Xs), jnp.asarray(ys), jnp.asarray(Xq))
    pt = tg.expert_predictions(thyp(hyp), T(Xs), T(ys), T(Xq))
    np.testing.assert_allclose(pt.mu.numpy(), np.asarray(pj.mu), **CHOL)
    np.testing.assert_allclose(pt.var.numpy(), np.asarray(pj.var), **CHOL)
    pjt = tg.ExpertPreds(mu=T(pj.mu), var=T(pj.var))
    pvj = jg.prior_variance(hyp, jnp.asarray(Xq))
    pv = tg.prior_variance(thyp(hyp), T(Xq))
    np.testing.assert_allclose(pv.numpy(), np.asarray(pvj), **EXACT)
    beta = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    rules = [
        (tg.poe(pjt), jg.poe(pj)),
        (tg.gpoe(pjt), jg.gpoe(pj)),
        (tg.gpoe(pjt, T(beta)), jg.gpoe(pj, jnp.asarray(beta))),
        (tg.bcm(pjt, T(pvj)), jg.bcm(pj, pvj)),
        (tg.gbcm(pjt, T(pvj)), jg.gbcm(pj, pvj)),
        (tg.gbcm(pjt, T(pvj), T(beta)), jg.gbcm(pj, pvj, jnp.asarray(beta))),
    ]
    for (mt, vt), (mj, vj) in rules:
        np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **EXACT)
        np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **EXACT)


def test_gpoe_falls_back_to_prior_far_away(sine):
    """tests/test_gp.py:88-100: Σβ = 1 ⇒ the prior variance far from data."""
    X, y, _, hyp = sine
    far = np.asarray([[40.0]], np.float32)
    preds = tg.expert_predictions(thyp(hyp), T(X.reshape(4, 16, 1)), T(y.reshape(4, 16)),
                                  T(far))
    _, var = tg.gpoe(preds)
    np.testing.assert_allclose(var.numpy(), tg.prior_variance(thyp(hyp), T(far)).numpy(),
                               rtol=0.05)


def test_sgpr_matches(sine2):
    """Statistics at the Cholesky bound; the posterior at the fitted hypers
    (σ_n² = 2.8e-3: Σ = Kmm + A/σ_n² is ill-conditioned) within the
    reference's own bound for one SGPR posterior reached two ways, atol
    5e-2 (tests/test_sparse_gp_graphical.py:41), and within twice JAX's
    distance from JAX's float64 posterior (mean: JAX 9.9e-3, the port
    4.5e-3; variance: 3.9e-5 both); the port's float64 posterior there
    against JAX's float64 one at rtol 1e-5 / atol 1e-6; the posterior at
    the default hypers with M = 6, which f32 factors well, at the Cholesky
    bound (measured: variance 6.7e-5 apart relatively);
    the ELBO where f32 factors Kmm and Σ (M = 6) at the Cholesky bound,
    and NaN in both where f32 cannot (M = 16: ``jnp.linalg.cholesky``
    gives NaN, so the port's does); the per-node bytes exactly, (M² + M +
    2)·4 (tests/test_sparse_gp_graphical.py:44)."""
    X, y, Xq, hyp = sine2
    Z = np.linspace(-3, 3, 16)[:, None].astype(np.float32)
    ht = thyp(hyp)
    sj = jg.sgpr_local_stats(hyp, jnp.asarray(Z), jnp.asarray(X), jnp.asarray(y))
    st = tg.sgpr_local_stats(ht, T(Z), T(X), T(y))
    for a, b in zip(st, sj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **CHOL)
    mj, vj = jg.sgpr_posterior(hyp, jnp.asarray(Z), sj, jnp.asarray(Xq))
    mt, vt = tg.sgpr_posterior(ht, T(Z), st, T(Xq))
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=5e-2)
    mj64, vj64 = jax64(lambda h, Z, X, y, Xq: jg.sgpr_posterior(
        h, Z, jg.sgpr_local_stats(h, Z, X, y), Xq), hyp, Z, X, y, Xq)
    s64 = tg.sgpr_local_stats(f64_hyp(hyp), T(Z).double(), T(X).double(), T(y).double())
    mt64, vt64 = tg.sgpr_posterior(f64_hyp(hyp), T(Z).double(), s64, T(Xq).double())
    np.testing.assert_allclose(mt64.numpy(), mj64, **EXACT)
    np.testing.assert_allclose(vt64.numpy(), vj64, **EXACT)
    within_twice_jax(mt.numpy(), np.asarray(mj), mj64)
    within_twice_jax(vt.numpy(), np.asarray(vj), vj64)
    assert np.isnan(float(jg.sgpr_elbo(hyp, jnp.asarray(Z), sj)))
    assert np.isnan(float(tg.sgpr_elbo(ht, T(Z), st)))
    Z6 = np.linspace(-3, 3, 6)[:, None].astype(np.float32)
    d = jg.default_hypers()
    s6j = jg.sgpr_local_stats(d, jnp.asarray(Z6), jnp.asarray(X), jnp.asarray(y))
    s6t = tg.sgpr_local_stats(thyp(d), T(Z6), T(X), T(y))
    ej, et = float(jg.sgpr_elbo(d, jnp.asarray(Z6), s6j)), float(tg.sgpr_elbo(thyp(d), T(Z6), s6t))
    m6j, v6j = jg.sgpr_posterior(d, jnp.asarray(Z6), s6j, jnp.asarray(Xq))
    m6t, v6t = tg.sgpr_posterior(thyp(d), T(Z6), s6t, T(Xq))
    np.testing.assert_allclose(m6t.numpy(), np.asarray(m6j), **CHOL)
    np.testing.assert_allclose(v6t.numpy(), np.asarray(v6j), **CHOL)
    assert np.isfinite(ej)
    np.testing.assert_allclose(et, ej, **CHOL)
    lj, lt = JLedger(), TLedger()
    dj = jg.distributed_sgpr(hyp, jnp.asarray(Z), jnp.asarray(X.reshape(4, 30, 1)),
                             jnp.asarray(y.reshape(4, 30)), jnp.asarray(Xq), ledger=lj)
    dt = tg.distributed_sgpr(ht, Z, X.reshape(4, 30, 1), y.reshape(4, 30), Xq, ledger=lt,
                             device="cpu")
    np.testing.assert_allclose(dt[0].numpy(), np.asarray(dj[0]), atol=5e-2)
    np.testing.assert_allclose(dt[0].numpy(), mt.numpy(), atol=5e-2)
    assert dt[2] == dj[2] == (16 * 16 + 16 + 2) * 4
    assert lt.summary() == lj.summary() and lt.events == lj.events
    parts = tg.SGPRStats(*(torch.stack(f) for f in zip(*[
        tg.sgpr_local_stats(ht, T(Z), T(X[30 * k:30 * (k + 1)]), T(y[30 * k:30 * (k + 1)]))
        for k in range(4)])))
    agg = tg.sgpr_aggregate(parts)
    np.testing.assert_allclose(agg.A.numpy(), st.A.numpy(), rtol=1e-4, atol=1e-4)
    assert float(agg.n) == float(st.n)


def test_moe_matches():
    """tests/test_gp.py:115-129: the assignment exactly, the prediction at
    the Cholesky bound."""
    means = np.asarray([[0.0, 0.0], [5.0, 5.0]], np.float32)
    Xa = np.asarray([[0.1, -0.2], [4.9, 5.3], [0.4, 0.1]], np.float32)
    z = tg.moe_map_assign(T(Xa), T(means), torch.ones(2))
    assert z.tolist() == [0, 1, 0]
    rng = np.random.default_rng(11)
    X = np.linspace(-3, 3, 64)[:, None].astype(np.float32)
    y = (np.sin(X[:, 0]) + 0.05 * rng.normal(size=64)).astype(np.float32)
    Xq = np.linspace(-2.5, 2.5, 12)[:, None].astype(np.float32)
    hyp = jg.default_hypers()
    m1 = np.asarray([[-1.5], [1.5]], np.float32)
    mj, vj = jg.moe_predict(hyp, jnp.asarray(X), jnp.asarray(y), jnp.asarray(Xq),
                            jnp.asarray(m1), jnp.ones(1))
    mt, vt = tg.moe_predict(thyp(hyp), X, y, Xq, m1, np.ones(1, np.float32), device="cpu")
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), **CHOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), **CHOL)
