"""Port parity: ``repro_torch.ml.graphical`` against ``repro.ml.graphical``
on the same inputs — the chain GMRF of ``tests/test_sparse_gp_graphical.py``
with JAX's own samples (``sample_gmrf(jax.random.key(0), Θ, 2000)``) handed
over as numpy — the port on the CPU.

Tolerances, each beside its test: the symmetric packing exactly; the
pseudo-likelihood to rtol 1e-5 / atol 1e-6 (``tests/test_torch_fit.py:35``)
and its gradient to rtol 1e-5 with atol 1e-5 of its largest element; the
Adagrad and ADMM solvers to rtol 1e-5 / atol 1e-5 after hundreds of
steps (each step's gradient sums run in another order); the support F1
exactly.  ``sample_gmrf`` draws from a
``torch.Generator``, not ``jax.random``, so it is held to its covariance.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ml import graphical as jgr  # noqa: E402
from repro_torch.ml import graphical as tgr  # noqa: E402

EXACT = dict(rtol=1e-5, atol=1e-6)  # tests/test_torch_fit.py:35
SOLVER = dict(rtol=1e-5, atol=1e-5)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def chain_gmrf():
    d = 6
    Theta = np.eye(d, dtype=np.float32) * 1.5
    for i in range(d - 1):
        Theta[i, i + 1] = Theta[i + 1, i] = 0.5
    X = np.array(jgr.sample_gmrf(jax.random.key(0), jnp.asarray(Theta), 2000))
    return Theta, X


def test_sym_and_flatten_match(chain_gmrf):
    rng = np.random.default_rng(2)
    flat = rng.normal(size=(21,)).astype(np.float32)
    np.testing.assert_array_equal(tgr._sym(T(flat), 6).numpy(),
                                  np.asarray(jgr._sym(jnp.asarray(flat), 6)))
    Theta, _ = chain_gmrf
    np.testing.assert_array_equal(tgr.flatten_sym(T(Theta)).numpy(),
                                  np.asarray(jgr.flatten_sym(jnp.asarray(Theta))))
    np.testing.assert_array_equal(tgr._sym(tgr.flatten_sym(T(Theta)), 6).numpy(), Theta)


@pytest.mark.parametrize("where", ["identity", "truth", "near-barrier"])
def test_pseudo_loglik_and_gradient_match(chain_gmrf, where):
    Theta, X = chain_gmrf
    start = {"identity": np.eye(6), "truth": Theta,
             "near-barrier": np.eye(6) * 0.02 + 0.01}[where].astype(np.float32)
    th = np.asarray(jgr.flatten_sym(jnp.asarray(start)))
    np.testing.assert_allclose(float(tgr.neg_pseudo_loglik(T(th), T(X))),
                               float(jgr.neg_pseudo_loglik(jnp.asarray(th), jnp.asarray(X))),
                               **EXACT)
    gj = np.asarray(jax.grad(jgr.neg_pseudo_loglik)(jnp.asarray(th), jnp.asarray(X)))
    gt = torch.func.grad(tgr.neg_pseudo_loglik)(T(th), T(X)).numpy()
    # each element a mean over 2,000 samples: to 1e-5 of the largest
    np.testing.assert_allclose(gt, gj, rtol=1e-5, atol=1e-5 * np.abs(gj).max())


def test_mple_centralized_matches(chain_gmrf):
    """800 Adagrad steps (tests/test_sparse_gp_graphical.py:82)."""
    Theta, X = chain_gmrf
    tt = tgr.mple_centralized(X, iters=800, device="cpu")
    tj = jgr.mple_centralized(jnp.asarray(X), iters=800)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **SOLVER)
    assert float(tgr.support_f1(tt, T(Theta))) > 0.95
    l0 = float(tgr.neg_pseudo_loglik(tgr.flatten_sym(torch.eye(6)), T(X)))
    assert float(tgr.neg_pseudo_loglik(tgr.flatten_sym(tt), T(X))) < l0


def test_mple_consensus_matches(chain_gmrf):
    """50 ADMM iterations of 50 inner steps (tests/test_sparse_gp_graphical.py:87-99):
    Θ and the residual history to rtol 1e-5 / atol 1e-5; F1 and the
    shrinking primal residual as there."""
    Theta, X = chain_gmrf
    Xs = X.reshape(4, 500, 6)
    tt, rt = tgr.mple_consensus(Xs, iters=50, inner_iters=50, device="cpu")
    tj, rj = jgr.mple_consensus(jnp.asarray(Xs), iters=50, inner_iters=50)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), **SOLVER)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history), **SOLVER)
    assert float(tgr.support_f1(tt, T(Theta))) > 0.95
    hist = rt.history.numpy()
    assert hist[-1, 0] < hist[2, 0]


def test_support_f1_matches(chain_gmrf):
    Theta, _ = chain_gmrf
    rng = np.random.default_rng(9)
    for _ in range(5):
        est = (Theta + rng.normal(size=Theta.shape) * 0.15).astype(np.float32)
        assert float(tgr.support_f1(T(est), T(Theta))) == pytest.approx(
            float(jgr.support_f1(jnp.asarray(est), jnp.asarray(Theta))), abs=1e-7)


def test_sample_gmrf_covariance_and_seed(chain_gmrf):
    """100,000 draws: the empirical covariance within 0.02 of Θ⁻¹ (its
    entries' standard error is ≈ 0.004); a generator with the same seed
    gives the same draws."""
    Theta, _ = chain_gmrf
    gen = torch.Generator().manual_seed(0)
    Xt = tgr.sample_gmrf(gen, T(Theta), 100_000)
    cov = np.cov(Xt.numpy().T.astype(np.float64))
    np.testing.assert_allclose(cov, np.linalg.inv(Theta.astype(np.float64)), atol=0.02)
    again = tgr.sample_gmrf(torch.Generator().manual_seed(0), T(Theta), 100_000)
    assert torch.equal(Xt, again)
    assert Xt.dtype == torch.float32 and Xt.shape == (100_000, 6)


def test_entry_points_need_a_gpu_by_default(chain_gmrf):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    _, X = chain_gmrf
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgr.mple_centralized(X, iters=1)
