"""Port parity: ``repro_torch.core.admm``, ``ProxStrategy`` and the
``admm_consensus`` transport against the JAX package, on the same numpy
inputs, the port on the CPU.

Iterates agree to rtol 1e-5 (atol 1e-6 for entries the soft threshold
sends to 0; the duals and residual norms, made of θ − z, to 1e-5 of θ's
scale): the per-node
solves and the averages round in another order in the two packages.  Ledgers — bytes, rounds, events — are equal exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import admm as ja  # noqa: E402
from repro.ml import linear as jl  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import admm as ta  # noqa: E402
from repro_torch.ml import linear as tl  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def problem(K=4, Nk=10, n=5, seed=0):
    """The LASSO problem of tests/test_api_fit.py (``_make_problem``), in
    f32: K nodes of Nk rows, y = X w."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(K, Nk, n)).astype(np.float32)
    w = rng.normal(size=(n,)).astype(np.float32)
    return X, np.einsum("kni,i->kn", X, w).astype(np.float32)


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("g", ["l1", "l2sq", "none"])
def test_prox_operators_match_jax(g):
    v = np.random.default_rng(1).normal(size=(64,)).astype(np.float32)
    np.testing.assert_array_equal(ta.PROX[g](T(v), 0.3).numpy(),
                                  np.asarray(ja.PROX[g](jnp.asarray(v), 0.3)))


@pytest.mark.parametrize("g, rho", [("l1", 1.0), ("l2sq", 0.5), ("none", 2.0)])
def test_consensus_admm_matches_jax(g, rho):
    X, y = problem()
    rj = ja.consensus_admm(jl.lasso_prox_builder((jnp.asarray(X), jnp.asarray(y))), 4, 5,
                           rho=rho, g=g, g_lam=0.1, iters=30)
    rt = ta.consensus_admm(tl.lasso_prox_builder((T(X), T(y))), 4, 5,
                           rho=rho, g=g, g_lam=0.1, iters=30, device="cpu")
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.state.theta.numpy(), np.asarray(rj.state.theta),
                               rtol=RTOL, atol=ATOL)
    # the duals and the residual norms are made of differences θ − z, so
    # their rounding is relative to θ's scale, not to their own
    scale = RTOL * float(np.abs(np.asarray(rj.state.theta)).max())
    np.testing.assert_allclose(rt.state.u.numpy(), np.asarray(rj.state.u), rtol=RTOL,
                               atol=scale)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history), rtol=RTOL,
                               atol=scale)
    assert int(rt.state.it) == int(rj.state.it) == 30


def test_gradient_local_prox_matches_jax():
    """The inner-gradient prox: ``jax.vmap(jax.grad(f))`` on one side,
    ``torch.func.vmap(torch.func.grad(f))`` on the other."""
    X, y = problem(n=6, seed=2)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    gj = jax.vmap(jax.grad(jl.lsq_loss), in_axes=(0, 0, 0))
    gt = torch.func.vmap(torch.func.grad(tl.lsq_loss), in_dims=(0, 0, 0))
    Xt, yt = T(X), T(y)
    rj = ja.consensus_admm(ja.gradient_local_prox(lambda th: gj(th, Xj, yj), inner_iters=10),
                           4, 6, rho=1.0, g="l1", g_lam=0.05, iters=20)
    rt = ta.consensus_admm(ta.gradient_local_prox(lambda th: gt(th, Xt, yt), inner_iters=10),
                           4, 6, rho=1.0, g="l1", g_lam=0.05, iters=20, device="cpu")
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=RTOL, atol=ATOL)


def test_consensus_admm_default_device_needs_a_gpu():
    """With no ``theta0`` the state is made on ``device``, "cuda" by
    default, as the other entry points do; with one it lives where
    ``theta0`` does."""
    X, y = problem()
    prox = tl.lasso_prox_builder((T(X), T(y)))
    rt = ta.consensus_admm(prox, 4, 5, iters=2, theta0=torch.zeros((4, 5)))
    assert rt.z.device.type == "cpu" and rt.state.u.device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ta.consensus_admm(prox, 4, 5, iters=2)


def test_fit_prox_lasso_matches_jax():
    """fit(ProxStrategy(lasso_prox_builder), transport="admm_consensus",
    steps=50, rho=1.0, g="l1", g_lam=0.1), as tests/test_api_fit.py runs
    it: θ and the residual trajectory agree, the ledger exactly."""
    X, y = problem()
    kw = dict(transport="admm_consensus", steps=50, rho=1.0, g="l1", g_lam=0.1)
    rj = japi.fit(japi.ProxStrategy(jl.lasso_prox_builder), (jnp.asarray(X), jnp.asarray(y)),
                  **kw)
    rt = tapi.fit(tapi.ProxStrategy(tl.lasso_prox_builder), (X, y), device="cpu", **kw)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.trajectory.numpy(), np.asarray(rj.trajectory),
                               rtol=RTOL, atol=ATOL)
    assert rt.ledger.summary() == rj.ledger.summary()
    assert rt.ledger.events == rj.ledger.events
    assert rt.ledger.rounds == 2 * 50
    assert rt.ledger.total_bytes == 50 * 2 * 2 * 4 * 5 * 4
    np.testing.assert_array_equal(rt.metrics["uplink_bytes_per_round"],
                                  rj.metrics["uplink_bytes_per_round"])
    np.testing.assert_array_equal(rt.metrics["downlink_bytes_per_round"],
                                  rj.metrics["downlink_bytes_per_round"])
    assert rt.metrics["transport"] == "admm_consensus"
    assert torch.equal(rt.metrics["admm"].z, rt.theta)
    # the fit reaches what the centralized LASSO objective says it should
    Xall, yall = T(X.reshape(-1, 5)), T(y.reshape(-1))
    np.testing.assert_allclose(
        float(tl.centralized_lasso_objective(rt.theta, Xall, yall, 0.1)),
        float(jl.centralized_lasso_objective(rj.theta, jnp.asarray(X.reshape(-1, 5)),
                                             jnp.asarray(y.reshape(-1)), 0.1)),
        rtol=RTOL)


#: each refusal of the admm_consensus transport and the words it names
REFUSALS = {
    "faults": "faults=", "no_steps": "needs steps=", "warm_start": "one-shot",
    "resume": "one-shot", "lossy_wire": "lossless wire", "executor": "local executor only",
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_admm_consensus_refuses(case):
    """The JAX transport's five refusals, with the same meaning (warm start
    and resume are one refusal there too)."""
    X, y = problem()
    kw = dict(transport="admm_consensus", steps=5, device="cpu")
    if case == "faults":
        kw["faults"] = tapi.FaultPlan(seed=1, dropout_p=0.2)
    elif case == "no_steps":
        kw.pop("steps")
    elif case == "warm_start":
        kw["theta0"] = np.zeros(5, np.float32)
    elif case == "resume":
        kw["carry"] = ()
    elif case == "lossy_wire":
        kw["wire"] = "topk:0.5"
    else:
        kw["executor"] = type("Other", (tapi.Executor,), {"name": "elsewhere"})()
    with pytest.raises(ValueError, match=REFUSALS[case]):
        tapi.fit(tapi.ProxStrategy(tl.lasso_prox_builder), (X, y), **kw)


def test_admm_transport_options():
    t = tapi.make_transport("admm_consensus", rho=0.5, g="l2sq", g_lam=0.2)
    assert isinstance(t, tapi.AdmmTransport) and (t.rho, t.g, t.g_lam) == (0.5, "l2sq", 0.2)
    assert "admm_consensus" in tapi.TRANSPORTS
    with pytest.raises(TypeError, match="staleness"):
        tapi.make_transport("admm_consensus", staleness=1)
    with pytest.raises(NotImplementedError, match="admm_consensus"):
        tapi.GradientDescent(tl.lsq_loss).make_local_prox(None)
