"""Port parity: ``repro_torch.api.LBFGS`` and the rest of
``repro_torch.ml.linear`` (the three deprecation shims, ``ista_lasso``,
``private_second_order``) and the three parts of
``examples/healthcare_federated.py``, against the JAX package on the same
numpy inputs, the port on the CPU.

Tolerances, each beside its test: rtol 1e-5 / atol 1e-6
(``tests/test_torch_fit.py:35``: the node sums round in another order)
with ledgers — bytes, rounds, events — equal exactly.  One case cannot
hold that on θ: L-BFGS on the logistic loss under ``allreduce``, where
the first curvature pair (s, y = g₁ − g₀) is a difference of nearly equal
gradients and the two-loop recursion magnifies its last bits
(``ROADMAP.md`` queue 3, item 15); there the port's float64 fit is held
to the JAX package's float64 fit (``jax.enable_x64``) at rtol 1e-5 / atol
1e-6, and the port's f32 θ to no farther from JAX's float64 θ than twice
the JAX package's own f32 θ.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import schedules as j_sched  # noqa: E402
from repro.data import make_feature_shards  # noqa: E402
from repro.ml import linear as jl  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.ml import linear as tl  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_fit.py:35
K, N, D = 4, 24, 300
LOSSES = {"lsq": (jl.lsq_loss, tl.lsq_loss), "logistic": (jl.logistic_loss, tl.logistic_loss)}


def problem(task="regression", seed=0):
    rng = np.random.default_rng(seed)
    Xs = (rng.normal(size=(K, N, D)) / np.sqrt(D)).astype(np.float32)
    w = rng.normal(size=(D,)).astype(np.float32)
    ys = np.einsum("kni,i->kn", Xs, w).astype(np.float32)
    if task == "classification":
        ys = np.where(ys >= 0, 1.0, -1.0).astype(np.float32)
    return Xs, ys


def shards(seed=1, noise=0.01):
    """The reference's own shards (tests/test_linear.py ``_shards``), as numpy."""
    Xs, ys, w = make_feature_shards(seed, 4, 25, 6, noise=noise)
    return np.array(Xs), np.array(ys), np.array(w)


def lbfgs_both(loss, transport, steps=10, **kw):
    jf, tf = LOSSES[loss]
    Xs, ys = problem("classification" if loss == "logistic" else "regression")
    rj = japi.fit(japi.LBFGS(jf), (jnp.asarray(Xs), jnp.asarray(ys)), transport=transport,
                  steps=steps, **kw)
    rt = tapi.fit(tapi.LBFGS(tf), (Xs, ys), transport=transport, steps=steps,
                  device="cpu", **kw)
    return rj, rt, (Xs, ys)


def assert_ledgers_equal(lj, lt):
    assert lt.summary() == lj.summary()
    assert lt.events == lj.events


def T(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------------------
# L-BFGS
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("loss, transport, kw", [
    ("lsq", "allreduce", {}),
    ("lsq", "delay_line", {"staleness": 2}),
    ("logistic", "delay_line", {"staleness": 2}),
], ids=["lsq-allreduce", "lsq-delay_line", "logistic-delay_line"])
def test_lbfgs_matches_reference(loss, transport, kw):
    """θ and trajectory to rtol 1e-5 / atol 1e-6; ledgers exactly."""
    rj, rt, _ = lbfgs_both(loss, transport, **kw)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.trajectory.numpy(), np.asarray(rj.trajectory),
                               rtol=RTOL, atol=ATOL)
    assert_ledgers_equal(rj.ledger, rt.ledger)
    assert rt.ledger.rounds == 11 and rt.ledger.events[0][1] == "fit/init"
    np.testing.assert_allclose(float(rt.metrics["loss"]), float(rj.metrics["loss"]),
                               rtol=RTOL, atol=ATOL)


def test_lbfgs_logistic_allreduce_conditioning():
    """Trajectory to rtol 1e-5 / atol 1e-6 and ledgers exactly.  In float64
    the two packages' fits agree to rtol 1e-5 / atol 1e-6 in θ and
    trajectory (measured: 8.3e-14 apart) with ledgers exactly equal; the
    port's f32 θ lies within twice the JAX package's own f32 distance from
    JAX's float64 θ (measured: port 9.2e-5, JAX 6.5e-5; queue 3, item 15).
    The first step, before any curvature pair, is bitwise."""
    rj, rt, (Xs, ys) = lbfgs_both("logistic", "allreduce")
    np.testing.assert_allclose(rt.trajectory.numpy(), np.asarray(rj.trajectory),
                               rtol=RTOL, atol=ATOL)
    assert_ledgers_equal(rj.ledger, rt.ledger)
    X64, y64 = Xs.astype(np.float64), ys.astype(np.float64)
    with jax.enable_x64(True):
        r64j = japi.fit(japi.LBFGS(jl.logistic_loss), (jnp.asarray(X64), jnp.asarray(y64)),
                        transport="allreduce", steps=10, theta0=jnp.zeros(D, jnp.float64))
        tj64 = np.asarray(r64j.theta, np.float64)
        trj64 = np.asarray(r64j.trajectory, np.float64)
    r64t = tapi.fit(tapi.LBFGS(tl.logistic_loss), (X64, y64), transport="allreduce", steps=10,
                    theta0=np.zeros(D), device="cpu")
    assert r64t.theta.dtype == torch.float64 and tj64.dtype == np.float64
    np.testing.assert_allclose(r64t.theta.numpy(), tj64, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(r64t.trajectory.numpy(), trj64, rtol=RTOL, atol=ATOL)
    assert_ledgers_equal(r64j.ledger, r64t.ledger)
    port_err = np.abs(rt.theta.numpy() - tj64).max()
    jax_err = np.abs(np.asarray(rj.theta) - tj64).max()
    assert port_err <= 2 * jax_err, (port_err, jax_err)
    one_j = japi.fit(japi.LBFGS(jl.logistic_loss), (jnp.asarray(Xs), jnp.asarray(ys)),
                     transport="allreduce", steps=1)
    one_t = tapi.fit(tapi.LBFGS(tl.logistic_loss), (Xs, ys), transport="allreduce", steps=1,
                     device="cpu")
    np.testing.assert_array_equal(one_t.theta.numpy(), np.asarray(one_j.theta))


def test_lbfgs_state_and_resume_in_port():
    """Resuming from the carry continues the run bitwise and charges no
    second initial gradient."""
    Xs, ys = problem()
    whole = tapi.fit(tapi.LBFGS(tl.lsq_loss), (Xs, ys), transport="allreduce", steps=6,
                     device="cpu")
    first = tapi.fit(tapi.LBFGS(tl.lsq_loss), (Xs, ys), transport="allreduce", steps=3,
                     device="cpu")
    rest = tapi.fit(tapi.LBFGS(tl.lsq_loss), (Xs, ys), transport="allreduce", steps=3,
                    carry=first.metrics["carry"], device="cpu")
    assert torch.equal(rest.theta, whole.theta)
    assert first.ledger.rounds == 4 and rest.ledger.rounds == 3
    state = whole.metrics["carry"][1]
    assert int(state.it) == 6 and state.S.shape == (8, D)


def test_lbfgs_refuses_faults_as_the_reference():
    Xs, ys = problem()
    for mod, strat, data in ((tapi, tapi.LBFGS(tl.lsq_loss), (Xs, ys)),
                             (japi, japi.LBFGS(jl.lsq_loss), (jnp.asarray(Xs), jnp.asarray(ys)))):
        kw = {"device": "cpu"} if mod is tapi else {}
        with pytest.raises(ValueError, match="SUM aggregate"):
            mod.fit(strat, data, transport="allreduce", steps=2,
                    faults=mod.FaultPlan(seed=0, dropout_p=0.2), **kw)


def test_two_loop_matches_reference():
    """The recursion alone, on a history with invalid rows between valid
    ones: to rtol 1e-5 / atol 1e-6."""
    from repro.api.strategy import _two_loop as j_two_loop
    from repro_torch.api.strategy import _two_loop as t_two_loop

    rng = np.random.default_rng(4)
    m, n = 8, 50
    S, Y = rng.normal(size=(2, m, n)).astype(np.float32)
    Y = (Y + 2 * S).astype(np.float32)
    rho = (1.0 / np.sum(S * Y, axis=1)).astype(np.float32)
    valid = np.array([0, 0, 1, 0, 1, 1, 0, 1], np.float32)
    g = rng.normal(size=(n,)).astype(np.float32)
    want = np.asarray(j_two_loop(*map(jnp.asarray, (g, S, Y, rho, valid))))
    got = t_two_loop(*map(T, (g, S, Y, rho, valid))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    none = t_two_loop(*map(T, (g, S, Y, rho, np.zeros(m, np.float32)))).numpy()
    np.testing.assert_array_equal(none, g)  # γ = 1, no pair: the gradient


# ----------------------------------------------------------------------------
# The shims, ISTA, second-order statistics
# ----------------------------------------------------------------------------


def test_distributed_gd_shim_warns_and_matches():
    Xs, ys, _ = shards()
    with pytest.warns(DeprecationWarning, match="repro_torch.api.fit"):
        rt = tl.distributed_gd(Xs, ys, steps=40, lr=0.1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rj = jl.distributed_gd(jnp.asarray(Xs), jnp.asarray(ys), steps=40, lr=0.1)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.losses.numpy(), np.asarray(rj.losses), rtol=RTOL, atol=ATOL)
    assert_ledgers_equal(rj.ledger, rt.ledger)
    assert rt.ledger.total_bytes == 40 * 2 * 4 * 6 * 4  # tests/test_linear.py:26


def test_admm_lasso_shim_warns_and_matches():
    """z and the residual history to rtol 1e-5 / atol 1e-6 (the solves of
    ``tests/test_torch_admm.py``; ℓ1 zeros exact)."""
    Xs, ys, _ = shards(noise=0.02)
    with pytest.warns(DeprecationWarning, match="repro_torch.api.fit"):
        rt = tl.admm_lasso(Xs, ys, lam=0.4, iters=60, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rj = jl.admm_lasso(jnp.asarray(Xs), jnp.asarray(ys), lam=0.4, iters=60)
    np.testing.assert_allclose(rt.z.numpy(), np.asarray(rj.z), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(rt.z.numpy() == 0, np.asarray(rj.z) == 0)


def test_distributed_lbfgs_shim_warns_and_matches():
    Xs, ys, _ = shards(seed=3)
    yc = np.sign(ys).astype(np.float32)
    with pytest.warns(DeprecationWarning, match="repro_torch.api.fit"):
        rt = tl.distributed_lbfgs(Xs, yc, steps=30, l2=1e-3, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        rj = jl.distributed_lbfgs(jnp.asarray(Xs), jnp.asarray(yc), steps=30, l2=1e-3)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.losses.numpy(), np.asarray(rj.losses), rtol=RTOL, atol=ATOL)
    assert_ledgers_equal(rj.ledger, rt.ledger)
    assert rt.ledger.rounds == 31  # steps + the initial gradient (tests/test_linear.py:67)
    with pytest.warns(DeprecationWarning):
        gd = tl.distributed_gd(Xs, yc, loss=tl.logistic_loss, steps=30, lr=0.5, l2=1e-3,
                               device="cpu")
    assert float(rt.losses[-1]) < float(gd.losses[-1])


def test_ista_lasso_matches_reference():
    """5,000 ISTA steps to rtol 1e-5 / atol 1e-6, zeros exact; and the
    consensus LASSO within the reference's 1e-3 of it
    (tests/test_linear.py:45)."""
    Xs, ys, _ = shards(noise=0.02)
    X, y = Xs.reshape(-1, 6), ys.reshape(-1)
    got = tl.ista_lasso(X, y, 0.4, iters=5000, device="cpu").numpy()
    want = np.asarray(jl.ista_lasso(jnp.asarray(X), jnp.asarray(y), 0.4, iters=5000))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got == 0, want == 0)
    with pytest.warns(DeprecationWarning):
        z = tl.admm_lasso(Xs, ys, lam=0.4, iters=300, device="cpu").z.numpy()
    np.testing.assert_allclose(z, got, atol=1e-3)


def test_private_second_order_matches_reference():
    """θ to rtol 1e-5 / atol 1e-6 (a 6 × 6 solve); ledger exactly, K·(n² + n)
    numbers up and n down (tests/test_linear.py:33-35)."""
    Xs, ys, _ = shards(noise=0.05)
    tt, lt = tl.private_second_order(Xs, ys, device="cpu")
    tj, lj = jl.private_second_order(jnp.asarray(Xs), jnp.asarray(ys))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=RTOL, atol=ATOL)
    assert_ledgers_equal(lj, lt)
    assert lt.uplink_bytes == 4 * (6 * 6 + 6) * 4 and lt.downlink_bytes == 6 * 4
    ols = np.linalg.lstsq(Xs.reshape(-1, 6), ys.reshape(-1), rcond=None)[0]
    np.testing.assert_allclose(tt.numpy(), ols, atol=1e-4)
    t2, _ = tl.private_second_order(Xs, ys, l2=0.5, device="cpu")
    j2, _ = jl.private_second_order(jnp.asarray(Xs), jnp.asarray(ys), l2=0.5)
    np.testing.assert_allclose(t2.numpy(), np.asarray(j2), rtol=RTOL, atol=ATOL)
    assert torch.get_float32_matmul_precision() == "highest"  # restored as found


def test_entry_points_need_a_gpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    Xs, ys, _ = shards()
    for call in (lambda: tl.private_second_order(Xs, ys),
                 lambda: tl.ista_lasso(Xs[0], ys[0], 0.1, iters=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


# ----------------------------------------------------------------------------
# examples/healthcare_federated.py, through both packages
# ----------------------------------------------------------------------------


def healthcare_data():
    """The example's clinics (rng seed 7), zero-padded to one shape, f32."""
    Kc, dim = 6, 12
    rng = np.random.default_rng(7)
    sizes = [30, 45, 60, 80, 120, 200]
    w_true = rng.normal(size=dim) * (rng.uniform(size=dim) > 0.5)
    Xs_list, ys_list = [], []
    for k in range(Kc):
        X = rng.normal(size=(sizes[k], dim)) + 0.3 * rng.normal(size=dim)
        Xs_list.append(X)
        ys_list.append(X @ w_true + 0.1 * rng.normal(size=sizes[k]))
    pad = max(sizes)
    Xp = np.stack([np.pad(x, ((0, pad - len(x)), (0, 0))) for x in Xs_list]).astype(np.float32)
    yp = np.stack([np.pad(y, (0, pad - len(y))) for y in ys_list]).astype(np.float32)
    return Xp, yp, sizes, w_true


def test_healthcare_part1_private_regression():
    Xp, yp, _, w_true = healthcare_data()
    tt, lt = tl.private_second_order(Xp, yp, device="cpu")
    tj, lj = jl.private_second_order(jnp.asarray(Xp), jnp.asarray(yp))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=RTOL, atol=ATOL)
    assert_ledgers_equal(lj, lt)
    assert np.linalg.norm(tt.numpy() - w_true) < 0.05


def test_healthcare_part2_consensus_lasso():
    """150 ADMM iterations, z to rtol 1e-5 / atol 1e-6, zeros exact."""
    Xp, yp, _, _ = healthcare_data()
    rt = tapi.fit(tapi.ProxStrategy(tl.lasso_prox_builder), (Xp, yp),
                  transport="admm_consensus", steps=150, g="l1", g_lam=3.0, device="cpu")
    rj = japi.fit(japi.ProxStrategy(jl.lasso_prox_builder), (jnp.asarray(Xp), jnp.asarray(yp)),
                  transport="admm_consensus", steps=150, g="l1", g_lam=3.0)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(rt.theta.numpy() == 0, np.asarray(rj.theta) == 0)
    assert_ledgers_equal(rj.ledger, rt.ledger)


def test_healthcare_part3_asynchronous_server():
    """The §5 server over JAX's asynchronous schedule (handed over as an
    array): θ to rtol 1e-5 / atol 1e-6, ledgers exactly."""
    Xp, yp, sizes, w_true = healthcare_data()
    Kc, lr = len(sizes), 0.1
    probs = j_sched.work_proportional_probs(jnp.asarray(sizes, jnp.float32))
    sched = np.asarray(j_sched.asynchronous(jax.random.key(1), Kc, 400, probs=probs))
    from repro_torch.core import schedules as t_sched

    np.testing.assert_allclose(t_sched.work_proportional_probs(sizes).numpy(),
                               np.asarray(probs), rtol=1e-6)
    Xj, yj, nj = jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(sizes)
    Xt, yt, nt = T(Xp), T(yp), torch.tensor(sizes)

    def Fj(k, theta):
        g = Xj[k].T @ (Xj[k] @ theta - yj[k]) / nj[k]
        return theta - lr * g

    def Ft(k, theta):
        g = Xt[k].T @ (Xt[k] @ theta - yt[k]) / nt[k]
        return theta - lr * g

    rj = japi.fit(japi.FunctionStrategy(Fj, num_nodes=Kc), transport="sequential_server",
                  schedule=jnp.asarray(sched), theta0=jnp.zeros(12))
    rt = tapi.fit(tapi.FunctionStrategy(Ft, num_nodes=Kc), transport="sequential_server",
                  schedule=sched, theta0=np.zeros(12, np.float32), device="cpu")
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
    assert_ledgers_equal(rj.ledger, rt.ledger)
    assert np.linalg.norm(rt.theta.numpy() - w_true) < 0.5
