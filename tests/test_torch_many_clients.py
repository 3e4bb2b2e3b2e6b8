"""Port parity at phone-scale client counts: ``repro_torch.api.fit`` and
``repro.api.fit`` on the same numpy inputs with more node rows than a CUDA
grid holds on its y axis (65,535).

The wire kernels once refused such stacks on the card; on the CPU the port
runs the kernels' plain versions (``use_kernel=True``) or the reference
row formulas (``"auto"``), each one call a leaf for all K nodes.  θ and the
trajectory are held at ``tests/test_torch_fit.py``'s rtol 1e-5 / atol 1e-6
(two libraries, two summation orders), a sweep's scenarios at
``tests/test_torch_executors.py``'s rtol 1e-6 / atol 1e-7; ledgers exactly.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.ml.linear import logistic_loss as j_logistic  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.ml.linear import logistic_loss as t_logistic  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # port ≡ reference (tests/test_torch_fit.py)
S_RTOL, S_ATOL = 1e-6, 1e-7  # sweep ≡ solo (tests/test_torch_executors.py)
D = 256  # the θ leaf is kernel-eligible
WIRES = {"topk:0.01+ef": lambda u: tapi.TopKWire(0.01, error_feedback=True, use_kernel=u),
         "int8+ef": lambda u: tapi.Int8Wire(error_feedback=True, use_kernel=u)}


def problem(K: int, seed: int = 0):
    """K clients of one record each, labels of a planted w."""
    rng = np.random.default_rng(seed)
    Xs = (rng.normal(size=(K, 1, D)) / np.sqrt(D)).astype(np.float32)
    w = rng.normal(size=(D,)).astype(np.float32)
    ys = np.where(np.einsum("kni,i->kn", Xs, w) >= 0, 1.0, -1.0).astype(np.float32)
    return Xs, ys


def close(got, want, rtol, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@lru_cache(maxsize=None)
def reference_fit(wire: str, K: int):
    """The JAX package's allreduce fit of ``problem(K)``, 2 rounds (each
    wire's run shared by the port's two paths)."""
    Xs, ys = problem(K)
    return japi.fit(japi.GradientDescent(j_logistic, lr=1.0),
                    (jnp.asarray(Xs), jnp.asarray(ys)), wire=wire,
                    transport="allreduce", steps=2)


@pytest.mark.parametrize("use_kernel", ["auto", True], ids=["rows", "kernel-plain"])
@pytest.mark.parametrize("wire", list(WIRES))
def test_fit_with_65536_clients_matches_reference(wire, use_kernel):
    """allreduce × a compressed wire over 65,536 clients, 2 rounds."""
    Xs, ys = problem(65536)
    kw = dict(transport="allreduce", steps=2)
    rj = reference_fit(wire, 65536)
    rt = tapi.fit(tapi.GradientDescent(t_logistic, lr=1.0), (Xs, ys),
                  wire=WIRES[wire](use_kernel), device="cpu", **kw)
    close(rt.theta, rj.theta, RTOL, ATOL)
    close(rt.trajectory, rj.trajectory, RTOL, ATOL)
    assert rt.ledger.summary() == rj.ledger.summary()
    assert rt.ledger.events == rj.ledger.events
    assert rt.ledger.uplink_bytes == 2 * 65536 * (
        max(1, round(0.01 * D)) * 8 if wire.startswith("topk") else D + 4)


@pytest.mark.parametrize("wire", list(WIRES))
def test_lr_sweep_over_65600_folded_rows_matches_reference(wire):
    """Two learning rates over 32,800 clients (65,600 rows once the
    scenarios fold into one encode call), one round (the reference's top-k
    takes about 3 s a round at this size on the CPU): each scenario
    against the JAX package's sweep and against the port's solo fit."""
    Xs, ys = problem(32800, seed=1)
    lrs = [0.5, 1.0]
    kw = dict(transport="allreduce", steps=1, executor="sweep")
    rj = japi.fit(japi.GradientDescent(j_logistic, lr=1.0),
                  (jnp.asarray(Xs), jnp.asarray(ys)), wire=wire,
                  sweep={"lr": jnp.asarray(lrs)}, **kw)
    rt = tapi.fit(tapi.GradientDescent(t_logistic, lr=1.0), (Xs, ys),
                  wire=WIRES[wire](True), device="cpu", sweep={"lr": lrs}, **kw)
    assert np.asarray(rt.theta).shape == (2, D) and len(rt.ledger) == 2
    for i, lr in enumerate(lrs):
        solo = tapi.fit(tapi.GradientDescent(t_logistic, lr=lr), (Xs, ys),
                        wire=WIRES[wire](True), device="cpu", transport="allreduce", steps=1)
        close(rt.theta[i], rj.theta[i], RTOL, ATOL)
        close(rt.trajectory[i], rj.trajectory[i], RTOL, ATOL)
        close(rt.theta[i], solo.theta, S_RTOL, S_ATOL)
        close(rt.trajectory[i], solo.trajectory, S_RTOL, S_ATOL)
        assert rt.ledger[i].summary() == rj.ledger[i].summary() == solo.ledger.summary()
