"""Port parity: ``repro_torch.api.fit(device="cpu")`` against
``repro.api.fit`` on the same numpy inputs.

θ and the trajectory agree to rtol 1e-5 / atol 1e-6: the node-gradient
sums and the aggregate run in another order in the two packages, so they
round differently in the last bits (and XLA contracts the int8 EF residual
into an FMA).  The ledger — bytes, rounds, events — and ``wire_kernel_hits``
are equal exactly.  Also: a JAX fit resumed in the port through
``convert.carry_from_reference``, and the default device refusing to run
without a GPU.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import schedules as j_sched  # noqa: E402
from repro.ml.linear import logistic_loss as j_logistic  # noqa: E402
from repro.ml.linear import lsq_loss as j_lsq  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.convert import carry_from_reference, theta_from_reference  # noqa: E402
from repro_torch.ml.linear import logistic_loss as t_logistic  # noqa: E402
from repro_torch.ml.linear import lsq_loss as t_lsq  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
K, N, D = 4, 24, 300  # the (300,) θ leaf is kernel-eligible


def problem(seed=0, task="regression"):
    rng = np.random.default_rng(seed)
    Xs = (rng.normal(size=(K, N, D)) / np.sqrt(D)).astype(np.float32)
    w = rng.normal(size=(D,)).astype(np.float32)
    ys = np.einsum("kni,i->kn", Xs, w).astype(np.float32)
    if task == "classification":
        ys = np.where(ys >= 0, 1.0, -1.0).astype(np.float32)
    return Xs, ys


def run_both(wire, transport="allreduce", loss="lsq", steps=6, lr=0.5,
             faults=None, **kw):
    """Fit both packages; ``wire`` is a spec string or a (JAX wire, port
    wire) pair."""
    j_wire, t_wire = (wire, wire) if isinstance(wire, str) else wire
    Xs, ys = problem(task="classification" if loss == "logistic" else "regression")
    jl, tl = (j_lsq, t_lsq) if loss == "lsq" else (j_logistic, t_logistic)
    j_faults = t_faults = None
    if faults is not None:
        j_faults = japi.FaultPlan(seed=11, **faults)
        t_faults = tapi.FaultPlan(seed=11, **faults)
    if "schedule" not in kw:
        kw["steps"] = steps
    j_kw = dict(kw)
    if "schedule" in kw:
        j_kw["schedule"] = jnp.asarray(kw["schedule"])
    rj = japi.fit(japi.GradientDescent(jl, lr=lr), (jnp.asarray(Xs), jnp.asarray(ys)),
                  transport=transport, wire=j_wire, faults=j_faults, **j_kw)
    rt = tapi.fit(tapi.GradientDescent(tl, lr=lr), (Xs, ys), transport=transport,
                  wire=t_wire, faults=t_faults, device="cpu", **kw)
    return rj, rt


def assert_fit_close(rj, rt):
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.trajectory.numpy(), np.asarray(rj.trajectory),
                               rtol=RTOL, atol=ATOL)
    assert rt.ledger.summary() == rj.ledger.summary()
    assert rt.ledger.events == rj.ledger.events
    np.testing.assert_array_equal(rt.metrics["uplink_bytes_per_round"],
                                  rj.metrics["uplink_bytes_per_round"])
    np.testing.assert_array_equal(rt.metrics["downlink_bytes_per_round"],
                                  rj.metrics["downlink_bytes_per_round"])
    assert rt.metrics.get("wire_kernel_hits") == rj.metrics.get("wire_kernel_hits")
    np.testing.assert_allclose(float(rt.metrics["loss"]), float(rj.metrics["loss"]),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("wire", [
    "dense", "thresh:0.05+ef", "topk:0.1", "topk:0.1+ef", "int8", "int8+ef",
])
def test_allreduce_matches_reference(wire):
    rj, rt = run_both(wire, steps=6)
    assert_fit_close(rj, rt)
    got = json.loads(json.dumps(rt.metrics_json()))
    assert got["uplink_bytes_per_round"] == rj.metrics_json()["uplink_bytes_per_round"]
    assert "carry" not in got


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("wire_cls", ["TopKWire", "Int8Wire"])
def test_forced_kernel_knob_matches_reference(wire_cls, use_kernel):
    """``use_kernel=True`` on CPU runs the kernels' plain versions (the JAX
    side its interpret-mode Pallas kernels); the report says so."""
    from repro.api import wire as j_wire

    args = (0.1,) if wire_cls == "TopKWire" else ()
    wires = tuple(
        getattr(mod, wire_cls)(*args, error_feedback=True, use_kernel=use_kernel)
        for mod in (j_wire, tapi)
    )
    rj, rt = run_both(wires, loss="logistic")
    assert_fit_close(rj, rt)
    assert rt.metrics["wire_kernel_hits"]["active"] is use_kernel


def test_delay_line_matches_reference():
    assert_fit_close(*run_both("topk:0.1+ef", transport="delay_line", staleness=2,
                               loss="logistic", steps=8))


@pytest.mark.parametrize("transport", ["sequential_server", "stale_server"])
@pytest.mark.parametrize("wire", ["dense", "topk:0.25+ef"])
def test_server_transports_match_reference(transport, wire):
    # a given schedule (asynchronous contacts), so both packages walk it
    sched = np.asarray(j_sched.asynchronous(jax.random.key(3), K, 10))
    assert_fit_close(*run_both(wire, transport=transport, schedule=sched, lr=0.3))


def test_fault_plan_matches_reference():
    """Dropout + a straggler + a quorum gate on the delay line: masked
    rows, rolled-back rounds and survivor-only bytes as the reference."""
    rj, rt = run_both("topk:0.1+ef", transport="delay_line", staleness=1, steps=10,
                      faults={"dropout_p": 0.4, "straggler": 1, "quorum": 2})
    assert_fit_close(rj, rt)
    assert rt.metrics["faults"] == rj.metrics["faults"]


@pytest.mark.parametrize("wire", ["dense", "topk:0.25"])
def test_server_dropout_matches_reference(wire):
    sched = np.asarray(j_sched.round_robin(K, 3))
    assert_fit_close(*run_both(wire, transport="sequential_server",
                               schedule=sched, faults={"dropout_p": 0.5}))


def test_server_dead_contact_keeps_wire_state():
    """A dropped contact leaves its node's EF residual as it was (the
    documented fault semantics).  The JAX local executor commits the
    discarded push's residual anyway (ROADMAP.md queue 3), so against it
    only the other rows — and, within one pass, θ — agree."""
    sched = np.asarray(j_sched.round_robin(K, 1))
    rj, rt = run_both("topk:0.25+ef", transport="sequential_server", schedule=sched,
                      faults={"dropout_p": 0.5})
    alive = japi.FaultPlan(seed=11, dropout_p=0.5).draws(0, K, K).u[
        np.arange(K), sched] >= 0.5
    assert not alive.all() and alive.any()
    res_t = rt.metrics["carry"].inner[2].numpy()
    res_j = np.asarray(rj.metrics["carry"].inner[2])
    assert not res_t[~alive].any()
    np.testing.assert_allclose(res_t[alive], res_j[alive], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
    assert rt.ledger.summary() == rj.ledger.summary()


def test_function_strategy_server():
    shifts = np.random.default_rng(4).normal(size=(K, 5)).astype(np.float32)
    sched = np.asarray(j_sched.round_robin(K, 3))
    rj = japi.fit(japi.FunctionStrategy(lambda k, th: 0.5 * th + jnp.asarray(shifts)[k],
                                        num_nodes=K, metric=jnp.sum),
                  transport="sequential_server", schedule=jnp.asarray(sched),
                  theta0=jnp.zeros(5))
    rt = tapi.fit(tapi.FunctionStrategy(lambda k, th: 0.5 * th + torch.from_numpy(shifts)[k],
                                        num_nodes=K, metric=torch.sum),
                  transport="sequential_server", schedule=sched,
                  theta0=torch.zeros(5), device="cpu")
    np.testing.assert_allclose(rt.trajectory.numpy(), np.asarray(rj.trajectory), rtol=RTOL)
    assert rt.ledger.summary() == rj.ledger.summary()
    np.testing.assert_allclose(float(rt.metrics["final_metric"]),
                               float(rj.metrics["final_metric"]), rtol=RTOL)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("case", ["allreduce-topk-ef", "delay-line", "server", "faults"])
def test_resume_jax_carry_in_port(case):
    """3 JAX rounds → ``carry_from_reference`` → 3 port rounds equals 6
    JAX rounds (θ, trajectory tail, ledger of the resumed part)."""
    Xs, ys = problem(1)
    jd, kw, j_kw = (jnp.asarray(Xs), jnp.asarray(ys)), {}, {}
    if case == "allreduce-topk-ef":
        kw = dict(transport="allreduce", wire="topk:0.1+ef")
    elif case == "delay-line":
        kw = dict(transport="delay_line", staleness=2, wire="int8+ef")
    elif case == "faults":
        kw = dict(transport="delay_line", staleness=1, wire="topk:0.1+ef")
        j_kw = dict(faults=japi.FaultPlan(seed=5, dropout_p=0.3, straggler=1))
    sched = np.asarray(j_sched.round_robin(K, 3))
    half = {"schedule": sched[:6]} if case == "server" else {"steps": 3}
    rest = {"schedule": sched[6:]} if case == "server" else {"steps": 3}
    full = {"schedule": sched} if case == "server" else {"steps": 6}
    if case == "server":
        kw = dict(transport="sequential_server", wire="topk:0.25+ef")
    st = japi.GradientDescent(j_lsq, lr=0.5)
    j_half = japi.fit(st, jd, **kw, **j_kw, **{k: jnp.asarray(v) if k == "schedule" else v
                                                 for k, v in half.items()})
    j_full = japi.fit(st, jd, **kw, **j_kw, **{k: jnp.asarray(v) if k == "schedule" else v
                                                 for k, v in full.items()})
    t_faults = (tapi.FaultPlan(seed=5, dropout_p=0.3, straggler=1)
                if case == "faults" else None)
    t_rest = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.5), (Xs, ys), **kw, **rest,
                      faults=t_faults,
                      carry=carry_from_reference(np_tree(j_half.metrics["carry"]),
                                                 device="cpu"),
                      device="cpu")
    np.testing.assert_allclose(t_rest.theta.numpy(), np.asarray(j_full.theta),
                               rtol=RTOL, atol=ATOL)
    n = 6 if case == "server" else 3
    np.testing.assert_allclose(t_rest.trajectory.numpy(),
                               np.asarray(j_full.trajectory)[-n:], rtol=RTOL, atol=ATOL)
    assert (t_rest.ledger.uplink_bytes + j_half.ledger.uplink_bytes
            == j_full.ledger.uplink_bytes)


def test_theta_from_reference_bitwise():
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3), "b": np.float32(2.5)}
    out = theta_from_reference(tree, device="cpu")
    assert out["w"].dtype == torch.float32 and out["w"].shape == (2, 3)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    assert float(out["b"]) == 2.5


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    Xs, ys = problem()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.fit(tapi.GradientDescent(t_lsq), (Xs, ys), transport="allreduce", steps=1)
    from repro_torch.data.pipeline import make_feature_shards

    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_feature_shards(0, 2, 4, 3)


# What of the fit path is still to port: a tracer (item 12) on any fit,
# the admm_consensus transport's and a secagg wire's among them, and the
# serve executor (item 10).  The mesh, multipod and sweep executors and
# the train CLI's staleness sweep are ported (tests/test_torch_executors.py)
@pytest.mark.parametrize("call, item", [
    (lambda: tapi.fit(tapi.GradientDescent(t_lsq), None, tracer=object(), device="cpu"), 12),
    (lambda: tapi.fit(tapi.ProxStrategy(lambda d: None, dim=3), None,
                      transport="admm_consensus", steps=2, tracer=object(), device="cpu"), 12),
    (lambda: tapi.fit(tapi.GradientDescent(t_lsq), problem(), transport="allreduce",
                      steps=2, wire="secagg", tracer=object(), device="cpu"), 12),
    (lambda: tapi.fit(tapi.GradientDescent(t_lsq), problem(), transport="allreduce",
                      steps=2, executor="serve", device="cpu"), 10),
], ids=["tracer", "admm", "secagg-tracer", "serve"])
def test_out_of_slice_raises_naming_roadmap(call, item):
    with pytest.raises(NotImplementedError, match=rf"ROADMAP\.md queue 1, item {item}\b"):
        call()
