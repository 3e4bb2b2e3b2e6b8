"""Port parity: the security wires — ``dp:<clip>,<sigma>``, ``secagg`` and
``>``-chains — of ``repro_torch.api.wire`` against the JAX package, the
port on the CPU.

* Fits with σ = 0 (``dp:c,0`` alone and chained before a top-k) and the
  chains ending in ``secagg`` agree with JAX's to rtol 1e-5 / atol 1e-6
  (``tests/test_torch_fit.py:35``: the node sums round in another order),
  with ledgers — bytes, rounds, events — equal exactly, under
  ``FaultPlan(seed=11, dropout_p=0.3)`` too (the fault draws are numpy's,
  bit for bit).
* ``secagg`` fits are bitwise the port's dense fits.
* σ > 0 draws from the port's own stream (``wire._stream_seed`` over seed,
  round counter, global node index, leaf), not ``jax.random``'s, so the
  noise and the masks are held to the statistics of the reference's own
  tests (``tests/test_faults.py`` ``TestDPWire`` / ``TestSecAggWire`` /
  ``TestChainWire``, ``tests/test_property.py:225-266``) at their bounds.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.api.wire import make_wire as j_make_wire  # noqa: E402
from repro.ml.linear import lsq_loss as j_lsq  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.api import wire as twire  # noqa: E402
from repro_torch.api.wire import make_wire  # noqa: E402
from repro_torch.core.schedules import round_robin  # noqa: E402
from repro_torch.ml.linear import lsq_loss as t_lsq  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_fit.py:35
K, N, D = 4, 24, 300  # the (300,) θ leaf is kernel-eligible


def problem(seed=0):
    rng = np.random.default_rng(seed)
    Xs = (rng.normal(size=(K, N, D)) / np.sqrt(D)).astype(np.float32)
    w = rng.normal(size=(D,)).astype(np.float32)
    return Xs, np.einsum("kni,i->kn", Xs, w).astype(np.float32)


def fit_both(wire, transport="allreduce", steps=6, faults=None, **kw):
    Xs, ys = problem()
    jf = tf = None
    if faults is not None:
        jf, tf = japi.FaultPlan(seed=11, **faults), tapi.FaultPlan(seed=11, **faults)
    j_kw = dict(kw)
    if "schedule" in kw:
        j_kw["schedule"] = jnp.asarray(np.asarray(kw["schedule"]))
    rj = japi.fit(japi.GradientDescent(j_lsq, lr=0.5), (jnp.asarray(Xs), jnp.asarray(ys)),
                  transport=transport, wire=wire, steps=steps, faults=jf, **j_kw)
    rt = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.5), (Xs, ys), transport=transport,
                  wire=wire, steps=steps, faults=tf, device="cpu", **kw)
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
    assert rt.metrics["wire"] == rj.metrics["wire"]


def msgs_of(Kn, n, seed, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).normal(size=(Kn, n)) * scale).astype(np.float32))


# ----------------------------------------------------------------------------
# Fits against JAX
# ----------------------------------------------------------------------------


# "dp:0.01,0.0" clips every node's message (their norms are ≈ 0.03)
@pytest.mark.parametrize("wire", [
    "dp:1.0,0.0", "dp:0.01,0.0", "dp:0.05,0.0>topk:0.1+ef", "topk:0.1+ef>secagg",
    "int8+ef>secagg", "topk:0.1>secagg", "secagg", "dp:0.05,0.0>int8",
])
def test_fit_matches_reference(wire):
    assert_fit_close(*fit_both(wire))


@pytest.mark.parametrize("wire", ["dp:0.05,0.0>topk:0.1+ef", "topk:0.1+ef>secagg",
                                  "dp:0.01,0.0"])
def test_fit_under_dropout_matches_reference(wire):
    assert_fit_close(*fit_both(wire, faults=dict(dropout_p=0.3)))


def test_fit_delay_line_chain_matches_reference():
    assert_fit_close(*fit_both("dp:0.05,0.0>topk:0.1", transport="delay_line", staleness=2))


def test_server_transport_dp_matches_reference():
    assert_fit_close(*fit_both("dp:0.01,0.0", transport="sequential_server", steps=None,
                               schedule=round_robin(K, 3)))


@pytest.mark.parametrize("wire", ["secagg", "topk:0.1+ef>secagg", "int8+ef>secagg"])
def test_secagg_fit_bitwise_port_dense(wire):
    Xs, ys = problem()
    base = wire.rsplit(">", 1)[0] if ">" in wire else "dense"
    a = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.5), (Xs, ys), transport="delay_line",
                 staleness=1, steps=8, wire=base, device="cpu")
    b = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.5), (Xs, ys), transport="delay_line",
                 staleness=1, steps=8, wire=wire, device="cpu")
    assert torch.equal(a.theta, b.theta) and torch.equal(a.trajectory, b.trajectory)
    assert a.ledger.summary() == b.ledger.summary()


def test_chain_ledger_under_dropout_counts_survivors():
    plan = tapi.FaultPlan(seed=11, dropout_p=0.3)
    Xs, ys = problem()
    res = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (Xs, ys), transport="allreduce",
                   steps=15, wire="dp:1.0,0.1>topk:0.5+ef", faults=plan, device="cpu")
    again = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (Xs, ys), transport="allreduce",
                     steps=15, wire="dp:1.0,0.1>topk:0.5+ef", faults=plan, device="cpu")
    assert torch.equal(res.theta, again.theta)
    live = (plan.draws(0, 15, K).u >= plan.dropout_p).sum(axis=1)
    up_each = make_wire("dp:1.0,0.1>topk:0.5+ef").push_bytes(torch.zeros((D,)))
    assert res.ledger.uplink_bytes == int(live.sum()) * up_each


def test_chain_reports_no_kernel_hits():
    Xs, ys = problem()
    res = tapi.fit(tapi.GradientDescent(t_lsq), (Xs, ys), transport="allreduce", steps=1,
                   wire="dp:1.0,0.0>topk:0.1+ef", device="cpu")
    assert "wire_kernel_hits" not in res.metrics


# ----------------------------------------------------------------------------
# Parsing, metering, guard rails (as TestDPWire / TestSecAggWire / TestChainWire)
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["dp:1.5,0.25", "secagg", "dp:1.0,0.5>topk:0.5+ef",
                                  "topk:0.5+ef>secagg", "int8>secagg",
                                  "dp:1.0,0.0>thresh:0.1"])
def test_spec_matches_reference(spec):
    wt, wj = make_wire(spec), j_make_wire(spec)
    assert (type(wt).__name__, wt.name, wt.lossless, wt.preserves_bytes) == (
        type(wj).__name__, wj.name, wj.lossless, wj.preserves_bytes)
    for n in (12, 300):
        assert wt.push_bytes(torch.zeros((n,))) == wj.push_bytes(jnp.zeros((n,)))
    if hasattr(wj, "stages"):
        assert [type(s).__name__ for s in wt.stages] == [type(s).__name__ for s in wj.stages]


@pytest.mark.parametrize("spec, err, match", [
    ("dp:0,0.5", ValueError, "dp clip"),
    ("dp:1.0,-0.5", ValueError, "dp sigma"),
    ("dp:1.0,0.5+ef", ValueError, "chain"),
    ("dp:1.0", ValueError, "dp:<clip>,<sigma>"),
    ("secagg+ef", ValueError, "secagg"),
    ("bogus", ValueError, "unknown wire spec"),
])
def test_spec_guard_rails(spec, err, match):
    for mk in (make_wire, j_make_wire):
        with pytest.raises(err, match=match):
            mk(spec)


def test_chain_guard_rails():
    with pytest.raises(ValueError, match="at least two"):
        tapi.ChainWire([make_wire("dense")])
    with pytest.raises(ValueError, match="nest"):
        tapi.ChainWire([make_wire("dense"), make_wire("dp:1.0,0.1>secagg")])
    theta = torch.zeros((12,))
    wi = make_wire("dp:1.0,0.5>topk:0.5+ef")
    assert wi.push_bytes(theta) == make_wire("topk:0.5+ef").push_bytes(theta)
    tail = make_wire("topk:0.5+ef>secagg")
    assert tail.push_bytes(theta) == wi.push_bytes(theta) and tail.preserves_bytes is False
    assert make_wire("dp:1.0,0.0>thresh:0.1").push_bytes(theta) is None


def test_secagg_server_transport_rejected():
    Xs, ys = problem()
    with pytest.raises(NotImplementedError, match="aggregate"):
        tapi.fit(tapi.GradientDescent(t_lsq), (Xs, ys), transport="sequential_server",
                 schedule=round_robin(K, 8), wire="secagg", device="cpu")


# ----------------------------------------------------------------------------
# DP statistics (TestDPWire's bounds)
# ----------------------------------------------------------------------------


def test_dp_clip_enforced_exactly():
    wi = make_wire("dp:1.0,0.0")
    msgs = msgs_of(4, 64, 0, scale=10.0)
    _, hat, nb = wi.encode_updates(wi.init_state(msgs[0], 4), msgs)
    np.testing.assert_allclose(torch.linalg.norm(hat, dim=1).numpy(), 1.0, rtol=1e-5)
    assert int(nb) == msgs.numel() * 4  # dense payload


def test_dp_small_updates_pass_unclipped():
    wi = make_wire("dp:100.0,0.0")
    msgs = msgs_of(4, 16, 0)
    _, hat, _ = wi.encode_updates(wi.init_state(msgs[0], 4), msgs)
    np.testing.assert_allclose(hat.numpy(), msgs.numpy(), rtol=1e-5, atol=1e-6)


def test_dp_privatize_matches_reference_at_zero_sigma():
    """σ = 0: the clip alone, per node, against JAX (tree of two leaves)."""
    rng = np.random.default_rng(3)
    tree = {"a": rng.normal(size=(5, 40)).astype(np.float32) * 3,
            "b": rng.normal(size=(5, 7)).astype(np.float32)}
    wt, wj = make_wire("dp:2.0,0.0"), j_make_wire("dp:2.0,0.0")
    st, hat, nb = wt.encode_updates(wt.init_state(None, 5),
                                    {k: torch.from_numpy(v) for k, v in tree.items()})
    sj, hj, nj = wj.encode_updates(wj.init_state(None, 5),
                                   {k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_allclose(hat[k].numpy(), np.asarray(hj[k]), rtol=RTOL, atol=ATOL)
    assert float(nb) == float(nj)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


def test_dp_noise_scale_statistical():
    # zero message → the output is the noise; 8 × 4096 draws within 5 %
    wi = make_wire("dp:2.0,0.5")
    msgs = torch.zeros((8, 4096))
    _, hat, _ = wi.encode_updates(wi.init_state(msgs[0], 8), msgs)
    flat = hat.numpy().ravel()
    assert abs(flat.mean()) < 0.05
    np.testing.assert_allclose(flat.std(), 0.5 * 2.0, rtol=0.05)


def test_dp_noise_seeded_and_counter_advanced():
    wi = make_wire("dp:1.0,0.5")
    msgs = torch.zeros((4, 32))
    st = wi.init_state(msgs[0], 4)
    st1, a, _ = wi.encode_updates(st, msgs)
    _, a2, _ = wi.encode_updates(st, msgs)
    assert torch.equal(a, a2)
    _, b, _ = wi.encode_updates(st1, msgs)
    assert not torch.equal(a, b)  # counters advanced → a fresh slice
    assert not torch.equal(a[0], a[1])  # per-node streams differ
    assert st.device.type == "cpu" and st.dtype == torch.int32
    assert st1.tolist() == [1, 1, 1, 1]


def test_dp_stream_is_a_function_of_its_words():
    """Node k's draw depends on (seed, counter, global index, leaf) only: the
    same row alone (one live node) equals its row in the stacked encode."""
    wi = twire.DPWire(1.0, 0.5, seed=7)
    msgs = torch.zeros((3, 10))
    cnt = torch.tensor([4, 9, 2], dtype=torch.int32)
    _, hat, _ = wi.encode_updates(cnt, msgs)
    for k in range(3):
        want = 0.5 * 1.0 * twire._normal((10,), torch.device("cpu"), 7, int(cnt[k]), k, 0)
        assert torch.equal(hat[k], want)
    assert len({twire._stream_seed(7, c, k, 0) for c in range(4) for k in range(4)}) == 16


def test_dp_under_dropout_freezes_dead_counters():
    Xs, ys = problem()
    plan = tapi.FaultPlan(seed=11, dropout_p=0.4)
    res = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (Xs, ys), transport="allreduce",
                   steps=15, wire="dp:1.0,0.05", faults=plan, device="cpu")
    again = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (Xs, ys), transport="allreduce",
                     steps=15, wire="dp:1.0,0.05", faults=plan, device="cpu")
    assert torch.equal(res.theta, again.theta)
    live = (plan.draws(0, 15, K).u >= plan.dropout_p).sum(axis=0)
    assert res.metrics["carry"].inner[2].tolist() == live.tolist()


def test_dp_fit_end_to_end():
    Xs, ys = problem()
    res = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (Xs, ys), transport="allreduce",
                   steps=20, wire="dp:1.0,0.01", device="cpu")
    assert bool(torch.isfinite(res.theta).all())


# ----------------------------------------------------------------------------
# secagg statistics (TestSecAggWire's and test_property.py's bounds)
# ----------------------------------------------------------------------------


def check_secagg(Kn, n, seed, rtol_atol):
    wi = make_wire("secagg")
    msgs = msgs_of(Kn, n, seed)
    pay = wi.uplink_payloads(wi.init_state(msgs[0], Kn), msgs).numpy()
    raw = msgs.numpy()
    for k in range(Kn):
        assert not np.allclose(pay[k], raw[k], atol=1e-3)
    np.testing.assert_allclose(pay.sum(axis=0), raw.sum(axis=0),
                               rtol=rtol_atol, atol=rtol_atol)


def test_secagg_payloads_masked_but_sum_recovers_aggregate():
    check_secagg(4, 32, 0, 1e-4)  # tests/test_faults.py: rtol = atol = 1e-4


@pytest.mark.parametrize("Kn, n, seed", [(2, 4, 0), (3, 17, 5), (6, 64, 999), (5, 33, 42)])
def test_secagg_masks_cancel_in_the_sum(Kn, n, seed):
    check_secagg(Kn, n, seed, 1e-3)  # tests/test_property.py:241: rtol = atol = 1e-3


def test_secagg_single_stream_and_counters():
    wi = make_wire("secagg")
    m = msgs_of(1, 8, 1)[0]
    st = wi.init_state(m, 1, stacked=False)
    assert torch.equal(wi.uplink_payloads(st, m, stacked=False), m)  # no pair to mask
    st1, out, nb = wi.encode_updates(st, m, stacked=False)
    assert torch.equal(out, m) and int(st1) == 1 and float(nb) == 32.0


def test_property_dp_clip_and_secagg_with_hypothesis():
    """The reference's two hypothesis properties (tests/test_property.py:225-266)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    @hyp.settings(max_examples=15, deadline=None)
    @hyp.given(clip=st.floats(0.1, 5.0), Kn=st.integers(2, 6), n=st.integers(4, 64),
               seed=st.integers(0, 1000))
    def dp_clip_bounds_every_node(clip, Kn, n, seed):
        wi = make_wire(f"dp:{clip},0.0")
        msgs = msgs_of(Kn, n, seed)
        _, hat, _ = wi.encode_updates(wi.init_state(msgs[0], Kn), msgs)
        want = np.minimum(np.linalg.norm(msgs.numpy(), axis=1), clip)
        np.testing.assert_allclose(np.linalg.norm(hat.numpy(), axis=1), want, rtol=1e-4)

    @hyp.settings(max_examples=15, deadline=None)
    @hyp.given(Kn=st.integers(2, 6), n=st.integers(4, 64), seed=st.integers(0, 1000))
    def secagg_masks_cancel(Kn, n, seed):
        check_secagg(Kn, n, seed, 1e-3)

    dp_clip_bounds_every_node()
    secagg_masks_cancel()
