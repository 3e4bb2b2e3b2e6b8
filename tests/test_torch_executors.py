"""Port parity: the executors beyond local — ``mesh`` and ``multipod`` on
``torch.distributed`` (8 gloo ranks on the CPU), ``sweep`` (S scenarios
under ``torch.func.vmap``) and their compositions — against the JAX
package's LOCAL fits of the same numpy problem and against the port's own
local and solo fits.

Tolerances are the reference's own (``tests/test_executors.py``):
* mesh ≡ local for the update transports: θ and trajectory at rtol 1e-5 /
  atol 1e-6 (the reduction order differs), ledgers equal;
* the server transports on the mesh ≡ the port's local walk bitwise (the
  owner's push plus the other ranks' zeros), ≡ the JAX package's local walk
  at the port's standing parity tolerance (rtol 1e-5 / atol 1e-6): two
  libraries, two summation orders;
* multipod ≡ mesh on the same mesh bitwise, ``overlap`` and
  ``reduce_scatter`` on ≡ off bitwise;
* a sweep ≡ S solo fits (the port's and the JAX package's) at rtol 1e-6 /
  atol 1e-7, ledgers exact.  The reference also claims ``mesh+sweep`` θ ≡ S
  solo mesh fits bitwise; under ``vmap`` a node's matrix-vector products
  become matrix products and round differently, so
  ``test_mesh_sweep_matches_solo_mesh_fits`` measures the gap (≤ 2.4e-7)
  and holds it at the local sweep's tolerance (``ROADMAP.md`` queue 3,
  item 18).

The mesh runs go through ``repro_torch.launch.mesh.run_ranks``: two
launches of 8 ranks, each with its own timeout, running the programs of
``tests/torch_mesh_ranks.py``.  The JAX package's own mesh is not the
yardstick: six of its mesh tests fail on some hosts under jax 0.9.0
(``ROADMAP.md`` queue 3, item 6).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.core import schedules as j_sched  # noqa: E402
from repro.ml.linear import lsq_loss as j_lsq  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core.staleness import delay_init, delay_push_pop, delay_push_read  # noqa: E402
from repro_torch.kernels.int8_quant import ops as q8_ops  # noqa: E402
from repro_torch.kernels.topk_compress import ops as tk_ops  # noqa: E402
from repro_torch.kernels.topk_compress import ref as tk_ref  # noqa: E402
from repro_torch.launch.mesh import make_node_mesh, run_ranks  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.ml.linear import lsq_loss as t_lsq  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # mesh ≡ local (the reference's)
S_RTOL, S_ATOL = 1e-6, 1e-7  # sweep ≡ solo (the reference's)
RANK_TIMEOUT = 240  # seconds a launch of 8 ranks may take (~10-20 s measured)


def bitwise(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and (
        a.reshape(-1).view(np.uint8) == b.reshape(-1).view(np.uint8)).all()


def jdata(X, y):
    return jnp.asarray(X), jnp.asarray(y)


def j_gd(lr=0.1):
    return japi.GradientDescent(j_lsq, lr=lr)


def t_gd(lr=0.1):
    return tapi.GradientDescent(t_lsq, lr=lr)


def tfit(strategy, data, **kw):
    return tapi.fit(strategy, data, device="cpu", **kw)


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def mesh_runs():
    outs = run_ranks(ranks.mesh_program, 8, backend="gloo", timeout=RANK_TIMEOUT)
    return outs


@pytest.fixture(scope="module")
def multipod_runs():
    outs = run_ranks(ranks.multipod_program, 8, backend="gloo", timeout=RANK_TIMEOUT)
    return outs[0]


@pytest.fixture(scope="module")
def jax_local():
    """The JAX package's local fits of the rank programs' problems."""
    X, y = ranks.problem()
    out = {}
    for transport, kw in ranks.UPDATE_CASES:
        out[transport] = japi.fit(j_gd(), jdata(X, y), transport=transport, steps=40, **kw)
    sched = j_sched.round_robin(8, 5)
    for transport, wire in ranks.SERVER_CASES:
        out[f"{transport}/{wire}"] = japi.fit(j_gd(), jdata(X, y), transport=transport,
                                              schedule=sched, wire=wire)
    out["lbfgs"] = japi.fit(japi.LBFGS(j_lsq), jdata(X, y), transport="allreduce",
                            steps=15)
    out["topk"] = japi.fit(j_gd(), jdata(X, y), transport="allreduce",
                           wire="topk:0.5+ef", steps=25)
    return out


# ---------------------------------------------------------------------------
# mesh on 8 gloo ranks
# ---------------------------------------------------------------------------


def test_mesh_ranks_hold_one_replicated_result(mesh_runs):
    r0 = mesh_runs[0]
    assert r0["world"] == 8
    for r in mesh_runs[1:]:
        for key in ("mesh/allreduce", "mesh/delay_line", "mesh/lbfgs"):
            assert bitwise(r[key]["theta"], r0[key]["theta"]), key
            assert bitwise(r[key]["traj"], r0[key]["traj"]), key


@pytest.mark.parametrize("transport", [t for t, _ in ranks.UPDATE_CASES])
def test_mesh_update_transports_match_local(mesh_runs, jax_local, transport):
    r = mesh_runs[0]
    mesh, loc, ref = r[f"mesh/{transport}"], r[f"local/{transport}"], jax_local[transport]
    close(mesh["theta"], ref.theta)
    close(mesh["traj"], ref.trajectory)
    close(mesh["theta"], loc["theta"])
    close(mesh["traj"], loc["traj"])
    assert mesh["ledger"] == ref.ledger.summary() == loc["ledger"]


@pytest.mark.parametrize("transport, wire", ranks.SERVER_CASES,
                         ids=[f"{t}-{w}" for t, w in ranks.SERVER_CASES])
def test_mesh_server_transports_bitwise_local(mesh_runs, jax_local, transport, wire):
    r = mesh_runs[0]
    mesh, loc = r[f"mesh/{transport}/{wire}"], r[f"local/{transport}/{wire}"]
    assert bitwise(mesh["theta"], loc["theta"])
    assert bitwise(mesh["traj"], loc["traj"])
    ref = jax_local[f"{transport}/{wire}"]
    close(mesh["theta"], ref.theta)
    close(mesh["traj"], ref.trajectory)
    assert mesh["ledger"] == loc["ledger"] == ref.ledger.summary()


def test_mesh_lbfgs_mean_aggregate(mesh_runs, jax_local):
    """``aggregate_op="mean"`` completes as a staged sum divided once by the
    fan-in; held to local at the reference's own L-BFGS mesh tolerance."""
    r = mesh_runs[0]
    ref = jax_local["lbfgs"]
    close(r["mesh/lbfgs"]["theta"], ref.theta, rtol=1e-4, atol=1e-5)
    close(r["mesh/lbfgs"]["theta"], r["local/lbfgs"]["theta"], rtol=1e-4, atol=1e-5)
    assert r["mesh/lbfgs"]["ledger"] == ref.ledger.summary() == r["local/lbfgs"]["ledger"]


def test_mesh_compressed_wire_encodes_per_shard(mesh_runs, jax_local):
    r = mesh_runs[0]
    mesh = r["mesh/topk"]
    assert mesh["ledger"] == jax_local["topk"].ledger.summary()
    close(mesh["theta"], jax_local["topk"].theta)
    assert mesh["traj"][-1] < mesh["traj"][0]
    assert mesh["ledger"]["uplink_bytes"] < 25 * 8 * 5 * 4  # below the dense cost


def test_mesh_kwindows_server_bitwise_local(mesh_runs):
    """A server strategy that reads its data at the rank-local index and its
    pooled slots and generators at the global one (``node_global_index``)
    places bitwise.  (The JAX package draws its windows from ``jax.random``,
    so only the byte ledger compares across packages: ``test_torch_kwindows``
    holds the algorithm.)"""
    r = mesh_runs[0]
    mesh, loc = r["mesh/kwindows"], r["local/kwindows"]
    for f in loc["theta"]:
        assert bitwise(mesh["theta"][f], loc["theta"][f]), f
    assert mesh["ledger"] == loc["ledger"]
    X = ranks.kwindows_points()
    from repro.ml.kwindows import KWindowsStrategy

    ref = japi.fit(KWindowsStrategy(jax.random.PRNGKey(0), num_windows=3, r=1.0),
                   jnp.asarray(X), transport="sequential_server",
                   schedule=j_sched.round_robin(8, 1))
    assert mesh["ledger"] == ref.ledger.summary()


def test_mesh_cascade_svm_any_union(mesh_runs):
    """The cascade SVM on replicated data: each rank trains the nodes
    ``node_shard_index`` gives it, the ``any`` union completes across ranks,
    and the SV-only byte hooks total across ranks."""
    from repro.ml.svm import CascadeStrategy as JCascade

    r = mesh_runs[0]
    mesh, loc = r["mesh/cascade"], r["local/cascade"]
    Xs, ys = ranks.svm_problem()
    ref = japi.fit(JCascade(C=1.0, iters=60), jdata(Xs, ys), transport="allreduce", steps=3)
    np.testing.assert_array_equal(mesh["sv_mask"], np.asarray(ref.theta.sv_mask))
    np.testing.assert_array_equal(mesh["sv_mask"], loc["sv_mask"])
    np.testing.assert_array_equal(mesh["traj"], loc["traj"])
    close(mesh["alpha"], ref.theta.alpha)
    assert mesh["ledger"] == loc["ledger"] == ref.ledger.summary()


def test_mesh_carry_resumes_on_local(mesh_runs):
    r = mesh_runs[0]
    close(r["resume"]["theta"], r["resume"]["full"])


@pytest.mark.parametrize("knob", ["reduce_scatter", "overlap2", "overlap1"])
def test_mesh_knobs_on_off_bitwise(mesh_runs, knob):
    r = mesh_runs[0]
    on, off = r[f"{knob}/True"], r[f"{knob}/False"]
    assert bitwise(on["theta"], off["theta"])
    assert bitwise(on["traj"], off["traj"])
    assert on["ledger"] == off["ledger"]


def test_mesh_overlap_carry_resumes_without_overlap(mesh_runs):
    r = mesh_runs[0]
    # 15 overlapped + 15 synchronous rounds ≡ 30 synchronous ones
    assert bitwise(r["overlap_resume"], r["overlap2/False"]["theta"])


def test_mesh_uneven_placement_rejected(mesh_runs):
    assert "cannot be placed evenly" in mesh_runs[0]["uneven"]


# ---------------------------------------------------------------------------
# multipod and the compositions on 8 gloo ranks
# ---------------------------------------------------------------------------

_MP_CASES = [f"{t}/{w}" for t, _ in ranks.UPDATE_CASES for w in ("dense", "topk:0.5+ef")]


@pytest.mark.parametrize("case", _MP_CASES + ["222"])
def test_multipod_bitwise_with_flat_mesh(multipod_runs, case):
    m = multipod_runs
    assert m["mesh_shape"] == (2, 4)
    flat, hier = m[f"flat/{case}"], m[f"hier/{case}"]
    assert bitwise(flat["theta"], hier["theta"])
    assert bitwise(flat["traj"], hier["traj"])
    by_hop = hier["ledger"]["by_hop"]
    assert set(by_hop) == {"intra_pod", "inter_pod"}
    assert all(v["total_bytes"] > 0 for v in by_hop.values())
    assert sum(v["total_bytes"] for v in by_hop.values()) == flat["ledger"]["total_bytes"]
    assert flat["ledger"]["by_hop"] == {}


def test_multipod_matches_jax_local(multipod_runs, jax_local):
    hier = multipod_runs["hier/allreduce/dense"]
    close(hier["theta"], jax_local["allreduce"].theta)
    assert hier["ledger"]["total_bytes"] == jax_local["allreduce"].ledger.total_bytes
    # the hop split of (2, 4): 6 intra-pod pushes, 2 inter-pod root pushes
    by_hop = hier["ledger"]["by_hop"]
    assert by_hop["intra_pod"]["total_bytes"] == 3 * by_hop["inter_pod"]["total_bytes"]


def test_multipod_decomposes_server_bytes(multipod_runs):
    m = multipod_runs
    assert bitwise(m["multipod/server"]["theta"], m["local/server"]["theta"])
    s = m["multipod/server"]["ledger"]
    assert set(s["by_hop"]) == {"intra_pod", "inter_pod"}
    assert sum(v["total_bytes"] for v in s["by_hop"].values()) == \
        m["local/server"]["ledger"]["total_bytes"]


def test_multipod_priced_cost_weights_inter_pod(multipod_runs):
    s = multipod_runs["priced"]
    inter = s["by_hop"]["inter_pod"]
    assert inter["price_per_byte"] == 5.0
    assert s["priced_cost"] == pytest.approx(s["total_bytes"] + 4.0 * inter["total_bytes"])


def test_multipod_calibrated_prices(multipod_runs):
    cal, ref = multipod_runs["calibrated"], multipod_runs["calibrated/ref"]
    assert bitwise(cal["theta"], ref["theta"])
    for hop, v in cal["ledger"]["by_hop"].items():
        assert v["total_bytes"] == ref["ledger"]["by_hop"][hop]["total_bytes"]
        assert v["price_per_byte"] > 0.0


def test_multipod_explicit_price_beats_calibration(multipod_runs):
    assert multipod_runs["explicit_price"] == [1.0, 42.0]


def test_mesh_sweep_matches_solo_mesh_fits(multipod_runs):
    """``mesh+sweep`` ≡ S solo mesh fits.  The reference claims θ bitwise;
    here the batched products round differently: measured ≤ 2.4e-7 in θ
    (8 gloo ranks, torch 2.13 on the CPU), held at the local sweep's
    rtol 1e-6 / atol 1e-7 (queue 3, item 18).  Trajectory at the
    reference's composed tolerance, ledgers exact."""
    m = multipod_runs
    res = m["mesh+sweep"]
    assert res["executor"] == "mesh+sweep"
    gap = 0.0
    for i, solo in enumerate(m["mesh/solo"]):
        gap = max(gap, float(np.abs(res["theta"][i] - solo["theta"]).max()))
        close(res["theta"][i], solo["theta"], S_RTOL, S_ATOL)
        close(res["traj"][i], solo["traj"], 1e-5, 1e-7)
        assert res["ledgers"][i] == solo["ledger"]
    assert gap < 1e-6


def test_multipod_sweep_keeps_per_hop_split(multipod_runs):
    m = multipod_runs
    res = m["multipod+sweep"]
    assert res["executor"] == "multipod+sweep"
    for i, solo in enumerate(m["multipod/solo"]):
        s = res["ledgers"][i]
        assert set(s["by_hop"]) == {"intra_pod", "inter_pod"}
        assert all(v["total_bytes"] > 0 for v in s["by_hop"].values())
        assert sum(v["total_bytes"] for v in s["by_hop"].values()) == s["total_bytes"]
        assert s == solo["ledger"]
        close(res["theta"][i], solo["theta"], S_RTOL, S_ATOL)


@pytest.mark.parametrize("kind", ["stal", "drop"])
def test_sweeps_compose_with_mesh(multipod_runs, kind):
    """A staleness sweep (one line of depth max D, each scenario read at its
    own index) and a dropout sweep (tensor masks, a straggler lag and a
    quorum rollback per scenario) inside each rank's loop."""
    m = multipod_runs
    res = m[f"{kind}+sweep"]
    for i, solo in enumerate(m[f"{kind}/solo"]):
        close(res["theta"][i], solo["theta"], S_RTOL, S_ATOL)
        assert res["totals"][i] == solo["ledger"]["total_bytes"]


# ---------------------------------------------------------------------------
# one process: validation and refusals
# ---------------------------------------------------------------------------


def test_mesh_world_of_one_matches_local():
    """Without a process group the mesh is a world of one on this process:
    the same loop, collectives the identity — bitwise local."""
    X, y = ranks.problem()
    for transport, kw in ranks.UPDATE_CASES:
        a = tfit(t_gd(), (X, y), transport=transport, steps=20, **kw)
        b = tfit(t_gd(), (X, y), transport=transport, steps=20, executor="mesh", **kw)
        c = tfit(t_gd(), (X, y), transport=transport, steps=20, executor="multipod", **kw)
        assert bitwise(a.theta.numpy(), b.theta.numpy())
        assert bitwise(b.theta.numpy(), c.theta.numpy())
        assert b.metrics["executor"] == "mesh" and c.metrics["executor"] == "multipod"
        assert set(c.ledger.summary()["by_hop"]) == {"intra_pod", "inter_pod"}


def test_mesh_server_transport_needs_shardable_data():
    with pytest.raises(ValueError, match="local"):
        tfit(tapi.FunctionStrategy(lambda k, t: t, num_nodes=4), None,
             transport="sequential_server", schedule=[0, 1, 2, 3],
             theta0=np.zeros(5, np.float32), executor="mesh")


def test_mesh_rejects_admm():
    from repro_torch.ml.linear import lasso_prox_builder

    X, y = ranks.problem(K=4)
    with pytest.raises(ValueError, match="local"):
        tfit(tapi.ProxStrategy(lasso_prox_builder), (X, y), transport="admm_consensus",
             steps=5, g="l1", g_lam=0.1, executor="mesh")


def test_mesh_rejects_aggregate_override():
    class Weird(tapi.GradientDescent):
        def aggregate(self, msgs):
            return torch.median(msgs, dim=0).values

    X, y = ranks.problem()
    with pytest.raises(NotImplementedError, match="aggregate"):
        tfit(Weird(t_lsq, lr=0.1), (X, y), transport="allreduce", steps=2, executor="mesh")


def test_mesh_update_needs_data_and_stacked_messages():
    from repro_torch.optim import sgd

    rng = np.random.default_rng(5)
    Xb = rng.normal(size=(3, 4, 2)).astype(np.float32)
    yb = rng.normal(size=(3, 4)).astype(np.float32)

    def loss(theta, batch):
        return torch.mean((batch[0] @ theta - batch[1]) ** 2)

    kw = dict(transport="allreduce", stream=(Xb, yb), theta0=np.zeros(2, np.float32),
              executor="mesh")
    with pytest.raises(ValueError, match="leading node axis"):
        tfit(tapi.OptimizerStrategy(loss, sgd(0.1)), None, **kw)
    with pytest.raises(ValueError, match="stacked messages"):
        tfit(tapi.OptimizerStrategy(loss, sgd(0.1)), np.zeros((1, 2), np.float32), **kw)


def test_mesh_server_rejects_replicate_data():
    class Rep(tapi.GradientDescent):
        replicate_data = True

    X, y = ranks.problem()
    with pytest.raises(ValueError, match="replicate_data"):
        tfit(Rep(t_lsq, lr=0.1), (X, y), transport="sequential_server",
             schedule=[0, 1, 2, 3, 4, 5, 6, 7], executor="mesh")


def test_multipod_needs_a_pod_axis():
    X, y = ranks.problem()
    with pytest.raises(ValueError, match="pod"):
        tfit(t_gd(), (X, y), transport="allreduce", steps=2,
             executor=tapi.MultiPodExecutor(make_node_mesh()))


def test_reduce_scatter_auto_resolution():
    assert tapi.MeshExecutor(reduce_scatter=True)._rs_active() is True
    assert tapi.MeshExecutor(reduce_scatter=False)._rs_active() is False
    # the reference turns it on only on a TPU
    assert tapi.MeshExecutor()._rs_active() is False


def test_executor_lists_match_reference():
    assert set(tapi.EXECUTORS) == set(japi.executor.EXECUTORS)
    assert set(tapi.COMPOSED_EXECUTORS) == set(japi.COMPOSED_EXECUTORS) == {
        "mesh+sweep", "multipod+sweep"}


def _error_text(call):
    try:
        call()
    except (ValueError, NotImplementedError) as e:
        return type(e).__name__, str(e)
    return None


_SW = {"lr": [0.1, 0.2]}


@pytest.mark.parametrize("name, call_of", [
    ("unknown", lambda api: api.make_executor("cluster")),
    ("bare-sweep", lambda api: api.make_executor("sweep")),
    ("composed-needs-params", lambda api: api.make_executor("mesh+sweep")),
    ("params-need-sweep", lambda api: api.make_executor("mesh", _SW)),
    ("instance-with-params", lambda api: api.make_executor(api.MeshExecutor(), _SW)),
    ("serve+sweep", lambda api: api.make_executor("serve+sweep", _SW)),
    ("local+mesh+sweep", lambda api: api.make_executor("local+mesh+sweep", _SW)),
    ("no-params", lambda api: api.SweepExecutor({})),
    ("count-mismatch", lambda api: api.SweepExecutor({"lr": [0.0] * 3, "l2": [0.0] * 4})),
])
def test_make_executor_errors_match_reference(name, call_of):
    """The same exception type and text as the JAX package's."""
    jsw = {"lr": jnp.asarray([0.1, 0.2])}

    def jcall():
        if name == "params-need-sweep":
            return japi.make_executor("mesh", jsw)
        if name == "instance-with-params":
            return japi.make_executor(japi.MeshExecutor(), jsw)
        if name in ("serve+sweep", "local+mesh+sweep"):
            return japi.make_executor(name, jsw)
        if name == "count-mismatch":
            return japi.SweepExecutor({"lr": jnp.zeros(3), "l2": jnp.zeros(4)})
        return call_of(japi)

    got, want = _error_text(lambda: call_of(tapi)), _error_text(jcall)
    assert got is not None and got == want


def test_make_executor_spec_strings():
    ex = tapi.make_executor("mesh+sweep", _SW)
    assert isinstance(ex, tapi.SweepExecutor) and isinstance(ex.inner, tapi.MeshExecutor)
    assert ex.name == "mesh+sweep" and ex.num_scenarios == 2
    ex = tapi.make_executor("multipod+sweep", _SW)
    assert isinstance(ex.inner, tapi.MultiPodExecutor) and ex.name == "multipod+sweep"
    assert tapi.make_executor("sweep", _SW).inner is None
    assert tapi.SweepExecutor(_SW, inner="local").inner is None
    assert isinstance(tapi.make_executor("mesh"), tapi.MeshExecutor)
    assert isinstance(tapi.make_executor(None), tapi.LocalExecutor)


def test_serve_executor_names_item_10():
    with pytest.raises(NotImplementedError, match=r"ROADMAP\.md queue 1, item 10\b"):
        tapi.make_executor("serve")


def test_sweep_unknown_attribute_rejected():
    X, y = ranks.problem(K=4)
    sw = tapi.SweepExecutor({"momentum": [0.1, 0.2]})
    with pytest.raises(ValueError, match="momentum"):
        tfit(t_gd(), (X, y), transport="allreduce", steps=3, executor=sw)


def test_sweep_rejects_server_transports():
    sw = tapi.SweepExecutor({"lr": [0.1, 0.2]})
    with pytest.raises(ValueError, match="local"):
        tfit(tapi.FunctionStrategy(lambda k, t: t, num_nodes=4), None,
             transport="sequential_server", schedule=[0, 1, 2, 3],
             theta0=np.zeros(5, np.float32), executor=sw)


def test_dropout_sweep_needs_a_plan():
    X, y = ranks.problem(K=4)
    with pytest.raises(ValueError, match="FaultPlan"):
        tfit(t_gd(), (X, y), transport="allreduce", steps=2, executor="sweep",
             sweep={"dropout_p": [0.0, 0.5]})


def test_admm_under_a_sweep_raises_as_reference():
    """A sweep over ρ of ``admm_consensus`` raises ``ValueError`` in both
    packages (the sweep= values need a sweep executor spec)."""
    from repro.ml.linear import lasso_prox_builder as j_prox

    X, y = ranks.problem(K=4)
    with pytest.raises(ValueError) as want:
        japi.fit(japi.ProxStrategy(j_prox), jdata(X, y), transport="admm_consensus",
                 steps=2, sweep={"rho": jnp.asarray([0.5, 1.0])})
    with pytest.raises(ValueError) as got:
        tfit(tapi.ProxStrategy(lambda d: None, dim=3), None, transport="admm_consensus",
             steps=2, sweep={"rho": [0.5, 1.0]})
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="local executor only"):
        tfit(tapi.ProxStrategy(lambda d: None, dim=3), None, transport="admm_consensus",
             steps=2, executor="sweep", sweep={"rho": [0.5, 1.0]})


# ---------------------------------------------------------------------------
# sweep ≡ S solo fits, the port's and the JAX package's
# ---------------------------------------------------------------------------

LRS = ranks.LRS


def _sweep_case(name):
    """(swept values, solo fit kwargs per scenario, shared kwargs) of a case,
    as (port kwargs, JAX kwargs) builders."""
    X, y = ranks.problem()
    if name == "lr":
        return dict(transport="allreduce", steps=30), {"lr": list(LRS)}, [
            dict(lr=lr) for lr in LRS]
    if name == "lr-topk":
        return dict(transport="allreduce", steps=20, wire="topk:0.5+ef"), \
            {"lr": [0.05, 0.1]}, [dict(lr=0.05), dict(lr=0.1)]
    if name == "lr-int8":
        return dict(transport="delay_line", staleness=1, steps=20, wire="int8+ef"), \
            {"lr": [0.05, 0.1]}, [dict(lr=0.05), dict(lr=0.1)]
    if name == "staleness":
        return dict(transport="delay_line", steps=40, lr=0.05), \
            {"staleness": [0, 1, 2, 3]}, [dict(staleness=D) for D in (0, 1, 2, 3)]
    if name == "theta0":
        th = np.random.default_rng(1).normal(size=(3, X.shape[-1])).astype(np.float32)
        return dict(transport="allreduce", steps=20), {"theta0": th}, [
            dict(theta0=th[i]) for i in range(3)]
    if name == "tau":
        taus = (0.0, 0.05, 0.2)
        return dict(transport="allreduce", steps=25, wire="thresh:0.1"), \
            {"tau": list(taus)}, [dict(wire=f"thresh:{t}") for t in taus]
    if name == "dropout_p":
        ps = (0.0, 0.2, 0.5)
        return dict(transport="delay_line", staleness=1, steps=20, wire="int8+ef",
                    faults=dict(seed=7, straggler=1, quorum=4)), \
            {"dropout_p": list(ps)}, [dict(dropout_p=p) for p in ps]
    raise KeyError(name)


def _solo_kwargs(shared, solo):
    kw = dict(shared)
    kw.update(solo)
    lr = kw.pop("lr", 0.1)
    faults = kw.pop("faults", None)
    p = kw.pop("dropout_p", None)
    if faults is not None:
        faults = dict(faults, dropout_p=0.0 if p is None else p)
    return lr, faults, kw


@pytest.mark.parametrize("case", ["lr", "lr-topk", "lr-int8", "staleness", "theta0",
                                  "tau", "dropout_p"])
def test_sweep_matches_solo_fits(case):
    X, y = ranks.problem()
    shared, sweep, solos = _sweep_case(case)
    lr, faults, kw = _solo_kwargs(shared, {})
    t_faults = None if faults is None else tapi.FaultPlan(**faults)
    res = tfit(t_gd(lr), (X, y), executor="sweep", sweep=sweep, faults=t_faults, **kw)
    S = len(solos)
    assert np.asarray(res.theta).shape[0] == S and len(res.ledger) == S
    assert res.trajectory.shape[:2] == (S, kw["steps"])
    for i, solo in enumerate(solos):
        lr, faults, kw = _solo_kwargs(shared, solo)
        th0 = kw.pop("theta0", None)
        t = tfit(t_gd(lr), (X, y), theta0=th0,
                 faults=None if faults is None else tapi.FaultPlan(**faults), **kw)
        j = japi.fit(j_gd(lr), jdata(X, y), theta0=None if th0 is None else jnp.asarray(th0),
                     faults=None if faults is None else japi.FaultPlan(**faults), **kw)
        for ref in (t.theta, j.theta):
            close(res.theta[i], ref, S_RTOL, S_ATOL)
        for ref in (t.trajectory, j.trajectory):
            close(res.trajectory[i], ref, S_RTOL, S_ATOL)
        assert res.ledger[i].summary() == t.ledger.summary() == j.ledger.summary()


def test_sweep_matches_jax_sweep_ledgers():
    """The batched byte counts of a swept threshold: per-scenario ledgers
    equal to the JAX package's own sweep, and the ratio really swept."""
    X, y = ranks.problem()
    taus = [0.0, 0.05, 0.2]
    res = tfit(t_gd(), (X, y), transport="allreduce", wire="thresh:0.1", steps=25,
               executor="sweep", sweep={"tau": taus})
    ref = japi.fit(j_gd(), jdata(X, y), transport="allreduce", wire="thresh:0.1", steps=25,
                   executor=japi.SweepExecutor({"tau": jnp.asarray(taus)}))
    totals = [led.total_bytes for led in res.ledger]
    assert totals == [led.total_bytes for led in ref.ledger]
    assert totals[0] > totals[1] > totals[2]
    np.testing.assert_array_equal(res.metrics["uplink_bytes_per_round"],
                                  np.asarray(ref.metrics["uplink_bytes_per_round"]))


def test_dp_sigma_sweep_matches_solo_fits():
    """The DP wire's σ per scenario: the noise is drawn once a round and
    node (its stream keys do not depend on the scenario) and scaled by each
    scenario's σ·clip.  The JAX package draws from ``jax.random``, so the
    solo fits are the port's."""
    X, y = ranks.problem()
    sig = [0.0, 0.01, 0.1]
    res = tfit(t_gd(), (X, y), transport="allreduce", wire="dp:1.0,0.5", steps=8,
               executor="sweep", sweep={"dp_sigma": sig})
    for i, s in enumerate(sig):
        solo = tfit(t_gd(), (X, y), transport="allreduce", wire=f"dp:1.0,{s}", steps=8)
        close(res.theta[i], solo.theta, S_RTOL, S_ATOL)
        assert res.ledger[i].summary() == solo.ledger.summary()


def test_dp_wire_under_a_dropout_sweep():
    """A dropout sweep freezes dead nodes' DP counters per scenario, so the
    scenarios' noise streams part: each scenario's noise is drawn outside
    the batch from its own counters."""
    X, y = ranks.problem()
    ps = [0.0, 0.4]
    plan = dict(seed=2)
    res = tfit(t_gd(), (X, y), transport="allreduce", wire="dp:1.0,0.05", steps=6,
               faults=tapi.FaultPlan(**plan), executor="sweep", sweep={"dropout_p": ps})
    for i, p in enumerate(ps):
        solo = tfit(t_gd(), (X, y), transport="allreduce", wire="dp:1.0,0.05", steps=6,
                    faults=tapi.FaultPlan(dropout_p=p, **plan))
        close(res.theta[i], solo.theta, S_RTOL, S_ATOL)
        np.testing.assert_array_equal(res.metrics["carry"].inner[2][i].numpy(),
                                      solo.metrics["carry"].inner[2].numpy())


def test_sweep_carry_resume():
    X, y = ranks.problem()
    kw = dict(transport="delay_line", wire="topk:0.5+ef", executor="sweep",
              sweep={"lr": [0.05, 0.1], "staleness": [0, 2]})
    full = tfit(t_gd(), (X, y), steps=30, **kw)
    a = tfit(t_gd(), (X, y), steps=15, **kw)
    b = tfit(t_gd(), (X, y), steps=15, carry=a.metrics["carry"], **kw)
    close(b.theta, full.theta, S_RTOL, S_ATOL)
    assert bitwise(b.theta.numpy(), full.theta.numpy())


def test_pytree_theta0_sweep_runs_in_turn():
    """``OptimizerStrategy`` is not vmappable (``torch.autograd.grad``): its
    scenarios run in turn inside each round, each bitwise its solo fit."""
    from repro.api.strategy import OptimizerStrategy as JOpt
    from repro.optim import adam as j_adam
    from repro_torch.optim import adam as t_adam

    rng = np.random.default_rng(2)
    Xb = rng.normal(size=(6, 4, 3)).astype(np.float32)
    yb = rng.normal(size=(6, 4)).astype(np.float32)
    th0 = {"w": rng.normal(size=(2, 3)).astype(np.float32),
           "b": rng.normal(size=(2,)).astype(np.float32)}

    def t_loss(theta, batch):
        Xt, yt = batch
        return 0.5 * torch.mean(((Xt @ theta["w"]) + theta["b"] - yt) ** 2)

    def j_loss(theta, batch):
        Xt, yt = batch
        return 0.5 * jnp.mean(((Xt @ theta["w"]) + theta["b"] - yt) ** 2)

    sw = tapi.SweepExecutor({"theta0": th0})
    assert sw.num_scenarios == 2
    res = tfit(tapi.OptimizerStrategy(t_loss, t_adam(0.1)), None, transport="delay_line",
               staleness=0, stream=(Xb, yb), executor=sw)
    for i in range(2):
        one = {k: v[i] for k, v in th0.items()}
        solo = tfit(tapi.OptimizerStrategy(t_loss, t_adam(0.1)), None,
                    transport="delay_line", staleness=0, stream=(Xb, yb), theta0=one)
        ref = japi.fit(JOpt(j_loss, j_adam(0.1)), None, transport="delay_line", staleness=0,
                       stream=(jnp.asarray(Xb), jnp.asarray(yb)),
                       theta0={k: jnp.asarray(v) for k, v in one.items()})
        for k in ("w", "b"):
            assert bitwise(res.theta[k][i].numpy(), solo.theta[k].numpy())
            close(res.theta[k][i], ref.theta[k], S_RTOL, S_ATOL)


def test_kernel_path_sweep_encodes_once_per_leaf_per_round(monkeypatch):
    """On the kernel path (here the CPU's plain version) a sweep's S
    scenarios reach the encode as ONE call on S·K rows per leaf and round,
    through the custom op's ``vmap`` rule — bitwise the codec path."""
    calls = []
    real = tk_ref.encode_threshold_ref

    def spy(c, t, *, with_residual):
        calls.append(tuple(c.shape))
        return real(c, t, with_residual=with_residual)

    monkeypatch.setattr(tk_ref, "encode_threshold_ref", spy)
    X, y = ranks.problem(n=300)
    wire = tapi.TopKWire(0.05, error_feedback=True, use_kernel=True)
    res = tfit(t_gd(), (X, y), transport="allreduce", wire=wire, steps=6,
               executor="sweep", sweep={"lr": list(LRS)})
    assert calls == [(4 * 8, 300)] * 6
    codec = tfit(t_gd(), (X, y), transport="allreduce", wire="topk:0.05+ef", steps=6,
                 executor="sweep", sweep={"lr": list(LRS)})
    assert bitwise(res.theta.numpy(), codec.theta.numpy())


# ---------------------------------------------------------------------------
# the custom ops under vmap, the dynamic delay read, the train CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("op", ["topk-ef", "topk-select", "int8"])
def test_custom_ops_under_vmap_bitwise_separate_calls(op):
    rng = np.random.default_rng(4)
    u = torch.from_numpy(rng.normal(size=(3, 4, 300)).astype(np.float32))
    r = torch.from_numpy(rng.normal(size=(3, 4, 300)).astype(np.float32))
    if op == "topk-ef":
        got = torch.func.vmap(lambda a, b: tk_ops.topk_encode(a, b, k=17))(u, r)
        want = [tk_ops.topk_encode(u[s], r[s], k=17) for s in range(3)]
    elif op == "topk-select":
        got = torch.func.vmap(lambda a: tk_ops.topk_encode(a, k=17)[::2])(u)
        want = [tk_ops.topk_encode(u[s], k=17)[::2] for s in range(3)]
    else:
        got = torch.func.vmap(q8_ops.int8_roundtrip)(u)
        want = [q8_ops.int8_roundtrip(u[s]) for s in range(3)]
    for s in range(3):
        for g, w in zip(got, want[s]):
            assert bitwise(g[s].numpy(), w.numpy())


def test_delay_push_read_tensor_index_matches_push_pop():
    rng = np.random.default_rng(0)
    D = 3
    a, b = delay_init(torch.zeros(4), D), delay_init(torch.zeros(4), D)
    for _ in range(8):
        g = torch.from_numpy(rng.normal(size=4).astype(np.float32))
        a, pa = delay_push_pop(a, g)
        b, pb = delay_push_read(b, g, torch.tensor(D))
        assert torch.equal(pa, pb) and torch.equal(a.buffer, b.buffer)
    _, read = delay_push_read(delay_init(torch.zeros(3), 2), torch.ones(3), torch.tensor(0))
    assert torch.equal(read, torch.ones(3))


def test_train_cli_staleness_sweep_matches_solo_runs(capsys, tmp_path):
    argv = ["--reduced", "--steps", "3", "--batch", "2", "--seq", "16", "--log-every", "3",
            "--compress-topk", "0.25", "--device", "cpu"]
    train_main(argv + ["--sweep-staleness", "0,1"])
    swept = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for D in (0, 1):
        train_main(argv + ["--staleness", str(D)])
        solo = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert swept["final_loss"][f"loss_D{D}"] == solo["final_loss"]
        assert [h[f"loss_D{D}"] for h in swept["history"]] == [
            h["loss"] for h in solo["history"]]
        assert swept["uplink_bytes"] == solo["uplink_bytes"]
    with pytest.raises(SystemExit, match="ckpt-dir"):
        train_main(argv + ["--sweep-staleness", "0,1", "--ckpt-dir", str(tmp_path)])
