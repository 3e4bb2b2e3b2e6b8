"""Port parity: the reference names that ``repro_torch.core`` and
``repro_torch.utils`` gained last — the stale-update trainer
(``make_stale_update``, ``AsyncSGDState``, ``staleness_bound_lr``), the
tree helpers, the packages' re-exports and ``int8_roundtrip_ref`` — and
``examples/quickstart.py``'s four fits through ``repro_torch.api``, each
against the JAX package on the same numpy inputs.

Tolerances: the synchronous trainer equals the plain optimizer bitwise
(the same operations); the stale trainer's θ equals the JAX wrapper's
step for step, bitwise, handed the same gradients (SGD's ``-lr·g`` and
the add round alike in both packages); the quickstart's θ to rtol 1e-5 /
atol 1e-6, as ``test_torch_fit.py``, and its ledgers exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import optim as j_optim  # noqa: E402
from repro.core import schedules as j_sched  # noqa: E402
from repro.core import staleness as j_stale  # noqa: E402
from repro.data import make_feature_shards as j_shards  # noqa: E402
from repro.kernels.int8_quant import ref as j_q8_ref  # noqa: E402
from repro.ml.linear import logistic_loss as j_logistic  # noqa: E402
from repro.utils import tree as j_tree  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.core import schedules as t_sched  # noqa: E402
from repro_torch.core import staleness as t_stale  # noqa: E402
from repro_torch.kernels.int8_quant import ref as t_q8_ref  # noqa: E402
from repro_torch.ml.linear import logistic_loss as t_logistic  # noqa: E402
from repro_torch.utils import tree as t_tree  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6

# ----------------------------------------------------------------------------
# The stale-update trainer (the cases of tests/test_staleness.py)
# ----------------------------------------------------------------------------

A_NP = (np.eye(4) * 2.0).astype(np.float32)
B_NP = np.ones(4, np.float32)


def _t_update(opt):
    def update(grads, state, params):
        upd, state = opt.update(grads, state, params)
        return t_optim.apply_updates(params, upd), state
    return update


def _j_update(opt):
    def update(grads, state, params):
        upd, state = opt.update(grads, state, params)
        return jax.tree.map(jnp.add, params, upd), state
    return update


def test_staleness_zero_is_the_plain_optimizer_bitwise():
    A, b = torch.from_numpy(A_NP), torch.from_numpy(B_NP)
    opt = t_optim.sgd(0.1)
    init, update = t_stale.make_stale_update(_t_update(opt), staleness=0)
    st = init(torch.zeros(4), opt.init(torch.zeros(4)))
    assert st.delay is None
    plain, plain_state = torch.zeros(4), opt.init(torch.zeros(4))
    for _ in range(20):
        st = update(st, A @ st.params - b)
        plain, plain_state = _t_update(opt)(A @ plain - b, plain_state, plain)
        assert torch.equal(st.params, plain)


@pytest.mark.parametrize("staleness", [1, 3])
def test_stale_updates_match_jax_step_for_step(staleness):
    """The same gradients handed to both wrappers (a seeded random
    sequence, so a wrong slot of the delay line shows), then the
    reference's convergence case run on the port alone."""
    lr = t_stale.staleness_bound_lr(0.2, staleness)
    assert lr == j_stale.staleness_bound_lr(0.2, staleness)
    t_opt, j_opt = t_optim.sgd(lr), j_optim.sgd(lr)
    t_init, t_upd = t_stale.make_stale_update(_t_update(t_opt), staleness=staleness)
    j_init, j_upd = j_stale.make_stale_update(_j_update(j_opt), staleness=staleness)
    ts = t_init(torch.zeros(4), t_opt.init(torch.zeros(4)))
    js = j_init(jnp.zeros(4), j_opt.init(jnp.zeros(4)))
    assert isinstance(ts, t_stale.AsyncSGDState) and ts.delay.buffer.shape == (staleness, 4)
    grads = np.random.default_rng(staleness).normal(size=(12, 4)).astype(np.float32)
    for t, g in enumerate(grads):
        ts = t_upd(ts, torch.from_numpy(g))
        js = j_upd(js, jnp.asarray(g))
        np.testing.assert_array_equal(ts.params.numpy(), np.asarray(js.params))
        if t < staleness:  # the replies that have not arrived yet
            assert not bool(ts.params.any())
        np.testing.assert_array_equal(ts.delay.buffer.numpy(), np.asarray(js.delay.buffer))
    assert int(ts.delay.step) == int(js.delay.step) == len(grads)

    A, b = torch.from_numpy(A_NP), torch.from_numpy(B_NP)
    st = t_init(torch.zeros(4), t_opt.init(torch.zeros(4)))
    for _ in range(300):
        st = t_upd(st, A @ st.params - b)
    np.testing.assert_allclose(st.params.numpy(), np.linalg.solve(A_NP, B_NP), atol=1e-3)


def test_staleness_bound_lr():
    assert t_stale.staleness_bound_lr(1.0, 0) == 1.0
    assert t_stale.staleness_bound_lr(1.0, 4) == 0.2


# ----------------------------------------------------------------------------
# Tree helpers, re-exports, the int8 reference
# ----------------------------------------------------------------------------


def _trees(seed):
    rng = np.random.default_rng(seed)
    a = {"w": rng.normal(size=(3, 5)).astype(np.float32),
         "b": [rng.normal(size=(7,)).astype(np.float32), np.asarray(rng.normal(size=()), np.float32)]}
    b = jax.tree.map(lambda x: np.asarray(x + rng.normal(size=x.shape), np.float32), a)
    return a, b


def _t(tree):
    return jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)


@pytest.mark.parametrize("helper", [
    "tree_add", "tree_sub", "tree_scale", "tree_axpy", "tree_zeros_like", "tree_dot",
    "tree_norm", "tree_size", "tree_bytes", "tree_allclose", "tree_cast",
])
def test_tree_helpers_match_reference(helper):
    a, b = _trees(0)
    args = {
        "tree_add": (a, b), "tree_sub": (a, b), "tree_scale": (1.5, a),
        "tree_axpy": (-0.25, a, b), "tree_zeros_like": (a,), "tree_dot": (a, b),
        "tree_norm": (a,), "tree_size": (a,), "tree_bytes": (a,), "tree_allclose": (a, b),
        "tree_cast": (a, "bfloat16"),
    }[helper]
    j_args = [jax.tree.map(jnp.asarray, x) if isinstance(x, dict) else x for x in args]
    t_args = [_t(x) if isinstance(x, dict) else x for x in args]
    if helper == "tree_cast":
        j_args[1], t_args[1] = jnp.bfloat16, torch.bfloat16
    j, t = getattr(j_tree, helper)(*j_args), getattr(t_tree, helper)(*t_args)
    if isinstance(j, (int, bool)):
        assert t == j
        return
    jl = jax.tree.leaves(j)
    tl = t_tree.tree_leaves(t)
    if helper in ("tree_dot", "tree_norm"):  # leaves summed in another order
        np.testing.assert_allclose(float(t), float(j), rtol=1e-6)
        return
    # jax orders dict leaves by key, torch by insertion: compare by path
    want = {jax.tree_util.keystr(p): np.asarray(x).astype(np.float32)
            for p, x in jax.tree_util.tree_leaves_with_path(j)}
    got = {jax.tree_util.keystr(p): x.float().numpy()
           for p, x in jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda x: x, t))}
    assert len(jl) == len(tl) and want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if helper == "tree_cast":
        assert all(x.dtype == torch.bfloat16 for x in tl)


def test_tree_allclose_sees_a_difference():
    a, _ = _trees(1)
    assert t_tree.tree_allclose(_t(a), _t(a))
    near = jax.tree.map(lambda x: np.asarray(x + np.float32(1e-7)), a)
    assert t_tree.tree_allclose(_t(a), _t(near)) == j_tree.tree_allclose(a, near) is True
    far = jax.tree.map(lambda x: np.asarray(x + np.float32(1e-3)), a)
    assert t_tree.tree_allclose(_t(a), _t(far)) == j_tree.tree_allclose(a, far) is False


def test_package_reexports_match_reference():
    import repro.core
    import repro.utils
    import repro_torch.core
    import repro_torch.utils

    for t_pkg, j_pkg in ((repro_torch.core, repro.core), (repro_torch.utils, repro.utils)):
        assert set(t_pkg.__all__) == set(j_pkg.__all__)
        assert all(hasattr(t_pkg, n) for n in t_pkg.__all__)
    assert len(repro_torch.core.__all__) == 20 and len(repro_torch.utils.__all__) == 12
    assert tapi.make_fault_plan(None) is None
    plan = tapi.FaultPlan(seed=1, dropout_p=0.5)
    assert tapi.make_fault_plan(plan) is plan


def test_int8_roundtrip_ref_bitwise():
    """``int8_roundtrip_ref`` composed of the two halves, bitwise the JAX
    package's un-jitted reference on 300 leaves (a multiply by 1/127 in
    place of its true divide differs on some of them)."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        x = (rng.normal(size=(int(rng.choice([1, 7, 64, 257, 499])),))
             * rng.uniform(1e-3, 1e3)).astype(np.float32)
        jo, js = j_q8_ref.int8_roundtrip_ref(jnp.asarray(x))
        to, ts = t_q8_ref.int8_roundtrip_ref(torch.from_numpy(x))
        np.testing.assert_array_equal(to.numpy().view(np.int32), np.asarray(jo).view(np.int32))
        assert ts.numpy().view(np.int32) == np.asarray(js).view(np.int32)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    out, _ = t_q8_ref.int8_roundtrip_ref(torch.from_numpy(x))
    assert out.shape == (3, 4, 5)


# ----------------------------------------------------------------------------
# examples/quickstart.py through both packages
# ----------------------------------------------------------------------------

K, NK, DIM, LR = 4, 50, 8, 0.3


def _quickstart_fits():
    """The example's four fits in each package: round-robin, asynchronous
    (the JAX schedule handed over), the stale handoff, and the stale
    handoff with ``topk:0.25+ef``."""
    Xs, ys, _ = j_shards(0, K, NK, DIM, task="classification")
    Xn, yn = np.asarray(Xs), np.asarray(ys)
    Xt, yt = torch.tensor(Xn), torch.tensor(yn)

    def Fj(k, theta):
        return theta - LR * jax.grad(j_logistic)(theta, Xs[k], ys[k])

    def Ft(k, theta):
        return theta - LR * torch.func.grad(t_logistic)(theta, Xt[k], yt[k])

    rr = np.asarray(j_sched.round_robin(K, num_rounds=50))
    np.testing.assert_array_equal(t_sched.round_robin(K, 50).numpy(), rr)
    asyn = np.asarray(j_sched.asynchronous(jax.random.key(0), K, num_contacts=200))
    runs = [("sequential_server", rr, "dense"), ("sequential_server", asyn, "dense"),
            ("stale_server", asyn, "dense"), ("stale_server", asyn, "topk:0.25+ef")]
    out = []
    for transport, sched, wire in runs:
        rj = japi.fit(japi.FunctionStrategy(Fj, num_nodes=K), transport=transport,
                      wire=wire, schedule=jnp.asarray(sched), theta0=jnp.zeros(DIM))
        rt = tapi.fit(tapi.FunctionStrategy(Ft, num_nodes=K), transport=transport,
                      wire=wire, schedule=torch.from_numpy(sched), theta0=torch.zeros(DIM),
                      device="cpu")
        out.append((rj, rt))
    return Xn, yn, out


def test_quickstart_fits_match_jax():
    Xn, yn, fits = _quickstart_fits()

    def accuracy(theta):
        return float(np.mean(np.sign(Xn.reshape(-1, DIM) @ theta) == yn.reshape(-1)))

    for rj, rt in fits:
        np.testing.assert_allclose(rt.theta.numpy(), np.asarray(rj.theta), rtol=RTOL, atol=ATOL)
        assert rt.ledger.summary() == rj.ledger.summary()
        assert rt.ledger.events == rj.ledger.events
        assert accuracy(rt.theta.numpy()) == accuracy(np.asarray(rj.theta)) > 0.9
    # the compressed push moves fewer bytes up than the dense one
    assert fits[3][1].ledger.uplink_bytes < fits[2][1].ledger.uplink_bytes
