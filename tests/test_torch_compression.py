"""Port parity: ``repro_torch.core`` / ``ml`` / ``data`` against the JAX
package, on the CPU.

The compression functions are held bitwise against ``jax.jit`` of the JAX
functions — the wire always runs them under jit, where XLA writes +0.0 for
dropped entries and multiplies by the f32 reciprocal of 127 for the int8
scale; the port writes the same bits.  The byte ledger, delay line, server
protocol, schedules and data pipeline are exact; the losses and their
gradients agree to f32 rounding (rtol 1e-6: the reductions run in another
order).
"""

from __future__ import annotations

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import allreduce as j_ar  # noqa: E402
from repro.core import compression as j_comp  # noqa: E402
from repro.core import schedules as j_sched  # noqa: E402
from repro.core import server as j_server  # noqa: E402
from repro.core import staleness as j_stale  # noqa: E402
from repro.data.pipeline import make_feature_shards as j_shards  # noqa: E402
from repro.ml import linear as j_lin  # noqa: E402
from repro_torch.core import allreduce as t_ar  # noqa: E402
from repro_torch.core import compression as t_comp  # noqa: E402
from repro_torch.core import schedules as t_sched  # noqa: E402
from repro_torch.core import server as t_server  # noqa: E402
from repro_torch.core import staleness as t_stale  # noqa: E402
from repro_torch.data.pipeline import make_feature_shards as t_shards  # noqa: E402
from repro_torch.ml import linear as t_lin  # noqa: E402

SHAPES = [(4096,), (128, 300), (513,), (300,), (8192,), (256,), (257,)]


def assert_bits_equal(jax_x, torch_x):
    a = np.ascontiguousarray(np.asarray(jax_x))
    b = np.ascontiguousarray(torch_x.numpy())
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def tree_np(seed, shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return {f"w{i}": (scale * rng.normal(size=s)).astype(np.float32)
            for i, s in enumerate(shapes)}


def to_j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def to_t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def assert_compressed_equal(jc, tc):
    for key in jc.tree:
        assert_bits_equal(jc.tree[key], tc.tree[key])
    assert float(jc.wire_bytes) == float(tc.wire_bytes)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["ref", "kernel"])
@pytest.mark.parametrize("shape", SHAPES)
def test_topk_and_int8_compress_bitwise(shape, use_kernel):
    x = tree_np(1, [shape, (7,)])  # a kernel-sized leaf and a tiny one
    jt = jax.jit(partial(j_comp.topk_compress, fraction=0.1, use_kernel=use_kernel))
    assert_compressed_equal(
        jt(to_j(x)), t_comp.topk_compress(to_t(x), 0.1, use_kernel=use_kernel)
    )
    ji = jax.jit(partial(j_comp.int8_compress, use_kernel=use_kernel))
    assert_compressed_equal(
        ji(to_j(x)), t_comp.int8_compress(to_t(x), use_kernel=use_kernel)
    )


@pytest.mark.parametrize("k", [1, 299, 300])
def test_topk_compress_k_edges(k):
    x = tree_np(2, [(300,)])
    f = k / 300
    jt = jax.jit(partial(j_comp.topk_compress, fraction=f))
    assert_compressed_equal(jt(to_j(x)), t_comp.topk_compress(to_t(x), f))


@pytest.mark.parametrize("shape", SHAPES)
def test_threshold_compress_bitwise(shape):
    x = tree_np(3, [shape, (5,)])
    jc = jax.jit(j_comp.threshold_compress)(to_j(x), 0.7)
    assert_compressed_equal(jc, t_comp.threshold_compress(to_t(x), 0.7))


def test_randk_compress_with_given_masks():
    x = tree_np(4, [(513,), (16, 20)])
    key = jax.random.key(0)
    jc = jax.jit(partial(j_comp.randk_compress, fraction=0.25))(key, to_j(x))
    # the JAX draws, handed to the port as its masks
    keys = jax.random.split(key, 2)
    masks = {
        name: torch.from_numpy(
            np.array(jax.random.uniform(kk, x[name].shape) < 0.25)
        )
        for kk, name in zip(keys, sorted(x))
    }
    assert_compressed_equal(jc, t_comp.randk_compress(masks, to_t(x), 0.25))


@pytest.mark.parametrize("codec", ["topk", "int8"])
def test_ef_chain_4_rounds(codec):
    """Round t's residual feeds round t+1.  Top-k is bitwise at every
    round.  Int8 is bitwise in round 0's push; its residual ``c - q·s``
    is one rounding apart, because XLA contracts it into an FMA under jit
    while the port rounds the product ``q·s`` first (ROADMAP.md queue 3) —
    so the chain is held to 1e-6 (a few f32 ulps of |c| ~ 1)."""
    x = tree_np(5, [(2048,), (40,)])
    j_codec = (partial(j_comp.topk_compress, fraction=0.05) if codec == "topk"
               else j_comp.int8_compress)
    t_codec = (partial(t_comp.topk_compress, fraction=0.05) if codec == "topk"
               else t_comp.int8_compress)
    j_step = jax.jit(lambda s, u: j_comp.ef_compress(s, u, j_codec))
    js, ts = j_comp.ef_init(to_j(x)), t_comp.ef_init(to_t(x))
    for t in range(4):
        u = {k: np.sin(v * (t + 1)).astype(np.float32) for k, v in x.items()}
        js, jc = j_step(js, to_j(u))
        ts, tc = t_comp.ef_compress(ts, to_t(u), t_codec)
        for key in x:
            if codec == "topk" or t == 0:
                assert_bits_equal(jc.tree[key], tc.tree[key])
            np.testing.assert_allclose(tc.tree[key].numpy(), np.asarray(jc.tree[key]),
                                       rtol=0, atol=1e-6)
            if codec == "topk":
                assert_bits_equal(js.residual[key], ts.residual[key])
            np.testing.assert_allclose(ts.residual[key].numpy(),
                                       np.asarray(js.residual[key]), rtol=0, atol=1e-6)
        assert float(jc.wire_bytes) == float(tc.wire_bytes)


def test_kernel_plan_and_raw_bytes():
    shapes = [(300,), (255,), (16, 16)]
    x = tree_np(6, shapes)
    x["h"] = np.zeros((400,), np.float16)
    assert t_comp.kernel_plan(to_t(x)) == j_comp.kernel_plan(to_j(x))
    assert t_comp.raw_bytes(to_t(x)) == j_comp.raw_bytes(to_j(x))


def test_comm_ledger_matches_reference():
    theta = tree_np(7, [(300,), (3, 4)])
    legs = []
    for mod, conv in ((j_ar, to_j), (t_ar, to_t)):
        led = mod.CommLedger()
        led.record_allreduce(conv(theta), 8, tag="a")
        led.record_push(conv(theta), tag="p")
        led.record_pull(conv(theta), tag="q")
        led.record_inference(conv(theta), conv(theta), tag="i")
        led.record_hop(conv(theta), "intra", 4, price_per_byte=0.5)
        led.attribute_hops([("intra", 6, 0.5), ("inter", 2, 3.0)])
        other = mod.CommLedger()
        other.record_hop(conv(theta), "inter", 2, price_per_byte=3.0)
        led.merge(other)
        legs.append(led)
    j, t = legs
    assert t.summary() == j.summary()
    assert t.events == j.events and t.hops == j.hops
    assert t.priced_cost() == j.priced_cost()
    empty_j, empty_t = j_ar.CommLedger(), t_ar.CommLedger()
    empty_j.attribute_hops([("intra", 0, 1.0)])
    empty_t.attribute_hops([("intra", 0, 1.0)])
    assert empty_t.summary() == empty_j.summary()


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
def test_server_allreduce(op):
    x = tree_np(8, [(5, 300)])
    j = j_ar.server_allreduce(to_j(x), op=op)
    t = t_ar.server_allreduce(to_t(x), op=op)
    np.testing.assert_allclose(t["w0"].numpy(), np.asarray(j["w0"]), rtol=1e-6)


def test_delay_line_push_pop_and_read():
    g = tree_np(9, [(6, 3)])
    js = j_stale.delay_init(to_j({"w0": g["w0"][0]}), 3)
    ts = t_stale.delay_init(to_t({"w0": g["w0"][0]}), 3)
    for t in range(6):
        push = {"w0": g["w0"][t]}
        if t % 2:
            js, jr = j_stale.delay_push_pop(js, to_j(push))
            ts, tr = t_stale.delay_push_pop(ts, to_t(push))
        else:
            js, jr = j_stale.delay_push_read(js, to_j(push), jnp.asarray(t % 4))
            ts, tr = t_stale.delay_push_read(ts, to_t(push), t % 4)
        assert_bits_equal(jr["w0"], tr["w0"])
        assert_bits_equal(js.buffer["w0"], ts.buffer["w0"])
        assert int(js.step) == int(ts.step)


def test_delay_line_of_depth_one_holds_the_push():
    """Depth 1 (``delay_line(1)``, the training slice's line): the popped
    value and the buffer bitwise the reference's; the buffer is the push
    itself, a view, not a copy."""
    g = tree_np(10, [(4, 5)])
    js = j_stale.delay_init(to_j({"w0": g["w0"][0]}), 1)
    ts = t_stale.delay_init(to_t({"w0": g["w0"][0]}), 1)
    for t in range(4):
        push = to_t({"w0": g["w0"][t]})
        js, jr = j_stale.delay_push_pop(js, to_j({"w0": g["w0"][t]}))
        ts, tr = t_stale.delay_push_pop(ts, push)
        assert_bits_equal(jr["w0"], tr["w0"])
        assert_bits_equal(js.buffer["w0"], ts.buffer["w0"])
        assert ts.buffer["w0"].data_ptr() == push["w0"].data_ptr()
        assert int(js.step) == int(ts.step)


@pytest.mark.parametrize("handoff", ["sequential", "stale"])
def test_run_protocol(handoff):
    shifts = np.random.default_rng(10).normal(size=(4, 6)).astype(np.float32)

    def j_F(k, th):
        return 0.5 * th + jnp.asarray(shifts)[k]

    def t_F(k, th):
        return 0.5 * th + torch.from_numpy(shifts)[k]

    sched = np.asarray(j_sched.round_robin(4, 3))
    js, jtraj = j_server.run_protocol(jnp.zeros(6), j_F, jnp.asarray(sched),
                                      handoff=handoff)
    ts, ttraj = t_server.run_protocol(torch.zeros(6), t_F, sched, handoff=handoff)
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), rtol=1e-6)
    np.testing.assert_allclose(ts.theta_prev.numpy(), np.asarray(js.theta_prev),
                               rtol=1e-6)
    assert int(ts.t) == int(js.t) == 12
    assert t_server.pull(ts) is ts.theta


def test_schedules():
    np.testing.assert_array_equal(
        t_sched.round_robin(5, 3).numpy(), np.asarray(j_sched.round_robin(5, 3))
    )
    sizes = np.asarray([10.0, 20.0, 0.0, 40.0], np.float32)
    np.testing.assert_allclose(
        t_sched.work_proportional_probs(sizes).numpy(),
        np.asarray(j_sched.work_proportional_probs(sizes)), rtol=1e-6,
    )
    s = np.asarray([0, 2, 2, 3], np.int32)
    assert float(t_sched.coverage(s, 5)) == float(j_sched.coverage(jnp.asarray(s), 5))
    g = torch.Generator().manual_seed(0)
    draws = t_sched.asynchronous(g, 4, 4000, probs=torch.tensor([0.1, 0.2, 0.3, 0.4]))
    freq = np.bincount(draws.numpy(), minlength=4) / 4000
    np.testing.assert_allclose(freq, [0.1, 0.2, 0.3, 0.4], atol=0.03)
    with pytest.raises(ValueError, match="p\\(S=i\\)"):
        t_sched.asynchronous(g, 2, 3, probs=torch.tensor([1.0, 0.0]))


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_make_feature_shards_bitwise(task):
    j = j_shards(3, 4, 17, 9, task=task, heterogeneity=0.5)
    t = t_shards(3, 4, 17, 9, task=task, heterogeneity=0.5, device="cpu")
    for a, b in zip(j, t):
        assert_bits_equal(a, b)


@pytest.mark.parametrize("loss", ["lsq_loss", "logistic_loss"])
def test_losses_and_gradients(loss):
    Xs, ys, _ = t_shards(5, 1, 40, 12, task="classification", device="cpu")
    X, y = Xs[0], ys[0]
    theta = np.random.default_rng(11).normal(size=12).astype(np.float32)
    j_loss, t_loss = getattr(j_lin, loss), getattr(t_lin, loss)
    jv, jg = jax.value_and_grad(j_loss)(jnp.asarray(theta), jnp.asarray(X.numpy()),
                                         jnp.asarray(y.numpy()))
    tv = t_loss(torch.from_numpy(theta), X, y)
    tg = torch.func.grad(t_loss)(torch.from_numpy(theta), X, y)
    np.testing.assert_allclose(float(tv), float(jv), rtol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-7)
