"""Port parity: the training slice — ``loss_fn`` and its gradients,
``OptimizerStrategy`` under ``delay_line`` × ``topk:f+ef``, resume from a
JAX carry, and ``repro_torch.launch.train`` — against the JAX package.

Weights cross with ``convert.params_from_reference`` and batches are the
reference's ``synthetic_lm_batches`` (``jax.random`` cannot be matched),
at the reduced tinyllama-1.1b and qwen2-1.5b configs (2 layers, d_model
256, f32 compute) on the CPU.  Tolerances:

* the loss to rtol 1e-5, each gradient leaf to 1e-5 × its max |g| (XLA
  and torch sum the matmuls in other orders; measured ≤ 7.6e-8 relative
  on the loss and ≤ 2.3e-6 × max |g|);
* the remat policies to each other bitwise (the recompute runs the same
  operations on the same inputs);
* fits: the trajectory to rtol 1e-5 / atol 1e-6 and the ledger exactly;
  θ to the same in all but 1e-4 of its elements, each within lr × steps
  (``_theta_close`` says why and what was measured).
"""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import optim as j_optim  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.data import synthetic_lm_batches as j_batches  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import carry_from_reference, params_from_reference  # noqa: E402
from repro_torch.launch import train as t_train  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.utils.tree import tree_flatten  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
GRAD_TOL = 1e-5  # × the leaf's max |g|
B, T = 2, 32


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def flat(tree) -> dict:
    """'/'-joined path → numpy leaf, for either package's tree."""
    if isinstance(jax.tree.leaves(tree)[0], torch.Tensor):
        leaves = torch.utils._pytree.tree_flatten_with_path(tree)[0]
        return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
                x.detach().numpy() for path, x in leaves}
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path):
            np.asarray(x) for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference_batches(cfg, n, seed=0):
    it = j_batches(seed, B, T, cfg.vocab_size)
    return [np_tree(next(it)) for _ in range(n)]


def stacked(batches):
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


@functools.lru_cache(maxsize=None)
def load(name):
    """(JAX config, port config, JAX params) of the reduced ``name``."""
    jc, tc = j_get_config(name).reduced(), t_get_config(name).reduced()
    return jc, tc, j_tf.init_params(jax.random.key(0), jc)


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "qwen2-1.5b"])
def model(request):
    return load(request.param)


def t_params(jp):
    return params_from_reference(np_tree(jp), "cpu")


def t_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


# ----------------------------------------------------------------------------
# The loss
# ----------------------------------------------------------------------------


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, size=(3, 5))
    mask = (rng.random((3, 5)) < 0.7).astype(np.float32)
    for m in (None, mask):
        j = j_layers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   mask=None if m is None else jnp.asarray(m))
        t = t_layers.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                   mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def _grads_close(jg, tg):
    jf, tf_ = flat(jg), flat(tg)
    assert sorted(jf) == sorted(tf_)
    for k, a in jf.items():
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(tf_[k], a, rtol=0, atol=GRAD_TOL * scale, err_msg=k)


@pytest.mark.parametrize("masked", [False, True], ids=["plain", "loss_mask"])
def test_loss_and_grads_match_jax(model, masked):
    jc, tc, jp = model
    batch = reference_batches(jc, 1)[0]
    if masked:
        batch["loss_mask"] = (np.random.default_rng(3).random((B, T)) < 0.8).astype(np.float32)
    (jl, jm), jg = jax.value_and_grad(lambda p: j_tf.loss_fn(p, jc, batch), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    tp = t_params(jp)
    leaves, spec = tree_flatten(tp)
    xs = [x.requires_grad_() for x in leaves]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"], tb["labels"] = tb["tokens"].long(), tb["labels"].long()
    tl, tm = t_tf.loss_fn(torch.utils._pytree.tree_unflatten(xs, spec), tc, tb)
    tg = torch.autograd.grad(tl, xs)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    np.testing.assert_allclose(float(tm["ce"]), float(jm["ce"]), rtol=RTOL)
    assert float(tm["aux"]) == float(jm["aux"]) == 0.0
    _grads_close(jg, torch.utils._pytree.tree_unflatten([g for g in tg], spec))


def test_chunked_ce_matches_reference(model):
    """Several chunks (chunk 8 of T 32) and a mask, against the JAX scan."""
    jc, tc, jp = model
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(B, T, jc.d_model)).astype(np.float32)
    labels = rng.integers(0, jc.vocab_size, size=(B, T))
    mask = (rng.random((B, T)) < 0.6).astype(np.float32)
    j = j_tf.chunked_ce(jp, jc, jnp.asarray(hidden), jnp.asarray(labels),
                        mask=jnp.asarray(mask), chunk=8)
    t = t_tf.chunked_ce(t_params(jp), tc, torch.from_numpy(hidden),
                        torch.from_numpy(labels), mask=torch.from_numpy(mask), chunk=8)
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


def _loss_grads(tc, params, batch):
    leaves, spec = tree_flatten(params)
    xs = [x.detach().clone().requires_grad_() for x in leaves]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(1) or x,
                                                  lambda x: x):
        loss, _ = t_tf.loss_fn(torch.utils._pytree.tree_unflatten(xs, spec), tc, batch)
    return loss, torch.autograd.grad(loss, xs), len(saved)


def test_remat_policies_agree_bitwise(model):
    jc, tc, jp = model
    tp = t_params(jp)
    batch = t_batch(reference_batches(jc, 1)[0])
    ref_loss, ref_grads, saved_none = _loss_grads(tc.replace(remat_policy="none"), tp, batch)
    for policy in ("full", "dots"):
        loss, grads, saved = _loss_grads(tc.replace(remat_policy=policy), tp, batch)
        assert torch.equal(loss, ref_loss), policy
        assert all(torch.equal(a, b) for a, b in zip(grads, ref_grads)), policy
        # the layer bodies ran under a checkpoint: their saved tensors are
        # the checkpoint's, not the outer graph's
        assert saved < saved_none, (policy, saved, saved_none)
    with pytest.raises(ValueError):
        _loss_grads(tc.replace(remat_policy="some"), tp, batch)


def test_mtp_loss_raises_naming_roadmap(model):
    """Once a refusal (MTP was ROADMAP item 11), now the MTP loss of the
    dense model with one MTP module (attention × dense FFN trunk) against
    the JAX package: the loss and its ``ce`` / ``aux`` / ``mtp`` metrics to
    rtol 1e-5, each gradient leaf to 1e-5 × its max |g|."""
    jc, tc, _ = model
    jc, tc = jc.replace(num_mtp_layers=1), tc.replace(num_mtp_layers=1)
    jp = j_tf.init_params(jax.random.key(1), jc)
    batch = reference_batches(jc, 1)[0]
    (jl, jm), jg = jax.jit(jax.value_and_grad(lambda p: j_tf.loss_fn(p, jc, batch),
                                              has_aux=True))(jax.tree.map(jnp.asarray, jp))
    leaves, spec = tree_flatten(t_params(jp))
    xs = [x.requires_grad_() for x in leaves]
    tl, tm = t_tf.loss_fn(torch.utils._pytree.tree_unflatten(xs, spec), tc, t_batch(batch))
    tg = torch.autograd.grad(tl, xs)
    assert sorted(tm) == sorted(jm) == ["aux", "ce", "mtp"]
    np.testing.assert_allclose(tl.item(), float(jl), rtol=RTOL)
    for k in ("ce", "mtp"):
        np.testing.assert_allclose(tm[k].item(), float(jm[k]), rtol=RTOL, err_msg=k)
    assert tm["aux"].item() == float(jm["aux"]) == 0.0
    _grads_close(jg, torch.utils._pytree.tree_unflatten(list(tg), spec))


# ----------------------------------------------------------------------------
# OptimizerStrategy × delay_line × topk:f+ef
# ----------------------------------------------------------------------------


LR = 1e-3
FEW = 2e-4  # the share of θ's elements allowed outside rtol/atol (see below)


def _strategies(jc, tc, steps, lr=LR):
    jo = j_optim.clip_by_global_norm(
        j_optim.adam(j_optim.warmup_cosine(lr, steps // 10 + 1, steps)), 1.0)
    js = japi.OptimizerStrategy(lambda p, b: j_tf.loss_fn(p, jc, b), jo, has_aux=True)
    return js, t_train.make_strategy(tc, t_train.make_optimizer(lr, steps))


def _theta_close(j_theta, t_theta, steps):
    """θ to rtol 1e-5 / atol 1e-6 in all but a few elements, and every
    element within ``LR × steps``.  Three things move single elements by
    more than the gradients' last bits, none of them a wrong result: a
    top-k survivor swapped where two magnitudes tie to within those bits,
    an int8 value rounded to the next quantum, and Adam dividing a
    gradient that straddles zero by its own magnitude (a last-bit
    difference becomes a step of up to ±lr).  Measured: at most 126 of
    1,247,232 elements (1.0e-4; qwen2-1.5b, dense with dropout), the
    largest 8.1e-4 = 0.81 lr (tinyllama-1.1b, topk:0.25+ef, a survivor
    swap); with momentum in place of Adam the dense wire stays within
    rtol/atol everywhere."""
    jf, tf_ = flat(j_theta), flat(t_theta)
    assert sorted(jf) == sorted(tf_)
    outside = total = 0
    for k, a in jf.items():
        d = np.abs(tf_[k] - a)
        assert d.max() <= LR * steps, (k, float(d.max()))
        outside += int((d > ATOL + RTOL * np.abs(a)).sum())
        total += a.size
    assert outside <= FEW * total, (outside, total)


def _fit_close(rj, rt, steps):
    _theta_close(rj.theta, rt.theta, steps)
    np.testing.assert_allclose(rt.trajectory.numpy(), np.asarray(rj.trajectory),
                               rtol=RTOL, atol=ATOL)
    assert rt.ledger.summary() == rj.ledger.summary()
    np.testing.assert_array_equal(rt.metrics["uplink_bytes_per_round"],
                                  rj.metrics["uplink_bytes_per_round"])


FIT_CASES = {
    "topk-ef": dict(wire="topk:0.25+ef"),
    "int8-ef": dict(wire="int8+ef"),
    "dense-faults": dict(wire="dense", faults=dict(dropout_p=0.4)),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fit_optimizer_strategy_matches_jax(model, case):
    """4 rounds of ``delay_line(1)`` under the launcher's optimizer (Adam,
    warmup-cosine, clip 1) on the reference's batches: θ, the trajectory
    and the ledger; the carry's structure (Adam's count, moment and
    residual shapes)."""
    jc, tc, jp = model
    spec = FIT_CASES[case]
    steps = 4
    stream = stacked(reference_batches(jc, steps))
    js, ts = _strategies(jc, tc, steps)
    jf = tf_ = None
    if "faults" in spec:
        jf, tf_ = japi.FaultPlan(seed=3, **spec["faults"]), tapi.FaultPlan(seed=3, **spec["faults"])
    kw = dict(transport="delay_line", staleness=1, wire=spec["wire"])
    rj = japi.fit(js, None, stream=jax.tree.map(jnp.asarray, stream), theta0=jp, faults=jf,
                  **kw)
    rt = tapi.fit(ts, None, stream=stream, theta0=t_params(jp), faults=tf_, device="cpu",
                  **kw)
    _fit_close(rj, rt, steps)
    tcar = rt.metrics["carry"]
    if "faults" in spec:
        tcar = tcar.inner
    opt_state, loss = tcar[1]
    assert int(opt_state["count"]) == steps and loss.shape == ()
    assert float(loss) == float(rt.trajectory[-1])
    for leaf, m, v in zip(*(tree_flatten(x)[0] for x in (tcar[0], opt_state["m"],
                                                          opt_state["v"]))):
        assert m.shape == v.shape == leaf.shape and m.dtype == torch.float32
    if spec["wire"].endswith("+ef"):
        assert all(r.shape == x.shape for r, x in zip(tree_flatten(tcar[2])[0],
                                                      tree_flatten(tcar[0])[0]))
    else:
        assert tcar[2] == ()


def test_fit_kernel_path_is_the_codec_bitwise(model):
    """The port's fused encode (forced; its plain versions on the CPU, one
    ``topk_encode`` per leaf as one row) and the reference codec give the
    same fit, bit for bit, and the ledger counts one push per round."""
    jc, tc, jp = model
    steps = 3
    stream = stacked(reference_batches(jc, steps, seed=2))
    _, ts = _strategies(jc, tc, steps)
    runs = [tapi.fit(ts, None, transport="delay_line", staleness=1,
                     wire=tapi.TopKWire(0.25, error_feedback=True, use_kernel=use),
                     stream=stream, theta0=t_params(jp), device="cpu")
            for use in (True, False)]
    for k, a in flat(runs[1].theta).items():
        assert np.array_equal(flat(runs[0].theta)[k].view(np.int32), a.view(np.int32)), k
    assert torch.equal(runs[0].trajectory, runs[1].trajectory)
    push = sum(max(1, round(0.25 * x.size)) * 8 for x in flat(jp).values())
    assert runs[0].ledger.uplink_bytes == runs[1].ledger.uplink_bytes == steps * push
    hits = runs[0].metrics["wire_kernel_hits"]
    assert hits["active"] and hits["kernel_leaves"] + hits["fallback_leaves"] == len(flat(jp))


def test_fit_resumes_from_a_jax_carry():
    """2 JAX rounds → ``carry_from_reference`` (Adam's int32 count, the
    scalar loss, EF residuals, the delay line) → 2 port rounds matches the
    JAX run resumed for the same 2 rounds; and the port's own carry
    resumes the port bit for bit (2 + 2 rounds = 4)."""
    jc, tc, jp = load("tinyllama-1.1b")
    stream = stacked(reference_batches(jc, 4, seed=5))
    head = {k: v[:2] for k, v in stream.items()}
    tail = {k: v[2:] for k, v in stream.items()}
    js, ts = _strategies(jc, tc, 4)
    kw = dict(transport="delay_line", staleness=1, wire="topk:0.25+ef")
    j_half = japi.fit(js, None, stream=jax.tree.map(jnp.asarray, head), theta0=jp, **kw)
    j_rest = japi.fit(js, None, stream=jax.tree.map(jnp.asarray, tail),
                      carry=j_half.metrics["carry"], **kw)
    carry = carry_from_reference(np_tree(j_half.metrics["carry"]), device="cpu")
    opt_state, loss = carry[1]
    assert opt_state["count"].dtype == torch.int32 and opt_state["count"].shape == ()
    assert int(opt_state["count"]) == 2 and loss.shape == () and carry[3].step.shape == ()
    t_rest = tapi.fit(ts, None, stream=tail, carry=carry, device="cpu", **kw)
    _theta_close(j_rest.theta, t_rest.theta, 4)
    np.testing.assert_allclose(t_rest.trajectory.numpy(), np.asarray(j_rest.trajectory),
                               rtol=RTOL, atol=ATOL)
    t_half = tapi.fit(ts, None, stream=head, theta0=t_params(jp), device="cpu", **kw)
    t_more = tapi.fit(ts, None, stream=tail, carry=t_half.metrics["carry"], device="cpu",
                      **kw)
    t_all = tapi.fit(ts, None, stream=stream, theta0=t_params(jp), device="cpu", **kw)
    for k, a in flat(t_all.theta).items():
        np.testing.assert_array_equal(flat(t_more.theta)[k], a, err_msg=k)


def test_single_stream_wire_encode_matches_jax():
    """``encode_updates(stacked=False)`` of every wire, on one θ-shaped
    message with residuals: the pushed message bitwise the reference's,
    and the new residuals too but for int8's (the port's fused path
    forced as well, its plain versions running on the CPU)."""
    rng = np.random.default_rng(4)
    msg = {"a": rng.normal(size=(300,)).astype(np.float32),
           "b": rng.normal(size=(7, 9)).astype(np.float32),
           "c": rng.normal(size=(4, 80)).astype(np.float32)}
    res = {k: (0.1 * rng.normal(size=v.shape)).astype(np.float32) for k, v in msg.items()}
    t = {k: torch.from_numpy(v) for k, v in msg.items()}
    tr = {k: torch.from_numpy(v) for k, v in res.items()}
    for spec in ("topk:0.1+ef", "topk:0.1", "int8+ef", "thresh:0.5+ef", "dense"):
        jw = japi.make_wire(spec)
        tws = [tapi.make_wire(spec)]
        if spec.startswith(("topk", "int8")):
            tws.append(type(tws[0])(**({"fraction": 0.1} if "topk" in spec else {}),
                                    error_feedback=spec.endswith("+ef"), use_kernel=True))
        j_state = jw.init_state(msg, 1, stacked=False)
        if j_state != ():
            j_state = jax.tree.map(jnp.asarray, res)
        # under jit, as every fit runs it (XLA writes a dropped element as +0.0)
        jn, jh, jb = jax.jit(lambda w, m, jw=jw: jw.encode_updates(w, m, stacked=False))(
            j_state, jax.tree.map(jnp.asarray, msg))
        for i, tw in enumerate(tws):
            t_state = tw.init_state(t, 1, stacked=False)
            if t_state != ():
                assert all(v.shape == t[k].shape for k, v in t_state.items())
                t_state = tr
            tn, th, tb = tw.encode_updates(t_state, t, stacked=False)
            for k in msg:
                assert np.array_equal(th[k].numpy().view(np.int32),
                                      np.asarray(jh[k]).view(np.int32)), (spec, k)
                if jn != () and spec.startswith("int8"):
                    # XLA contracts the residual c − q·s into an FMA
                    # (ROADMAP.md queue 3, item 4): held as the EF chain is
                    np.testing.assert_allclose(tn[k].numpy(), np.asarray(jn[k]), rtol=0,
                                               atol=1e-6, err_msg=spec)
                elif jn != ():
                    assert np.array_equal(tn[k].numpy().view(np.int32),
                                          np.asarray(jn[k]).view(np.int32)), (spec, k)
            assert float(tb) == float(jb), spec
            if i == 0 and spec.startswith(("topk", "int8")):
                assert float(tb) == tw.push_bytes(t)  # one push
                # priced from shapes: the codec's count on zeros, exactly
                assert tw.push_bytes(t) == tapi.CompressedWire.push_bytes(tw, t)


# ----------------------------------------------------------------------------
# The launcher and the train → checkpoint → serve round trip
# ----------------------------------------------------------------------------


def test_train_cli_loss_decreases(capsys):
    hist = t_train.main([
        "--arch", "tinyllama-1.1b", "--reduced", "--steps", "30", "--batch", "4",
        "--seq", "32", "--log-every", "10", "--lr", "1e-3", "--device", "cpu",
    ])
    assert hist[-1]["loss"] < hist[0]["loss"] - 0.1
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["final_loss"] == hist[-1]["loss"] and final["uplink_bytes"] > 0
    assert [h["step"] for h in final["history"]] == [1, 10, 20, 30]


# --sweep-staleness is ported (tests/test_torch_executors.py holds each
# level to a solo run); --multipod waits for item 13
@pytest.mark.parametrize("flag,item", [("--multipod", "item 13")])
def test_train_cli_unported_flags_raise(flag, item):
    with pytest.raises(NotImplementedError, match=item):
        t_train.main(["--reduced", "--steps", "2", flag, "--device", "cpu"])


def test_train_checkpoint_restore_and_serve(tmp_path):
    """The train-and-checkpoint half of ``examples/train_lm_e2e.py`` on
    the port: train with staleness 1 and ``topk:0.25+ef``, checkpoint every
    half, restore the last step into a fresh model and serve it through
    ``ContinuousLMEngine`` on the CPU.  The served greedy ids are those of
    the trained θ, and the checkpoint restores in the JAX package too."""
    from repro import checkpoint as j_ckpt
    from repro_torch.serve import ContinuousLMEngine

    steps = 8
    hist = t_train.main([
        "--arch", "tinyllama-1.1b", "--reduced", "--steps", str(steps), "--batch", "4",
        "--seq", "32", "--lr", "1e-3", "--staleness", "1", "--compress-topk", "0.25",
        "--log-every", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", str(steps // 2),
        "--device", "cpu",
    ])
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert t_ckpt.latest_step(str(tmp_path)) == steps
    cfg = t_get_config("tinyllama-1.1b").reduced()
    fresh = t_tf.init_params(torch.Generator().manual_seed(1), cfg)
    params = t_ckpt.restore(str(tmp_path), steps, fresh)
    j_like = j_tf.init_params(jax.random.key(0), j_get_config("tinyllama-1.1b").reduced())
    j_params = j_ckpt.restore(str(tmp_path), steps, j_like)
    for k, a in flat(j_params).items():
        np.testing.assert_array_equal(flat(params)[k], a, err_msg=k)

    prompts = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(3, 16))
    outs = []
    for p in (params, fresh):
        engine = ContinuousLMEngine(cfg, p, n_slots=2, page_size=8, max_seq=40,
                                    device="cpu")
        tickets = [engine.submit(q, max_new=8) for q in prompts]
        engine.run_until_idle()
        outs.append(np.stack([t.result() for t in tickets]))
    assert outs[0].shape == (3, 8) and ((outs[0] >= 0) & (outs[0] < cfg.vocab_size)).all()
    assert not np.array_equal(outs[0], outs[1])  # the restored weights are the ones served


def test_training_default_device_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tapi.fit(tapi.OptimizerStrategy(lambda p, b: p.sum(), t_optim.sgd(0.1)), None,
                 transport="delay_line", steps=1, theta0=torch.zeros(3))
