"""Port parity: ``repro_torch.optim`` against ``repro.optim``.

The same seeded numpy trees and gradients go through both packages for a
few steps; updates, parameters and every state leaf are held to rtol
1e-6 (atol 1e-7 for values near 0).  Both compute in f32 in the same
order.  Measured over the four steps: SGD (with and without the
schedule), momentum, Nesterov, AdamW and bf16 moments are bitwise equal;
Adam differs in 8 elements (≤ 1.8e-7 relative) and Adagrad in one
(8.3e-8), where XLA contracts ``b·m + (1 − b)·g`` into a fused
multiply-add or rounds ``pow`` / ``sqrt`` in its own last bit.  Under
``clip_by_global_norm`` the global norm sums in another order (XLA's
reduction tree against torch's), so every clipped gradient moves by an
ulp and 380 elements differ, all within the tolerance.  The cases of
``tests/test_optim.py`` run on the port as well.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as j_optim  # noqa: E402
from repro.optim.optimizers import apply_updates as j_apply  # noqa: E402
from repro_torch import optim as t_optim  # noqa: E402
from repro_torch.utils.tree import tree_map  # noqa: E402

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"w": (7, 5), "b": (5,), "emb": (3, 4, 2)}


def _tree(rng, scale=1.0):
    return {k: (scale * rng.normal(size=s)).astype(np.float32) for k, s in SHAPES.items()}


def _close(j, t, what):
    jl = jax.tree.map(np.asarray, j)
    for k in SHAPES:
        a = np.asarray(jl[k], dtype=np.float32)
        b = t[k].float().numpy()
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f"{what}[{k}]")


def _pair(name):
    """(reference optimizer, port optimizer) of one kind."""
    j, t = j_optim, t_optim
    return {
        "sgd": (j.sgd(0.1), t.sgd(0.1)),
        "sgd-schedule": (j.sgd(j.warmup_cosine(0.5, 2, 6)),
                         t.sgd(t.warmup_cosine(0.5, 2, 6))),
        "momentum": (j.momentum(0.05), t.momentum(0.05)),
        "nesterov": (j.momentum(0.05, beta=0.8, nesterov=True),
                     t.momentum(0.05, beta=0.8, nesterov=True)),
        "adam": (j.adam(1e-2), t.adam(1e-2)),
        "adamw": (j.adam(j.warmup_cosine(3e-3, 2, 6), weight_decay=0.1),
                  t.adam(t.warmup_cosine(3e-3, 2, 6), weight_decay=0.1)),
        "adam-bf16": (j.adam(1e-2, moment_dtype="bfloat16"),
                      t.adam(1e-2, moment_dtype="bfloat16")),
        "adagrad": (j.adagrad(0.3), t.adagrad(0.3)),
        "clip-adam": (j.clip_by_global_norm(j.adam(1e-2), 1.0),
                      t.clip_by_global_norm(t.adam(1e-2), 1.0)),
        "clip-sgd-inactive": (j.clip_by_global_norm(j.sgd(0.1), 1e6),
                              t.clip_by_global_norm(t.sgd(0.1), 1e6)),
    }[name]


@pytest.mark.parametrize("name", ["sgd", "sgd-schedule", "momentum", "nesterov", "adam",
                                  "adamw", "adam-bf16", "adagrad", "clip-adam",
                                  "clip-sgd-inactive"])
def test_optimizer_steps_match_reference(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    jo, to = _pair(name)
    p0 = _tree(rng)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    assert sorted(ts) == sorted(js)
    assert ts["count"].dtype == torch.int32 and ts["count"].shape == ()
    for step in range(4):
        g = _tree(rng, scale=3.0)
        ju, js = jo.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tu, ts = to.update({k: torch.from_numpy(v.copy()) for k, v in g.items()}, ts, tp)
        _close(ju, tu, f"{name} step {step} updates")
        for key in ("m", "v", "mu", "G"):
            if key in js:
                assert ts[key]["w"].dtype == getattr(torch, str(js[key]["w"].dtype))
                _close(js[key], ts[key], f"{name} step {step} {key}")
        assert int(ts["count"]) == int(js["count"])
        jp, tp = j_apply(jp, ju), t_optim.apply_updates(tp, tu)
        _close(jp, tp, f"{name} step {step} params")


@pytest.mark.parametrize("step", [0, 1, 3, 7, 10, 55, 100, 140])
def test_warmup_cosine_matches_reference(step):
    j = j_optim.warmup_cosine(2e-3, 10, 100, floor=0.1)(jnp.asarray(step))
    t = t_optim.warmup_cosine(2e-3, 10, 100, floor=0.1)(torch.tensor(step, dtype=torch.int32))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(float(t), float(j), rtol=RTOL)


# ----------------------------------------------------------------------------
# tests/test_optim.py's cases, on the port
# ----------------------------------------------------------------------------


def _run(opt, steps=200, n=4):
    params = torch.full((n,), 5.0)
    state = opt.init(params)
    for _ in range(steps):
        upd, state = opt.update(params, state, params)  # ∇ ½‖θ‖² = θ
        params = t_optim.apply_updates(params, upd)
    return params


@pytest.mark.parametrize("name,opt", [
    ("sgd", t_optim.sgd(0.1)), ("momentum", t_optim.momentum(0.05)),
    ("adam", t_optim.adam(0.1)), ("adagrad", t_optim.adagrad(1.0)),
])
def test_optimizers_minimize_quadratic(name, opt):
    assert float(_run(opt).abs().max()) < 0.1, name


def test_adam_first_step_formula():
    opt = t_optim.adam(0.1, b1=0.9, b2=0.999, eps=1e-8)
    p = {"w": torch.tensor([1.0])}
    upd, _ = opt.update({"w": torch.tensor([0.5])}, opt.init(p), p)
    # bias-corrected first step = -lr * g/|g| = -lr (up to eps)
    np.testing.assert_allclose(upd["w"].numpy(), [-0.1], rtol=1e-4)


def test_clip_caps_global_norm():
    opt = t_optim.clip_by_global_norm(t_optim.sgd(1.0), 1.0)
    p = torch.zeros(4)
    upd, _ = opt.update(torch.full((4,), 100.0), opt.init(p), p)
    np.testing.assert_allclose(float(torch.linalg.norm(upd)), 1.0, rtol=1e-5)


def test_bf16_moments():
    opt = t_optim.adam(0.1, moment_dtype="bfloat16")
    p = {"w": torch.ones(8)}
    st = opt.init(p)
    assert st["m"]["w"].dtype == torch.bfloat16
    upd, st = opt.update({"w": torch.ones(8)}, st, p)
    assert bool(torch.isfinite(upd["w"]).all()) and st["v"]["w"].dtype == torch.bfloat16


def test_warmup_cosine_schedule():
    sched = t_optim.warmup_cosine(1.0, warmup=10, total=100, floor=0.1)
    assert float(sched(0)) == 0.0
    np.testing.assert_allclose(float(sched(10)), 1.0, rtol=1e-5)
    assert 0.099 <= float(sched(100)) < 0.15


def test_weight_decay():
    opt = t_optim.adam(0.1, weight_decay=0.1)
    p = {"w": torch.tensor([10.0])}
    upd, _ = opt.update({"w": torch.tensor([0.0])}, opt.init(p), p)
    assert float(upd["w"][0]) < 0  # decays toward zero even with zero grad


def test_state_is_functional():
    """An update makes new tensors: the state and params it was given stay
    as they were (a resumed fit may hold on to an earlier carry)."""
    opt = t_optim.clip_by_global_norm(t_optim.adam(0.1), 1.0)
    p = {"w": torch.ones(3)}
    st = opt.init(p)
    before = tree_map(torch.clone, st)
    upd, new = opt.update({"w": torch.full((3,), 2.0)}, st, p)
    assert torch.equal(st["m"]["w"], before["m"]["w"]) and int(st["count"]) == 0
    assert int(new["count"]) == 1 and torch.equal(p["w"], torch.ones(3))
