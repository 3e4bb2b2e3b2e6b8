"""Port parity: the MoE FFN (``repro_torch.models.moe``) and the MoE models
(olmoe-1b-7b, reduced) against ``repro.models.moe`` and the JAX package's
serving paths.

Weights come from the reference's inits and cross with
``params_from_reference``; inputs are made with numpy from a seed.  Held:

* routing exactly: expert ids (the lower id first among tied
  probabilities, as ``jax.lax.top_k``), positions within an expert,
  ``keep`` and the dropped count;
* in f32, y to atol = rtol = 1e-5 and aux to rtol 1e-6 (sums run in
  another order);
* the decode-consistency case of ``tests/test_decode_consistency.py``
  (decode within 2e-3 of the full forward), and in f32 compute both sides
  to the JAX numbers at ``tests/test_torch_models.py``'s 1e-4;
* greedy ids of olmoe-1b-7b (reduced) through ``prefill_and_decode`` equal
  the JAX ``launch.serve`` path's (the continuous engine's are held in
  ``tests/test_torch_serve.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.config import MoEConfig as JMoE  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.config import MoEConfig as TMoE  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

ATOL = RTOL = 1e-5
LOGIT_TOL = 1e-4  # tests/test_torch_models.py

BASE = dict(name="moe", num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
            vocab_size=128, head_dim=16, compute_dtype="float32", param_dtype="float32")
#: the MoE FFN cases: (experts, top-k, capacity factor, shared experts, router skew)
CASES = {
    "plain": (4, 2, 2.0, 0, 0.0),
    "shared": (4, 2, 2.0, 1, 0.0),  # tests/test_decode_consistency.py's moe case
    "drops": (4, 2, 1.0, 0, 3.0),  # cf 1.0 and a skewed router: capacity drops
    "olmoe-like": (16, 4, 1.25, 0, 0.0),
}


def _cfgs(case, **changes):
    E, k, cf, shared, _ = CASES[case]
    moe = dict(num_experts=E, top_k=k, d_ff_expert=64, num_shared_experts=shared,
               d_ff_shared=64 if shared else 0, capacity_factor=cf)
    kw = dict(BASE, **changes)
    return JConfig(moe=JMoE(**moe), **kw), TConfig(moe=TMoE(**moe), **kw)


def _params(jc, case, seed=0):
    jp = j_moe.moe_init(jax.random.key(seed), jc)
    skew = CASES[case][4]
    if skew:
        jp["router"]["kernel"] = jp["router"]["kernel"].at[:, 0].add(skew / np.sqrt(jc.d_model))
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _x(jc, B=2, T=12, seed=1, shift=0.0):
    return (np.random.default_rng(seed).normal(size=(B, T, jc.d_model)) + shift).astype(np.float32)


def _jax_routing(jp, jc, x):
    """The reference's routing, per row: ids, positions, keep."""
    m = jc.moe
    B, T, _ = x.shape
    C = max(1, int(m.capacity_factor * T * m.top_k / m.num_experts))
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"]["kernel"], axis=-1)
    _, ids = jax.lax.top_k(probs, m.top_k)
    pos = jax.vmap(lambda r: j_moe._positions_in_expert(r.reshape(-1), m.num_experts))(ids)
    return np.asarray(ids), np.asarray(pos), np.asarray(pos) < C


# ----------------------------------------------------------------------------
# The dispatch rank and the routing
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "all-equal", "one-each", "runs"])
def test_positions_in_expert_match_jax(kind):
    rng = np.random.default_rng(0)
    ids = {"random": rng.integers(0, 8, size=200), "all-equal": np.full(64, 3),
           "one-each": rng.permutation(16), "runs": np.repeat([2, 0, 2, 1], 5)}[kind]
    ids = ids.astype(np.int32)
    want = np.asarray(j_moe._positions_in_expert(jnp.asarray(ids), 8))
    got = t_moe._positions_in_expert(torch.from_numpy(ids), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # batched over a leading axis, row by row the same
    two = t_moe._positions_in_expert(torch.from_numpy(np.stack([ids, ids[::-1].copy()])), 8)
    np.testing.assert_array_equal(two[0].numpy(), want)
    np.testing.assert_array_equal(
        two[1].numpy(), np.asarray(j_moe._positions_in_expert(jnp.asarray(ids[::-1]), 8)))


@pytest.mark.parametrize("case", list(CASES))
def test_routing_and_drops_match_jax_exactly(case):
    jc, tc = _cfgs(case)
    jp, tp = _params(jc, case)
    x = _x(jc, T=16, shift=1.0 if CASES[case][4] else 0.0)
    j_ids, j_pos, j_keep = _jax_routing(jp, jc, x)
    _, _, t_ids = t_moe.route(tp, tc, torch.from_numpy(x))
    np.testing.assert_array_equal(t_ids.numpy(), j_ids)
    m = tc.moe
    C = max(1, int(m.capacity_factor * 16 * m.top_k / m.num_experts))
    dest, keep = t_moe.dispatch(t_ids, C, m.num_experts)
    B = x.shape[0]
    np.testing.assert_array_equal(keep.numpy(), j_keep)
    t_pos = t_moe._positions_in_expert(t_ids.reshape(B, -1), m.num_experts)
    np.testing.assert_array_equal(t_pos.numpy(), j_pos)
    dropped = int((~keep).sum())
    assert dropped == int((~j_keep).sum())
    if case == "drops":
        assert dropped > 0
    # kept entries land in distinct rows; dropped ones in the trash row only
    for b in range(B):
        kept = dest[b][keep[b]]
        assert len(set(kept.tolist())) == len(kept)
        assert bool((dest[b][~keep[b]] == m.num_experts * C).all())


def test_router_ties_take_the_lower_expert_first():
    """Tied probabilities (two equal router columns; an all-zero router):
    the ids come in the order ``jax.lax.top_k`` gives them."""
    jc, tc = _cfgs("olmoe-like")
    jp, _ = _params(jc, "olmoe-like")
    x = _x(jc)
    for kernel in (np.repeat(np.asarray(jp["router"]["kernel"])[:, :8], 2, axis=1),
                   np.zeros((jc.d_model, 16), np.float32)):
        jq = dict(jp, router={"kernel": jnp.asarray(kernel)})
        tq = params_from_reference(jax.tree.map(np.asarray, jq), "cpu")
        j_ids, _, _ = _jax_routing(jq, jc, x)
        _, _, t_ids = t_moe.route(tq, tc, torch.from_numpy(x))
        np.testing.assert_array_equal(t_ids.numpy(), j_ids)
    np.testing.assert_array_equal(t_ids.numpy()[0, 0], [0, 1, 2, 3])


# ----------------------------------------------------------------------------
# moe_apply
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_jax(case):
    jc, tc = _cfgs(case)
    jp, tp = _params(jc, case)
    x = _x(jc, T=16, shift=1.0 if CASES[case][4] else 0.0)
    jy, jaux = j_moe.moe_apply(jp, jc, jnp.asarray(x))
    ty, taux = t_moe.moe_apply(tp, tc, torch.from_numpy(x))
    assert ty.shape == x.shape and ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_moe_apply_bf16_compute_matches_jax():
    """bf16 activations (expert stacks cast as ``compute_params`` casts
    them): y within 3e-2 (the JAX package's bf16 attention limit) plus
    2^-6 of |y| (two bf16 roundings apart: the routed sum and the shared
    expert's add each round once), and aux, read in f32, to rtol 1e-6."""
    jc, tc = _cfgs("shared")
    jp, tp = _params(jc, "shared")
    x = _x(jc, T=16)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    jy, jaux = j_moe.moe_apply(jp, jc, xb)
    w = t_tf.compute_params({"ffn": tp}, tc.replace(compute_dtype="bfloat16"))["ffn"]
    assert w["experts"]["w_gate"].dtype == torch.bfloat16
    assert w["router"]["kernel"].dtype == torch.float32
    ty, taux = t_moe.moe_apply(w, tc, torch.from_numpy(x).bfloat16())
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy, np.float32), atol=3e-2,
                               rtol=2.0 ** -6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_combine_adds_the_slots_in_order():
    """In bf16, y is a token's k slots added one after another from slot 0
    (the order of the reference's ``.at[tok].add``), bit for bit: the same
    routing, dispatch and expert products, then k bf16 adds.  One f32 sum
    over the slots, rounded once, is another function of the same
    entries."""
    jc, tc = _cfgs("olmoe-like")
    _, tp = _params(jc, "olmoe-like")
    x = torch.from_numpy(_x(jc, T=8)).bfloat16()
    y, _ = t_moe.moe_apply(tp, tc, x)
    m = tc.moe
    B, T, d = x.shape
    C = max(1, int(m.capacity_factor * T * m.top_k / m.num_experts))
    _, gates, ids = t_moe.route(tp, tc, x)
    dest, keep = t_moe.dispatch(ids, C, m.num_experts)
    rows = torch.arange(B)[:, None]
    buf = torch.zeros((B, m.num_experts * C + 1, d), dtype=torch.bfloat16)
    buf[rows, dest] = x.repeat_interleave(m.top_k, dim=1)
    xe = buf[:, :-1].reshape(B, m.num_experts, C, d)
    w = {k: v.bfloat16() for k, v in tp["experts"].items()}
    h = torch.einsum("becf,efd->becd",
                     torch.nn.functional.silu(torch.einsum("becd,edf->becf", xe, w["w_gate"]))
                     * torch.einsum("becd,edf->becf", xe, w["w_up"]), w["w_down"])
    ent = h.reshape(B, -1, d)[rows, dest.clamp(max=m.num_experts * C - 1)]
    ent = (torch.where(keep[..., None], ent, 0.0) * gates.reshape(B, -1, 1).bfloat16())
    ent = ent.reshape(B, T, m.top_k, d)
    want = ent[:, :, 0]
    for j in range(1, m.top_k):
        want = want + ent[:, :, j]
    assert torch.equal(y, want)
    assert not torch.equal(y, ent.float().sum(dim=2).bfloat16())


# ----------------------------------------------------------------------------
# The MoE model
# ----------------------------------------------------------------------------


def _model(jc, seed=0):
    jp = j_tf.init_params(jax.random.key(seed), jc)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_decode_matches_full_forward_and_jax(compute):
    """``tests/test_decode_consistency.py``'s moe case (a shared expert,
    cf 2.0, bf16 compute) through the port: decode within 2e-3 of the full
    forward.  In f32 compute both are also held to the JAX numbers at 1e-4
    (in bf16 the two packages' roundings part by a few bf16 steps of the
    logits)."""
    kw = {k: v for k, v in BASE.items() if k not in ("compute_dtype", "param_dtype", "name")}
    moe = dict(num_experts=4, top_k=2, d_ff_expert=64, num_shared_experts=1, d_ff_shared=64,
               capacity_factor=2.0)
    jc, tc = JConfig(moe=JMoE(**moe), **kw), TConfig(moe=TMoE(**moe), **kw)
    assert tc.compute_dtype == "bfloat16"  # the reference case's default
    jc, tc = jc.replace(compute_dtype=compute), tc.replace(compute_dtype=compute)
    jp, tp = _model(jc)
    T, B = 12, 2
    toks = np.asarray(jax.random.randint(jax.random.key(1), (B, T), 0, jc.vocab_size))
    t_full, t_aux, _ = t_tf.forward(tp, tc, torch.from_numpy(toks).long())
    cache = t_tf.init_cache(tc, B, T, torch.float32)
    outs = []
    for t in range(T):
        lg, cache = t_tf.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]).long(), cache)
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    assert float((t_full - dec).abs().max()) < 2e-3
    if compute == "bfloat16":
        return
    j_full, j_aux, _ = j_tf.forward(jp, jc, jnp.asarray(toks))
    jcache = j_tf.init_cache(jc, B, T, jnp.float32)
    j_decode = jax.jit(j_tf.decode_step, static_argnames=("cfg",))
    jouts = []
    for t in range(T):
        jlg, jcache = j_decode(jp, jc, jnp.asarray(toks[:, t:t + 1]), jcache)
        jouts.append(np.asarray(jlg[:, 0]))
    np.testing.assert_allclose(t_full.numpy(), np.asarray(j_full), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(dec.numpy(), np.stack(jouts, 1), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-6)


def test_olmoe_forward_and_aux_match_jax():
    jc, tc = j_get_config("olmoe-1b-7b").reduced(), t_get_config("olmoe-1b-7b").reduced()
    jp, tp = _model(jc)
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, size=(2, 9)).astype(np.int32)
    jl, ja, _ = j_tf.forward(jp, jc, jnp.asarray(toks))
    tl, ta, _ = t_tf.forward(tp, tc, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_olmoe_greedy_ids_match_jax_launch_serve():
    jc, tc = j_get_config("olmoe-1b-7b").reduced(), t_get_config("olmoe-1b-7b").reduced()
    jp, tp = _model(jc)
    prompts = np.random.default_rng(3).integers(0, jc.vocab_size, size=(3, 7)).astype(np.int32)
    want = np.asarray(j_serve.prefill_and_decode(jc, jp, jnp.asarray(prompts), gen=6,
                                                 cache_len=14))
    got = t_serve.prefill_and_decode(tc, tp, torch.from_numpy(prompts), gen=6, cache_len=14)
    np.testing.assert_array_equal(got.numpy(), want)
    loop = t_serve.prefill_and_decode(tc, tp, torch.from_numpy(prompts), gen=6, cache_len=14,
                                      prefill="loop")
    assert loop.shape == got.shape


def test_compute_params_keeps_router_and_casts_experts_once():
    tc = t_get_config("olmoe-1b-7b").reduced().replace(compute_dtype="bfloat16")
    p = t_tf.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    w = t_tf.compute_params(p, tc)
    ffn, wf = p["seg0"]["l0"]["ffn"], w["seg0"]["l0"]["ffn"]
    assert wf["router"]["kernel"] is ffn["router"]["kernel"]
    assert all(wf["experts"][n].dtype == torch.bfloat16 for n in ("w_gate", "w_up", "w_down"))
    assert torch.equal(wf["experts"]["w_up"], ffn["experts"]["w_up"].bfloat16())
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tc.vocab_size, size=(2, 6)))
    a, a_aux, _ = t_tf.forward(p, tc, toks)
    b, b_aux, _ = t_tf.forward(w, tc, toks)
    assert torch.equal(a, b) and torch.equal(a_aux, b_aux)


def test_config_and_specs_match_reference():
    j, t = j_get_config("olmoe-1b-7b"), t_get_config("olmoe-1b-7b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [(s.mixer, s.ffn) for s in t_tf.layer_specs(t)] == \
           [(s.mixer, s.ffn) for s in j_tf.layer_specs(j)]


@pytest.mark.parametrize("arch,continuous", [
    ("olmoe-1b-7b", True), ("olmoe-1b-7b", False), ("minicpm3-4b", False),
    ("deepseek-v3-671b", False),
])
def test_launch_serve_reaches_the_mla_and_moe_code(arch, continuous, monkeypatch, capsys):
    """``launch.serve --arch <arch> --reduced`` (with and without
    ``--continuous``) runs the new mixers and FFNs: every request gets its
    ids, and the MoE router / MLA attention were called."""
    from repro_torch.models import mla as t_mla

    calls = {"route": 0, "mla": 0}
    route, mla_apply = t_moe.route, t_mla.mla_apply

    def counted_route(*a, **k):
        calls["route"] += 1
        return route(*a, **k)

    def counted_mla(*a, **k):
        calls["mla"] += 1
        return mla_apply(*a, **k)

    monkeypatch.setattr(t_moe, "route", counted_route)
    monkeypatch.setattr(t_mla, "mla_apply", counted_mla)
    argv = ["--arch", arch, "--reduced", "--batch", "2", "--requests", "3",
            "--prompt-len", "5", "--gen", "3", "--device", "cpu"]
    outs = t_serve.main(argv + (["--continuous"] if continuous else []))
    assert np.asarray(outs).shape == (3, 3)
    cfg = t_get_config(arch)
    assert (calls["route"] > 0) == (cfg.moe is not None)
    assert (calls["mla"] > 0) == (cfg.mixer == "mla")
    assert "sample:" in capsys.readouterr().out
