"""The port's launch specs against the JAX package's
(``tests/test_launch.py``): configs adapted to the four input shapes,
input / cache / batch specs, the train step with gradient accumulation,
and the prefill and serve steps, on the host mesh.

The reference's own launch tests that lower under a mesh context fail
under jax 0.9.0 (ROADMAP queue 3, item 2), so the JAX steps here run
without a mesh context, where its ``maybe_shard`` is the identity."""

from __future__ import annotations

import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, SHAPES  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models import whisper as j_whisper  # noqa: E402
from repro.optim import optimizers as j_optim  # noqa: E402
from repro_torch.configs import SHAPES as T_SHAPES  # noqa: E402
from repro_torch.configs import applicable  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import carry_from_reference, params_from_reference  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.optim import optimizers as t_optim  # noqa: E402
from repro_torch.sharding import rules as t_rules  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # tests/test_torch_train.py
FEW = 2e-4  # tests/test_torch_train.py: θ's share allowed outside rtol/atol
LOGIT_TOL = 1e-4  # tests/test_torch_models.py
BF16_RTOL = 2.0 ** -7  # one bf16 rounding step of a cache row

_DTYPES = {jnp.dtype(jnp.int32): torch.int32, jnp.dtype(jnp.float32): torch.float32,
           jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _path(p) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in p)


def j_shapes(tree) -> dict:
    return {_path(p): (tuple(x.shape), _DTYPES[jnp.dtype(x.dtype)])
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def t_shapes(tree) -> dict:
    return {_path(p): (tuple(x.shape), x.dtype)
            for p, x in torch.utils._pytree.tree_flatten_with_path(tree)[0]
            if isinstance(x, torch.Tensor)}


def _cfg_dict(cfg) -> dict:
    """Every field, sub-configs included, tuples and lists alike."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


# ----------------------------------------------------------------------------
# Shapes and configs
# ----------------------------------------------------------------------------


def test_launch_shapes_and_skip_table_as_reference():
    from repro.configs import applicable as j_applicable

    assert {k: dataclasses.astuple(v) for k, v in T_SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in SHAPES.items()}
    for arch in ARCHS:
        for shape in SHAPES:
            assert applicable(arch, shape) == j_applicable(arch, shape)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_shape_adapted_config_matches_reference(arch, shape):
    """Every field of the adapted config, the sub-configs included."""
    assert _cfg_dict(t_specs.shape_adapted_config(arch, shape)) == _cfg_dict(
        j_specs.shape_adapted_config(arch, shape))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch, shape):
    """Shapes and types of every input, the whisper memory / frames, the
    VLM's vision prefix and M-RoPE positions and the decode cache
    included; the port's are meta tensors (no storage).  The reference's
    caches carry an int32 fill index a layer, the port's one host int."""
    got = t_specs.input_specs(arch, shape)
    want = j_specs.input_specs(arch, shape)
    assert set(got) == set(want)
    t_leaves = torch.utils._pytree.tree_leaves(got)
    assert all(x.device.type == "meta" for x in t_leaves if isinstance(x, torch.Tensor))
    jw = {k: v for k, v in j_shapes(want).items() if not k.endswith("/index")}
    assert t_shapes(got) == jw
    idx = [x for x in t_leaves if isinstance(x, int)]
    n_index = sum(k.endswith("/index") for k in j_shapes(want))
    assert len(idx) == n_index and set(idx) <= {SHAPES[shape].seq_len - 1}


def test_input_specs_cover_all_shapes():
    """``tests/test_launch.py::test_input_specs_cover_all_shapes`` on the port."""
    for arch in ("tinyllama-1.1b", "whisper-base", "qwen2-vl-2b", "jamba-1.5-large-398b"):
        for shape in T_SHAPES:
            specs = t_specs.input_specs(arch, shape)
            assert "tokens" in specs
            leaves = torch.utils._pytree.tree_leaves(specs)
            assert all(hasattr(x, "shape") for x in leaves if not isinstance(x, int))


def test_shape_adapted_config_rules():
    """``tests/test_launch.py::test_shape_adapted_config_rules`` on the port."""
    S = t_specs
    assert S.shape_adapted_config("tinyllama-1.1b", "long_500k").sliding_window == 8192
    assert S.shape_adapted_config("xlstm-125m", "long_500k").sliding_window == 0
    assert S.shape_adapted_config("tinyllama-1.1b", "train_4k").remat_policy == "full"
    assert S.shape_adapted_config("deepseek-v3-671b", "decode_32k").num_mtp_layers == 0
    assert S.shape_adapted_config("deepseek-v3-671b", "train_4k").param_dtype == "bfloat16"


def test_concrete_inputs_match_the_specs():
    got = t_specs.concrete_inputs("tinyllama-1.1b", "train_4k", seed=3, device="cpu")
    specs = t_specs.input_specs("tinyllama-1.1b", "train_4k")
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in specs.items()}
    assert all(v.device.type == "cpu" for v in got.values())
    assert int(got["tokens"].max()) < 32000 - 1 and int(got["tokens"].min()) >= 0
    again = t_specs.concrete_inputs("tinyllama-1.1b", "train_4k", seed=3, device="cpu")
    assert torch.equal(got["tokens"], again["tokens"])
    if not torch.cuda.is_available():  # the default is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            t_specs.concrete_inputs("tinyllama-1.1b", "train_4k", seed=3)


def _reduced_moe_cfgs():
    from repro.models.config import ModelConfig as JC, MoEConfig as JM
    from repro_torch.models.config import ModelConfig as TC, MoEConfig as TM

    kw = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
              vocab_size=512, head_dim=16)
    return (JC(**kw, moe=JM(num_experts=4, top_k=2, d_ff_expert=64)),
            TC(**kw, moe=TM(num_experts=4, top_k=2, d_ff_expert=64)))


def _host_jmesh():
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))


def test_cache_specs_structure():
    """``tests/test_sharding.py::test_cache_specs_structure`` on the port:
    the spec tree has ``init_cache``'s structure, and equals the
    reference's spec for spec."""
    from repro.sharding.rules import P as JP  # noqa: N814

    jc, tc = _reduced_moe_cfgs()
    cspecs = t_specs.cache_specs(tc, make_host_mesh(), B=4)
    cache = t_tf.init_cache(tc, 4, 16, torch.float32, device="meta")
    spec_struct = torch.utils._pytree.tree_structure(
        torch.utils._pytree.tree_map(lambda _: 0, cspecs,
                                     is_leaf=lambda s: isinstance(s, t_rules.P)))
    assert spec_struct == torch.utils._pytree.tree_structure(
        torch.utils._pytree.tree_map(lambda _: 0, cache))
    want = j_specs.cache_specs(jc, _host_jmesh(), B=4)
    jl = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda s: isinstance(s, JP))[0]
    tl = torch.utils._pytree.tree_flatten_with_path(
        cspecs, is_leaf=lambda s: isinstance(s, t_rules.P))[0]
    assert {_path(p): tuple(s) for p, s in tl} == {_path(p): tuple(s) for p, s in jl}


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-vl-2b", "whisper-base",
                                  "jamba-1.5-large-398b", "xlstm-125m", "deepseek-v3-671b"])
def test_cache_and_batch_specs_every_strategy(arch):
    """``cache_specs`` and ``batch_specs`` (six strategies) on the host
    mesh, spec for spec, at the decode_32k and train_4k batches."""
    from repro.sharding.rules import P as JP  # noqa: N814

    for shape in ("train_4k", "decode_32k"):
        s = SHAPES[shape]
        jc = j_specs.shape_adapted_config(arch, shape)
        tc = t_specs.shape_adapted_config(arch, shape)
        jin = j_specs.input_specs_for(jc, s.kind, s.global_batch, s.seq_len)
        tin = t_specs.input_specs_for(tc, s.kind, s.global_batch, s.seq_len)
        for strategy in ("tp", "dp", "dp_fsdp", "kvseq", "serve", "ep2d"):
            got = t_specs.batch_specs(tin, make_host_mesh(), s.global_batch, strategy=strategy)
            want = j_specs.batch_specs(jin, _host_jmesh(), s.global_batch, strategy=strategy)
            assert {k: tuple(v) for k, v in got.items()} == {
                k: tuple(v) for k, v in want.items()}
        if s.kind == "decode":
            got = t_specs.cache_specs(tc, make_host_mesh(), s.global_batch)
            want = j_specs.cache_specs(jc, _host_jmesh(), s.global_batch)
            jl = jax.tree_util.tree_flatten_with_path(want, is_leaf=lambda x: isinstance(x, JP))
            tl = torch.utils._pytree.tree_flatten_with_path(
                got, is_leaf=lambda x: isinstance(x, t_rules.P))
            assert {_path(p): tuple(v) for p, v in tl[0]} == {
                _path(p): tuple(v) for p, v in jl[0]}


def test_mesh_context_as_reference():
    for arch in ("tinyllama-1.1b", "deepseek-v3-671b"):
        for strategy in ("tp", "dp", "dp_fsdp", "kvseq"):
            tc = t_specs.shape_adapted_config(arch, "train_4k")
            got = t_specs.make_mesh_context_for(make_host_mesh(), tc, 256, strategy=strategy)
            want = j_specs.make_mesh_context_for(_host_jmesh(), tc, 256, strategy=strategy)
            assert (got.logical, got.fsdp) == (want.logical, want.fsdp)


# ----------------------------------------------------------------------------
# The steps on the host mesh
# ----------------------------------------------------------------------------

B, T = 2, 16


@functools.lru_cache(maxsize=None)
def reduced(arch):
    jc, tc = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    init = j_whisper.init_params if jc.is_encoder_decoder else j_tf.init_params
    return jc, tc, init(jax.random.key(0), jc)


def _batch(cfg, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab_size, size=(B, T)).astype(np.int32)}


def _flat(tree) -> dict:
    if isinstance(torch.utils._pytree.tree_leaves(tree)[0], torch.Tensor):
        return {_path(p): x.detach().float().numpy()
                for p, x in torch.utils._pytree.tree_flatten_with_path(tree)[0]}
    return {_path(p): np.asarray(x, np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _theta_close(j_theta, t_theta, lr):
    """θ to rtol/atol in all but ``FEW`` of its elements, each within
    2·lr: Adam divides a gradient straddling zero by its own magnitude,
    so a last-bit difference becomes a step of ±lr
    (``tests/test_torch_train.py``'s ``_theta_close``)."""
    jf, tf_ = _flat(j_theta), _flat(t_theta)
    assert sorted(jf) == sorted(tf_)
    outside = total = 0
    for k, a in jf.items():
        d = np.abs(tf_[k] - a)
        assert d.max() <= 2 * lr, (k, float(d.max()))
        outside += int((d > ATOL + RTOL * np.abs(a)).sum())
        total += a.size
    assert outside <= FEW * total, (outside, total)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b", "xlstm-125m"])
def test_make_train_step_matches_reference(arch, microbatches):
    """One step of clip ∘ Adam(warmup-cosine) at B 2 × T 16, the whole
    batch or accumulated over 2 microbatches: the loss and θ after the
    step against the reference's ``make_train_step`` (jitted, no mesh
    context), on the same parameters."""
    jc, tc, jp = reduced(arch)
    batch = _batch(jc)
    jo = j_specs.make_optimizer(jc)
    jstep = jax.jit(j_specs.make_train_step(jc, jo, microbatches=microbatches))
    jp2, _, jm = jstep(jp, jo.init(jp), jax.tree.map(jnp.asarray, batch))

    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    to = t_specs.make_optimizer(tc)
    tstep = t_specs.make_train_step(tc, to, microbatches=microbatches)
    tp2, tos, tm = tstep(tp, to.init(tp), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=RTOL, atol=ATOL)
    assert set(tm) == set(jm)
    assert int(tos["count"]) == 1
    _theta_close(jp2, tp2, lr=3e-4 / 100)  # the schedule's rate at step 1


GRAD_TOL = 1e-5  # tests/test_torch_train.py: × the leaf's max |g|


def _grads_close(got: dict, want: dict):
    """Each leaf within ``GRAD_TOL`` × its max |g|.  sLSTM's input-gate bias
    (the block with recurrent ``r_i``) has gradient 0 in exact arithmetic:
    a shift of every input preactivation scales the cell and its
    normalizer alike, and h is their ratio.  What f32 computes there is
    rounding noise, held on both sides to ``GRAD_TOL`` × the tree's max
    |g|."""
    assert sorted(got) == sorted(want)
    tree_max = max(float(np.abs(a).max()) for a in want.values())
    for k, a in want.items():
        if k.endswith("mixer/w_i/bias") and k.replace("w_i/bias", "r_i") in want:
            assert max(np.abs(a).max(), np.abs(got[k]).max()) <= GRAD_TOL * tree_max, k
            continue
        scale = max(float(np.abs(a).max()), 1e-30)
        np.testing.assert_allclose(got[k], a, rtol=0, atol=GRAD_TOL * scale, err_msg=k)


def _train_grads(specs, cfg, params, batch, microbatches, *, jitted):
    """The gradients ``make_train_step`` hands its optimizer: an optimizer
    that moves nothing and keeps them as its new state."""
    if jitted:
        zeros = lambda t: jax.tree.map(lambda x: jnp.zeros(x.shape, jnp.float32), t)  # noqa: E731
        opt = j_optim.Optimizer(init=zeros, update=lambda g, s, p=None: (zeros(g), g))
        step = jax.jit(specs.make_train_step(cfg, opt, microbatches=microbatches))
    else:
        zeros = lambda t: torch.utils._pytree.tree_map(  # noqa: E731
            lambda x: torch.zeros_like(x, dtype=torch.float32), t)
        opt = t_optim.Optimizer(init=zeros, update=lambda g, s, p=None: (zeros(g), g))
        step = specs.make_train_step(cfg, opt, microbatches=microbatches)
    return _flat(step(params, opt.init(params), batch)[1])


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b", "xlstm-125m"])
def test_train_step_accumulated_grads_match_reference(arch, microbatches):
    """The f32 gradients the step hands its optimizer, whole or summed over
    2 microbatches each divided by the count, against the reference's at
    B 2 × T 16 (each leaf within 1e-5 × its max |g|).  Where the loss is a
    mean over the batch's tokens and nothing couples the rows (tinyllama,
    xlstm), the accumulated gradients are also the whole batch's: a sum
    left undivided, or divided twice, is off by a factor of 2."""
    jc, tc, jp = reduced(arch)
    batch = _batch(jc)
    want = _train_grads(j_specs, jc, jp, jax.tree.map(jnp.asarray, batch), microbatches,
                        jitted=True)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = _train_grads(t_specs, tc, tp, tbatch, microbatches, jitted=False)
    _grads_close(got, want)
    if microbatches > 1 and tc.moe is None:
        _grads_close(got, _train_grads(t_specs, tc, tp, tbatch, 1, jitted=False))


def test_train_step_accumulation_is_the_mean_of_microbatches():
    """With microbatches the step sums f32 gradients each divided by the
    count, in microbatch order: the loss is the mean of the two halves'."""
    jc, tc, jp = reduced("tinyllama-1.1b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(jc).items()}
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    halves = [t_tf.loss_fn(tp, tc, {k: v[i:i + 1] for k, v in batch.items()})[0]
              for i in range(2)]
    to = t_specs.make_optimizer(tc)
    _, _, m = t_specs.make_train_step(tc, to, microbatches=2)(tp, to.init(tp), batch)
    assert set(m) == {"loss"}
    np.testing.assert_allclose(float(m["loss"]), float(halves[0] / 2 + halves[1] / 2),
                               rtol=1e-6)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-base"])
def test_prefill_step_matches_reference(arch):
    jc, tc, jp = reduced(arch)
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, jc.vocab_size, size=(B, T)).astype(np.int32)}
    if jc.is_encoder_decoder:
        batch["frame_embeds"] = rng.normal(size=(B, jc.encoder_seq_len, jc.d_model)).astype(
            np.float32)
    want = jax.jit(j_specs.make_prefill_step(jc))(jp, jax.tree.map(jnp.asarray, batch))
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    step, args, _ = t_specs.build_jitted(tc, "prefill", make_host_mesh(), B, T)
    got = step(tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert tuple(got.shape) == tuple(want.shape) == tuple(args[1]["tokens"].shape) + (
        tc.padded_vocab,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "whisper-base"])
def test_serve_step_matches_reference(arch):
    """One decode step against a bf16 cache filled to index 4 of 24
    (``tests/test_launch.py::test_decode_step_lowers_and_runs``): logits,
    the written cache row and the advanced index; the plain kernel
    version (``decode_attn="plain"``) gives the same logits."""
    jc, tc, jp = reduced(arch)
    S, idx = 24, 4
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, jc.vocab_size, size=(B, 1)).astype(np.int32)
    if jc.is_encoder_decoder:
        jcache = j_whisper.init_decoder_cache(jc, B, S, jnp.bfloat16, index=idx)
        memory = rng.normal(size=(B, jc.encoder_seq_len, jc.d_model)).astype(np.float32)
        jbatch = {"tokens": jnp.asarray(tokens), "memory": jnp.asarray(memory), "cache": jcache}
    else:
        jcache = j_tf.init_cache(jc, B, S, jnp.bfloat16, index=idx)
        jbatch = {"tokens": jnp.asarray(tokens), "cache": jcache}
    jlogits, jnew = jax.jit(j_specs.make_serve_step(jc))(jp, jbatch)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")

    def tbatch():
        b = {"tokens": torch.from_numpy(tokens),
             "cache": carry_from_reference(jax.tree.map(np.asarray, jcache), "cpu")}
        if jc.is_encoder_decoder:
            b["memory"] = torch.from_numpy(memory)
        return b

    step, _, _ = t_specs.build_jitted(tc, "decode", make_host_mesh(), B, S)
    logits, new = step(tp, tbatch())
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
    jk = jnew.k if jc.is_encoder_decoder else jnew["seg0"]["l0"].k
    tk = new.k if jc.is_encoder_decoder else new["seg0"]["l0"].k
    np.testing.assert_allclose(tk[:, :, idx].float().numpy(),
                               np.asarray(jk[:, :, idx], np.float32), rtol=BF16_RTOL, atol=1e-6)
    assert (new.index if jc.is_encoder_decoder else new["seg0"]["l0"].index) == idx + 1
    if not jc.is_encoder_decoder:
        plain = t_specs.make_serve_step(tc, decode_attn="plain")(tp, tbatch())[0]
        np.testing.assert_allclose(plain.numpy(), logits.numpy(), atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_build_jitted_places_nothing_on_the_host_mesh():
    """On a ``SoloMesh`` the step's arguments are used as they are: the
    step is ``make_serve_step``'s, bitwise."""
    _, tc, jp = reduced("qwen2-1.5b")
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    tokens = torch.zeros((B, 1), dtype=torch.int32)
    step, args, pshape = t_specs.build_jitted(tc, "decode", make_host_mesh(), B, 8)
    assert all(x.device.type == "meta" for x in torch.utils._pytree.tree_leaves(pshape))
    a = step(tp, {"tokens": tokens, "cache": t_tf.init_cache(tc, B, 8, torch.bfloat16,
                                                              index=3)})[0]
    b = t_specs.make_serve_step(tc)(tp, {"tokens": tokens, "cache": t_tf.init_cache(
        tc, B, 8, torch.bfloat16, index=3)})[0]
    assert torch.equal(a, b)
    assert t_specs.count_params(pshape) == sum(
        x.size for x in jax.tree.leaves(jp))
