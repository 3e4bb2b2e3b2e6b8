"""Port parity: the mamba mixer (``repro_torch.models.mamba``), its decode
cache and the hybrid stack (jamba-1.5-large-398b, reduced) against
``repro.models.mamba`` and ``repro.models.transformer``.

Weights come from the reference's inits and cross with
``params_from_reference``; inputs are made with numpy from a seed.  Held:

* ``mamba_apply`` in f32 compute at atol = rtol = 1e-5, at T 300 (one full
  chunk of 256 and a padded one) and T 16, without a cache and with one
  (a prefill that crosses the chunk boundary from a carried state, then
  single-token steps; both cache leaves too); in bf16 compute at 3e-2 +
  2^-6·|y| (the bf16 bound of ``tests/test_torch_mla.py``: PyTorch's CPU
  bf16 matmul rounds by row count);
* the in-chunk doubling scan against the step-by-step recurrence;
* the decode-consistency cases of ``tests/test_decode_consistency.py``:
  the hybrid's decode within 2e-3 of its forward (the reference's bound),
  pure mamba's forward and per-step decode each held to the reference's
  at 1e-4 (its own chunked-forward comparison is ``xfail`` there);
* jamba-1.5-large-398b ``reduced()``: forward, one train step and one
  decode step (``tests/torch_arch_parity.py``);
* a JAX ``MambaCache`` crosses with ``convert`` and the decode resumes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_arch_parity as arch  # noqa: E402
from torch_arch_parity import one_thread  # noqa: E402,F401
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import cache as j_cache  # noqa: E402
from repro.models import mamba as j_mamba  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoE  # noqa: E402
from repro.models.config import SSMConfig as JSSM  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import carry_from_reference, params_from_reference  # noqa: E402
from repro_torch.models import cache as t_cache  # noqa: E402
from repro_torch.models import mamba as t_mamba  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.models.config import MoEConfig as TMoE  # noqa: E402
from repro_torch.models.config import SSMConfig as TSSM  # noqa: E402

ATOL = RTOL = 1e-5
BF16_ATOL, BF16_RTOL = 3e-2, 2.0 ** -6
LOGIT_TOL = 1e-4
DECODE_VS_FORWARD = 2e-3  # tests/test_decode_consistency.py

#: tests/test_decode_consistency.py's mamba and hybrid cases
BASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
            head_dim=16, compute_dtype="float32")
CASES = {
    "mamba": dict(hybrid_pattern=("mamba",)),
    "hybrid": dict(num_layers=4, num_kv_heads=2, hybrid_pattern=("mamba", "attn"),
                   moe=dict(num_experts=4, top_k=2, d_ff_expert=64, layer_mode="every_other",
                            capacity_factor=2.0)),
}


def _cfgs(case="mamba", **changes):
    kw = {**BASE, **CASES[case], **changes}
    moe = kw.pop("moe", None)
    jc = JConfig(ssm=JSSM(), moe=JMoE(**moe) if moe else None, **kw)
    tc = TConfig(ssm=TSSM(), moe=TMoE(**moe) if moe else None, **kw)
    return jc, tc


def _mixer(jc, seed=0):
    jp = j_mamba.mamba_init(jax.random.key(seed), jc)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _x(B, T, d, seed):
    return np.random.default_rng(seed).normal(size=(B, T, d)).astype(np.float32)


def _close(got, want, compute="float32"):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    if compute == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=BF16_RTOL)


def test_mamba_cache_init_matches_reference():
    jc = j_cache.mamba_cache_init(2, 4, 128, 16, jnp.bfloat16)
    tc = t_cache.mamba_cache_init(2, 4, 128, 16, torch.bfloat16)
    assert tc.conv.shape == jc.conv.shape and tc.conv.dtype == torch.bfloat16
    assert tc.ssm.shape == jc.ssm.shape and tc.ssm.dtype == torch.float32  # the state stays f32
    assert not bool(tc.conv.any()) and not bool(tc.ssm.any())
    assert t_cache.MambaCache._fields == j_cache.MambaCache._fields


@pytest.mark.parametrize("L", [1, 5, 64, 256])
def test_doubling_scan_is_the_recurrence(L):
    """The in-chunk scan against h_t = a_t·h_{t−1} + b_t step by step from a
    carried state, a ∈ (0, 1] as exp(dt·A) makes it."""
    g = torch.Generator().manual_seed(L)
    a = torch.rand((2, L, 8, 4), generator=g)
    b = torch.randn((2, L, 8, 4), generator=g)
    h0 = torch.randn((2, 8, 4), generator=g)
    last, hs = t_mamba._ssm_chunk(h0, a, b)
    h, want = h0, []
    for t in range(L):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(hs, torch.stack(want, 1), atol=ATOL, rtol=RTOL)
    assert torch.equal(last, hs[:, -1])


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [300, 16])
def test_mamba_apply_matches_jax(T, compute):
    jc, tc = _cfgs(compute_dtype=compute)
    jp, tp = _mixer(jc)
    x = _x(2, T, jc.d_model, T)
    cd_j, cd_t = jnp.dtype(compute), getattr(torch, compute)
    jy, jn = jax.jit(lambda p, x: j_mamba.mamba_apply(p, jc, x))(jp, jnp.asarray(x).astype(cd_j))
    ty, tn = t_mamba.mamba_apply(tp, tc, torch.from_numpy(x).to(cd_t))
    assert jn is None and tn is None and ty.dtype == cd_t and ty.shape == (2, T, jc.d_model)
    _close(ty, jy, compute)


def test_mamba_cached_prefill_and_steps_match_jax():
    """A prefill of 300 tokens into a cache that already holds a state (the
    chunk boundary crossed from a carried state; the final state from
    position 299, not the padding), then three single-token steps: the
    outputs and both cache leaves after each call."""
    jc, tc = _cfgs()
    jp, tp = _mixer(jc, seed=1)
    d_inner = 2 * jc.d_model
    jcache = j_cache.mamba_cache_init(2, 4, d_inner, 16, jnp.float32)
    tcache = t_cache.mamba_cache_init(2, 4, d_inner, 16, torch.float32)
    apply = jax.jit(lambda p, x, c: j_mamba.mamba_apply(p, jc, x, cache=c))
    for i, T in enumerate((5, 300, 1, 1, 1)):
        x = _x(2, T, jc.d_model, 10 + i)
        jy, jcache = apply(jp, jnp.asarray(x), jcache)
        ty, tcache = t_mamba.mamba_apply(tp, tc, torch.from_numpy(x), cache=tcache)
        _close(ty, jy)
        _close(tcache.conv, jcache.conv)
        _close(tcache.ssm, jcache.ssm)
        assert tcache.ssm.dtype == torch.float32


def test_mamba_keeps_A_log_and_D_in_f32():
    """``A_log`` and ``D`` are f32 whatever the parameter type, and
    ``compute_params`` casts the projections but leaves them and the conv
    weights as they are (the mixer casts the conv weights when it reads
    them)."""
    _, tc = _cfgs("hybrid", param_dtype="bfloat16", compute_dtype="bfloat16")
    p = t_tf.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    w = t_tf.compute_params(p, tc)
    m, wm = p["seg0"]["l0"]["mixer"], w["seg0"]["l0"]["mixer"]
    assert m["A_log"].dtype == m["D"].dtype == torch.float32
    assert m["conv_w"].dtype == torch.bfloat16
    for leaf in ("A_log", "D", "conv_w", "conv_b"):
        assert wm[leaf] is m[leaf]
    f32 = tc.replace(param_dtype="float32")
    w32 = t_tf.compute_params(t_tf.init_params(torch.Generator(), f32, device="cpu"), f32)
    assert w32["seg0"]["l0"]["mixer"]["A_log"].dtype == torch.float32
    assert w32["seg0"]["l0"]["mixer"]["in_proj"]["kernel"].dtype == torch.bfloat16


def _model(jc, seed=0):
    jp = j_tf.init_params(jax.random.key(seed), jc)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def test_decode_matches_full_forward_and_jax():
    """Pure mamba: the forward and the per-step decode each against the
    reference's (its own decode-against-forward comparison is ``xfail``)."""
    jc, tc = _cfgs("mamba")
    jp, tp = _model(jc)
    B, T = 2, 12
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, size=(B, T))
    forward, step = arch.jax_steps(jc)
    jfull = np.asarray(forward(jp, jnp.asarray(toks)))
    jdec = arch.decode_all(step, jp, toks, j_tf.init_cache(jc, B, T, jnp.float32), jnp.asarray)
    with torch.no_grad():
        tfull = t_tf.forward(tp, tc, torch.from_numpy(toks))[0].numpy()
        tdec = _port_decode(tp, tc, toks)
    np.testing.assert_allclose(tfull, jfull, atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(tdec, jdec, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_hybrid_decode_matches_full_forward():
    """Mamba, attention and MoE: decode within the reference's 2e-3 of the
    forward (the JAX numbers: the jamba and resume tests below)."""
    jc, tc = _cfgs("hybrid")
    _, tp = _model(jc)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, size=(2, 12))
    with torch.no_grad():
        full = t_tf.forward(tp, tc, torch.from_numpy(toks))[0].numpy()
        assert float(np.abs(_port_decode(tp, tc, toks) - full).max()) < DECODE_VS_FORWARD


def _port_decode(tp, tc, toks):
    cache = t_tf.init_cache(tc, toks.shape[0], toks.shape[1], torch.float32)
    return arch.decode_all(lambda p, t, c: t_tf.decode_step(p, tc, t, c), tp, toks, cache,
                           torch.from_numpy)


def test_jax_mamba_state_resumes_in_the_port():
    """A JAX decode state of the hybrid stack (mamba and attention layers)
    crosses with ``carry_from_reference`` and the port's next step gives the
    JAX step's logits."""
    jc, tc = _cfgs("hybrid")
    jp, tp = _model(jc)
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, size=(2, 7))
    _, step = arch.jax_steps(jc)
    jcache = j_tf.init_cache(jc, 2, 8, jnp.float32)
    for t in range(6):
        _, jcache = step(jp, jnp.asarray(toks[:, t:t + 1]), jcache)
    tcache = carry_from_reference(jax.tree.map(np.asarray, jcache), "cpu")
    assert isinstance(tcache["seg0"]["l0"], t_cache.MambaCache)
    assert tcache["seg0"]["l1"].index == 6  # one host int for the stack
    want, _ = step(jp, jnp.asarray(toks[:, 6:7]), jcache)
    got, _ = t_tf.decode_step(tp, tc, torch.from_numpy(toks[:, 6:7]), tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.fixture(scope="module")
def jamba():
    return arch.run("jamba-1.5-large-398b")


def test_jamba_reduced_forward_matches_jax(jamba):
    arch.check_logits(jamba["port"]["logits"], jamba["jax"]["logits"], jamba["cfg"].vocab_size)


def test_jamba_reduced_train_step_matches_jax(jamba):
    assert jamba["port"]["metrics"]["aux"] > 0  # MoE on every other layer
    arch.check_train_step(jamba)


def test_jamba_reduced_decode_step_matches_jax(jamba):
    arch.check_logits(jamba["port"]["decode"], jamba["jax"]["decode"], jamba["cfg"].vocab_size)


def test_jamba_config_and_segments_match_reference():
    j, t = j_get_config("jamba-1.5-large-398b"), t_get_config("jamba-1.5-large-398b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    for jc, tc in ((j, t), (j.reduced(), t.reduced())):
        assert [(s.mixer, s.ffn) for s in t_tf.layer_specs(tc)] == \
               [(s.mixer, s.ffn) for s in j_tf.layer_specs(jc)]
        assert [([(u.mixer, u.ffn) for u in s.unit], s.repeats) for s in t_tf.segments(tc)] == \
               [([(u.mixer, u.ffn) for u in s.unit], s.repeats) for s in j_tf.segments(jc)]
    assert [s.repeats for s in t_tf.segments(t)] == [9]  # 8 mixers × MoE every other layer
