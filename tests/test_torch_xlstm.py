"""Port parity: the xLSTM blocks (``repro_torch.models.xlstm``), their decode
caches and the xLSTM stack (xlstm-125m, reduced) against
``repro.models.xlstm`` and ``repro.models.transformer``.

Weights come from the reference's inits and cross with
``params_from_reference``; inputs are made with numpy from a seed.  Held,
in f32 compute:

* ``slstm_apply`` (a loop over time in the port, ``lax.scan`` there) and
  ``mlstm_apply``'s recurrent step, with and without a cache, at atol =
  rtol = 1e-5, the new caches too;
* ``mlstm_apply``'s chunkwise-parallel form at T 300 (a chunk of 256 and
  a padded one).  That form divides by max(|n·q|, exp(−m)), and where the
  normaliser nearly cancels it turns f32 rounding into errors of ~1e-5 at
  |h| ≈ 0.5 in both packages (ROADMAP queue 3): so it is held to a
  float64 run of the recurrence within 4× the reference's own distance to
  it (the packages sum in other orders: the port's distance was 0.75× and
  2.1× the reference's on two seeds), and to the reference at the
  whole-model 1e-4;
* ``_mlstm_parallel`` against ``_mlstm_step`` unrolled, within 4× the
  reference's own gap between its two forms (the step forms agree at
  1e-5);
* the decode-consistency case of ``tests/test_decode_consistency.py``
  (decode within 2e-3 of the forward) and xlstm-125m ``reduced()``:
  forward, one train step, one decode step (``tests/torch_arch_parity.py``).
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
from repro.models import transformer as j_tf  # noqa: E402
from repro.models import xlstm as j_x  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.models.config import XLSTMConfig as JX  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import cache as t_cache  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models import xlstm as t_x  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.models.config import XLSTMConfig as TX  # noqa: E402

ATOL = RTOL = 1e-5
LOGIT_TOL = 1e-4
#: the port's f32 rounding error in mLSTM's parallel form, as a multiple of
#: the reference's (see the module docstring)
ROUNDING_RATIO = 4.0
DECODE_VS_FORWARD = 2e-3  # tests/test_decode_consistency.py

#: tests/test_decode_consistency.py's xlstm case
BASE = dict(num_layers=4, d_model=64, num_heads=4, num_kv_heads=4, d_ff=0, vocab_size=128,
            compute_dtype="float32")


def _cfgs():
    return JConfig(xlstm=JX(slstm_at=(1, 3)), **BASE), TConfig(xlstm=TX(slstm_at=(1, 3)), **BASE)


def _block(init, jc, seed):
    jp = init(jax.random.key(seed), jc)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _x(B, T, seed, d=64):
    return np.random.default_rng(seed).normal(size=(B, T, d)).astype(np.float32)


def _close(got, want, tol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=tol, rtol=tol)


def test_xlstm_cache_inits_match_reference():
    jm, tm = j_cache.mlstm_cache_init(2, 4, 32, 32), t_cache.mlstm_cache_init(2, 4, 32, 32)
    js, ts = j_cache.slstm_cache_init(2, 64), t_cache.slstm_cache_init(2, 64)
    for j, t in ((jm, tm), (js, ts)):
        assert t._fields == j._fields
        for a, b in zip(j, t):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))  # m starts at −1e30


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 101, dtype=np.float32)
    got = t_layers.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6, rtol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - got).max() > 1e-4  # the erf form would not pass the check above


@pytest.mark.parametrize("cached", [False, True], ids=["no-cache", "cache"])
def test_slstm_apply_matches_jax(cached):
    jc, tc = _cfgs()
    jp, tp = _block(j_x.slstm_init, jc, 1)
    apply = jax.jit(lambda p, x, c: j_x.slstm_apply(p, jc, x, cache=c))
    jcache = j_cache.slstm_cache_init(2, 64) if cached else None
    tcache = t_cache.slstm_cache_init(2, 64) if cached else None
    for i, T in enumerate((40, 1, 1) if cached else (40,)):
        x = _x(2, T, 20 + i)
        jy, jcache = apply(jp, jnp.asarray(x), jcache)
        ty, tcache = t_x.slstm_apply(tp, tc, torch.from_numpy(x), cache=tcache)
        _close(ty, jy)
        assert (tcache is None) == (not cached)
        if cached:
            for a, b in zip(jcache, tcache):
                _close(b, a)


def test_mlstm_step_matches_jax():
    """The decode path: ``mlstm_apply`` with a cache, one token a call."""
    jc, tc = _cfgs()
    jp, tp = _block(j_x.mlstm_init, jc, 2)
    apply = jax.jit(lambda p, x, c: j_x.mlstm_apply(p, jc, x, cache=c))
    jcache, tcache = j_cache.mlstm_cache_init(2, 4, 32, 32), t_cache.mlstm_cache_init(2, 4, 32, 32)
    for i in range(6):
        x = _x(2, 1, 30 + i)
        jy, jcache = apply(jp, jnp.asarray(x), jcache)
        ty, tcache = t_x.mlstm_apply(tp, tc, torch.from_numpy(x), cache=tcache)
        _close(ty, jy)
        for a, b in zip(jcache, tcache):
            _close(b, a)
    with pytest.raises(ValueError, match="T == 1"):
        t_x.mlstm_apply(tp, tc, torch.zeros((2, 2, 64)), cache=tcache)


def _gate_inputs(tp, tc, x):
    """q, k, v, i, f of ``mlstm_apply`` for ``x``, as the port makes them."""
    B, T, _ = x.shape
    H = tc.num_heads
    xi, _ = t_layers.dense(tp["up_proj"], torch.from_numpy(x)).chunk(2, dim=-1)
    Dh = xi.shape[-1] // H
    qkv = [t_layers.dense(tp[w], xi).reshape(B, T, H, Dh) for w in ("wq", "wk", "wv")]
    return (*qkv, t_layers.dense(tp["w_i"], xi), t_layers.dense(tp["w_f"], xi))


def _recurrence_f64(q, k, v, i_pre, f_pre):
    """The mLSTM recurrence step by step in float64 (numpy)."""
    q, k, v, i_pre, f_pre = (t.detach().double().numpy() for t in (q, k, v, i_pre, f_pre))
    B, T, H, Dh = q.shape
    C, n, m = np.zeros((B, H, Dh, Dh)), np.zeros((B, H, Dh)), np.full((B, H), -1e30)
    out = []
    for t in range(T):
        logf = -np.logaddexp(0.0, -f_pre[:, t])
        m_new = np.maximum(logf + m, i_pre[:, t])
        fw, iw = np.exp(logf + m - m_new)[..., None], np.exp(i_pre[:, t] - m_new)[..., None]
        C = C * fw[..., None] + iw[..., None] * k[:, t][..., None] * v[:, t][..., None, :]
        n = n * fw + iw * k[:, t]
        qs = q[:, t] * Dh ** -0.5
        den = np.maximum(np.abs(np.einsum("bhk,bhk->bh", n, qs)), np.exp(-m_new))
        out.append(np.einsum("bhkv,bhk->bhv", C, qs) / den[..., None])
        m = m_new
    return np.stack(out, axis=1)


@pytest.fixture(scope="module")
def mlstm_300():
    """Both packages' chunkwise-parallel mLSTM at T 300, the float64
    recurrence, and each package's step form unrolled."""
    jc, tc = _cfgs()
    jp, tp = _block(j_x.mlstm_init, jc, 3)
    x = _x(2, 300, 40)
    gates = _gate_inputs(tp, tc, x)
    jg = [jnp.asarray(g.detach().numpy()) for g in gates]
    jy = np.asarray(jax.jit(lambda p, x: j_x.mlstm_apply(p, jc, x)[0])(jp, jnp.asarray(x)))
    ty = t_x.mlstm_apply(tp, tc, torch.from_numpy(x))[0].detach().numpy()
    jh = np.asarray(jax.jit(j_x._mlstm_parallel)(*jg))
    th = t_x._mlstm_parallel(*gates).detach().numpy()

    def unrolled(step, cache, xs):
        hs = []
        for t in range(xs[0].shape[1]):
            cache, h = step(cache, *(g[:, t] for g in xs))
            hs.append(np.asarray(h) if not isinstance(h, torch.Tensor) else h.detach().numpy())
        return np.stack(hs, axis=1)

    j_step = unrolled(jax.jit(j_x._mlstm_step), j_cache.mlstm_cache_init(2, 4, 32, 32), jg)
    t_step = unrolled(t_x._mlstm_step, t_cache.mlstm_cache_init(2, 4, 32, 32), gates)
    return {"jy": jy, "ty": ty, "jh": jh, "th": th, "f64": _recurrence_f64(*gates),
            "j_step": j_step, "t_step": t_step}


def test_mlstm_parallel_matches_jax_and_float64(mlstm_300):
    r = mlstm_300
    ref_err = np.abs(r["jh"] - r["f64"]).max()
    assert np.abs(r["th"] - r["f64"]).max() <= ROUNDING_RATIO * ref_err
    np.testing.assert_allclose(r["th"], r["jh"], atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(r["ty"], r["jy"], atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_mlstm_parallel_matches_step_unrolled(mlstm_300):
    r = mlstm_300
    np.testing.assert_allclose(r["t_step"], r["j_step"], atol=ATOL, rtol=RTOL)
    gap = np.abs(r["jh"] - r["j_step"]).max()
    assert np.abs(r["th"] - r["t_step"]).max() <= ROUNDING_RATIO * gap


def test_decode_matches_full_forward():
    jc, tc = _cfgs()
    jp = j_tf.init_params(jax.random.key(0), jc)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    B, T = 2, 12
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, size=(B, T))
    with torch.no_grad():
        full = t_tf.forward(tp, tc, torch.from_numpy(toks))[0].numpy()
        dec = arch.decode_all(lambda p, t, c: t_tf.decode_step(p, tc, t, c), tp, toks,
                              t_tf.init_cache(tc, B, T, torch.float32), torch.from_numpy)
    assert float(np.abs(full - dec).max()) < DECODE_VS_FORWARD


@pytest.fixture(scope="module")
def xlstm():
    return arch.run("xlstm-125m")


def test_xlstm_reduced_forward_matches_jax(xlstm):
    arch.check_logits(xlstm["port"]["logits"], xlstm["jax"]["logits"], xlstm["cfg"].vocab_size)


def test_xlstm_reduced_train_step_matches_jax(xlstm):
    arch.check_train_step(xlstm)


def test_xlstm_reduced_decode_step_matches_jax(xlstm):
    arch.check_logits(xlstm["port"]["decode"], xlstm["jax"]["decode"], xlstm["cfg"].vocab_size)


def test_launch_serve_takes_loop_prefill(capsys):
    """``launch.serve --arch xlstm-125m --reduced``: the recurrent stack
    takes loop prefill (its decode steps are held to the reference's
    above), and batched prefill is refused, as there."""
    from repro_torch.launch import serve as t_serve

    tc = t_get_config("xlstm-125m").reduced()
    assert not t_serve.batched_prefill_supported(tc)
    tp = t_tf.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    prompts = torch.from_numpy(np.random.default_rng(5).integers(0, tc.vocab_size, size=(2, 6)))
    with pytest.raises(ValueError, match="recurrent mixers"):
        t_serve.prefill_and_decode(tc, tp, prompts, gen=1, cache_len=8, prefill="batched")
    outs = t_serve.main(["--arch", "xlstm-125m", "--reduced", "--batch", "2", "--prompt-len",
                         "5", "--gen", "3", "--device", "cpu"])
    assert "loop prefill" in capsys.readouterr().out and outs.shape == (2, 3)


def test_train_cli_takes_a_recurrent_arch(capsys):
    """``launch.train --arch xlstm-125m --reduced`` with the top-k wire
    trains the xLSTM stack with finite losses (the loss falling over 8
    steps, and jamba's run, are ``chip_smoke.py``'s checks)."""
    from repro_torch.launch import train as t_train

    hist = t_train.main(["--arch", "xlstm-125m", "--reduced", "--steps", "2", "--batch", "2",
                         "--seq", "16", "--log-every", "1", "--compress-topk", "0.25",
                         "--device", "cpu"])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "topk:0.25+ef" in capsys.readouterr().out


def test_xlstm_config_and_segments_match_reference():
    j, t = j_get_config("xlstm-125m"), t_get_config("xlstm-125m")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert [(s.mixer, s.ffn) for s in t_tf.layer_specs(t)] == \
           [(s.mixer, s.ffn) for s in j_tf.layer_specs(j)]
    assert [(len(s.unit), s.repeats) for s in t_tf.segments(t)] == [(4, 3)]
    p = t_tf.init_params(torch.Generator(), t, device="meta")
    assert "ffn_norm" not in p["seg0"]["l3"]  # xLSTM blocks carry their own FFN
