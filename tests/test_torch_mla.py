"""Port parity: Multi-head Latent Attention (``repro_torch.models.mla``), its
latent cache, and the MLA models (minicpm3-4b, reduced) against
``repro.models.mla`` and the JAX package's serving path.

Weights come from the reference's inits and cross with
``params_from_reference``; inputs are made with numpy from a seed.  Held:

* ``mla_apply`` without a cache, with a cache (a prompt, then one token)
  and absorbed, in f32 compute to atol = rtol = 1e-5; in bf16 compute to
  3e-2, the JAX package's bf16 attention limit (``chip_smoke.py``'s
  ``ATTN_TOL``), plus 2^-6 of |y| for the last bf16 rounding of the output
  projection; the cache leaves to the same bounds against the JAX cache
  (they are matmul outputs, summed in another order) and bitwise against
  the layer's own latents (the write moves values without arithmetic);
* the decode-consistency cases of ``tests/test_decode_consistency.py``
  in f32 compute: decode within 2e-3 of the full forward, and absorbed
  decode within 2e-3 of unabsorbed, each also held to the JAX numbers at
  ``tests/test_torch_models.py``'s 1e-4 (in bf16 compute decode and
  forward are held to the bf16 bound above, and, with every bf16 product
  done as an f32 product rounded once, to the reference's 2e-3: see the
  test);
* greedy ids of minicpm3-4b (reduced) through ``prefill_and_decode`` equal
  the JAX ``launch.serve`` path's; ``--continuous`` refuses MLA as the
  reference does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import serve as j_serve  # noqa: E402
from repro.models import cache as j_cache  # noqa: E402
from repro.models import mla as j_mla  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.config import MLAConfig as JMLA  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.launch import serve as t_serve  # noqa: E402
from repro_torch.models import cache as t_cache  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import mla as t_mla  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.config import MLAConfig as TMLA  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402

ATOL = RTOL = 1e-5
BF16_ATOL = 3e-2
LOGIT_TOL = 1e-4  # tests/test_torch_models.py

#: tests/test_decode_consistency.py's mla case
MLA = dict(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16, qk_rope_head_dim=8,
           v_head_dim=16)
BASE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128, vocab_size=128,
            mixer="mla")


def _cfgs(compute="float32"):
    return (JConfig(mla=JMLA(**MLA), **BASE).replace(compute_dtype=compute),
            TConfig(mla=TMLA(**MLA), **BASE).replace(compute_dtype=compute))


def _layer(jc, seed=0):
    jp = j_mla.mla_init(jax.random.key(seed), jc)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


def _x(jc, B, T, seed):
    return np.random.default_rng(seed).normal(size=(B, T, jc.d_model)).astype(np.float32)


def _close(got, want, compute):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if compute == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    else:
        np.testing.assert_allclose(got, want, atol=BF16_ATOL, rtol=2.0 ** -6)


def test_mla_cache_init_matches_reference():
    jc = j_cache.mla_cache_init(2, 9, 16, 8, jnp.float32)
    tc = t_cache.mla_cache_init(2, 9, 16, 8, torch.float32)
    assert tc.c_kv.shape == jc.c_kv.shape and tc.k_rope.shape == jc.k_rope.shape
    assert tc.index == int(jc.index) == 0 and not bool(tc.c_kv.any())


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("absorb", [False, True], ids=["unabsorbed", "absorbed"])
def test_mla_apply_matches_jax(absorb, compute):
    """No cache (T 10), then a cache of 16: a prompt of 6 at index 0, and
    one token at index 6, the cache leaves checked after each."""
    jc, tc = _cfgs(compute)
    jp, tp = _layer(jc)
    cd_j, cd_t = jnp.dtype(compute), getattr(torch, compute)
    B = 2
    x = _x(jc, B, 10, 3)
    pos = np.broadcast_to(np.arange(10), (B, 10)).copy()
    jy, _ = j_mla.mla_apply(jp, jc, jnp.asarray(x).astype(cd_j), positions=jnp.asarray(pos),
                            absorb=absorb)
    ty, tn = t_mla.mla_apply(tp, tc, torch.from_numpy(x).to(cd_t),
                             positions=torch.from_numpy(pos), absorb=absorb)
    assert tn is None and ty.dtype == cd_t
    _close(ty, jy, compute)

    jcache = j_cache.mla_cache_init(B, 16, 16, 8, jnp.float32)
    tcache = t_cache.mla_cache_init(B, 16, 16, 8, torch.float32)
    for T, idx, seed in ((6, 0, 4), (1, 6, 5)):
        x = _x(jc, B, T, seed)
        pos = np.broadcast_to(np.arange(idx, idx + T), (B, T)).copy()
        jy, jcache = j_mla.mla_apply(jp, jc, jnp.asarray(x).astype(cd_j),
                                     positions=jnp.asarray(pos), cache=jcache, absorb=absorb)
        ty, tcache = t_mla.mla_apply(tp, tc, torch.from_numpy(x).to(cd_t),
                                     positions=torch.from_numpy(pos), cache=tcache,
                                     absorb=absorb)
        _close(ty, jy, compute)
        assert tcache.index == int(jcache.index) == idx + T
        _close(tcache.c_kv, jcache.c_kv, compute)
        _close(tcache.k_rope, jcache.k_rope, compute)
        # the write itself moves values: the rows [idx, idx + T) are bitwise
        # the layer's own latents, the rows past them still zero
        xt = torch.from_numpy(x).to(cd_t)
        c_new = t_layers.dense(tp["w_dkv"], xt).float()
        k_new = t_layers.apply_rope(t_layers.dense(tp["w_kr"], xt)[:, :, None, :],
                                    torch.from_numpy(pos), tc.rope_theta)[:, :, 0, :].float()
        assert torch.equal(tcache.c_kv[:, idx:idx + T], c_new)
        assert torch.equal(tcache.k_rope[:, idx:idx + T], k_new)
        assert not bool(tcache.c_kv[:, idx + T:].any())


def _model(jc, seed=0):
    jp = j_tf.init_params(jax.random.key(seed), jc)
    return jp, params_from_reference(jax.tree.map(np.asarray, jp), "cpu")


#: the JAX decode step compiled once a config (op by op it compiles each op)
_j_decode = jax.jit(j_tf.decode_step, static_argnames=("cfg", "mla_absorb"))


def _decode_all(tf, params, cfg, toks, cache, mk, absorb=False):
    step = _j_decode if tf is j_tf else tf.decode_step
    outs = []
    for t in range(toks.shape[1]):
        lg, cache = step(params, cfg, mk(toks[:, t:t + 1]), cache, mla_absorb=absorb)
        outs.append(np.asarray(lg[:, 0]) if tf is j_tf else lg[:, 0].numpy())
    return np.stack(outs, axis=1)


def _t_tokens(a):
    return torch.from_numpy(np.ascontiguousarray(a)).long()


class _F32Products(TorchDispatchMode):
    """Every matrix product with a bf16 operand done in f32 and rounded to
    bf16 once, so its result does not depend on how many rows it has."""

    ops = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
           torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in self.ops and any(isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
                                    for a in args):
            args = [a.float() if isinstance(a, torch.Tensor) else a for a in args]
            return func(*args, **(kwargs or {})).to(torch.bfloat16)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("compute", ["bfloat16", "float32"])
def test_decode_matches_full_forward_and_jax(compute):
    """``tests/test_decode_consistency.py``'s mla case: in f32 compute,
    decode within 2e-3 of the full forward, and both held to the JAX
    numbers at 1e-4.  In bf16 compute (the reference case's default) within
    the bf16 bound of this file: PyTorch's CPU bf16 matmul rounds a
    product of 2 rows (one decode token) differently from the same rows
    among 24 (the forward) — measured 7.8e-3 apart in one element of
    ``w_dq``'s product here — which XLA's does not, and the two layers carry
    that to 3.1e-2 in the logits, 0.77 of the bound at that element
    (``ROADMAP.md`` queue 3, item 24).  The witness that this rounding is
    the whole gap: with every bf16 product an f32 product rounded once, as
    XLA's CPU dot does, decode is within the reference's 2e-3 of the
    forward (measured 0, bitwise)."""
    jc, tc = _cfgs(compute)
    jp, tp = _model(jc)
    B, T = 2, 12
    toks = np.asarray(jax.random.randint(jax.random.key(1), (B, T), 0, jc.vocab_size))
    full, _, _ = t_tf.forward(tp, tc, _t_tokens(toks))
    dec = _decode_all(t_tf, tp, tc, toks, t_tf.init_cache(tc, B, T, torch.float32), _t_tokens)
    if compute == "bfloat16":
        live = full[..., : tc.vocab_size]
        _close(torch.from_numpy(dec[..., : tc.vocab_size]), live, compute)
        with _F32Products():
            full, _, _ = t_tf.forward(tp, tc, _t_tokens(toks))
            dec = _decode_all(t_tf, tp, tc, toks, t_tf.init_cache(tc, B, T, torch.float32),
                              _t_tokens)
        assert float(np.abs(full.float().numpy() - dec.astype(np.float32)).max()) < 2e-3
        return
    assert float(np.abs(full.numpy() - dec).max()) < 2e-3
    j_full, _, _ = j_tf.forward(jp, jc, jnp.asarray(toks))
    j_dec = _decode_all(j_tf, jp, jc, toks, j_tf.init_cache(jc, B, T, jnp.float32), jnp.asarray)
    np.testing.assert_allclose(full.numpy(), np.asarray(j_full), atol=LOGIT_TOL, rtol=LOGIT_TOL)
    np.testing.assert_allclose(dec, j_dec, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_mla_absorb_matches_unabsorbed():
    """The reference's ``test_mla_absorb_matches_unabsorbed``: absorbed and
    unabsorbed decode within 2e-3 at every step (f32 compute), and each to
    the JAX package's at 1e-4."""
    jc, tc = _cfgs("float32")
    jp, tp = _model(jc)
    B, T = 2, 8
    toks = np.asarray(jax.random.randint(jax.random.key(1), (B, T), 0, jc.vocab_size))
    got = {a: _decode_all(t_tf, tp, tc, toks, t_tf.init_cache(tc, B, T, torch.float32),
                          _t_tokens, absorb=a) for a in (False, True)}
    assert float(np.abs(got[False] - got[True]).max(axis=(0, 2)).max()) < 2e-3
    for a in (False, True):
        want = _decode_all(j_tf, jp, jc, toks, j_tf.init_cache(jc, B, T, jnp.float32),
                           jnp.asarray, absorb=a)
        np.testing.assert_allclose(got[a], want, atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_absorbed_path_reads_the_parameter_type_weights():
    """``compute_params`` casts the MLA projections to bf16 but leaves
    ``w_uk`` / ``w_uv`` in f32, which the absorbed path reads; the logits
    of a bf16 model are the same from either weight tree."""
    tc = t_get_config("minicpm3-4b").reduced().replace(compute_dtype="bfloat16")
    p = t_tf.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    w = t_tf.compute_params(p, tc)
    mix = w["seg0"]["l0"]["mixer"]
    assert mix["w_dq"]["kernel"].dtype == torch.bfloat16
    assert mix["w_uk"]["kernel"] is p["seg0"]["l0"]["mixer"]["w_uk"]["kernel"]
    assert mix["w_uv"]["kernel"].dtype == torch.float32
    toks = _t_tokens(np.random.default_rng(2).integers(0, tc.vocab_size, size=(2, 5)))
    for absorb in (False, True):
        outs = []
        for tree in (p, w):
            cache = t_tf.init_cache(tc, 2, 6, torch.float32)
            _, cache = t_tf.decode_step(tree, tc, toks, cache,
                                        positions=torch.arange(5).expand(2, 5))
            lg, _ = t_tf.decode_step(tree, tc, toks[:, :1], cache, mla_absorb=absorb)
            outs.append(lg)
        assert torch.equal(outs[0], outs[1]), absorb


def test_minicpm3_greedy_ids_match_jax_launch_serve():
    jc, tc = j_get_config("minicpm3-4b").reduced(), t_get_config("minicpm3-4b").reduced()
    jp, tp = _model(jc)
    prompts = np.random.default_rng(3).integers(0, jc.vocab_size, size=(3, 7)).astype(np.int32)
    want = np.asarray(j_serve.prefill_and_decode(jc, jp, jnp.asarray(prompts), gen=6,
                                                 cache_len=14))
    got = t_serve.prefill_and_decode(tc, tp, torch.from_numpy(prompts), gen=6, cache_len=14)
    np.testing.assert_array_equal(got.numpy(), want)


def test_continuous_refuses_mla_as_the_reference():
    tc = t_get_config("minicpm3-4b").reduced()
    with pytest.raises(ValueError, match="paged decode supports attn-only stacks, got mixer 'mla'"):
        t_serve.main(["--arch", "minicpm3-4b", "--reduced", "--continuous", "--batch", "2",
                      "--requests", "2", "--prompt-len", "4", "--gen", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="attn-only"):
        t_tf.init_paged_cache(tc, 4, 2, torch.float32)


def test_config_and_specs_match_reference():
    j, t = j_get_config("minicpm3-4b"), t_get_config("minicpm3-4b")
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert [(s.mixer, s.ffn) for s in t_tf.layer_specs(t)] == \
           [(s.mixer, s.ffn) for s in j_tf.layer_specs(j)]
