"""Port parity: the VLM front end — M-RoPE (``layers.apply_mrope``),
``attn_apply`` with ``mrope_positions``, ``forward`` / ``loss_fn`` with
``vision_embeds`` — on qwen2-vl-2b, and the llama-architecture
deepseek-67b, against the JAX package.

Weights come from the reference's inits and cross with
``params_from_reference``; inputs are made with numpy from a seed.  Held,
in f32 compute: ``apply_mrope`` and ``attn_apply`` at atol = rtol = 1e-5,
on every cache-free branch (the plain ``_sdpa``, ``_sdpa_q_chunked`` and
the flash branch, whose kernel is its plain version on the CPU: held to
the reference's plain branch, which its own tests hold its Pallas kernel
to) and the KV-cache branch (a prompt, then single tokens); the reduced
models' forward, train step and decode step at the whole-model bounds of
``tests/torch_arch_parity.py``.  Both full configs field for field, their
trees on the meta device leaf for leaf.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import torch_arch_parity as arch  # noqa: E402
from torch_arch_parity import one_thread  # noqa: E402,F401
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import cache as j_cache  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import cache as t_cache  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402

ATOL = RTOL = 1e-5
VLM = "qwen2-vl-2b"


def _grid_positions(B, T, Tv=16, side=4, seed=0):
    """(3, B, T) M-RoPE ids: a ``side`` × ``side`` patch grid at temporal 0,
    then text continuing on all three streams from the grid's extent."""
    t = np.zeros((3, B, T), dtype=np.int64)
    r = np.arange(Tv)
    t[1, :, :Tv], t[2, :, :Tv] = r // side, r % side
    t[:, :, Tv:] = side + np.arange(T - Tv) + np.random.default_rng(seed).integers(0, 3, (B, 1))
    return t


@pytest.mark.parametrize("D, sections", [(128, (16, 24, 24)), (64, (8, 12, 12))])
def test_apply_mrope_matches_jax(D, sections):
    rng = np.random.default_rng(D)
    x = rng.normal(size=(2, 40, 3, D)).astype(np.float32)
    pos = _grid_positions(2, 40)
    want = j_layers.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = t_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="head_dim/2"):
        t_layers.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6, (8, 8, 8))


def test_mrope_on_text_positions_is_rope():
    """Where the three streams agree (text), M-RoPE is RoPE, bitwise: the
    continuous engine serves text with 1-D positions, as the reference's."""
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(2, 9, 4, 128)).astype(np.float32))
    pos = torch.arange(9).expand(2, 9) + 100
    m = t_layers.apply_mrope(x, torch.stack([pos] * 3), 1e6, (16, 24, 24))
    assert torch.equal(m, t_layers.apply_rope(x, pos, 1e6))


def _attn_layer(seed=0):
    jc, tc = j_get_config(VLM).reduced(), t_get_config(VLM).reduced()
    jp = j_tf.init_params(jax.random.key(seed), jc)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    jl = jax.tree.map(lambda x: x[0], jp["seg0"])["l0"]["mixer"]
    tl = pytree.tree_map(lambda x: x[0], tp["seg0"])["l0"]["mixer"]
    return jc, tc, jl, tl


#: cache-free branches: (tokens, use_kernel, config changes)
CACHE_FREE = {
    "plain": (64, False, {}),
    "flash": (128, True, {}),
    "q-chunked": (128, False, {"attn_q_chunk": 32}),
}


@pytest.mark.parametrize("branch", list(CACHE_FREE))
def test_attn_apply_mrope_cache_free_matches_jax(branch):
    jc, tc, jl, tl = _attn_layer()
    T, use_kernel, changes = CACHE_FREE[branch]
    jc, tc = jc.replace(**changes), tc.replace(**changes)
    x = np.random.default_rng(T).normal(size=(2, T, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T), (2, T)).copy()
    mpos = _grid_positions(2, T)
    jy, _ = jax.jit(lambda p, x, a, b: j_attn.attn_apply(p, jc, x, positions=a, mrope_positions=b))(
        jl, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mpos))
    ty, tn = t_attn.attn_apply(tl, tc, torch.from_numpy(x), positions=torch.from_numpy(pos),
                               mrope_positions=torch.from_numpy(mpos), use_kernel=use_kernel)
    assert tn is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=RTOL)
    # M-RoPE changes the result: the 1-D positions alone give another one
    flat, _ = t_attn.attn_apply(tl, tc, torch.from_numpy(x), positions=torch.from_numpy(pos))
    assert float((flat - ty).abs().max()) > 1e-3


def test_attn_apply_mrope_kv_cache_matches_jax():
    """A prompt of 20 (a 4 × 4 patch grid and 4 text tokens) into a cache of
    24, then single tokens, each with its M-RoPE ids; the cache leaves
    after each call."""
    jc, tc, jl, tl = _attn_layer(1)
    B, S = 2, 24
    mpos = _grid_positions(B, S)
    apply = jax.jit(lambda p, x, a, b, c: j_attn.attn_apply(p, jc, x, positions=a,
                                                            mrope_positions=b, cache=c))
    jcache = j_cache.kv_cache_init(B, S, jc.num_kv_heads, jc.head_dim, jnp.float32)
    tcache = t_cache.kv_cache_init(B, S, tc.num_kv_heads, tc.head_dim, torch.float32)
    start = 0
    for i, T in enumerate((20, 1, 1, 1)):
        x = np.random.default_rng(50 + i).normal(size=(B, T, jc.d_model)).astype(np.float32)
        pos = np.broadcast_to(np.arange(start, start + T), (B, T)).copy()
        mp = mpos[:, :, start:start + T].copy()
        jy, jcache = apply(jl, jnp.asarray(x), jnp.asarray(pos), jnp.asarray(mp), jcache)
        ty, tcache = t_attn.attn_apply(tl, tc, torch.from_numpy(x), positions=torch.from_numpy(pos),
                                       mrope_positions=torch.from_numpy(mp), cache=tcache)
        start += T
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tcache.k.numpy(), np.asarray(jcache.k), atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(tcache.v.numpy(), np.asarray(jcache.v), atol=ATOL, rtol=RTOL)
        assert tcache.index == int(jcache.index) == start


def test_vision_prefix_replaces_the_first_token_embeddings():
    """With ``vision_embeds`` the tokens under the prefix do not matter."""
    tc = t_get_config(VLM).reduced()
    tp = t_tf.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    batch = arch.lm_batch(tc)
    toks = torch.from_numpy(batch["tokens"])
    other = toks.clone()
    other[:, :4] = (other[:, :4] + 7) % tc.vocab_size
    kw = {k: torch.from_numpy(batch[k]) for k in ("vision_embeds", "mrope_positions")}
    with torch.no_grad():
        a = t_tf.forward(tp, tc, toks, **kw)[0]
        b = t_tf.forward(tp, tc, other, **kw)[0]
        c = t_tf.forward(tp, tc, other, mrope_positions=kw["mrope_positions"])[0]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.fixture(scope="module", params=[VLM, "deepseek-67b"])
def reduced(request):
    return arch.run(request.param)


def test_reduced_forward_matches_jax(reduced):
    arch.check_logits(reduced["port"]["logits"], reduced["jax"]["logits"],
                      reduced["cfg"].vocab_size)


def test_reduced_train_step_matches_jax(reduced):
    arch.check_train_step(reduced)


def test_reduced_decode_step_matches_jax(reduced):
    arch.check_logits(reduced["port"]["decode"], reduced["jax"]["decode"],
                      reduced["cfg"].vocab_size)


@pytest.mark.parametrize("name, n_params", [
    (VLM, 1_543_910_912), ("deepseek-67b", 67_425_001_472), ("xlstm-125m", 150_354_504),
])
def test_full_config_and_tree_match_reference(name, n_params):
    """The full config field for field, and its tree on the meta device:
    every leaf's name, shape and type as ``jax.eval_shape(init_params)``
    gives them."""
    jc, tc = j_get_config(name), t_get_config(name)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tc.reduced()) == dataclasses.asdict(jc.reduced())
    shapes = jax.eval_shape(lambda k: j_tf.init_params(k, jc), jax.random.key(0))
    want = {jax.tree_util.keystr(p): (tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_leaves_with_path(shapes)}
    tp = t_tf.init_params(torch.Generator(), tc, device="meta")
    got = {pytree.keystr(p): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for p, x in pytree.tree_leaves_with_path(tp)}
    assert got == want
    n = sum(int(np.prod(s)) for s, _ in got.values())
    assert n == n_params
