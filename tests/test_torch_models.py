"""Port parity: ``repro_torch.models`` (config, layers, KV caches,
attention, transformer) against ``repro.models``.

Weights come from the reference's ``init_params`` and cross with
``repro_torch.convert.params_from_reference``; other inputs are made with
numpy from a seed and handed to both packages.  Everything runs in f32 on
the CPU.  Logits are held at atol = rtol = 1e-4: XLA and PyTorch sum
matmuls in other orders and round ``rsqrt``, ``pow``, ``sin``/``cos`` and
``exp`` in other last bits, and the differences compound over the layers
(measured ≤ 2e-6 on the tiny config).  Cache operations move values
without arithmetic and are held bitwise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import attention as j_attn  # noqa: E402
from repro.models import cache as j_cache  # noqa: E402
from repro.models import layers as j_layers  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.models import attention as t_attn  # noqa: E402
from repro_torch.models import cache as t_cache  # noqa: E402
from repro_torch.models import layers as t_layers  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.models.config import SSMConfig  # noqa: E402

ATOL = RTOL = 1e-4

TINY = dict(
    name="tiny", vocab_size=97, d_model=32, num_layers=2, num_heads=4,
    num_kv_heads=2, head_dim=8, d_ff=64, compute_dtype="float32",
    param_dtype="float32",
)
CONFIGS = ["tiny", "tinyllama-1.1b", "qwen2-1.5b"]


def _configs(name):
    if name == "tiny":
        return JConfig(**TINY), TConfig(**TINY)
    return j_get_config(name).reduced(), t_get_config(name).reduced()


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    jc, tc = _configs(request.param)
    jp = j_tf.init_params(jax.random.key(0), jc)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(b), np.asarray(a), atol=atol, rtol=rtol)


def _rng(seed):
    return np.random.default_rng(seed)


# ----------------------------------------------------------------------------
# Config
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tinyllama-1.1b", "qwen2-1.5b"])
def test_configs_match_reference(name):
    j, t = j_get_config(name), t_get_config(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.padded_vocab, t.q_per_kv) == (j.padded_vocab, j.q_per_kv)
    assert t.replace(num_layers=3).num_layers == 3


#: archs ported after the attention family (each once refused, naming its item)
PORTED_SINCE = ("minicpm3-4b", "deepseek-v3-671b", "olmoe-1b-7b", "qwen2-vl-2b",
                "whisper-base", "deepseek-67b", "xlstm-125m", "jamba-1.5-large-398b")


@pytest.mark.parametrize("name", [
    "qwen2-vl-2b", "whisper-base", "minicpm3-4b", "deepseek-v3-671b",
    "deepseek-67b", "xlstm-125m", "jamba-1.5-large-398b", "olmoe-1b-7b",
])
def test_unported_archs_name_their_roadmap_item(name):
    """No arch is refused any more: the eight that once named their item
    resolve to the reference's config, field by field (the reduced variant
    too), and the registry lists the reference's ten archs in its order."""
    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.configs import ARCHS as T_ARCHS

    assert T_ARCHS == J_ARCHS and name in T_ARCHS
    j, t = j_get_config(name), t_get_config(name)
    jd, td = dataclasses.asdict(j), dataclasses.asdict(t)
    assert td.keys() == jd.keys()
    for field in jd:
        assert td[field] == jd[field], field
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())
    assert (t.padded_vocab, t.q_per_kv) == (j.padded_vocab, j.q_per_kv)


def test_layer_specs_and_segments_match_reference():
    from repro.models import transformer as jt

    for name in ("tinyllama-1.1b", "qwen2-1.5b") + PORTED_SINCE:
        jc, tc = j_get_config(name), t_get_config(name)
        if jc.is_encoder_decoder:
            continue  # whisper is its own model (tests/test_torch_whisper.py)
        assert [(s.mixer, s.ffn) for s in t_tf.layer_specs(tc)] == \
               [(s.mixer, s.ffn) for s in jt.layer_specs(jc)]
        assert [(len(s.unit), s.repeats) for s in t_tf.segments(tc)] == \
               [(len(s.unit), s.repeats) for s in jt.segments(jc)]


# ----------------------------------------------------------------------------
# Layers
# ----------------------------------------------------------------------------


def test_layers_match_reference():
    rng = _rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    k = rng.normal(size=(16, 24)).astype(np.float32)
    b = rng.normal(size=(24,)).astype(np.float32)
    s = rng.normal(size=(16,)).astype(np.float32)
    e = rng.normal(size=(40, 16)).astype(np.float32)
    ids = rng.integers(0, 40, size=(2, 5))
    T = torch.from_numpy
    _close(j_layers.dense({"kernel": k, "bias": b}, jnp.asarray(x)),
           t_layers.dense({"kernel": T(k), "bias": T(b)}, T(x)))
    _close(j_layers.rmsnorm({"scale": s}, jnp.asarray(x)),
           t_layers.rmsnorm({"scale": T(s)}, T(x)))
    _close(j_layers.embed({"embedding": e}, jnp.asarray(ids)),
           t_layers.embed({"embedding": T(e)}, T(ids)))
    _close(j_layers.unembed({"embedding": e}, jnp.asarray(x)),
           t_layers.unembed({"embedding": T(e)}, T(x)))
    w = {n: {"kernel": rng.normal(size=sh).astype(np.float32)}
         for n, sh in (("w_gate", (16, 32)), ("w_up", (16, 32)), ("w_down", (32, 16)))}
    _close(j_layers.swiglu(w, jnp.asarray(x)),
           t_layers.swiglu(pytree.tree_map(T, w), T(x)))


@pytest.mark.parametrize("theta", [10000.0, 1e6])
def test_rope_matches_reference(theta):
    """Angles positions · theta^(−2i/D) in f32; ``torch.pow`` and XLA's
    ``pow`` may round the last bit apart, so held at 1e-5 (positions up to
    2000 scale that bit into the angle)."""
    rng = _rng(1)
    x = rng.normal(size=(2, 7, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 2000, size=(2, 7))
    _close(j_layers.rope_frequencies(64, theta), t_layers.rope_frequencies(64, theta),
           atol=0, rtol=1e-6)
    _close(j_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta),
           t_layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           atol=1e-5, rtol=1e-5)


def test_dense_casts_weight_to_activation_type():
    x = torch.randn(3, 8).bfloat16()
    p = {"kernel": torch.randn(8, 4), "bias": torch.randn(4)}
    y = t_layers.dense(p, x)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, x @ p["kernel"].bfloat16() + p["bias"].bfloat16())


def test_init_distributions():
    """Same shapes and distributions as the reference's init: kernels a
    normal truncated to ±2σ with σ = d_in^-½, embeddings σ = 0.02, norms 1,
    biases 0."""
    cfg = t_get_config("qwen2-1.5b").reduced()
    p = t_tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    wq = p["seg0"]["l0"]["mixer"]["wq"]["kernel"]
    sigma = cfg.d_model ** -0.5
    assert float(wq.abs().max()) <= 2 * sigma * (1 + 1e-6)
    # std of N(0,1) truncated to [−2, 2] is 0.8796
    assert abs(float(wq.std()) / sigma - 0.8796) < 0.02
    emb = p["embed"]["embedding"]
    assert float(emb.abs().max()) <= 0.04 * (1 + 1e-6)
    assert bool((p["seg0"]["l0"]["mixer_norm"]["scale"] == 1).all())
    assert bool((p["seg0"]["l0"]["mixer"]["wq"]["bias"] == 0).all())
    assert "lm_head" not in p  # tied


def test_full_width_tree_matches_reference_shapes():
    """The tinyllama-1.1b tree at full width: every leaf's name, shape and
    type as ``jax.eval_shape(init_params)`` gives them, on the meta device
    (no memory)."""
    jc, tc = j_get_config("tinyllama-1.1b"), t_get_config("tinyllama-1.1b")
    shapes = jax.eval_shape(lambda k: j_tf.init_params(k, jc), jax.random.key(0))
    want = {jax.tree_util.keystr(path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_leaves_with_path(shapes)}
    tp = t_tf.init_params(torch.Generator(), tc, device="meta")
    got = {pytree.keystr(path): (tuple(x.shape), str(x.dtype).replace("torch.", ""))
           for path, x in pytree.tree_leaves_with_path(tp)}
    assert got == want
    assert sum(int(np.prod(s)) for s, _ in got.values()) == 1_100_048_384


def test_params_from_reference_bitwise_f32_and_bf16():
    jc = JConfig(**TINY)
    jp = j_tf.init_params(jax.random.key(3), jc)
    for cast in (None, jnp.bfloat16):
        tree = jp if cast is None else jax.tree.map(lambda x: x.astype(cast), jp)
        ref = jax.tree.map(np.asarray, tree)
        tp = params_from_reference(ref, "cpu")
        for path, leaf in jax.tree_util.tree_leaves_with_path(ref):
            t = tp
            for k in path:
                t = t[k.key]
            bits = np.int16 if cast is not None else np.int32
            tdt = torch.int16 if cast is not None else torch.int32
            np.testing.assert_array_equal(leaf.view(bits), t.view(tdt).numpy())


def test_compute_params_same_numbers_as_casting_per_call():
    cfg = t_get_config("tinyllama-1.1b").reduced().replace(compute_dtype="bfloat16")
    p = t_tf.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    w = t_tf.compute_params(p, cfg)
    assert w["seg0"]["l0"]["mixer"]["wq"]["kernel"].dtype == torch.bfloat16
    assert w["lm_head"]["kernel"].dtype == torch.bfloat16
    assert w["embed"]["embedding"] is p["embed"]["embedding"]  # f32, not copied
    assert w["final_norm"]["scale"] is p["final_norm"]["scale"]
    toks = torch.from_numpy(_rng(2).integers(0, cfg.vocab_size, size=(2, 6)))
    a, _, _ = t_tf.forward(p, cfg, toks)
    b, _, _ = t_tf.forward(w, cfg, toks)
    assert torch.equal(a, b)
    f32 = cfg.replace(compute_dtype="float32")
    assert t_tf.compute_params(p, f32)["lm_head"]["kernel"] is p["lm_head"]["kernel"]


# ----------------------------------------------------------------------------
# Caches
# ----------------------------------------------------------------------------


class TestPageAllocator:
    def test_never_hands_out_null_page_and_reuses_freed(self):
        a = t_cache.PageAllocator(8)
        first = a.alloc(7)
        assert first is not None and t_cache.NULL_PAGE not in first
        assert a.free_pages == 0
        a.free(first)
        assert set(a.alloc(7)) == set(first)

    def test_all_or_nothing(self):
        a = t_cache.PageAllocator(5)
        assert a.alloc(5) is None
        assert a.free_pages == 4
        assert len(a.alloc(4)) == 4
        assert a.alloc(1) is None

    def test_double_free_and_foreign_free_raise(self):
        a = t_cache.PageAllocator(4)
        pages = a.alloc(2)
        a.free(pages)
        with pytest.raises(ValueError, match="double free|not allocated"):
            a.free(pages)
        with pytest.raises(ValueError, match="not allocated"):
            a.free([t_cache.NULL_PAGE])

    def test_lifo_reuse_and_bad_sizes(self):
        a = t_cache.PageAllocator(8)
        x = a.alloc(3)
        a.free(x)
        assert a.alloc(3) == list(reversed(x))
        with pytest.raises(ValueError):
            t_cache.PageAllocator(1)
        with pytest.raises(ValueError):
            a.alloc(-1)


def _both_caches(n_pages, P, Hkv, D):
    return (j_cache.paged_kv_cache_init(n_pages, P, Hkv, D, jnp.float32),
            t_cache.paged_kv_cache_init(n_pages, P, Hkv, D, torch.float32))


def _same_arena(jc, tc):
    np.testing.assert_array_equal(np.asarray(jc.k), tc.k.numpy())
    np.testing.assert_array_equal(np.asarray(jc.v), tc.v.numpy())


class TestPagedCacheOps:
    def test_write_view_append_roundtrip(self):
        P, Hkv, D = 4, 2, 3
        jc, tc = _both_caches(7, P, Hkv, D)
        block = np.asarray([[1, 2, 3], [4, 5, 6]], np.int32)
        rng = _rng(0)
        k_seq = rng.normal(size=(8, Hkv, D)).astype(np.float32)
        v_seq = rng.normal(size=(8, Hkv, D)).astype(np.float32)
        jc = j_cache.paged_write(jc, jnp.asarray(block[0]), jnp.asarray(k_seq), jnp.asarray(v_seq), 5)
        tc = t_cache.paged_write(tc, torch.from_numpy(block[0]), torch.from_numpy(k_seq),
                                 torch.from_numpy(v_seq), 5)
        _same_arena(jc, tc)
        k, v = t_cache.paged_view(tc, torch.from_numpy(block))
        np.testing.assert_array_equal(k[0, :5].numpy(), k_seq[:5])
        np.testing.assert_array_equal(v[0, :5].numpy(), v_seq[:5])
        np.testing.assert_array_equal(k[1].numpy(), np.zeros((12, Hkv, D)))

        k_tok = rng.normal(size=(2, Hkv, D)).astype(np.float32)
        v_tok = rng.normal(size=(2, Hkv, D)).astype(np.float32)
        length = np.asarray([5, 0], np.int32)
        jc = j_cache.paged_append(jc, jnp.asarray(block), jnp.asarray(length),
                                  jnp.asarray(k_tok), jnp.asarray(v_tok))
        tc = t_cache.paged_append(tc, torch.from_numpy(block), torch.from_numpy(length),
                                  torch.from_numpy(k_tok), torch.from_numpy(v_tok))
        _same_arena(jc, tc)
        jk, jv = j_cache.paged_view(jc, jnp.asarray(block))
        tk, tv = t_cache.paged_view(tc, torch.from_numpy(block))
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        np.testing.assert_array_equal(np.asarray(jv), tv.numpy())
        np.testing.assert_array_equal(tk[0, 5].numpy(), k_tok[0])
        np.testing.assert_array_equal(tk[1, 0].numpy(), k_tok[1])

    def test_dense_cache_init_matches_reference(self):
        jc = j_cache.kv_cache_init(2, 8, 3, 4, jnp.float32)
        tc = t_cache.kv_cache_init(2, 8, 3, 4, torch.float32)
        assert tc.k.shape == jc.k.shape and tc.v.shape == jc.v.shape
        assert tc.index == int(jc.index) == 0 and not bool(tc.k.any())

    def test_null_page_swallows_inactive_writes(self):
        P, Hkv, D = 2, 1, 2
        tc = t_cache.paged_kv_cache_init(4, P, Hkv, D, torch.float32)
        live = torch.tensor([[1, 2]])
        dead = torch.full((1, 2), t_cache.NULL_PAGE)
        tok = torch.ones((1, Hkv, D))
        tc = t_cache.paged_append(tc, dead, torch.zeros((1,), dtype=torch.int32), tok, tok)
        k, _ = t_cache.paged_view(tc, live)
        assert bool((k == 0).all())

    def test_padding_rows_redirect_to_null_page(self):
        P, Hkv, D = 2, 1, 2
        jc, tc = _both_caches(4, P, Hkv, D)
        block_row = np.asarray([1, 2], np.int32)
        seq = np.full((4, Hkv, D), 7.0, np.float32)
        tc = t_cache.paged_write(tc, torch.from_numpy(block_row), torch.from_numpy(seq),
                                 torch.from_numpy(seq), 2)
        k, _ = t_cache.paged_view(tc, torch.from_numpy(block_row)[None])
        np.testing.assert_array_equal(k[0, :2].numpy(), seq[:2])
        np.testing.assert_array_equal(k[0, 2:].numpy(), np.zeros((2, Hkv, D)))
        # pages 1 and 2 agree with the reference (the null page's contents
        # are not compared: which duplicate write wins there is undefined)
        jc = j_cache.paged_write(jc, jnp.asarray(block_row), jnp.asarray(seq), jnp.asarray(seq), 2)
        np.testing.assert_array_equal(np.asarray(jc.k)[1:], tc.k[1:].numpy())

    def test_bucket_past_the_slots_pages_goes_to_null_page(self):
        """A prompt bucket longer than the slot's pages: the rows past them
        are padding and land in the null page."""
        tc = t_cache.paged_kv_cache_init(4, 2, 1, 2, torch.float32)
        seq = torch.arange(16, dtype=torch.float32).reshape(8, 1, 2)
        t_cache.paged_write(tc, torch.tensor([1, 2, 3]), seq, seq, 5)
        k, _ = t_cache.paged_view(tc, torch.tensor([[1, 2, 3]]))
        assert torch.equal(k[0, :5], seq[:5])


# ----------------------------------------------------------------------------
# Attention routing
# ----------------------------------------------------------------------------


def test_decode_routing_and_plan():
    tc = TConfig(**TINY)
    assert t_attn.resolve_decode_attn("auto", device="cpu") == "plain"
    assert t_attn.resolve_decode_attn(False, device="cpu") == "plain"
    assert t_attn.resolve_decode_attn("auto", device="cuda") == "cuda"
    assert t_attn.resolve_decode_attn(True, device="cuda") == "cuda"
    with pytest.raises(ValueError, match="needs a CUDA device"):
        t_attn.resolve_decode_attn(True, device="cpu")
    with pytest.raises(ValueError, match="sliding-window"):
        t_attn.resolve_decode_attn("auto", sliding_window=8, device="cpu")
    plan = t_attn.decode_kernel_plan(tc, use_kernel="auto", device="cpu")
    assert plan["path"] == "plain" and "kernel needs CUDA" in plan["reason"]
    off = t_attn.decode_kernel_plan(tc, use_kernel=False, device="cuda")
    assert off["path"] == "plain" and "opt-out" in off["reason"]
    assert t_attn.decode_kernel_plan(tc, use_kernel=True, device="cuda")["path"] == "cuda"
    assert t_attn.decode_kernel_plan(tc.replace(sliding_window=8), device="cpu")["path"] == "off"


def test_unported_attention_paths_raise():
    """What the port still refuses: the decode kernel on a CPU tensor.
    M-RoPE runs (``tests/test_torch_vlm.py``): with ``mrope_sections`` but
    no ``mrope_positions`` the layer rotates by RoPE, as the reference's.
    The flash and query-chunked branches of the cache-free path run
    (``test_attn_apply_cache_free_branches_match_jax``)."""
    tc = TConfig(**TINY)
    p = t_tf.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    lp = pytree.tree_map(lambda x: x[0], p["seg0"])["l0"]["mixer"]
    x = torch.randn((1, 128, tc.d_model), generator=torch.Generator().manual_seed(1))
    pos = torch.arange(128)[None]
    m = tc.replace(mrope_sections=(2, 1, 1))
    rope, _ = t_attn.attn_apply(lp, tc, x, positions=pos)
    assert torch.equal(t_attn.attn_apply(lp, m, x, positions=pos)[0], rope)
    mrope, _ = t_attn.attn_apply(lp, m, x, positions=pos,
                                 mrope_positions=torch.stack([pos, pos // 2, pos // 3]))
    assert not torch.equal(mrope, rope)
    y, _ = t_attn.attn_apply(lp, tc, x[:, :8], positions=pos[:, :8], use_kernel=True)
    assert y.shape == (1, 8, tc.d_model)  # below 128 tokens the plain path, as there
    with pytest.raises(ValueError, match="decode_attn='cuda'"):
        t_attn._decode_attend(torch.zeros(1, 4, 8), torch.zeros(1, 4, 2, 8),
                              torch.zeros(1, 4, 2, 8), 1, impl="cuda")


#: cache-free branches of ``attn_apply``: (tokens, use_kernel, config changes)
CACHE_FREE = {
    "flash": (128, True, {}),
    "flash-short": (96, True, {}),  # below 128 tokens: the plain _sdpa, as there
    "q-chunked": (128, False, {"attn_q_chunk": 32}),
    "q-chunk-unrolled": (128, False, {"attn_q_chunk": 32, "unroll_time_scans": True}),
    "flash-window": (160, True, {"sliding_window": 48}),
    "q-chunked-window": (128, False, {"attn_q_chunk": 64, "sliding_window": 40}),
}


@pytest.mark.parametrize("branch", list(CACHE_FREE))
def test_attn_apply_cache_free_branches_match_jax(model, branch):
    """The flash branch (``use_kernel=True``, T >= 128: the kernel's plain
    version here, the Pallas kernel in interpret mode there) and
    ``_sdpa_q_chunked`` against the reference's ``attn_apply``."""
    jc, tc, jp, tp = model
    T, use_kernel, changes = CACHE_FREE[branch]
    jc, tc = jc.replace(**changes), tc.replace(**changes)
    jl = jax.tree.map(lambda x: x[0], jp["seg0"])["l0"]["mixer"]
    tl = pytree.tree_map(lambda x: x[0], tp["seg0"])["l0"]["mixer"]
    rng = _rng(T + len(branch))
    x = rng.normal(size=(2, T, jc.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    jy, _ = j_attn.attn_apply(jl, jc, jnp.asarray(x), positions=jnp.asarray(pos),
                              use_kernel=use_kernel)
    ty, tcache = t_attn.attn_apply(tl, tc, torch.from_numpy(x),
                                   positions=torch.from_numpy(pos.copy()),
                                   use_kernel=use_kernel)
    assert tcache is None and ty.shape == (2, T, tc.d_model)
    _close(jy, ty)
    # every cache-free branch computes the same attention
    plain, _ = t_attn.attn_apply(tl, tc.replace(attn_q_chunk=0), torch.from_numpy(x),
                                 positions=torch.from_numpy(pos.copy()))
    _close(plain, ty)


def test_attn_apply_decode_impls_agree(model):
    """Dense-cache decode: the kernel's plain version ("plain") and the
    ``_sdpa`` path ("off") against the reference's "xla" and "off"."""
    jc, tc, jp, tp = model
    jl = jax.tree.map(lambda x: x[0], jp["seg0"])["l0"]["mixer"]
    tl = pytree.tree_map(lambda x: x[0], tp["seg0"])["l0"]["mixer"]
    rng = _rng(4)
    B, S = 2, 16
    x = rng.normal(size=(B, 1, jc.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, B, S, jc.num_kv_heads, jc.head_dim)).astype(np.float32)
    pos = np.full((B, 1), 5, np.int32)
    ref = None
    for j_impl, t_impl in (("xla", "plain"), ("off", "off")):
        jcache = j_cache.KVCache(k=jnp.asarray(kv[0]), v=jnp.asarray(kv[1]),
                                 index=jnp.asarray(5, jnp.int32))
        tcache = t_cache.KVCache(k=torch.from_numpy(kv[0].copy()),
                                 v=torch.from_numpy(kv[1].copy()), index=5)
        jy, jn = j_attn.attn_apply(jl, jc, jnp.asarray(x), positions=jnp.asarray(pos),
                                   cache=jcache, decode_attn=j_impl)
        ty, tn = t_attn.attn_apply(tl, tc, torch.from_numpy(x), positions=torch.from_numpy(pos),
                                   cache=tcache, decode_attn=t_impl)
        _close(jy, ty)
        _close(jn.k, tn.k)
        assert tn.index == int(jn.index) == 6
        ref = ty if ref is None else ref
        _close(ref, ty)


# ----------------------------------------------------------------------------
# Transformer: forward, decode_step, paged_decode_step
# ----------------------------------------------------------------------------


def test_forward_logits(model):
    jc, tc, jp, tp = model
    toks = _rng(5).integers(0, jc.vocab_size, size=(2, 9)).astype(np.int32)
    jl, _, _ = j_tf.forward(jp, jc, jnp.asarray(toks))
    tl, aux, cache = t_tf.forward(tp, tc, torch.from_numpy(toks).long())
    assert tl.dtype == torch.float32 and tl.shape == (2, 9, jc.padded_vocab)
    assert aux == 0.0 and cache is None
    _close(jl, tl)
    if jc.padded_vocab != jc.vocab_size:
        assert bool((tl[..., jc.vocab_size:] == -1e30).all())


def test_decode_step_prefill_then_token(model):
    """Prefill a bucket through the dense cache at positions arange(T),
    then one token at the fill index — the engine's join path."""
    jc, tc, jp, tp = model
    rng = _rng(6)
    T, S = 8, 16
    toks = rng.integers(0, jc.vocab_size, size=(1, T)).astype(np.int32)
    jcache = j_tf.init_cache(jc, 1, S, jnp.float32)
    tcache = t_tf.init_cache(tc, 1, S, torch.float32)
    pos = np.arange(T)[None]
    jl, jcache = j_tf.decode_step(jp, jc, jnp.asarray(toks), jcache, positions=jnp.asarray(pos))
    tl, tcache = t_tf.decode_step(tp, tc, torch.from_numpy(toks).long(), tcache,
                                  positions=torch.from_numpy(pos))
    _close(jl, tl)
    _close(jcache["seg0"]["l0"].k, tcache["seg0"]["l0"].k)
    assert tcache["seg0"]["l0"].index == T
    nxt = rng.integers(0, jc.vocab_size, size=(1, 1)).astype(np.int32)
    jl, _ = j_tf.decode_step(jp, jc, jnp.asarray(nxt), jcache)
    tl, tcache = t_tf.decode_step(tp, tc, torch.from_numpy(nxt).long(), tcache)
    _close(jl, tl)
    assert tcache["seg0"]["l0"].index == T + 1


def test_paged_decode_step_logits(model):
    """Two slots, one live with a prefilled prompt, one inactive on the
    null page: logits of the live slot and the arena agree with the
    reference (both decode implementations of each side)."""
    jc, tc, jp, tp = model
    rng = _rng(7)
    P, n_pages, pps = 4, 9, 4
    prompt_len = 6
    toks = rng.integers(0, jc.vocab_size, size=(1, 8)).astype(np.int32)
    pos = np.arange(8)[None]
    jd = j_tf.init_cache(jc, 1, 8, jnp.float32)
    td = t_tf.init_cache(tc, 1, 8, torch.float32)
    _, jd = j_tf.decode_step(jp, jc, jnp.asarray(toks), jd, positions=jnp.asarray(pos))
    _, td = t_tf.decode_step(tp, tc, torch.from_numpy(toks).long(), td,
                             positions=torch.from_numpy(pos))
    block = np.zeros((2, pps), np.int32)
    block[0] = [3, 1, 7, 2]
    jpg = j_tf.paged_insert_prompt(j_tf.init_paged_cache(jc, n_pages, P, jnp.float32), jd,
                                   jnp.asarray(block[0]), jnp.asarray(prompt_len))
    tpg = t_tf.paged_insert_prompt(t_tf.init_paged_cache(tc, n_pages, P, torch.float32), td,
                                   torch.from_numpy(block[0]), prompt_len)
    np.testing.assert_allclose(tpg["seg0"]["l0"].k[:, 1:].numpy(),
                               np.asarray(jpg["seg0"]["l0"].k)[:, 1:], atol=ATOL, rtol=RTOL)
    length = np.asarray([prompt_len, 0], np.int32)
    last = np.asarray([[toks[0, prompt_len - 1]], [0]], np.int32)
    for j_impl, t_impl in (("xla", "plain"), ("pallas", "plain")):
        jl, jn = j_tf.paged_decode_step(jp, jc, jnp.asarray(last), jpg, jnp.asarray(block),
                                        jnp.asarray(length), decode_attn=j_impl)
        tl, tn = t_tf.paged_decode_step(tp, tc, torch.from_numpy(last).long(), tpg,
                                        torch.from_numpy(block).long(),
                                        torch.from_numpy(length), decode_attn=t_impl)
        _close(jl[0], tl[0])
        assert tn["seg0"]["l0"] is tpg["seg0"]["l0"]  # updated in place
        np.testing.assert_allclose(tn["seg0"]["l0"].k[:, 1:].numpy(),
                                   np.asarray(jn["seg0"]["l0"].k)[:, 1:], atol=ATOL, rtol=RTOL)


def test_unported_families_raise():
    """Every mixer family builds now (the recurrent ones: ``tests/
    test_torch_mamba.py``, ``test_torch_xlstm.py``); what still raises is
    the paged cache for any mixer but attention, as the reference's does,
    and an unknown mixer."""
    tc = TConfig(**TINY)
    gen = torch.Generator()
    hybrid = tc.replace(num_layers=4, hybrid_pattern=("mamba", "attn"), ssm=SSMConfig())
    p = t_tf.init_params(gen, hybrid, device="meta")
    assert set(p["seg0"]["l0"]["mixer"]) >= {"A_log", "D", "conv_w", "in_proj"}
    c = t_tf.init_cache(hybrid, 1, 4, torch.float32)
    assert isinstance(c["seg0"]["l0"], t_cache.MambaCache) and c["seg0"]["l1"].index == 0
    for mixer in ("mla", "mamba"):
        with pytest.raises(ValueError, match="attn-only"):
            t_tf.init_paged_cache(tc.replace(mixer=mixer, ssm=SSMConfig()), 4, 2, torch.float32)
    with pytest.raises(KeyError):
        t_tf.init_params(gen, tc.replace(mixer="rwkv"), device="meta")
