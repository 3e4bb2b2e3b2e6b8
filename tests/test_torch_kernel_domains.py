"""Port parity at the kernels' widened domains: any GQA group and head
widths to 256 for decode and flash attention, l1 / l∞ rows past one staged
centroid row for nearest-centroid assignment, and a re-headed model served
end to end.

On the CPU the port's ops take their kernels' plain versions; the JAX side
runs its Pallas kernels in interpret mode, as its own tests run them.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances: 2e-5 in f32 and 3e-2 in bf16 for attention (the JAX package's
``tests/test_kernels_decode.py`` and ``test_kernels_flash.py``); for
nearest centroid, indices equal and distances within atol 1e-5 + rtol
1e-5 (the JAX pdist test's ``jnp.allclose``).  The zero-column pad of a
head width that is no multiple of 8 is held bitwise against the plain
version at the true width.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as j_dec  # noqa: E402
from repro.kernels.decode_attention import ref as j_dec_ref  # noqa: E402
from repro.kernels.flash_attention import ops as j_fa  # noqa: E402
from repro.kernels.flash_attention import ref as j_fa_ref  # noqa: E402
from repro.kernels.pdist_argmin import ops as j_pd  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models.config import ModelConfig as JConfig  # noqa: E402
from repro.serve import ContinuousLMEngine as JEngine  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.kernels import _heads as t_heads  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as t_dec_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_dec  # noqa: E402
from repro_torch.kernels.decode_attention import ref as t_dec_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_fa  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_fa_ref  # noqa: E402
from repro_torch.kernels.pdist_argmin import kernel as t_pd_kernel  # noqa: E402
from repro_torch.kernels.pdist_argmin import ops as t_pd  # noqa: E402
from repro_torch.models.config import ModelConfig as TConfig  # noqa: E402
from repro_torch.serve import ContinuousLMEngine  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 3e-2
PDIST_ATOL = PDIST_RTOL = 1e-5

GROUPS = (3, 5, 7, 12, 71)
WIDTHS = (24, 36, 80, 96, 256)


def _max_diff(jax_out, torch_out) -> float:
    return float(np.max(np.abs(
        np.asarray(jnp.asarray(jax_out).astype(jnp.float32)) - torch_out.float().numpy())))


def _normal(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


# ----------------------------------------------------------------------------
# Decode attention: any G, D to 256
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("D", WIDTHS)
@pytest.mark.parametrize("G", GROUPS)
def test_decode_any_group_and_width_matches_jax(G, D):
    """f32 decode at (B 2, S 70, Hkv 1 or 2) against the JAX Pallas kernel
    in interpret mode and its reference, rows of lengths 70 and 33."""
    Hkv = 1 if G > 12 else 2
    B, S, Hq = 2, 70, G * Hkv
    rng = np.random.default_rng(G * 1000 + D)
    q, k, v = _normal(rng, B, Hq, D), _normal(rng, B, S, Hkv, D), _normal(rng, B, S, Hkv, D)
    vl = np.array([S, 33], np.int32)
    out = t_dec.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), torch.from_numpy(vl))
    assert out.shape == (B, Hq, D) and out.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    assert _max_diff(j_dec.decode_attention(jq, jk, jv, jnp.asarray(vl), bk=64), out) < F32_TOL
    assert _max_diff(j_dec_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(vl)), out) < F32_TOL


@pytest.mark.parametrize("G,D", list(zip(GROUPS, WIDTHS)), ids=str)
def test_decode_any_group_and_width_matches_jax_bf16(G, D):
    B, S, Hkv = 2, 50, 1
    rng = np.random.default_rng(G + D)
    q, k, v = _normal(rng, B, G, D), _normal(rng, B, S, Hkv, D), _normal(rng, B, S, Hkv, D)
    vl = np.array([S, 17], np.int32)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = t_dec.decode_attention(tq, tk, tv, torch.from_numpy(vl))
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    assert _max_diff(j_dec.decode_attention(jq, jk, jv, jnp.asarray(vl), bk=64), out) < BF16_TOL


@pytest.mark.parametrize("D", [20, 36, 100, 250])
def test_decode_zero_column_pad_is_bitwise(D):
    """The wrapper's pad (zero columns up to a multiple of 8) with the true
    width's scale gives the plain version at the true width bitwise: zero
    products add exactly 0 and the scale is the same constant."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.from_numpy(a) for a in (
        _normal(rng, 2, 6, D), _normal(rng, 2, 40, 2, D), _normal(rng, 2, 40, 2, D)))
    vl = torch.tensor([40, 9], dtype=torch.int32)
    Dp = t_heads.padded_width(D)
    assert Dp % 8 == 0 and D < Dp < D + 8
    assert t_heads.head_dim_error(Dp, "ops") is None and t_heads.head_dim_error(D, "ops")
    padded = t_dec_ref.decode_attention_plain(
        t_heads.pad_heads(q, Dp), t_heads.pad_heads(k, Dp), t_heads.pad_heads(v, Dp), vl,
        scale=D ** -0.5)
    want = t_dec_ref.decode_attention_plain(q, k, v, vl)
    assert torch.equal(padded[..., :D].view(torch.int32), want.view(torch.int32))


def test_decode_domain_and_refusal_message():
    """Every multiple of 8 from 8 to 256 is taken; D 264 is refused with the
    domain in the message; no G is refused."""
    taken = [D for D in range(1, 300) if t_heads.head_dim_error(D, "ops") is None]
    assert taken == list(range(8, 257, 8))
    assert "up to 256" in t_heads.head_dim_error(264, "ops")
    assert "ops.decode_attention pads" in t_heads.head_dim_error(36, "ops.decode_attention")
    assert not hasattr(t_dec_kernel, "GROUPS")


# ----------------------------------------------------------------------------
# Flash attention: D to 256
# ----------------------------------------------------------------------------

#: (causal, window, q_offset, T, S)
FLASH_MODES = {"causal": (True, 0, 0, 64, 64), "window": (True, 24, 0, 64, 64),
               "q_offset": (True, 0, 40, 40, 80)}


def _jax_flash_ref(jq, jk, jv, **kw):
    t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    return t(j_fa_ref.attention_ref(t(jq), t(jk), t(jv), **kw))


@pytest.mark.parametrize("mode", list(FLASH_MODES))
@pytest.mark.parametrize("D", WIDTHS)
def test_flash_any_width_matches_jax(D, mode):
    causal, window, q_offset, T, S = FLASH_MODES[mode]
    B, Hq, Hkv = 1, 4, 2
    rng = np.random.default_rng(D * 7 + len(mode))
    q, k, v = _normal(rng, B, T, Hq, D), _normal(rng, B, S, Hkv, D), _normal(rng, B, S, Hkv, D)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = t_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               **kw)
    assert out.shape == (B, T, Hq, D)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    assert _max_diff(j_fa.flash_attention(jq, jk, jv, bq=32, bk=32, **kw), out) < F32_TOL
    assert _max_diff(_jax_flash_ref(jq, jk, jv, **kw), out) < F32_TOL


@pytest.mark.parametrize("D", WIDTHS)
def test_flash_any_width_matches_jax_bf16(D):
    B, T, Hq, Hkv = 1, 64, 4, 1
    rng = np.random.default_rng(D + 3)
    q, k, v = _normal(rng, B, T, Hq, D), _normal(rng, B, T, Hkv, D), _normal(rng, B, T, Hkv, D)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = t_fa.flash_attention(tq, tk, tv)
    assert out.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    assert _max_diff(j_fa.flash_attention(jq, jk, jv, bq=32, bk=32), out) < BF16_TOL


@pytest.mark.parametrize("D", [20, 36, 100, 250])
def test_flash_zero_column_pad_is_bitwise(D):
    rng = np.random.default_rng(D + 1)
    q, k, v = (torch.from_numpy(a).transpose(1, 2) for a in (
        _normal(rng, 1, 48, 4, D), _normal(rng, 1, 48, 2, D), _normal(rng, 1, 48, 2, D)))
    Dp = t_heads.padded_width(D)
    for plain in (t_fa_ref.attention_ref, t_fa_ref.attention_bf16p):
        kw = dict(causal=True, window=20)
        padded = plain(t_heads.pad_heads(q, Dp), t_heads.pad_heads(k, Dp), t_heads.pad_heads(v, Dp),
                       scale=D ** -0.5, **kw)
        want = plain(q, k, v, **kw)
        assert torch.equal(padded[..., :D].view(torch.int32), want.view(torch.int32))


def test_flash_domain_and_refusal_message():
    with pytest.raises(ValueError, match="no kernel for D=264: .*up to 256 .*wgmma"):
        t_fa_kernel._check_head_dim(264)
    with pytest.raises(ValueError, match="ops.flash_attention pads"):
        t_fa_kernel._check_head_dim(36)
    t_fa_kernel._check_head_dim(256)


@pytest.mark.parametrize("D", [8, 24, 40, 64, 80, 96, 128, 192, 256])
def test_tf32_image_decodes_by_width_class(D):
    """``tf32_image_ref`` lays every width out in the tiles of its class
    (``width_class``): decoding each tile by the swizzle and the key order
    gives back k and v (hi + lo within 2^-22 of each value), zero past S and
    past D; at class 256 the tile is eight parts (K's 64-column quarters,
    then Vᵀ's 64-row quarters), each its hi plane, then its lo plane."""
    Dc = t_fa_ref.width_class(D)
    assert D <= Dc and (Dc == D or D not in t_fa_ref.OWN_WIDTHS)
    B, S, Hkv = 1, 70, 2
    rng = np.random.default_rng(D)
    k = torch.from_numpy(_normal(rng, B, S, Hkv, D))
    v = torch.from_numpy(_normal(rng, B, S, Hkv, D))
    img = t_fa_ref.tf32_image_ref(k, v)
    kb, nb = -(-Dc // 32), (1 if Dc < 64 else Dc // 64)
    nkt = -(-S // 64)
    tile = 2 * kb * 2048 + 2 * nb * 4096
    assert img.shape == (B * Hkv * nkt * tile,)
    img = img.reshape(B, Hkv, nkt, tile)
    r = torch.arange(64)[:, None]
    c = torch.arange(kb * 32)[None, :]
    swz_k = r * 32 + (((c // 4) % 8) ^ (r % 8)) * 4 + c % 4
    dd = torch.arange(nb * 64)[:, None]
    pk = torch.arange(64)[None, :]
    swz_v = (dd % 64) * 32 + (((pk % 32) // 4) ^ (dd % 8)) * 4 + pk % 4
    if Dc == 256:  # part = 8192 floats: hi (4096), then lo
        k_off = (c // 64) * 8192 + ((c % 64) // 32) * 2048 + swz_k
        k_lo = k_off + 4096
        v_off = 2 * kb * 2048 + (dd // 64) * 8192 + (pk // 32) * 2048 + swz_v
        v_lo = v_off + 4096
    else:  # hi plane, then lo plane
        k_off = (c // 32) * 2048 + swz_k
        k_lo = k_off + kb * 2048
        v_off = 2 * kb * 2048 + ((dd // 64) * 2 + pk // 32) * 2048 + swz_v
        v_lo = v_off + nb * 4096
    keys = t_fa_ref.vt_key_at(torch.arange(64))
    got_k = (img[..., k_off] + img[..., k_lo]).reshape(B, Hkv, nkt * 64, -1)
    per_key = torch.empty((B, Hkv, nkt, nb * 64, 64))
    per_key[..., keys] = img[..., v_off] + img[..., v_lo]
    got_v = per_key.transpose(-1, -2).reshape(B, Hkv, nkt * 64, -1)
    for got, x in ((got_k, k), (got_v, v)):
        full = torch.zeros((B, Hkv, nkt * 64, got.shape[-1]))
        full[:, :, :S, :D] = x.permute(0, 2, 1, 3)
        assert float((got - full).abs().max()) <= 2.0 ** -22 * float(x.abs().max())
        assert bool((got[:, :, S:] == 0).all()) and bool((got[..., D:] == 0).all())


# ----------------------------------------------------------------------------
# Nearest centroid under l1 / l∞ past one staged centroid row
# ----------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l1", "linf"])
def test_pdist_wide_rows_match_jax(metric):
    """N 16 × K 4 at d 60,000 (past the 58,108 columns a block stages): the
    port's plain version against the JAX Pallas kernel in interpret mode;
    each point sits near one centroid, so the indices are that centroid."""
    N, K, d = 16, 4, 60_000
    rng = np.random.default_rng(11)
    C = _normal(rng, K, d)
    near = rng.integers(0, K, size=N)
    X = (C[near] + 0.1 * _normal(rng, N, d)).astype(np.float32)
    assert d > t_pd_kernel.MAX_D_STAGED
    idx, dist = t_pd.pdist_argmin(torch.from_numpy(X), torch.from_numpy(C), metric=metric)
    jidx, jdist = j_pd.pdist_argmin(jnp.asarray(X), jnp.asarray(C), metric=metric)
    assert np.array_equal(idx.numpy(), np.asarray(jidx)) and np.array_equal(idx.numpy(), near)
    jd = np.asarray(jdist)
    assert np.all(np.abs(dist.numpy() - jd) <= PDIST_ATOL + PDIST_RTOL * np.abs(jd))


@pytest.mark.parametrize("shape", [(4096, 16, 100_000), (600, 16, 58_109), (257, 20, 70_001),
                                   (1, 1, 58_109), (5_000_000, 1000, 60_000)], ids=str)
def test_pdist_wide_plan_covers_d(shape):
    """The split kernel's plan: splits of a multiple of 64 columns that
    cover d exactly once, within grid.z, and blocks enough to fill 132 SMs
    where d allows it."""
    N, K, d = shape
    jlen, nsplit = t_pd_kernel.plan_wide(N, K, d, 132)
    assert jlen % t_pd_kernel.WIDE_CHUNK == 0 and jlen >= t_pd_kernel.WIDE_CHUNK
    assert (nsplit - 1) * jlen < d <= nsplit * jlen and 1 <= nsplit <= 65535
    cells = -(-N // t_pd_kernel.WIDE_POINTS) * -(-K // t_pd_kernel.WIDE_CENTROIDS)
    # rounding a split up to whole chunks at most halves the blocks
    assert 2 * cells * nsplit >= min(t_pd_kernel.WIDE_BLOCKS_PER_SM * 132, cells * -(-d // 64))


# ----------------------------------------------------------------------------
# A re-headed model served end to end
# ----------------------------------------------------------------------------

REHEADED = dict(
    name="reheaded", vocab_size=97, d_model=64, num_layers=2, num_heads=2,
    num_kv_heads=1, head_dim=96, d_ff=128, compute_dtype="float32",
    param_dtype="float32",
)


@pytest.mark.parametrize("use_kernel", [False, True], ids=["xla", "pallas"])
def test_reheaded_engine_greedy_ids_match_jax(use_kernel):
    """Two layers of width 64 with 2 query heads and 1 KV head at D 96 (G 2,
    a width the first kernels did not take): the port's engine, its
    weights carried across by ``convert.py``, gives the JAX engine's greedy
    ids, with the JAX decode through its XLA mirror or its Pallas kernel."""
    jc, tc = JConfig(**REHEADED), TConfig(**REHEADED)
    jp = j_tf.init_params(jax.random.key(3), jc)
    tp = params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    reqs = [(rng.integers(0, jc.vocab_size, size=n).astype(np.int32), g)
            for n, g in [(3, 6), (5, 3), (1, 5), (7, 2)]]

    def serve(engine):
        tickets = [engine.submit(p, max_new=g) for p, g in reqs]
        engine.run_until_idle()
        return [t.result().tolist() for t in tickets]

    port = ContinuousLMEngine(tc, tp, device="cpu", n_slots=3, page_size=4, max_seq=24)
    ref = JEngine(jc, jp, n_slots=3, page_size=4, max_seq=24, use_kernel=use_kernel)
    assert serve(port) == serve(ref)
    assert port.kernel_hits["plain"] == sum(g - 1 for _, g in reqs)
