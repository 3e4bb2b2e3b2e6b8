"""Port parity: forward flash attention of ``repro_torch`` against the JAX
package's ``kernels/flash_attention``.

On the CPU the port's ``ops.flash_attention`` takes the kernel's plain
version (``ref.attention_ref``), the function ``chip_smoke.py`` and
``tests/test_torch_cuda.py`` hold the CUDA kernel to on the card.  The JAX
side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode through ``ops.flash_attention``, and ``ref.attention_ref``.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the JAX package's own (``tests/test_kernels_flash.py``):
2e-5 in f32, 3e-2 in bf16.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import ops as j_ops  # noqa: E402
from repro.kernels.flash_attention import ref as j_ref  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.flash_attention import ops as t_ops  # noqa: E402
from repro_torch.kernels._tf32 import tf32_round  # noqa: E402
from repro_torch.kernels.flash_attention import ref as t_ref  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, TF32_TILE, _mask, vt_key_at)

F32_TOL = 2e-5
BF16_TOL = 3e-2

# (B, T, S, Hq, Hkv, D, causal, window): the SHAPES of tests/test_kernels_flash.py
SHAPES = [
    (2, 64, 64, 4, 2, 32, True, 0),
    (1, 128, 128, 8, 8, 64, True, 0),
    (2, 96, 96, 4, 1, 16, True, 0),  # padding (96 % 64 != 0 with bq=64)
    (2, 64, 64, 8, 2, 32, True, 24),  # sliding window
    (1, 48, 48, 4, 4, 64, False, 0),  # bidirectional
]


def _inputs(seed, B, T, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _both(q, k, v, dtype=np.float32):
    """The numpy inputs as JAX and torch arrays of one type."""
    jd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    td = torch.bfloat16 if dtype == "bf16" else torch.float32
    return ([jnp.asarray(a).astype(jd) for a in (q, k, v)],
            [torch.from_numpy(a).to(td) for a in (q, k, v)])


def _max_diff(jax_out, torch_out) -> float:
    return float(np.max(np.abs(
        np.asarray(jnp.asarray(jax_out).astype(jnp.float32)) - torch_out.float().numpy())))


def _jax_ref(jq, jk, jv, **kw):
    t = lambda a: a.transpose(0, 2, 1, 3)  # noqa: E731
    return t(j_ref.attention_ref(t(jq), t(jk), t(jv), **kw))


@pytest.mark.parametrize("case", SHAPES, ids=str)
def test_flash_matches_jax_kernel_and_ref_f32(case):
    B, T, S, Hq, Hkv, D, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(*_inputs(sum(case[:6]), B, T, S, Hq, Hkv, D))
    out = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window, bq=32, bk=32)
    assert out.shape == (B, T, Hq, D) and out.dtype == torch.float32
    jout = j_ops.flash_attention(jq, jk, jv, causal=causal, window=window, bq=32, bk=32)
    assert _max_diff(jout, out) < F32_TOL
    assert _max_diff(_jax_ref(jq, jk, jv, causal=causal, window=window), out) < F32_TOL


@pytest.mark.parametrize("case", SHAPES, ids=str)
def test_flash_matches_jax_kernel_bf16(case):
    B, T, S, Hq, Hkv, D, causal, window = case
    (jq, jk, jv), (tq, tk, tv) = _both(*_inputs(sum(case[:6]) + 1, B, T, S, Hq, Hkv, D),
                                       dtype="bf16")
    out = t_ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert out.dtype == torch.bfloat16
    jout = j_ops.flash_attention(jq, jk, jv, causal=causal, window=window, bq=32, bk=32)
    assert _max_diff(jout, out) < BF16_TOL


@pytest.mark.parametrize("q_offset,window", [(60, 0), (60, 16), (10, 0)])
def test_flash_query_offset(q_offset, window):
    """T < S with the queries placed at q_offset: the chunked-prefill
    layout the kernel's ``q_offset`` serves."""
    B, T, S, Hq, Hkv, D = 2, 40, 100, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(*_inputs(q_offset + window, B, T, S, Hq, Hkv, D))
    out = t_ops.flash_attention(tq, tk, tv, window=window, q_offset=q_offset)
    jout = j_ops.flash_attention(jq, jk, jv, window=window, q_offset=q_offset, bq=32, bk=32)
    assert _max_diff(jout, out) < F32_TOL
    assert _max_diff(_jax_ref(jq, jk, jv, window=window, q_offset=q_offset), out) < F32_TOL


def test_flash_fully_masked_rows_give_zero():
    """A window behind a query offset past the keys leaves rows that see
    no key at all: 0, as the JAX kernel's guarded divide and its
    reference's ``isnan → 0`` give."""
    B, T, S, Hq, Hkv, D = 1, 64, 64, 4, 2, 32
    (jq, jk, jv), (tq, tk, tv) = _both(*_inputs(5, B, T, S, Hq, Hkv, D))
    out = t_ops.flash_attention(tq, tk, tv, window=8, q_offset=40)
    dead = (out == 0).all(dim=-1).all(dim=-1)[0]
    # rows t see keys (t + 32, t + 40] ∩ [0, 64): none from t = 31 on
    assert bool(dead[31:].all()) and not bool(dead[:31].any())
    jout = j_ops.flash_attention(jq, jk, jv, window=8, q_offset=40, bq=32, bk=32)
    assert _max_diff(jout, out) < F32_TOL
    assert bool((np.asarray(jout)[0, 31:] == 0).all())


def test_flash_block_shape_independence():
    """The result does not depend on ``bq``/``bk`` (the JAX test's
    property), and both agree with the JAX kernel at two block shapes."""
    (jq, jk, jv), (tq, tk, tv) = _both(*_inputs(3, 1, 128, 128, 4, 4, 32))
    o1 = t_ops.flash_attention(tq, tk, tv, bq=32, bk=32)
    o2 = t_ops.flash_attention(tq, tk, tv, bq=64, bk=128)
    assert torch.equal(o1, o2)
    for bq, bk in ((32, 32), (64, 128)):
        assert _max_diff(j_ops.flash_attention(jq, jk, jv, bq=bq, bk=bk), o1) < F32_TOL


def test_flash_plain_version_matches_jax_ref_layout():
    """``ref.attention_ref`` in its own (B, H, T, D) layout against the JAX
    one, GQA with a window and an offset."""
    q, k, v = _inputs(11, 2, 48, 80, 6, 3, 16)
    t = lambda a: np.ascontiguousarray(a.transpose(0, 2, 1, 3))  # noqa: E731
    q, k, v = t(q), t(k), t(v)
    kw = dict(causal=True, window=20, q_offset=32)
    out = t_ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    exp = j_ref.attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    assert _max_diff(exp, out) < F32_TOL


def test_flash_routes_by_device():
    q = torch.zeros((1, 8, 2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        t_ops.flash_attention(q, q, q)


def test_route_is_a_fixed_function_of_the_type():
    """bf16 goes to the bf16 tensor-core kernel, f32 to the 3xTF32 one, and
    no other type has a kernel; the CPU path takes the routed kernel's
    plain version."""
    assert t_kernel.route(torch.bfloat16) == "flash_attention_tc"
    assert t_kernel.route(torch.float32) == "flash_attention_tf32"
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            t_kernel.route(dtype)
    assert t_ops.PLAIN == {"flash_attention_tf32": t_ref.attention_ref,
                           "flash_attention_tc": t_ref.attention_bf16p}
    from repro_torch import kernels

    assert set(t_kernel.ROUTES.values()) <= set(kernels.KERNEL_NAMES)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cpu_path_takes_the_routed_plain_version(dtype):
    (_, _, _), (tq, tk, tv) = _both(*_inputs(21, 2, 96, 96, 4, 2, 32),
                                     dtype="bf16" if dtype == torch.bfloat16 else np.float32)
    out = t_ops.flash_attention(tq, tk, tv, window=40)
    plain = t_ops.PLAIN[t_kernel.route(dtype)]
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    assert torch.equal(out, t(plain(t(tq), t(tk), t(tv), window=40)))


# (B, T, S, Hq, Hkv, D, causal, window, q_offset): the JAX test shapes, a
# query offset with T < S, rows that see no key, D 8 and D 128
BF16P_CASES = [c + (0,) for c in SHAPES] + [
    (2, 40, 100, 4, 2, 32, True, 0, 60), (1, 64, 64, 4, 2, 32, True, 8, 40),
    (1, 70, 70, 2, 1, 8, True, 0, 0), (1, 130, 130, 4, 2, 128, True, 0, 0),
]


@pytest.mark.parametrize("case", BF16P_CASES, ids=str)
def test_bf16p_plain_matches_ref_and_jax_kernel(case):
    """The tensor-core kernel's arithmetic (online softmax over 64-key
    tiles, P rounded to bf16 for P·V, l summed in f32) against
    ``attention_ref`` and the JAX kernel in interpret mode, in bf16 at the
    JAX package's bf16 limit; rows that see no key are exactly 0."""
    B, T, S, Hq, Hkv, D, causal, window, q_offset = case
    (jq, jk, jv), (tq, tk, tv) = _both(*_inputs(sum(case[:6]) + 7, B, T, S, Hq, Hkv, D),
                                       dtype="bf16")
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    out = t(t_ref.attention_bf16p(t(tq), t(tk), t(tv), **kw))
    assert out.dtype == torch.bfloat16 and out.shape == tq.shape
    ref = t(t_ref.attention_ref(t(tq), t(tk), t(tv), **kw))
    assert float((out.float() - ref.float()).abs().max()) < BF16_TOL
    jout = j_ops.flash_attention(jq, jk, jv, bq=32, bk=32, **kw)
    assert _max_diff(jout, out) < BF16_TOL
    dead = (ref.float() == 0).all(dim=-1)
    assert bool((out[dead] == 0).all())
    if q_offset == 40:  # the window leaves rows 31.. without a key
        assert bool(dead[0, 31:].all())


def test_bf16p_rounds_p_where_attention_ref_does_not():
    """On f32 inputs the two plain versions differ only by P's rounding to
    bf16 in P·V: within bf16's relative step of each other, and not equal."""
    (_, _, _), (tq, tk, tv) = _both(*_inputs(4, 1, 128, 128, 4, 2, 64))
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    a = t_ref.attention_ref(t(tq), t(tk), t(tv))
    b = t_ref.attention_bf16p(t(tq), t(tk), t(tv))
    diff = float((a - b).abs().max())
    assert 0.0 < diff < 2.0 ** -8 * float(tv.abs().max())


# ----------------------------------------------------------------------------
# The f32 route on the card (csrc/flash_attention_tf32.cu) takes both
# products as three TF32 products a term.  Its arithmetic, emulated in
# plain PyTorch (attention_3xtf32 below), is held here to the JAX kernel in
# interpret mode and to attention_ref at the f32 limit; 1xTF32 and a
# mismatched key order must miss it.  The prep kernel's image is checked
# by decoding its plain version (ref.tf32_image_ref).
# ----------------------------------------------------------------------------

#: the kernel's register mapping: position p of each 8-key k-step of P·V
#: holds key FRAGMENT_KEYS[p] in the A registers (the kernel passes the S
#: accumulators s[4j], s[4j + 2], s[4j + 1], s[4j + 3], keys 2·t4 and
#: 2·t4 + 1, to positions t4 and t4 + 4)
FRAGMENT_KEYS = (0, 2, 4, 6, 1, 3, 5, 7)


def _split(x: torch.Tensor, passes: int):
    hi = tf32_round(x)
    return hi, (tf32_round(x - hi) if passes == 3 else torch.zeros_like(x))


def _tf32_product(a, b, eq: str, passes: int, step: int = 8):
    """a·b over the last axis of a (the k axis of ``eq``) as the kernel
    takes it: for each ``step``-wide k-step, lo_a·hi_b + hi_a·lo_b +
    hi_a·hi_b added in that order, then the k-steps added in order, in f32
    (``passes`` 1: hi_a·hi_b alone, 1xTF32); each product of TF32 values is
    exact in f32."""
    (ah, al), (bh, bl) = _split(a, passes), _split(b, passes)
    out = None
    for k0 in range(0, a.shape[-1], step):
        ks = slice(k0, k0 + step)
        terms = ([(al, bh), (ah, bl)] if passes == 3 else []) + [(ah, bh)]
        part = None  # the k-step's products, then added to the running sum
        for x, y in terms:
            yk = y[..., ks, :] if eq.endswith("sd->bhgtd") else y[..., ks]
            t = torch.einsum(eq, x[..., ks], yk)
            part = t if part is None else part + t
        out = part if out is None else out + part
    return out


def attention_3xtf32(q, k, v, *, causal: bool = True, window: int = 0, q_offset: int = 0,
                     passes: int = 3, fragment_keys=FRAGMENT_KEYS, vt_keys=None) -> torch.Tensor:
    """The f32 route's arithmetic in the layout of ``attention_ref`` (q (B,
    Hq, T, D), k/v (B, Hkv, S, D), f32): logits as three TF32 products a
    k-step of 8 head columns (``_tf32_product``), an online softmax over
    64-key tiles from key 0 with f32 running (m, l), masked logits −inf and
    p exactly 0, then P·V as three TF32 products a k-step of 8 keys, with
    P's columns taken in the A fragment's key order (``fragment_keys``) and
    Vᵀ's rows in the prep's (``vt_keys``, by default ``vt_key_at``): the two
    orders must agree, or keys are paired with the wrong values.  The end
    divides by l where l > 0 (by 1 elsewhere).  ``passes=1`` is the 1xTF32
    control."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, T, D).float()
    kf, vf = k.float(), v.float()
    nkt = -(-S // TF32_TILE)
    pad = nkt * TF32_TILE - S
    kf = torch.nn.functional.pad(kf, (0, 0, 0, pad))
    vf = torch.nn.functional.pad(vf, (0, 0, 0, pad))
    mask = torch.nn.functional.pad(_mask(T, S, causal, window, q_offset, q.device), (0, pad))
    a_keys = torch.tensor(fragment_keys, device=q.device)
    v_keys = (vt_key_at(torch.arange(8, device=q.device)) if vt_keys is None
              else torch.tensor(vt_keys, device=q.device))
    m = torch.full(qg.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for k0 in range(0, nkt * TF32_TILE, TF32_TILE):
        keep = mask[:, k0:k0 + TF32_TILE]
        s = _tf32_product(qg, kf[:, :, k0:k0 + TF32_TILE], "bhgtd,bhsd->bhgts", passes)
        s = torch.where(keep, s * (D ** -0.5), float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(dim=-1)
        # the positions of each 8-key k-step: P through the A fragment, V
        # through the prepared Vᵀ rows
        base = torch.arange(0, TF32_TILE, 8, device=q.device)[:, None]
        p_phys = p[..., (base + a_keys).reshape(-1)]
        v_phys = vf[:, :, k0:k0 + TF32_TILE][:, :, (base + v_keys).reshape(-1)]
        pv = _tf32_product(p_phys, v_phys, "bhgts,bhsd->bhgtd", passes)
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.where(l > 0.0, l, 1.0)[..., None]
    return out.reshape(B, Hq, T, D).to(q.dtype)


#: the f32 route's cases: BF16P_CASES (the JAX test shapes, a query offset
#: with T < S, rows that see no key, D 8 and D 128) and a ragged S past one
#: 64-key tile with a window
TF32_CASES = BF16P_CASES + [(2, 100, 131, 6, 3, 16, False, 50, 0)]


def _tf32(case, seed, scale=1.0, worst=False):
    B, T, S, Hq, Hkv, D = case[:6]
    q, k, v = _inputs(seed, B, T, S, Hq, Hkv, D)
    q, k = q * scale, k * scale
    if worst:  # every q and k element at the split's worst case
        q, k = _worst_split(q), _worst_split(k)
    return q, k, v


def _worst_split(a: np.ndarray) -> np.ndarray:
    """The same values with their low 13 bits set to 0x1001: just above half
    a TF32 step, so hi rounds away by almost half a step and lo = tf32(v −
    hi) rounds away by half of its own, the most 3xTF32 drops a term."""
    u = a.astype(np.float32).view(np.uint32)
    return ((u & ~np.uint32(0x1FFF)) | np.uint32(0x1001)).view(np.float32)


def _emulated(q, k, v, case, **kw):
    causal, window, q_offset = case[6:]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))  # noqa: E731
    out = attention_3xtf32(t(q), t(k), t(v), causal=causal, window=window,
                                 q_offset=q_offset, **kw)
    return out.transpose(1, 2)


@pytest.mark.parametrize("case", TF32_CASES, ids=str)
def test_3xtf32_emulation_matches_jax_kernel_and_ref(case):
    """The f32 route's arithmetic (three TF32 products a term, 64-key tiles,
    the Vᵀ key order) against the JAX kernel (interpret mode) and
    ``attention_ref`` at the f32 limit; rows that see no key are 0."""
    q, k, v = _tf32(case, sum(case[:6]) + 13)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    causal, window, q_offset = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = _emulated(q, k, v, case)
    assert out.dtype == torch.float32 and out.shape == tq.shape
    jout = j_ops.flash_attention(jq, jk, jv, bq=32, bk=32, **kw)
    assert _max_diff(jout, out) < F32_TOL
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    ref = t(t_ref.attention_ref(t(tq), t(tk), t(tv), **kw))
    assert float((out - ref).abs().max()) < F32_TOL
    dead = (ref == 0).all(dim=-1)
    assert bool((out[dead] == 0).all())


@pytest.mark.parametrize("scale", [2.0, 3.0])
def test_3xtf32_emulation_holds_at_the_split_worst_case(scale):
    """Large q and k (q, k ~ N(0, scale²): logits of standard deviation
    scale², a peaked softmax) whose every element sits at the split's worst
    case still hold the f32 limit against the JAX kernel and
    ``attention_ref``, and 1xTF32 does not.  Past scale 3 the limit stops
    measuring TF32: the JAX package's own f32 kernel leaves attention_ref by
    1.9e-5 at scale 4 and 4.0e-5 at scale 6 on these inputs (its online
    softmax and f32 logits of ±100), and so does 3xTF32, by as much."""
    case = (1, 128, 128, 4, 2, 64, True, 0, 0)
    q, k, v = _tf32(case, 31, scale=scale, worst=True)
    (jq, jk, jv), (tq, tk, tv) = _both(q, k, v)
    out = _emulated(q, k, v, case)
    t = lambda a: a.transpose(1, 2)  # noqa: E731
    ref = t(t_ref.attention_ref(t(tq), t(tk), t(tv)))
    assert float((out - ref).abs().max()) < F32_TOL
    assert _max_diff(j_ops.flash_attention(jq, jk, jv, bq=32, bk=32), out) < F32_TOL
    one = _emulated(q, k, v, case, passes=1)
    assert float((one - ref).abs().max()) > F32_TOL


@pytest.mark.parametrize("case", [SHAPES[0] + (0,), SHAPES[1] + (0,), TF32_CASES[-1]], ids=str)
def test_1xtf32_control_misses_the_f32_limit(case):
    """The planted control: one TF32 product a term (hi·hi alone), the same
    emulation otherwise, misses 2e-5 against the JAX kernel at N(0, 1)
    inputs, so the comparisons above can see a route that dropped the
    lo terms."""
    q, k, v = _tf32(case, sum(case[:6]) + 13)
    (jq, jk, jv), _ = _both(q, k, v)
    causal, window, q_offset = case[6:]
    jout = j_ops.flash_attention(jq, jk, jv, bq=32, bk=32, causal=causal, window=window,
                                 q_offset=q_offset)
    assert _max_diff(jout, _emulated(q, k, v, case)) < F32_TOL
    assert _max_diff(jout, _emulated(q, k, v, case, passes=1)) > F32_TOL


def test_3xtf32_key_orders_must_agree():
    """P reaches the A fragment in the order ``FRAGMENT_KEYS`` and the prep
    writes Vᵀ in the order ``vt_key_at``: they are the same order, and the
    emulation with either one replaced by the natural order pairs keys with
    the wrong values."""
    pos = torch.arange(8)
    assert tuple(t_ref.vt_key_at(pos).tolist()) == FRAGMENT_KEYS
    assert sorted(FRAGMENT_KEYS) == list(range(8))
    # the register mapping of the kernel: position t4 <- s[4j] (key 2 t4),
    # position t4 + 4 <- s[4j + 1] (key 2 t4 + 1)
    assert FRAGMENT_KEYS == tuple([2 * t for t in range(4)] + [2 * t + 1 for t in range(4)])
    case = SHAPES[0] + (0,)
    q, k, v = _tf32(case, 3)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)))  # noqa: E731
    ref = t_ref.attention_ref(t(q), t(k), t(v))
    good = attention_3xtf32(t(q), t(k), t(v))
    assert float((good - ref).abs().max()) < F32_TOL
    for kw in (dict(vt_keys=tuple(range(8))), dict(fragment_keys=tuple(range(8)))):
        bad = attention_3xtf32(t(q), t(k), t(v), **kw)
        assert float((bad - ref).abs().max()) > 0.1


@pytest.mark.parametrize("shape", [(2, 130, 3, 64), (1, 64, 2, 8), (1, 70, 1, 128),
                                   (2, 5, 2, 16), (1, 100, 1, 32)], ids=str)
def test_tf32_image_decodes_to_k_and_v(shape):
    """The prep kernel's plain version: decoding each tile by the swizzle
    and the key order gives back k and v (hi + lo within 2⁻²² of each
    value, hi a TF32 value, hi and lo exact in a product), zero past S and
    past D; the image is as long as the kernel's ``repro_flash_tf32_image_bytes``
    says (2 planes × (⌈D/32⌉ 8 KB K blocks + max(1, D/64) 16 KB Vᵀ blocks)
    a tile)."""
    B, S, Hkv, D = shape
    rng = np.random.default_rng(sum(shape))
    k = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    img = t_ref.tf32_image_ref(k, v)
    kb, nb = -(-D // 32), max(1, D // 64)
    nkt = -(-S // 64)
    tile = 2 * kb * 2048 + 2 * nb * 4096
    assert img.shape == (B * Hkv * nkt * tile,)
    img = img.reshape(B, Hkv, nkt, tile)
    assert int((img.view(torch.int32) & 0x1FFF).abs().max()) == 0  # every value TF32
    r = torch.arange(64)[:, None]
    c = torch.arange(kb * 32)[None, :]
    k_off = (c // 32) * 2048 + r * 32 + (((c // 4) % 8) ^ (r % 8)) * 4 + c % 4
    k_hi, k_lo = img[..., k_off], img[..., kb * 2048 + k_off]  # (B, Hkv, nkt, 64, kb·32)
    dd = torch.arange(nb * 64)[:, None]
    pk = torch.arange(64)[None, :]
    v_off = (2 * kb * 2048 + ((dd // 64) * 2 + pk // 32) * 2048 + (dd % 64) * 32
             + (((pk % 32) // 4) ^ (dd % 8)) * 4 + pk % 4)
    v_hi, v_lo = img[..., v_off], img[..., nb * 4096 + v_off]  # (B, Hkv, nkt, nb·64, 64)
    keys = t_ref.vt_key_at(torch.arange(64))
    for hi, lo, x, vt in ((k_hi, k_lo, k, False), (v_hi, v_lo, v, True)):
        full = torch.zeros((B, Hkv, nkt * 64, hi.shape[-1 if not vt else -2]))
        if vt:  # rows are head columns, positions keys in vt_key_at's order
            per_key = torch.empty_like(hi)
            per_key[..., keys] = hi + lo
            got = per_key.transpose(-1, -2).reshape(B, Hkv, nkt * 64, -1)
        else:
            got = (hi + lo).reshape(B, Hkv, nkt * 64, -1)
        full[:, :, :S, :D] = x.permute(0, 2, 1, 3)
        assert float((got - full).abs().max()) <= 2.0**-22 * float(x.abs().max())
        assert bool((got[:, :, S:] == 0).all()) and bool((got[..., D:] == 0).all())
