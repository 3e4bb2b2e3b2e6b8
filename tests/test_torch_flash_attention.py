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
from repro_torch.kernels.flash_attention import ref as t_ref  # noqa: E402

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
    """bf16 goes to the tensor-core kernel, f32 to the CUDA-core one, and
    no other type has a kernel; the CPU path takes the routed kernel's
    plain version."""
    assert t_kernel.route(torch.bfloat16) == "flash_attention_tc"
    assert t_kernel.route(torch.float32) == "flash_attention"
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            t_kernel.route(dtype)
    assert t_ops.PLAIN == {"flash_attention": t_ref.attention_ref,
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
