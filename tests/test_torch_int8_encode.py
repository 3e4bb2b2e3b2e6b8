"""Port parity of the int8 wire encode (``int8_encode``: EF add, row
scale, quantize→dequantize round trip and residual in one call) against
the JAX package's ``Int8Wire``, bitwise (the residual as ``c - out``: XLA
contracts the JAX wire's own into an FMA).

The JAX side runs as its own tests run it on the CPU: ``make_wire`` with
the kernel forced on, so each node's leaf goes through the jitted
``int8_roundtrip`` with its Pallas kernels in interpret mode, one node at a
time under its ``lax.scan``.  On the CPU the port's encode takes its plain
version (``ref.int8_encode_ref``), the function the card tests hold both
CUDA routes to.  Inputs are made with numpy from a seed.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.kernels.int8_quant import ops as j_q8  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.kernels.int8_quant import ops as t_q8  # noqa: E402
from repro_torch.kernels.int8_quant import ref as t_q8_ref  # noqa: E402

#: the fit's (K, D) rows, rows off 16 bytes, and rows just over the
#: 256-element kernel gate
SHAPES = [(16, 2000), (5, 8193), (3, 257)]


def bits(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x)).view(np.uint32)


def assert_bits_equal(jax_x, torch_x):
    a, b = np.asarray(jax_x), torch_x.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(bits(a), bits(b))


def normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("with_ef", [True, False], ids=["int8+ef", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_int8_encode_bitwise_the_jax_wire(shape, with_ef):
    """out and per-row scale bitwise the JAX ``Int8Wire`` encode with its
    Pallas kernels, the residual ``c - out`` bitwise on its out; the
    port's wire with the kernel forced on gives the same out and
    residual."""
    m = normal(sum(shape), shape)
    m[0] *= 50.0  # one node with a much larger range keeps its own scale
    r = normal(sum(shape) + 1, shape, 0.25) if with_ef else None
    jw = japi.make_wire("int8+ef" if with_ef else "int8")
    jw.use_kernel = True
    jstate = jnp.asarray(r) if with_ef else ()
    j_res, j_out, _ = jw.encode_updates(jstate, jnp.asarray(m), stacked=True)

    tm = torch.from_numpy(m)
    tr = None if r is None else torch.from_numpy(r)
    out, res, scale = t_q8.int8_encode(tm, tr)
    assert_bits_equal(j_out, out)
    if with_ef:
        # the residual is c - out rounded once after out was rounded, on
        # JAX's own out; under jit XLA contracts the wire's c - q·s into an
        # FMA (ROADMAP queue 3, item 4), within one rounding of q·s of it
        c = m + r
        assert_bits_equal(c - np.asarray(j_out), res)
        gap = np.abs(np.asarray(j_res, dtype=np.float64) - res.numpy())
        assert np.all(gap <= 2.0**-24 * np.abs(np.asarray(j_out)) + 2.0**-24 * np.abs(res.numpy()))
    else:
        assert res is None
    for i in range(shape[0]):
        c = jnp.asarray(m[i]) if r is None else jnp.asarray(m[i]) + jnp.asarray(r[i])
        assert_bits_equal(j_q8.int8_roundtrip(c)[1], scale[i])

    tw = tapi.Int8Wire(error_feedback=with_ef, use_kernel=True)
    w_res, w_out, _ = tw.encode_updates(tr if with_ef else (), tm, stacked=True)
    assert torch.equal(w_out.view(torch.int32), out.view(torch.int32))
    if with_ef:
        assert torch.equal(w_res.view(torch.int32), res.view(torch.int32))


def test_nan_max_gives_a_nan_scale():
    """A row whose max is NaN gets a NaN scale (clamp_min keeps NaN, where
    fmaxf would give 1e-12), so its whole row decodes to NaN, as in the
    JAX package; the other rows are untouched."""
    m = normal(3, (4, 300))
    m[1, 17] = np.nan
    out, res, scale = t_q8.int8_encode(torch.from_numpy(m), torch.zeros(4, 300))
    assert bool(torch.isnan(scale[1])) and bool(torch.isfinite(scale[[0, 2, 3]]).all())
    assert bool(torch.isnan(out[1]).all()) and bool(torch.isnan(res[1]).all())
    j_out, j_scale = j_q8.int8_roundtrip(jnp.asarray(m[1]))
    assert np.isnan(np.asarray(j_scale)) and np.isnan(np.asarray(j_out)).all()
    clean, _, clean_scale = t_q8.int8_encode(torch.from_numpy(m[[0, 2, 3]]), torch.zeros(3, 300))
    assert torch.equal(out[[0, 2, 3]].view(torch.int32), clean.view(torch.int32))
    assert torch.equal(scale[[0, 2, 3]].view(torch.int32), clean_scale.view(torch.int32))


def _counting(monkeypatch):
    calls = []
    encode = t_q8._encode

    def counted(m, r):
        calls.append(tuple(m.shape))
        return encode(m, r)

    monkeypatch.setattr(t_q8, "_encode", counted)
    return calls


@pytest.mark.parametrize("case", ["ef", "no-ef", "shared-r"])
def test_vmap_folds_scenarios_into_one_call(monkeypatch, case):
    """``torch.func.vmap`` over S scenarios equals S calls bitwise and makes
    ONE call of the op, on S·K rows (a residual without the scenario axis
    is the same for every scenario)."""
    S, K, n = 3, 4, 300
    u = torch.from_numpy(normal(4, (S, K, n)))
    r = torch.from_numpy(normal(5, (S, K, n), 0.25))
    if case == "ef":
        fn, args = t_q8.int8_encode, (u, r)
        want = [t_q8.int8_encode(u[s], r[s]) for s in range(S)]
    elif case == "no-ef":
        fn, args = (lambda a: t_q8.int8_encode(a)[::2]), (u,)
        want = [t_q8.int8_encode(u[s])[::2] for s in range(S)]
    else:
        fn, args = (lambda a: t_q8.int8_encode(a, r[0])), (u,)
        want = [t_q8.int8_encode(u[s], r[0]) for s in range(S)]
    calls = _counting(monkeypatch)
    got = torch.func.vmap(fn)(*args)
    assert calls == [(S * K, n)]
    for s in range(S):
        for g, w in zip(got, want[s]):
            assert torch.equal(g[s].view(torch.int32), w.view(torch.int32))


def test_encode_without_residual_is_the_roundtrip():
    """``int8_encode(x)`` without a residual is ``int8_roundtrip(x)`` and the
    composition the wire used before the encode was one kernel (absmax,
    clamp_min × 1/127, quant-dequant), bitwise."""
    x = torch.from_numpy(normal(6, (5, 8193)))
    out, res, scale = t_q8.int8_encode(x)
    rt_out, rt_scale = t_q8.int8_roundtrip(x)
    s = torch.clamp_min(t_q8_ref.absmax_ref(x), 1e-12) * (1.0 / 127.0)
    assert res is None
    for a, b in ((out, rt_out), (scale, rt_scale), (out, t_q8_ref.quant_dequant_ref(x, s)),
                 (scale, s)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_encode_refuses_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        t_q8._encode(torch.zeros((2, 300), device="meta"), None)
