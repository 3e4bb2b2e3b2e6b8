"""Port parity: the wire-encode kernel ops of ``repro_torch`` against the
jitted JAX ops, bitwise.

The JAX side runs as its own tests run it on the CPU: the jitted
``topk_encode`` / ``int8_roundtrip`` with their Pallas kernels in
interpret mode.  On the CPU the port's ops take their kernels' plain
versions (``ref.py``) — the same functions ``chip_smoke.py`` holds the
CUDA kernels to on the card.  Inputs are made with numpy from a seed and
handed to both packages; equality is on the bit patterns, so signed zeros
count (under jit XLA writes +0.0 for dropped entries, and so does the
port).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.int8_quant import ops as q8_ops  # noqa: E402
from repro.kernels.topk_compress import ops as tk_ops  # noqa: E402
from repro_torch.kernels.int8_quant import ops as t_q8  # noqa: E402
from repro_torch.kernels.topk_compress import ops as t_tk  # noqa: E402

# the shape list of tests/test_wire_kernels.py: across the (8, 1024) tile
# boundary, under it, and both sides of the 256-element kernel gate
SHAPES = [(4096,), (128, 300), (513,), (300,), (8192,), (256,), (257,)]


def bits(x) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x))
    return a.view(np.uint32 if a.dtype == np.float32 else a.dtype)


def assert_bits_equal(jax_x, torch_x):
    a, b = np.asarray(jax_x), torch_x.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(bits(a), bits(b))


def normal(seed, shape, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("with_ef", [False, True], ids=["select", "encode"])
@pytest.mark.parametrize("shape", SHAPES)
def test_topk_encode_bitwise(shape, with_ef):
    x = normal(1, shape)
    r = normal(2, shape, 0.25) if with_ef else None
    k = max(1, x.size // 10)
    jo, jres, jc = tk_ops.topk_encode(
        jnp.asarray(x), None if r is None else jnp.asarray(r), k=k
    )
    to, tres, tc = t_tk.topk_encode(
        torch.from_numpy(x)[None], None if r is None else torch.from_numpy(r)[None],
        k=k,
    )
    assert_bits_equal(jo, to[0])
    assert int(jc) == int(tc[0])
    if with_ef:
        assert_bits_equal(jres, tres[0])
    else:
        assert jres is None and tres is None


@pytest.mark.parametrize("k", [1, 255, 256])
def test_topk_encode_k_edges(k):
    x = normal(4, (256,))
    jo, _, jc = tk_ops.topk_encode(jnp.asarray(x), k=k)
    to, _, tc = t_tk.topk_encode(torch.from_numpy(x)[None], k=k)
    assert_bits_equal(jo, to[0])
    assert int(jc) == int(tc[0]) == k


def test_topk_ef_residual_chain_4_rounds():
    """Round t's residual feeds round t+1 in both packages; outputs and
    residuals stay bitwise equal at every round."""
    x = normal(5, (2048,))
    r_j, r_t = jnp.zeros_like(jnp.asarray(x)), torch.zeros((1, 2048))
    for t in range(4):
        m = np.sin(x * (t + 1)).astype(np.float32)
        o_j, r_j, _ = tk_ops.topk_encode(jnp.asarray(m), r_j, k=64)
        o_t, r_t, _ = t_tk.topk_encode(torch.from_numpy(m)[None], r_t, k=64)
        assert_bits_equal(o_j, o_t[0])
        assert_bits_equal(r_j, r_t[0])


def test_topk_encode_stacked_rows_match_per_row_calls():
    """The stacked (K, n) call thresholds each node row on its own: row i
    equals the JAX encode of node i alone (what the JAX wire's scan does)."""
    u, r = normal(6, (5, 300)), normal(7, (5, 300), 0.5)
    o, res, cnt = t_tk.topk_encode(torch.from_numpy(u), torch.from_numpy(r), k=30)
    for i in range(5):
        jo, jres, jc = tk_ops.topk_encode(jnp.asarray(u[i]), jnp.asarray(r[i]), k=30)
        assert_bits_equal(jo, o[i])
        assert_bits_equal(jres, res[i])
        assert int(jc) == int(cnt[i])


@pytest.mark.parametrize("case", ["k=1", "k=1%", "k=n", "tied"])
@pytest.mark.parametrize("with_ef", [False, True], ids=["select", "encode"])
@pytest.mark.parametrize("shape", [(16, 2000), (5, 8193), (3, 1027)], ids=str)
def test_topk_encode_stacked_rows_edges_match_per_row_calls(shape, with_ef, case):
    """The stacked (K, n) encode against the JAX encode of each row alone,
    at the fit's (16, 2000) and rows of odd length, k = 1, 1 % and n, and
    rows whose magnitudes tie at the k-th (every tie survives)."""
    K, n = shape
    u = normal(10 + K, shape)
    r = normal(20 + K, shape, 0.25) if with_ef else None
    k = {"k=1": 1, "k=1%": max(1, n // 100), "k=n": n, "tied": max(1, n // 100)}[case]
    if case == "tied":
        # half of each row at |c| = 8, above the rest: all of it survives
        if r is None:
            u[:, ::2] = np.copysign(np.float32(8.0), u[:, ::2])
        else:
            u[:, ::2] = np.copysign(np.float32(7.75), u[:, ::2])
            r[:, ::2] = np.copysign(np.float32(0.25), u[:, ::2])
    o, res, cnt = t_tk.topk_encode(
        torch.from_numpy(u), None if r is None else torch.from_numpy(r), k=k)
    for i in range(K):
        jo, jres, jc = tk_ops.topk_encode(
            jnp.asarray(u[i]), None if r is None else jnp.asarray(r[i]), k=k)
        assert_bits_equal(jo, o[i])
        assert int(jc) == int(cnt[i])
        if with_ef:
            assert_bits_equal(jres, res[i])
        else:
            assert jres is None and res is None
    if case == "tied":
        assert np.all(cnt.numpy() >= (n + 1) // 2)
    elif case == "k=n":
        assert np.all(cnt.numpy() == n)


@pytest.mark.parametrize("shape", SHAPES)
def test_int8_roundtrip_bitwise(shape):
    x = normal(8, shape)
    got, scale = t_q8.int8_roundtrip(torch.from_numpy(x)[None])
    exp, exp_scale = q8_ops.int8_roundtrip(jnp.asarray(x))
    assert_bits_equal(exp, got[0])
    assert_bits_equal(exp_scale, scale[0])


def test_int8_roundtrip_stacked_rows_scale_per_node():
    x = normal(9, (4, 513))
    x[2] *= 100.0  # one node with a much larger range keeps its own scale
    got, scale = t_q8.int8_roundtrip(torch.from_numpy(x))
    for i in range(4):
        exp, exp_scale = q8_ops.int8_roundtrip(jnp.asarray(x[i]))
        assert_bits_equal(exp, got[i])
        assert_bits_equal(exp_scale, scale[i])


def test_ops_refuse_other_devices():
    x = torch.zeros((1, 300), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        t_tk.encode_threshold(x, torch.zeros((1,), device="meta"), with_residual=True)
    with pytest.raises(ValueError, match="no kernel"):
        t_q8.absmax(x)
