"""Port parity: the approximate top-k of ``repro_torch`` (``count_ge``,
``apply_threshold``, ``topk_sparsify``) against the JAX package's
``kernels/topk_compress``.

On the CPU the port's ops take the kernels' plain versions, the functions
``chip_smoke.py`` and ``tests/test_torch_cuda.py`` hold the CUDA kernels
to on the card.  The JAX side runs as its own tests run it on the CPU: the
Pallas count and mask kernels in interpret mode.  Inputs are made with
numpy from a seed and handed to both packages.  Counts are compared
exactly (the JAX kernel's f32 counts are exact below 2^24, and every size
here is far below), the mask and ``topk_sparsify`` bitwise, signed zeros
included.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.topk_compress import kernel as j_kernel  # noqa: E402
from repro.kernels.topk_compress import ops as j_ops  # noqa: E402
from repro.kernels.topk_compress import ref as j_ref  # noqa: E402
from repro_torch.kernels.topk_compress import ops as t_ops  # noqa: E402
from repro_torch.kernels.topk_compress import ref as t_ref  # noqa: E402

# (shape, k): the CASES of tests/test_kernels_topk.py
CASES = [((4096,), 100), ((128, 300), 500), ((10000,), 1), ((8192,), 8191), ((513,), 64)]


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint16)


def _thresholds(seed, x):
    """128 positive thresholds in a shuffled order, a few of them exactly
    an element's magnitude (the ``>=`` edge)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(1e-3, 1.1 * float(np.abs(x).max()), size=128).astype(np.float32)
    flat = np.abs(x.reshape(-1))
    t[:4] = flat[rng.integers(0, flat.size, size=4)]
    return rng.permutation(t)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_count_ge_equals_jax_counts(case):
    shape, _ = case
    x = _x(sum(shape), shape)
    t = _thresholds(len(shape), x)
    got = t_ops.count_ge(torch.from_numpy(x), torch.from_numpy(t))
    exp = np.asarray(j_kernel.count_ge(jnp.asarray(x), jnp.asarray(t)))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))


def test_count_ge_bf16_equals_jax_counts():
    x = _x(7, (3000,))
    xb = torch.from_numpy(x).bfloat16()
    t = _thresholds(8, xb.float().numpy())
    got = t_ops.count_ge(xb, torch.from_numpy(t))
    exp = np.asarray(j_kernel.count_ge(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(t)))
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.int64))


def test_count_ge_counts_only_the_elements():
    """A threshold of 0 counts every element and no padding: the JAX
    kernel's zero padding would add 8192·nb − n there (ROADMAP.md queue 3)."""
    x = torch.from_numpy(_x(3, (513,)))
    t = torch.linspace(0.0, 2.0, 128)
    got = t_ops.count_ge(x, t)
    assert int(got[0]) == 513
    exp = (x.abs()[:, None] >= t[None, :]).sum(dim=0)
    assert torch.equal(got, exp)


#: a NaN with its sign bit set: an order by raw bits would put it first
NEG_NAN = np.array([0xFFC00000], np.uint32).view(np.float32)[0]


def _edge_x(seed, n, dtype="f32"):
    """Normal elements with NaN (either sign), ±inf, −0.0 and +0.0 among
    them; bf16 cases hold bf16 values."""
    x = _x(seed, (n,))
    x[[1, 5]] = np.nan
    x[9] = NEG_NAN
    x[2], x[3], x[4], x[6] = np.inf, -np.inf, -0.0, 0.0
    return x if dtype == "f32" else torch.from_numpy(x).bfloat16().float().numpy()


def _edge_t(seed, x):
    """Unsorted thresholds with duplicates, NaN, values <= 0, −0.0, ±inf
    and exact element magnitudes among them."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0.0, 3.0, size=128).astype(np.float32)
    t[10:30] = t[30:50]  # duplicates
    t[50:52] = np.nan
    t[52] = NEG_NAN
    t[53], t[54], t[55], t[56], t[57] = -1.0, 0.0, -0.0, np.inf, -np.inf
    flat = np.abs(x.reshape(-1))
    t[58:62] = flat[[0, 7, 8, 10]]
    return rng.permutation(t)


def _edge_cases():
    """(name, x as f32, thresholds, dtype) of the count's edge cases."""
    rng = np.random.default_rng(11)
    x = _edge_x(1, 5000)
    yield "edge elements and thresholds", x, _edge_t(2, x), "f32"
    xb = _edge_x(3, 3001, "bf16")
    yield "bf16 edge elements and thresholds", xb, _edge_t(4, xb), "bf16"
    t = rng.uniform(0.0, 3.0, size=128).astype(np.float32)
    yield "unsorted thresholds", _x(5, (4097,)), t, "f32"
    yield "one threshold 128 times", _x(6, (1000,)), np.full(128, 0.5, np.float32), "f32"
    yield "all thresholds NaN", _x(7, (1000,)), np.full(128, np.nan, np.float32), "f32"
    yield "every element equal", np.full(2000, -1.25, np.float32), np.sort(t), "f32"
    yield "sorted descending, over ±inf", x, np.sort(_edge_t(8, x))[::-1].copy(), "f32"
    yield "thresholds <= 0 only", x, -rng.uniform(0.0, 1.0, 128).astype(np.float32), "f32"


def _case_inputs(shape):
    x = _x(sum(shape), shape)
    return str(shape), x, _thresholds(len(shape), x), "f32"


#: the count's CASES (as test_count_ge_equals_jax_counts makes them) and edge cases
RANKED = [_case_inputs(shape) for shape, _ in CASES] + list(_edge_cases())


def _torch_x(x, dtype):
    tx = torch.from_numpy(x)
    return tx.bfloat16() if dtype == "bf16" else tx


@pytest.mark.parametrize("case", RANKED, ids=[c[0] for c in RANKED])
def test_count_ge_ranked_equals_plain(case):
    """The count kernel's arithmetic (sorted thresholds, rank by a binary
    search, histogram, suffix sums) gives the plain count exactly."""
    _, x, t, dtype = case
    tx = _torch_x(x, dtype)
    got = t_ref.count_ge_ranked(tx, torch.from_numpy(t))
    assert got.dtype == torch.int64
    assert torch.equal(got, t_ref.count_ge_ref(tx, torch.from_numpy(t)))


@pytest.mark.parametrize("case", RANKED, ids=[c[0] for c in RANKED])
def test_count_ge_ranked_equals_jax_counts(case):
    """… and the JAX kernel's counts, but for its zero padding: it also
    counts the (-n) mod 8192 padded zeros where a threshold is <= 0."""
    _, x, t, dtype = case
    got = t_ref.count_ge_ranked(_torch_x(x, dtype), torch.from_numpy(t)).numpy()
    jx = jnp.asarray(x).astype(jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    exp = np.asarray(j_kernel.count_ge(jx, jnp.asarray(t))).astype(np.int64)
    pad = (-x.size) % (j_kernel.ROWS * j_kernel.BLOCK)
    np.testing.assert_array_equal(got + pad * (np.float32(0.0) >= t), exp)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_threshold_bitwise_with_jax(dtype):
    x = _x(4, (1000,))
    x[::5] = -np.abs(x[::5])
    x[3], x[4] = -0.0, 0.0
    jd, td = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32, torch.float32)
    jx = jnp.asarray(x).astype(jd)
    tx = torch.from_numpy(x).to(td)
    for thr in (0.0, 0.5, float(abs(x[10]))):
        got = t_ops.apply_threshold(tx, torch.tensor(thr))
        exp = j_kernel.apply_threshold(jx, jnp.asarray(thr, jnp.float32))
        assert got.dtype == td
        np.testing.assert_array_equal(_bits(got.view(torch.int16 if dtype == "bf16"
                                                     else torch.int32).numpy()),
                                      _bits(np.asarray(exp).view(np.uint16 if dtype == "bf16"
                                                                 else np.uint32)))
    # dropped entries are +0.0, never −0.0, and a stored −0.0 survives t = 0
    got = t_ops.apply_threshold(torch.from_numpy(x), torch.tensor(0.5)).numpy()
    assert not np.signbit(got[np.abs(x) < 0.5]).any()
    assert np.signbit(t_ops.apply_threshold(torch.from_numpy(x), torch.tensor(0.0)).numpy()[3])


@pytest.mark.parametrize("case", CASES, ids=str)
def test_topk_sparsify_bitwise_with_jax(case):
    shape, k = case
    x = _x(k, shape)
    got = t_ops.topk_sparsify(torch.from_numpy(x), k)
    exp = np.asarray(j_ops.topk_sparsify(jnp.asarray(x), k))
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(exp))
    # the JAX test's own properties: exactly k kept, equal to the exact top-k
    assert int((got != 0).sum()) == k
    exact = t_ref.topk_sparsify_ref(torch.from_numpy(x), k)
    assert torch.equal(got == exact, torch.ones(shape, dtype=torch.bool))
    assert np.array_equal(exact.numpy(), np.asarray(j_ref.topk_sparsify_ref(jnp.asarray(x), k)))


def test_topk_sparsify_kept_dominate_dropped_and_values_preserved():
    x = torch.from_numpy(_x(3, (2048,)))
    out = t_ops.topk_sparsify(x, 64)
    kept = out != 0
    assert float(x[kept].abs().min()) >= float(x[~kept].abs().max())
    assert torch.equal(out[kept], x[kept])


def test_topk_sparsify_k_larger_than_size():
    x = torch.from_numpy(_x(4, (100,)))
    assert torch.equal(t_ops.topk_sparsify(x, 1000), x)


def test_topk_sparsify_ref_signed_zeros():
    """The exact reference multiplies by the mask, as the JAX one does, so
    a dropped negative is −0.0 there (compare it with ``==``)."""
    x = torch.tensor([-3.0, -0.5, 2.0, 0.25])
    out = t_ref.topk_sparsify_ref(x, 2)
    assert torch.equal(out, torch.tensor([-3.0, 0.0, 2.0, 0.0]))
    assert bool(torch.signbit(out[1])) and not bool(torch.signbit(out[3]))
    j = np.asarray(j_ref.topk_sparsify_ref(jnp.asarray(x.numpy()), 2))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(j))


def test_topk_ops_route_by_device():
    x = torch.zeros((8,), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        t_ops.count_ge(x, torch.zeros(128, device="meta"))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        t_ops.apply_threshold(x, torch.zeros((), device="meta"))
