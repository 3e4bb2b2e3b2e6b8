"""Port parity: ``repro_torch.kernels.pdist_argmin`` against the JAX
package's nearest-centroid kernel (interpret mode on the CPU, as its own
tests run it) and its reference, from the same numpy inputs.

On the CPU the port's ``ops.pdist_argmin`` takes its plain version (the
direct form Σ(x − c)²); the JAX kernel computes l2 in the expanded form
‖x‖² − 2x·c + ‖c‖².  Distances therefore agree to the JAX test's own
``jnp.allclose(atol=1e-5)`` (its default rtol 1e-5 included), and indices
are compared exactly after a margin check: every point's gap between its
nearest and its second-nearest distinct centroid, from the JAX package's
distances, must exceed that tolerance, so no rounding can flip one.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.pdist_argmin import ops as j_ops  # noqa: E402
from repro.kernels.pdist_argmin import ref as j_ref  # noqa: E402
from repro.ml.clustering import pdist as j_pdist  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels._tf32 import tf32_round  # noqa: E402
from repro_torch.kernels.pdist_argmin import ops as t_ops  # noqa: E402
from repro_torch.kernels.pdist_argmin import ref as t_ref  # noqa: E402

#: (N, K, d, metric): the cases of tests/test_kernels_pdist.py
CASES = [
    (500, 16, 8, "l2"),
    (300, 7, 5, "l1"),
    (260, 5, 3, "linf"),
    (128, 32, 64, "l2"),
    (1000, 3, 2, "linf"),
    (65, 4, 4, "l1"),  # N not a multiple of bn
]
ATOL = RTOL = 1e-5  # jnp.allclose(atol=1e-5) of the JAX test, its default rtol


def inputs(N, K, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, d)).astype(np.float32),
            rng.normal(size=(K, d)).astype(np.float32))


def top2_gap(D: np.ndarray, C: np.ndarray) -> float:
    """Smallest gap, over points, between the nearest distance and the
    nearest distance to a centroid whose row differs from the winner's
    (identical rows give identical distances in any implementation, so
    their exact ties cannot flip)."""
    _, cls = np.unique(np.asarray(C), axis=0, return_inverse=True)
    cls = cls.reshape(-1)
    D = np.asarray(D, dtype=np.float64)
    win = np.argmin(D, axis=1)
    other = np.where(cls[None, :] == cls[win][:, None], np.inf, D)
    if not np.isfinite(other).any():
        return np.inf
    return float(np.min(np.min(other, axis=1) - D[np.arange(len(D)), win]))


def assert_margin(D, C) -> None:
    """No point's nearest centroid is within the distance tolerance of its
    second-nearest distinct one."""
    tol = ATOL + RTOL * float(np.max(np.min(np.asarray(D), axis=1)))
    gap = top2_gap(D, C)
    assert gap > tol, f"top-2 margin {gap} is inside the tolerance {tol}"


def jax_distances(X, C, metric):
    return np.asarray(j_pdist(jnp.asarray(X), jnp.asarray(C),
                              metric="l2sq" if metric == "l2" else metric))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_pdist_argmin_matches_jax(case):
    N, K, d, metric = case
    X, C = inputs(N, K, d, N + K)
    assert_margin(jax_distances(X, C, metric), C)
    j_idx, j_dist = j_ops.pdist_argmin(jnp.asarray(X), jnp.asarray(C), metric=metric, bn=64)
    r_idx, r_dist = j_ref.pdist_argmin_ref(jnp.asarray(X), jnp.asarray(C), metric=metric)
    before = dict(kernels.LAUNCHES)
    idx, dist = t_ops.pdist_argmin(torch.from_numpy(X), torch.from_numpy(C),
                                   metric=metric, bn=64)
    assert kernels.LAUNCHES == before  # the CPU takes the plain version
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    assert idx.shape == (N,) and dist.shape == (N,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(dist.numpy(), np.asarray(r_dist), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "l1", "linf"])
def test_pdist_argmin_bf16_matches_jax(metric):
    """bf16 in, f32 compute: the port's result on bf16 tensors is its f32
    result on the same (exactly widened) values, and agrees with the JAX
    kernel in bf16 on at least 99 % of points, the JAX test's bound."""
    X, C = inputs(200, 5, 8, 0)
    Xb, Cb = torch.from_numpy(X).bfloat16(), torch.from_numpy(C).bfloat16()
    idx, dist = t_ops.pdist_argmin(Xb, Cb, metric=metric)
    idx32, dist32 = t_ops.pdist_argmin(Xb.float(), Cb.float(), metric=metric)
    assert torch.equal(idx, idx32) and torch.equal(dist, dist32)
    j_idx, _ = j_ops.pdist_argmin(jnp.asarray(X, dtype=jnp.bfloat16),
                                  jnp.asarray(C, dtype=jnp.bfloat16), metric=metric, bn=64)
    agree = float(np.mean(idx.numpy() == np.asarray(j_idx)))
    assert agree > 0.99


@pytest.mark.parametrize("metric", ["l2", "l1", "linf"])
def test_pdist_argmin_ties_take_the_first_index(metric):
    """Duplicated centroid rows tie exactly: every point takes the first
    of them, as jnp.argmin does."""
    X, C = inputs(97, 3, 6, 7)
    Cdup = np.concatenate([C, C[::-1], C])  # rows k, 5 − k and 6 + k are equal
    idx, dist = t_ops.pdist_argmin(torch.from_numpy(X), torch.from_numpy(Cdup), metric=metric)
    j_idx, j_dist = j_ops.pdist_argmin(jnp.asarray(X), jnp.asarray(Cdup), metric=metric)
    i0, _ = t_ops.pdist_argmin(torch.from_numpy(X), torch.from_numpy(C), metric=metric)
    assert_margin(jax_distances(X, Cdup, metric), Cdup)
    np.testing.assert_array_equal(idx.numpy(), i0.numpy())  # rows 0..2 come first
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), rtol=RTOL, atol=ATOL)


def test_kmeans_estep_equivalence():
    """The port's kernel path agrees with its clustering module's plain
    E-step, as the JAX test holds its kernel to its own."""
    from repro_torch.ml.clustering import pdist

    X, C = (torch.from_numpy(a) for a in inputs(300, 6, 4, 1))
    idx, _ = t_ops.pdist_argmin(X, C, metric="l2", bn=128)
    D = pdist(X, C, metric="l2sq")
    assert_margin(D.numpy(), C.numpy())
    assert torch.equal(idx.long(), torch.argmin(D, dim=1))


#: (N, K, d): shapes that force the l1/l∞ kernel's tiling on the card: all
#: of C in shared memory beside the points at K 1,000 × d 42, points wider
#: than the 64-column register tile at d 512, and N off the 256-point pass
TILING_CASES = [(300, 1000, 42), (257, 64, 512), (513, 33, 17)]


@pytest.mark.parametrize("metric", ["l1", "linf"])
@pytest.mark.parametrize("case", TILING_CASES, ids=str)
def test_cuda_core_route_tiling_cases_match_jax(case, metric):
    """The l1/l∞ route's plain version, which the card's kernel is held to,
    against the JAX kernel (interpret mode) and reference at the shapes that
    force the kernel's tiling: distances within the JAX test's tolerance,
    indices equal wherever the top-2 gap clears it."""
    N, K, d = case
    X, C = inputs(N, K, d, N + K + d)
    j_idx, j_dist = j_ops.pdist_argmin(jnp.asarray(X), jnp.asarray(C), metric=metric, bn=64)
    r_idx, r_dist = j_ref.pdist_argmin_ref(jnp.asarray(X), jnp.asarray(C), metric=metric)
    before = dict(kernels.LAUNCHES)
    idx, dist = t_ops.pdist_argmin(torch.from_numpy(X), torch.from_numpy(C), metric=metric)
    assert kernels.LAUNCHES == before  # the CPU takes the plain version
    assert idx.shape == (N,) and idx.dtype == torch.int32
    tol = ATOL + RTOL * np.abs(dist.numpy())
    clear = clear_rows(jax_distances(X, C, metric), C, tol)
    assert clear.mean() > 0.9
    for want in (j_idx, r_idx):
        np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(want)[clear])
    for want in (j_dist, r_dist):
        np.testing.assert_allclose(dist.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_pdist_argmin_refuses_other_devices_and_metrics():
    X = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        t_ops.pdist_argmin(X, X)
    with pytest.raises(ValueError, match="cosine"):
        t_ref.pdist_argmin_ref(torch.zeros((4, 3)), torch.zeros((2, 3)), "cosine")


# ----------------------------------------------------------------------------
# The l2 route on the card (csrc/pdist_argmin_tc.cu) runs the expanded form
# on the tensor cores with a guard.  Its arithmetic, emulated in plain
# PyTorch (ref.pdist_argmin_tc_emulated), is held here to the JAX kernel
# and to the direct form; an adversarial case shows that the guard is what
# keeps it on the direct form's answer.
# ----------------------------------------------------------------------------


def adversarial_inputs(seed, N=400, pairs=16, d=8):
    """Points with ‖x‖² ≈ 1e6 around centroids that come in pairs 1e-3
    apart: the expanded form loses the pair's order to cancellation, the
    direct form keeps it."""
    rng = np.random.default_rng(seed)
    base = np.full(d, 1000.0 / np.sqrt(d))
    centers = base + rng.normal(size=(pairs, d))
    step = rng.normal(size=(pairs, d))
    step *= 1e-3 / np.linalg.norm(step, axis=1, keepdims=True)
    C = np.concatenate([centers, centers + step]).astype(np.float32)
    X = (base + rng.normal(size=(N, d))).astype(np.float32)
    return X, C


def clear_rows(D, C, tol):
    """Points whose gap between the nearest and the second-nearest distinct
    centroid (by the f64 distances D) exceeds ``tol``: there no rounding
    can flip the index."""
    _, cls = np.unique(np.asarray(C, dtype=np.float64), axis=0, return_inverse=True)
    cls = cls.reshape(-1)
    D = np.asarray(D, dtype=np.float64)
    win = np.argmin(D, axis=1)
    other = np.where(cls[None, :] == cls[win][:, None], np.inf, D)
    return np.min(other, axis=1) - D[np.arange(len(D)), win] > tol


TC_CASES = ([("cases", N, K, d, "f32") for N, K, d, _ in CASES]
            + [("cases", 500, 16, 8, "bf16"), ("cases", 128, 32, 64, "bf16"),
               ("cases", 300, 1, 5, "f32"),
               ("adversarial", 400, 32, 8, "f32"), ("planted control", 400, 32, 8, "f32")])


@pytest.mark.parametrize("case", TC_CASES, ids=str)
def test_tc_route_emulation(case):
    """The guarded expanded form gives the direct form's indices wherever
    the top-2 gap clears the tolerance, and distances within atol 1e-5 +
    rtol 1e-5 of the JAX kernel (interpret mode) and of the direct form;
    at the JAX test's shapes the guard re-checks few rows.  On the
    adversarial inputs the guard re-checks the rows it must; the planted
    control, the same emulation without the guard, must give a wrong
    index there, or the adversarial case could not catch a missing guard."""
    kind, N, K, d, dt = case
    dtype = torch.float32 if dt == "f32" else torch.bfloat16
    if kind == "cases":
        X, C = inputs(N, K, d, N + K)
    else:
        X, C = adversarial_inputs(7, N, K // 2, d)
    Xt, Ct = torch.from_numpy(X).to(dtype), torch.from_numpy(C).to(dtype)
    Xw, Cw = Xt.float().numpy(), Ct.float().numpy()  # the values both sides see
    idx, dist, flagged = t_ref.pdist_argmin_tc_emulated(Xt, Ct, guard=kind != "planted control")
    r_idx, r_dist = t_ref.pdist_argmin_ref(Xt, Ct, "l2")
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32 and idx.shape == (N,)
    D = ((Xw[:, None, :].astype(np.float64) - Cw[None, :, :]) ** 2).sum(-1)
    tol = ATOL + RTOL * np.abs(r_dist.numpy())
    clear = clear_rows(D, Cw, tol) if K > 1 else np.ones(N, dtype=bool)
    same = idx.numpy() == r_idx.numpy()
    if kind == "planted control":
        assert not same[clear].all(), "the unguarded expanded form kept every index"
        return
    assert same[clear].all()
    np.testing.assert_allclose(dist.numpy(), r_dist.numpy(), rtol=RTOL, atol=ATOL)
    if kind == "adversarial":
        # every row whose nearest centroid has its pair partner next to it
        # is inside the bound, and the guard re-ran it
        assert clear.mean() > 0.9 and bool(flagged[torch.from_numpy(clear)].all())
        return
    assert float(flagged.float().mean()) < 0.05  # the guard is selective
    j_idx, j_dist = j_ops.pdist_argmin(jnp.asarray(Xw), jnp.asarray(Cw), metric="l2", bn=64)
    assert (idx.numpy() == np.asarray(j_idx))[clear].all()
    np.testing.assert_allclose(dist.numpy(), np.asarray(j_dist), rtol=RTOL, atol=ATOL)


def test_tf32_round_keeps_eleven_bits():
    """hi = tf32(v) rounds to nearest with ties to even, and v − hi − lo
    leaves at most 2⁻²² of v: the split that 3xTF32 relies on."""
    v = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -1.0 - 2**-12, float("inf")])
    assert tf32_round(v).tolist() == [1.0, 1.0, 1.0 + 2**-9, -1.0, float("inf")]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert float(((x - hi) / x).abs().max()) <= 2**-11
    assert float(((x.double() - hi.double() - lo.double()) / x.double()).abs().max()) <= 2**-22
