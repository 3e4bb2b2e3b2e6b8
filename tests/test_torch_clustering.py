"""Port parity: ``repro_torch.ml.clustering`` against ``repro.ml.clustering``
on the same numpy inputs (the port on the CPU, where its E-steps take the
nearest-centroid kernel's plain version).

Clustering is discontinuous: one flipped assignment moves a centroid far
beyond any tolerance.  So every trajectory test first replays the JAX run
step by step with the JAX package's own functions (``pdist``, ``_m_step``,
…), checks that the replay lands where the JAX function does, and asserts
that the smallest top-2 distance gap over all its E-steps — the nearest
against the second-nearest distinct centroid — is above the distance
tolerance.  Only then is the port compared: centroids atol 1e-5, inertia
rtol 1e-5, assignments identical.  The sums of the M-step run in another
order in the two packages, so centroids differ in their last bits.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ml import clustering as jc  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.ml import clustering as tc  # noqa: E402

ATOL, RTOL = 1e-5, 1e-5


def T(a) -> torch.Tensor:
    """A tensor owning a copy of ``a`` (JAX's numpy views are read-only)."""
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(13)
    centers = np.asarray([(-5.0, -5.0), (0.0, 5.0), (5.0, -2.0)])
    X = np.concatenate([rng.normal(size=(60, 2)) * 0.7 + c for c in centers])
    return X.astype(np.float32), centers


@pytest.fixture(scope="module")
def mixture():
    """Five overlapping 4-d components: many points between clusters."""
    rng = np.random.default_rng(5)
    means = rng.normal(size=(5, 4)) * 3.0
    X = means[rng.integers(0, 5, size=240)] + rng.normal(size=(240, 4))
    C0 = X[rng.choice(240, size=5, replace=False)]
    return X.astype(np.float32), C0.astype(np.float32)


def top2_gap(D, C) -> float:
    """Smallest gap, over points, between the nearest distance and the
    nearest distance to a centroid whose row differs from the winner's
    (identical rows tie exactly in any implementation: first index)."""
    _, cls = np.unique(np.asarray(C), axis=0, return_inverse=True)
    cls = cls.reshape(-1)
    D = np.asarray(D, dtype=np.float64)
    win = np.argmin(D, axis=1)
    other = np.where(cls[None, :] == cls[win][:, None], np.inf, D)
    return float(np.min(np.min(other, axis=1) - D[np.arange(len(D)), win]))


class Margin:
    """The smallest top-2 gap seen, against the distance tolerance
    ATOL + RTOL · (largest distance compared)."""

    def __init__(self):
        self.gap, self.scale = np.inf, 0.0

    def see(self, D, C):
        self.gap = min(self.gap, top2_gap(D, C))
        self.scale = max(self.scale, float(np.max(np.min(np.asarray(D), axis=1))))

    def check(self):
        tol = ATOL + RTOL * self.scale
        assert self.gap > tol, f"top-2 margin {self.gap} is inside the tolerance {tol}"


def jax_kmeans_replay(X, C0, K, metric, iters, keep_empty=False):
    """The JAX k-means trajectory, one E-step and M-step at a time:
    ``(final centroids, Margin)``.  ``keep_empty``: an empty cluster keeps
    its centroid (``distributed_kmeans``) instead of falling to 0."""
    X, C, margin = jnp.asarray(X), jnp.asarray(C0), Margin()
    for _ in range(iters):
        D = jc.pdist(X, C, metric=metric)
        margin.see(D, C)
        C_new, counts = jc._m_step(X, jnp.argmin(D, axis=1), K, metric)
        C = jnp.where(counts[:, None] > 0, C_new, C) if keep_empty else C_new
    margin.see(jc.pdist(X, C, metric=metric), C)
    return np.asarray(C), margin


def assert_result_close(rt, rj):
    np.testing.assert_allclose(rt.centroids.numpy(), np.asarray(rj.centroids), atol=ATOL)
    np.testing.assert_allclose(float(rt.inertia), float(rj.inertia), rtol=RTOL)
    np.testing.assert_array_equal(rt.assignments.numpy(), np.asarray(rj.assignments))
    assert rt.iters == rj.iters


@pytest.mark.parametrize("metric", ["l2", "l2sq", "l1", "linf"])
def test_pdist_matches_jax(mixture, metric):
    X, C = mixture
    np.testing.assert_allclose(tc.pdist(T(X), T(C), metric).numpy(),
                               np.asarray(jc.pdist(jnp.asarray(X), jnp.asarray(C), metric)),
                               rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="unknown metric"):
        tc.pdist(T(X), T(C), "cosine")


@pytest.mark.parametrize("metric", ["l2", "l1", "linf"])
def test_m_step_matches_jax(mixture, metric):
    """Mean / coordinate-wise median / midrange, an empty cluster included
    (it falls back to the mean of nothing: 0)."""
    X, _ = mixture
    assign = np.random.default_rng(1).integers(0, 5, size=X.shape[0])
    assign[assign == 3] = 4  # cluster 3 is empty
    Ct, nt = tc._m_step(T(X), T(assign), 6, metric)
    Cj, nj = jc._m_step(jnp.asarray(X), jnp.asarray(assign), 6, metric)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def test_m_step_median_and_midrange():
    X = T(np.asarray([[0.0, 0.0], [1.0, 0.0], [10.0, 0.0]], np.float32))
    zeros = torch.zeros(3, dtype=torch.long)
    assert float(tc._m_step(X, zeros, 1, "l1")[0][0, 0]) == 1.0  # not the mean 3.67
    assert float(tc._m_step(X, zeros, 1, "linf")[0][0, 0]) == 5.0  # (min + max)/2


@pytest.mark.parametrize("metric", ["l2", "l2sq", "l1", "linf"])
def test_kmeans_matches_jax(mixture, metric):
    X, C0 = mixture
    C_replay, margin = jax_kmeans_replay(X, C0, 5, metric, iters=8)
    margin.check()
    rj = jc.kmeans(jnp.asarray(X), jnp.asarray(C0), num_clusters=5, metric=metric, iters=8)
    np.testing.assert_allclose(C_replay, np.asarray(rj.centroids), atol=ATOL)
    before = dict(kernels.LAUNCHES)
    rt = tc.kmeans(T(X), T(C0), num_clusters=5, metric=metric, iters=8)
    assert kernels.LAUNCHES == before  # the CPU takes the plain version
    assert_result_close(rt, rj)


def test_distributed_kmeans_matches_jax(blobs):
    X, _ = blobs
    C0 = np.asarray(jc.kmeans_pp_init(jax.random.key(0), jnp.asarray(X), 3))
    C_replay, margin = jax_kmeans_replay(X, C0, 3, "l2sq", iters=12, keep_empty=True)
    margin.check()
    Xs = X.reshape(3, 60, 2)
    rj = jc.distributed_kmeans(jnp.asarray(Xs), jnp.asarray(C0), num_clusters=3, iters=12)
    np.testing.assert_allclose(C_replay, np.asarray(rj.centroids), atol=ATOL)
    rt = tc.distributed_kmeans(T(Xs), T(C0), num_clusters=3, iters=12)
    assert_result_close(rt, rj)


def test_distributed_kmeans_keeps_empty_clusters_and_matches_jax(mixture):
    """Heterogeneous shards and a centroid no point is near: the empty
    cluster keeps its centroid on both sides."""
    X, C0 = mixture
    C0 = C0.copy()
    C0[2] = 100.0
    C_replay, margin = jax_kmeans_replay(X, C0, 5, "l2sq", iters=6, keep_empty=True)
    margin.check()
    Xs = X[np.argsort(X[:, 0], kind="stable")].reshape(4, 60, 4)
    rj = jc.distributed_kmeans(jnp.asarray(Xs), jnp.asarray(C0), num_clusters=5, iters=6)
    rt = tc.distributed_kmeans(T(Xs), T(C0), num_clusters=5, iters=6)
    assert_result_close(rt, rj)
    assert float(rt.centroids[2, 0]) == 100.0


def test_distributed_kmeans_identical_to_centralized(blobs):
    """§4.1: the sufficient-statistics Allreduce gives the centralized
    trajectory, in the port as in the JAX package."""
    X, _ = blobs
    C0 = np.asarray(jc.kmeans_pp_init(jax.random.key(0), jnp.asarray(X), 3))
    res_c = tc.kmeans(T(X), T(C0), num_clusters=3, metric="l2sq", iters=25)
    res_d = tc.distributed_kmeans(T(X.reshape(3, 60, 2)), T(C0), num_clusters=3, iters=25)
    np.testing.assert_allclose(res_c.centroids.numpy(), res_d.centroids.numpy(), atol=ATOL)
    np.testing.assert_allclose(float(res_c.inertia), float(res_d.inertia), rtol=RTOL)
    assert torch.equal(res_c.assignments, res_d.assignments)


def jax_consensus_replay(Xs, C0, *, rho, iters, em_iters):
    """JAX's consensus k-means (core.admm loop, local EM, greedy
    alignment), one step at a time: ``(centroids, history, Margin)``.  The
    alignment's greedy argmins are margin-checked like the E-steps."""
    Kn, _, d = Xs.shape
    K = C0.shape[0]
    z, u = jnp.zeros((K * d,)), jnp.zeros((Kn, K * d))
    margin, hist = Margin(), []
    for _ in range(iters):
        v = z[None, :] - u
        rows = []
        for k in range(Kn):
            X, V = jnp.asarray(Xs[k]), v[k].reshape(K, d)
            C = V
            for _ in range(em_iters):
                D = jc.pdist(X, C, metric="l2sq")
                margin.see(D, C)
                onehot = jax.nn.one_hot(jnp.argmin(D, axis=1), K, dtype=X.dtype)
                C = (onehot.T @ X + 0.5 * rho * V) / (
                    jnp.sum(onehot, axis=0)[:, None] + 0.5 * rho)
            d2 = np.array(jnp.sum((V[:, None, :] - C[None, :, :]) ** 2, axis=-1), np.float64)
            perm = []
            for i in range(K):
                row = d2[i].copy()
                row[perm] = np.inf
                margin.see(row[None, :], np.asarray(C))
                perm.append(int(np.argmin(row)))
            rows.append(C[jnp.asarray(perm)].reshape(-1))
        theta = jnp.stack(rows)
        z_new = jnp.mean(theta + u, axis=0)
        u = u + theta - z_new[None, :]
        hist.append((float(jnp.linalg.norm(theta - z_new[None, :])),
                     float(rho * np.sqrt(Kn) * jnp.linalg.norm(z_new - z))))
        z = z_new
    return np.asarray(z.reshape(K, d)), np.asarray(hist), margin


@pytest.mark.parametrize("shards", ["homogeneous", "heterogeneous"])
def test_consensus_kmeans_matches_jax(blobs, shards):
    X, _ = blobs
    if shards == "homogeneous":
        X = X[np.random.default_rng(3).permutation(X.shape[0])]
    Xs = X.reshape(3, 60, 2)  # heterogeneous: node k holds blob k
    C0 = np.asarray(jc.kmeans_pp_init(jax.random.key(0), jnp.asarray(X), 3))
    C_replay, hist_replay, margin = jax_consensus_replay(Xs, C0, rho=0.1, iters=8, em_iters=3)
    margin.check()
    Cj, rj = jc.consensus_kmeans(jnp.asarray(Xs), jnp.asarray(C0), iters=8)
    np.testing.assert_allclose(C_replay, np.asarray(Cj), atol=ATOL)
    np.testing.assert_allclose(hist_replay, np.asarray(rj.history), rtol=RTOL, atol=ATOL)
    Ct, rt = tc.consensus_kmeans(T(Xs), T(C0), iters=8)
    np.testing.assert_allclose(Ct.numpy(), np.asarray(Cj), atol=ATOL)
    np.testing.assert_allclose(rt.history.numpy(), np.asarray(rj.history),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(rt.state.theta.numpy(), np.asarray(rj.state.theta), atol=ATOL)
    assert int(rt.state.it) == int(rj.state.it) == 8


def test_kmeans_pp_init_picks_data_points_one_per_blob(blobs):
    """``jax.random`` cannot be matched, so the port's seeding is held to
    what it promises: K rows of X, reproducible from the generator, and on
    three far-apart blobs one center in each (the draw is ∝ d²)."""
    X, centers = blobs
    Xt = T(X)
    C1 = tc.kmeans_pp_init(torch.Generator().manual_seed(4), Xt, 3)
    C2 = tc.kmeans_pp_init(torch.Generator().manual_seed(4), Xt, 3)
    assert torch.equal(C1, C2) and C1.shape == (3, 2)
    assert all(bool((Xt == c).all(dim=1).any()) for c in C1)
    blob = np.argmin(np.linalg.norm(C1.numpy()[:, None] - centers[None], axis=-1), axis=1)
    assert sorted(blob.tolist()) == [0, 1, 2]


def test_summarize_representatives_matches_jax(blobs):
    X, _ = blobs
    D = np.asarray(jc.pdist(jnp.asarray(X), jnp.asarray(X), metric="l2"))
    assert np.min(np.abs(D - 1.0)) > ATOL  # no neighbour within rounding of eps
    rj, mj = jc.summarize_representatives(jnp.asarray(X), eps=1.0, min_pts=5, max_reps=30)
    rt, mt = tc.summarize_representatives(T(X), eps=1.0, min_pts=5, max_reps=30)
    assert 3 <= int(mt.sum()) <= 30
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


def radius_t_margin(X, T_, M) -> float:
    """Replay of the radius-T pass in f64: the smallest distance between a
    decision's value and its threshold (nearest vs T, nearest vs
    second-nearest)."""
    X = np.asarray(X, np.float64)
    C, cnt, ncl, m = np.zeros((M, X.shape[1])), np.zeros(M), 0, np.inf
    for x in X:
        j, near = 0, False
        if ncl:
            dd = np.sqrt(np.sum((C[:ncl] - x) ** 2, axis=1))
            j = int(np.argmin(dd))
            near = dd[j] <= T_
            m = min(m, abs(dd[j] - T_), *(np.sort(dd)[1:2] - dd[j]))
        open_new = not near and ncl < M
        tgt = ncl if open_new else j
        cnt[tgt] += 1
        C[tgt] += (x - C[tgt]) / cnt[tgt]
        ncl += open_new
    return m


def merge_margin(C, counts, mask, T_) -> float:
    """Replay of the server merge in f64: the smallest |distance − T| over
    the pairs it tests."""
    C, counts, mask = (np.array(a, np.float64) for a in (C, counts, mask))
    m = np.inf
    for i in range(C.shape[0]):
        dd = np.sqrt(np.sum((C - C[i]) ** 2, axis=1))
        live = (mask > 0) & (np.arange(len(C)) > i) & (mask[i] > 0)
        if live.any():
            m = min(m, float(np.min(np.abs(dd[live] - T_))))
        cand = live & (dd <= T_)
        if cand.any():
            j = int(np.argmax(cand))
            tot = counts[i] + counts[j]
            C[i] = (C[i] * counts[i] + C[j] * counts[j]) / max(tot, 1.0)
            counts[i], counts[j], mask[j] = tot, 0.0, 0.0
    return m


@pytest.mark.parametrize("T_, M", [(2.5, 20), (1.0, 6)], ids=["open", "overflow"])
def test_radius_t_clustering_and_merge_match_jax(blobs, T_, M):
    X, _ = blobs
    assert radius_t_margin(X, T_, M) > ATOL
    rj = jc.radius_t_clustering(jnp.asarray(X), T=T_, max_clusters=M)
    rt = tc.radius_t_clustering(T(X), T=T_, max_clusters=M)
    np.testing.assert_allclose(rt[0].numpy(), np.asarray(rj[0]), atol=ATOL)
    np.testing.assert_array_equal(rt[1].numpy(), np.asarray(rj[1]))
    np.testing.assert_array_equal(rt[2].numpy(), np.asarray(rj[2]))
    assert float(rt[1].sum()) == X.shape[0]
    assert merge_margin(*(np.asarray(a) for a in rj), 2.5) > ATOL
    mj = jc.merge_centroids(*rj, T=2.5)
    mt = tc.merge_centroids(*rt, T=2.5)
    np.testing.assert_allclose(mt[0].numpy(), np.asarray(mj[0]), atol=ATOL)
    np.testing.assert_array_equal(mt[1].numpy(), np.asarray(mj[1]))
    np.testing.assert_array_equal(mt[2].numpy(), np.asarray(mj[2]))


def test_merge_centroids_count_weighted():
    C = T(np.asarray([[0.0, 0.0], [0.2, 0.0], [5.0, 5.0]], np.float32))
    C2, counts2, mask2 = tc.merge_centroids(C, T(np.asarray([10.0, 30.0, 5.0], np.float32)),
                                            torch.ones(3), T=1.0)
    assert int(mask2.sum()) == 2
    np.testing.assert_allclose(C2[0].numpy(), [0.15, 0.0], atol=1e-6)
    np.testing.assert_array_equal(counts2.numpy(), [40.0, 0.0, 5.0])
