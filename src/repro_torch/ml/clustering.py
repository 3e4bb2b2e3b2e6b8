"""Distributed clustering, paper §4.1 (port of ``repro.ml.clustering``).

* ``kmeans``                 — EM-style k-means under ℓ1 / ℓ2 / ℓ∞ with the
                               metric-matched M-step (median / mean /
                               midrange).
* ``distributed_kmeans``     — sufficient-statistics form: nodes push only
                               per-cluster (Σx, count); one Allreduce per EM
                               iteration; the same trajectory as
                               centralized k-means on the union.
* ``consensus_kmeans``       — [21]: ADMM consensus on the centroid matrix.
* ``summarize_representatives`` — [30]-style density summarization.
* ``radius_t_clustering`` / ``merge_centroids`` — [27]: local clusters of
                               radius T, merged at the server.

Every E-step — of ``kmeans``, ``distributed_kmeans``, ``consensus_kmeans``
and ``kmeans_pp_init`` — is one call of ``kernels.pdist_argmin.ops``: the
nearest-centroid CUDA kernel for CUDA tensors, its plain version for CPU
ones.  The kernel's index and distance are both used, so for ℓ2 the final
assignment and inertia of a call come from one launch.  ``pdist`` (the
full matrix) stays plain PyTorch: ``summarize_representatives`` needs every
distance, not the argmin.  The reference's ``lax.scan`` loops are Python
loops; the M-step keeps its one-hot product (``onehot.T @ X``, in full f32
unless the caller enabled TF32).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.pdist_argmin import ops as pdist_ops
from repro_torch.telemetry import trace as _trace

#: the kernel's metric for each E-step metric (l2 and l2sq share one argmin)
_KERNEL_METRIC = {"l2": "l2", "l2sq": "l2", "l1": "l1", "linf": "linf"}


# ----------------------------------------------------------------------------
# Distances
# ----------------------------------------------------------------------------


def pdist(X: torch.Tensor, C: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """Pairwise distances (N, K) between points X (N, d) and centroids C
    (K, d), in plain PyTorch (the E-steps use ``nearest`` instead)."""
    diff = X[:, None, :] - C[None, :, :]
    if metric == "l2":
        return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))
    if metric == "l2sq":
        return torch.sum(diff * diff, dim=-1)
    if metric == "l1":
        return torch.sum(torch.abs(diff), dim=-1)
    if metric == "linf":
        return torch.amax(torch.abs(diff), dim=-1)
    raise ValueError(f"unknown metric {metric!r}")


def nearest(X: torch.Tensor, C: torch.Tensor, metric: str = "l2"):
    """One E-step: ``(assignments (N,) int64, distance (N,) f32)`` of each
    point's nearest centroid, one launch of the nearest-centroid kernel on
    the card.  The distance is the kernel's: squared for ``l2`` and
    ``l2sq``.

    ``kmeans(metric="l2")`` in the JAX package takes the argmin over
    ``sqrt`` distances; the kernel's is over squared ones.  The two differ
    only where two squared distances round to one square root — a tie the
    parity tests' top-2 margin check rules out."""
    if metric not in _KERNEL_METRIC:
        raise ValueError(f"unknown metric {metric!r}")
    idx, dist = pdist_ops.pdist_argmin(X, C, metric=_KERNEL_METRIC[metric])
    return idx.long(), dist


def kmeans_pp_init(gen: torch.Generator, X: torch.Tensor, K: int) -> torch.Tensor:
    """k-means++ seeding: pick centers ∝ squared distance to the nearest
    chosen center, drawn from ``gen`` (on X's device).  As in the JAX
    package, every pick runs a full E-step against all K rows (the unchosen
    rows repeat the first center) and draws ∝ max(d², 1e-12)."""
    N = X.shape[0]
    first = X[torch.randint(0, N, (), generator=gen, device=gen.device).to(X.device)]
    C = first[None].repeat(K, 1)
    for i in range(1, K):
        _, d2 = nearest(X, C, metric="l2sq")
        w = torch.clamp_min(d2, 1e-12).to(gen.device)
        C[i] = X[torch.multinomial(w, 1, generator=gen)[0].to(X.device)]
    return C


class KMeansResult(NamedTuple):
    centroids: torch.Tensor  # (K, d)
    assignments: torch.Tensor  # (N,)
    inertia: torch.Tensor  # scalar
    iters: int


def _one_hot(assign: torch.Tensor, K: int, dtype) -> torch.Tensor:
    """(N, K) one-hot rows in ``dtype``, written straight into that type
    (``F.one_hot`` would first build an int64 matrix twice the size)."""
    onehot = torch.zeros((assign.shape[0], K), dtype=dtype, device=assign.device)
    return onehot.scatter_(1, assign[:, None], 1.0)


def _m_step(X, assign, K, metric):
    """The metric-matched M-step: ``(centroids (K, d), counts (K,))``."""
    onehot = _one_hot(assign, K, X.dtype)  # (N, K)
    counts = torch.sum(onehot, dim=0)  # (K,)
    mean = (onehot.T @ X) / torch.clamp_min(counts, 1.0)[:, None]
    if metric in ("l2", "l2sq"):
        return mean, counts
    big = 1e30
    member = onehot.T[:, :, None] > 0  # (K, N, 1)
    if metric == "l1":
        # coordinate-wise median of the assigned points (masked sort)
        srt = torch.sort(torch.where(member, X[None], big), dim=1).values  # (K, N, d)
        lo = torch.clamp_min(torch.div(counts - 1, 2, rounding_mode="floor"), 0).long()
        hi = torch.div(counts, 2, rounding_mode="floor").long()
        ar = torch.arange(K, device=X.device)
        meds = 0.5 * (srt[ar, lo] + srt[ar, hi])
        return torch.where(counts[:, None] > 0, meds, mean), counts
    if metric == "linf":
        # midrange: (min + max)/2 of the assigned points, per coordinate
        mn = torch.amin(torch.where(member, X[None], big), dim=1)
        mx = torch.amax(torch.where(member, X[None], -big), dim=1)
        return torch.where(counts[:, None] > 0, 0.5 * (mn + mx), mean), counts
    raise ValueError(metric)


def kmeans(
    X: torch.Tensor,
    init_centroids: torch.Tensor,
    *,
    num_clusters: int,
    metric: str = "l2",
    iters: int = 50,
) -> KMeansResult:
    """``iters`` EM steps from ``init_centroids``; one kernel launch per
    E-step, plus one for the final assignment (and one more for the
    inertia, which is always squared l2, under l1 and linf)."""
    K = num_clusters
    C = init_centroids
    for _ in range(iters):
        assign, _ = nearest(X, C, metric)
        C, _ = _m_step(X, assign, K, metric)
    assign, dist = nearest(X, C, metric)
    if metric not in ("l2", "l2sq"):
        _, dist = nearest(X, C, "l2sq")
    return KMeansResult(centroids=C, assignments=assign, inertia=torch.sum(dist), iters=iters)


# ----------------------------------------------------------------------------
# Sufficient-statistics distributed k-means
# ----------------------------------------------------------------------------


def node_stats(Xs: torch.Tensor, assign: torch.Tensor, K: int):
    """The M-step of ``distributed_kmeans``: each node's per-cluster (Σx,
    count) from its one-hot product, summed over nodes (the Allreduce).
    ``assign`` holds the stacked nodes' assignments, node after node."""
    Knodes, Nk, _ = Xs.shape
    sums, counts = [], []
    for k in range(Knodes):
        onehot = _one_hot(assign[k * Nk:(k + 1) * Nk], K, Xs.dtype)
        sums.append(onehot.T @ Xs[k])  # (K, d)
        counts.append(torch.sum(onehot, dim=0))  # (K,)
        del onehot
    return torch.sum(torch.stack(sums), dim=0), torch.sum(torch.stack(counts), dim=0)


def distributed_kmeans(
    Xs: torch.Tensor,  # (Knodes, Nk, d)
    init_centroids: torch.Tensor,
    *,
    num_clusters: int,
    iters: int = 50,
) -> KMeansResult:
    """Each node pushes per-cluster (Σx, count); the server aggregates.

    One Allreduce of (K·d + K) numbers per EM iteration — independent of
    the local data sizes.  The centroids are shared by every node, so one
    kernel launch over the stacked (Knodes·Nk, d) points is the E-step of
    all nodes: ``iters`` + 1 launches a call.  The M-step's one-hot product
    runs one node at a time (a node's one-hot is Nk × K).  With an ambient
    tracer each E-step is a ``kmeans/estep`` span, each M-step a
    ``kmeans/mstep`` and the final assignment a ``kmeans/assign``."""
    K = num_clusters
    Xall = Xs.reshape(-1, Xs.shape[-1])

    def estep(C):
        return nearest(Xall, C, "l2sq")[0]

    def mstep(assign, C):
        g_sums, g_counts = node_stats(Xs, assign, K)
        C_new = g_sums / torch.clamp_min(g_counts, 1.0)[:, None]
        return torch.where(g_counts[:, None] > 0, C_new, C)

    def final(C):
        assign, dist = nearest(Xall, C, "l2sq")
        return assign, torch.sum(dist)

    tracer = _trace.current_tracer()
    if tracer is not None:
        estep = tracer.spanned("kmeans/estep", estep)
        mstep = tracer.spanned("kmeans/mstep", mstep)
        final = tracer.spanned("kmeans/assign", final)
    C = init_centroids
    for _ in range(iters):
        C = mstep(estep(C), C)
    assign, inertia = final(C)
    return KMeansResult(centroids=C, assignments=assign, inertia=inertia, iters=iters)


# ----------------------------------------------------------------------------
# Consensus k-means via ADMM ([21])
# ----------------------------------------------------------------------------


def _align(C: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """Greedily permute rows of C to match rows of V (K is small): row i
    takes the nearest column not yet taken, first index on ties.  The scan
    runs on the host."""
    K = C.shape[0]
    d2 = torch.sum((V[:, None, :] - C[None, :, :]) ** 2, dim=-1).cpu()  # (K, K)
    perm = torch.zeros((K,), dtype=torch.long)
    for i in range(K):
        j = int(torch.argmin(d2[i]))
        perm[i] = j
        d2[:, j] = float("inf")
    return C[perm.to(C.device)]


def consensus_kmeans(
    Xs: torch.Tensor,
    init_centroids: torch.Tensor,
    *,
    rho: float = 0.1,
    iters: int = 60,
    local_em_iters: int = 3,
):
    """ADMM consensus on the flattened centroid matrix.

    Local prox: ``local_em_iters`` EM steps on the node's shard pulled
    toward the consensus centroids (weights: local count vs ρ), then a
    greedy slot re-alignment to the consensus — consensus on a SET of
    centroids is only defined up to a per-node permutation.  Each EM step's
    E-step is one kernel launch: iters × Knodes × local_em_iters in all.
    Returns ``(centroids (K, d), ADMMResult)``."""
    from repro_torch.core.admm import consensus_admm

    Knodes, Nk, d = Xs.shape
    K = init_centroids.shape[0]
    dim = K * d

    def local_prox(v_flat, u, rho_):
        out = []
        for k in range(Knodes):
            X = Xs[k]
            V = v_flat[k].reshape(K, d)
            C = V
            for _ in range(local_em_iters):
                assign, _ = nearest(X, C, "l2sq")
                onehot = _one_hot(assign, K, X.dtype)
                counts = torch.sum(onehot, dim=0)
                sums = onehot.T @ X
                # argmin Σ‖x−c‖² + (ρ/2)‖c−v‖² → (Σx + ρ/2·v) / (n + ρ/2)
                C = (sums + 0.5 * rho_ * V) / (counts[:, None] + 0.5 * rho_)
            out.append(_align(C, V).reshape(-1))
        return torch.stack(out)

    theta0 = init_centroids.reshape(1, -1).repeat(Knodes, 1)
    res = consensus_admm(local_prox, Knodes, dim, rho=rho, g="none", iters=iters,
                         theta0=theta0)
    return res.z.reshape(K, d), res


# ----------------------------------------------------------------------------
# Representative-point summarization ([30], DBSCAN-flavored)
# ----------------------------------------------------------------------------


def summarize_representatives(
    X: torch.Tensor,
    *,
    eps: float,
    min_pts: int,
    max_reps: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy core-point cover: every representative has ≥ min_pts
    neighbors within eps and covered neighborhoods do not overlap.

    Returns ``(reps, mask)`` with fixed shape (max_reps, d) / (max_reps,)."""
    N, d = X.shape
    neigh = pdist(X, X, metric="l2") <= eps  # (N, N)
    covered = torch.sum(neigh, dim=1) < min_pts  # noise points never become reps
    reps = torch.zeros((max_reps, d), dtype=X.dtype, device=X.device)
    mask = torch.zeros((max_reps,), dtype=X.dtype, device=X.device)
    for slot in range(max_reps):
        counts = torch.sum(neigh & ~covered[None, :], dim=1)
        counts = torch.where(covered, -1, counts)
        best = int(torch.argmax(counts))
        if int(counts[best]) < min_pts:
            break  # nothing changes any more: the reference's later steps are no-ops
        covered = covered | neigh[best]
        reps[slot] = X[best]
        mask[slot] = 1.0
    return reps, mask


# ----------------------------------------------------------------------------
# Radius-T incremental clustering ([27])
# ----------------------------------------------------------------------------


def radius_t_clustering(
    X: torch.Tensor, *, T: float, max_clusters: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass: assign each point to the nearest open centroid if within
    T, else open a new cluster (up to ``max_clusters``; overflow folds into
    the nearest).  Returns (centroids, counts, mask)."""
    N, d = X.shape
    C = torch.zeros((max_clusters, d), dtype=X.dtype, device=X.device)
    counts = torch.zeros((max_clusters,), dtype=X.dtype, device=X.device)
    ncl = 0
    for x in X:
        dd = torch.sqrt(torch.sum((C[:ncl] - x[None, :]) ** 2, dim=1))
        j = int(torch.argmin(dd)) if ncl else 0
        near = ncl > 0 and bool(dd[j] <= T)
        open_new = not near and ncl < max_clusters
        tgt = ncl if open_new else j
        new_count = counts[tgt] + 1.0
        # running mean update
        C[tgt] = C[tgt] + (x - C[tgt]) / new_count
        counts[tgt] = new_count
        ncl += int(open_new)
    mask = (torch.arange(max_clusters, device=X.device) < ncl).float()
    return C, counts, mask


def merge_centroids(
    C: torch.Tensor, counts: torch.Tensor, mask: torch.Tensor, *, T: float
):
    """Server-side merge: greedily fold together centroids closer than T
    (count-weighted means) — the aggregation step of [27]."""
    Kc = C.shape[0]
    C, counts, mask = C.clone(), counts.clone(), mask.clone()
    ar = torch.arange(Kc, device=C.device)
    for i in range(Kc):
        dd = torch.sqrt(torch.sum((C - C[i][None, :]) ** 2, dim=1))
        cand = (dd <= T) & (mask > 0) & (ar > i) & (mask[i] > 0)
        if not bool(torch.any(cand)):
            continue
        j = int(torch.argmax(cand.to(torch.uint8)))
        tot = counts[i] + counts[j]
        C[i] = (C[i] * counts[i] + C[j] * counts[j]) / torch.clamp_min(tot, 1.0)
        counts[i] = tot
        counts[j] = 0.0
        mask[j] = 0.0
    return C, counts, mask
