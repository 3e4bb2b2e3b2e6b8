"""K-windows clustering — the paper's §4.2 (port of ``repro.ml.kwindows``).

The paper's ℓ∞-constrained k-means: the E-step is replaced by the window
indicator u_{i,k} = 1{‖x_i − c_k‖_{ℓ∞^w} < 1}, the M-step stays the mean,
followed by Phase 2 (per-coordinate enlargement while the capture ratio
gains ≥ θ_e) and Phase 3 (merging pairs whose shared-capture ratio
exceeds θ_m).  Windows are boxes: centers ``c`` (K, d) and halfwidths
``h`` (K, d), with ‖x−c‖_{ℓ∞^w} = max_d |x_d−c_d|/h_d.  A point inside
several windows goes to the nearest center in ℓ2.

``KWindowsStrategy`` is [60]'s naive distributed variant on ``api.fit``:
local k-windows at each node, then the server merges ALL overlapping
windows.  k-windows reaches no kernel: the window test is a weighted ℓ∞
box test, not a nearest-centroid search.  The reference's ``lax.scan``
loops are Python loops, and its ``jax.random`` keys are
``torch.Generator``s.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import torch

from repro_torch.api import executor as _exec
from repro_torch.api.strategy import Strategy


class KWindows(NamedTuple):
    centers: torch.Tensor  # (K, d)
    halfwidths: torch.Tensor  # (K, d)
    alive: torch.Tensor  # (K,) 1.0 = active cluster
    counts: torch.Tensor  # (K,) points captured


def window_membership(X: torch.Tensor, win: KWindows) -> torch.Tensor:
    """(N, K) indicator u_{i,k} = 1{‖x_i − c_k‖_{ℓ∞^w} < 1} (and k alive)."""
    z = torch.abs(X[:, None, :] - win.centers[None, :, :]) / torch.clamp_min(
        win.halfwidths[None, :, :], 1e-12
    )
    inside = torch.amax(z, dim=-1) < 1.0
    return inside & (win.alive[None, :] > 0)


def assign_points(X: torch.Tensor, win: KWindows) -> torch.Tensor:
    """Resolve overlapping membership by nearest center (ℓ2); -1 = uncaptured."""
    member = window_membership(X, win)
    d2 = torch.sum((X[:, None, :] - win.centers[None, :, :]) ** 2, dim=-1)
    d2 = torch.where(member, d2, float("inf"))
    a = torch.argmin(d2, dim=1)
    return torch.where(torch.any(member, dim=1), a, -1)


def _masked_mean(X, mask, fallback):
    cnt = torch.sum(mask, dim=0)  # (K,)
    s = mask.T @ X  # (K, d)
    mean = s / torch.clamp_min(cnt, 1.0)[:, None]
    return torch.where(cnt[:, None] > 0, mean, fallback), cnt


# ----------------------------------------------------------------------------
# Phase 1 — windowed k-means ("E-step replaced by the window indicator")
# ----------------------------------------------------------------------------


def phase1_movements(X: torch.Tensor, win: KWindows, *, iters: int = 20) -> KWindows:
    for _ in range(iters):
        member = window_membership(X, win).to(X.dtype)
        centers, cnt = _masked_mean(X, member, win.centers)
        win = KWindows(centers, win.halfwidths, win.alive, cnt)
    return win


# ----------------------------------------------------------------------------
# Phase 2 — enlargement, gated on relative capture gain θ_e
# ----------------------------------------------------------------------------


def phase2_enlargement(
    X: torch.Tensor,
    win: KWindows,
    *,
    enlarge_factor: float = 1.25,
    theta_e: float = 1.05,
    rounds: int = 8,
) -> KWindows:
    """Grow each window per coordinate while capture grows ≥ θ_e×, with
    re-centering (movement) after each accepted enlargement."""
    d = X.shape[1]
    cols = torch.arange(d, device=X.device)
    for _ in range(rounds):
        for coord in range(d):
            member = window_membership(X, win)
            old_cnt = torch.sum(member, dim=0).float()  # (K,)
            h_new = win.halfwidths.clone()
            h_new[:, coord] *= enlarge_factor
            cand = KWindows(win.centers, h_new, win.alive, win.counts)
            new_cnt = torch.sum(window_membership(X, cand), dim=0).float()
            accept = new_cnt >= theta_e * torch.clamp_min(old_cnt, 1.0)  # (K,)
            h = torch.where(accept[:, None] & (cols == coord)[None, :],
                            h_new, win.halfwidths)
            win = KWindows(win.centers, h, win.alive, win.counts)
            # movement after enlargement
            member = window_membership(X, win).to(X.dtype)
            centers, cnt = _masked_mean(X, member, win.centers)
            win = KWindows(centers, win.halfwidths, win.alive, cnt)
    return win


# ----------------------------------------------------------------------------
# Phase 3 — merging, gated on overlap ratio θ_m
# ----------------------------------------------------------------------------


def _merge_pairs(carry, pairs, K):
    """The reference's greedy merge scan: for i in order, fold the first
    live j with ``pairs[i, j]`` into i (count-weighted center, union box)."""
    centers, half, alive, counts = (t.clone() for t in carry)
    for i in range(K):
        row = pairs[i] & (alive > 0)
        if not (bool(torch.any(row)) and bool(alive[i] > 0)):
            continue
        j = int(torch.argmax(row.to(torch.uint8)))
        tot = counts[i] + counts[j]
        c = (centers[i] * counts[i] + centers[j] * counts[j]) / torch.clamp_min(tot, 1.0)
        lo = torch.minimum(centers[i] - half[i], centers[j] - half[j])
        hi = torch.maximum(centers[i] + half[i], centers[j] + half[j])
        centers[i] = c
        half[i] = torch.clamp_min((hi - lo) / 2.0, 1e-12)
        counts[i] = tot
        counts[j] = 0.0
        alive[j] = 0.0
    return KWindows(centers, half, alive, counts)


def _overlap_counts(X: torch.Tensor, win: KWindows) -> torch.Tensor:
    member = window_membership(X, win).float()  # (N, K)
    return member.T @ member  # (K, K) pairwise joint-capture counts


def phase3_merging(X: torch.Tensor, win: KWindows, *, theta_m: float = 0.5) -> KWindows:
    """Merge pairs whose shared-capture ratio exceeds θ_m.

    ratio(i,j) = card(W_i ∩ W_j captured) / min(card_i, card_j); merged
    cluster = count-weighted center, union box.  Candidate pairs are
    pre-filtered by the paper's dist(c_i,c_j) < 2·max radius test.
    """
    K = win.centers.shape[0]
    joint = _overlap_counts(X, win)
    cnt = torch.diagonal(joint)
    cdist = torch.sqrt(
        torch.sum((win.centers[:, None, :] - win.centers[None, :, :]) ** 2, dim=-1)
    )
    rad = torch.amax(win.halfwidths, dim=1)
    near = cdist < 2.0 * torch.maximum(rad[:, None], rad[None, :])
    ratio = joint / torch.clamp_min(torch.minimum(cnt[:, None], cnt[None, :]), 1.0)
    mergeable = (
        (ratio > theta_m)
        & near
        & (win.alive[:, None] > 0)
        & (win.alive[None, :] > 0)
        & torch.ones((K, K), dtype=torch.bool, device=X.device).triu(1)
    )
    return _merge_pairs(win, mergeable, K)


# ----------------------------------------------------------------------------
# Full pipeline + distributed variant
# ----------------------------------------------------------------------------


def init_windows(gen: torch.Generator, X: torch.Tensor, K: int, r: float) -> KWindows:
    """Initial square windows of edge 2r centered on K distinct data
    points, chosen without replacement from ``gen``."""
    idx = torch.randperm(X.shape[0], generator=gen, device=gen.device)[:K].to(X.device)
    centers = X[idx]
    half = torch.full((K, X.shape[1]), r, dtype=X.dtype, device=X.device)
    return KWindows(centers, half, torch.ones((K,), device=X.device),
                    torch.zeros((K,), device=X.device))


def kwindows(
    gen: torch.Generator,
    X: torch.Tensor,
    *,
    num_windows: int,
    r: float,
    theta_e: float = 1.05,
    theta_m: float = 0.5,
    p1_iters: int = 20,
    p2_rounds: int = 6,
) -> KWindows:
    """The three-phase k-windows algorithm (start with many windows; the
    merge phase converges toward the natural cluster count)."""
    win = init_windows(gen, X, num_windows, r)
    win = phase1_movements(X, win, iters=p1_iters)
    win = phase2_enlargement(X, win, theta_e=theta_e, rounds=p2_rounds)
    win = phase3_merging(X, win, theta_m=theta_m)
    # refresh counts after merging
    cnt = torch.sum(window_membership(X, win).to(X.dtype), dim=0)
    return KWindows(win.centers, win.halfwidths, win.alive * (cnt > 0), cnt)


def boxes_overlap(win: KWindows) -> torch.Tensor:
    """(K, K) pairwise geometric box-overlap indicator."""
    lo = win.centers - win.halfwidths
    hi = win.centers + win.halfwidths
    sep = torch.any(
        (lo[:, None, :] > hi[None, :, :]) | (hi[:, None, :] < lo[None, :, :]),
        dim=-1,
    )
    return (~sep) & (win.alive[:, None] > 0) & (win.alive[None, :] > 0)


def merge_overlapping_windows(win: KWindows, *, sweeps: int = 3) -> KWindows:
    """[60]'s naive server-side rule: merge every geometrically overlapping
    pair, regardless of shared capture counts.  Multiple sweeps collapse
    chained overlaps."""
    K = win.centers.shape[0]
    upper = torch.ones((K, K), dtype=torch.bool, device=win.centers.device).triu(1)
    for _ in range(sweeps):
        win = _merge_pairs(win, boxes_overlap(win) & upper, K)
    return win


def _node_generators(seed, K: int, device) -> list:
    """K generators on ``device``, seeded from ``seed`` (an int or a
    ``torch.Generator``) deterministically."""
    base = seed if isinstance(seed, torch.Generator) else torch.Generator().manual_seed(seed)
    seeds = torch.randint(0, 2**62, (K,), generator=base, device=base.device).tolist()
    return [torch.Generator(device=device).manual_seed(s) for s in seeds]


class KWindowsStrategy(Strategy):
    """[60]'s distributed k-windows as a Strategy on ``api.fit``.

    θ is the pooled window set (K·W slots, one block per node).  Each §5
    contact runs the full three-phase local k-windows on the node's shard
    and pushes its windows into its slot block; ``finalize`` is the naive
    server merge of ALL overlapping windows.  One round-robin pass
    reproduces ``distributed_kwindows``::

        res = api.fit(KWindowsStrategy(0, num_windows=32, r=1.0), Xs,
                      transport="sequential_server",
                      schedule=schedules.round_robin(K, 1), device="cuda")

    ``seed`` (an int or a ``torch.Generator``) takes the place of the
    reference's ``jax.random`` key: each node draws its initial windows
    from its own generator, derived from it deterministically.
    """

    def __init__(self, seed, *, num_windows: int, r: float, **kw):
        self.seed = seed
        self.num_windows = num_windows
        self.r = r
        self.kw = kw

    def num_nodes(self, data):
        return data.shape[0]

    def init_theta(self, data):
        Knodes, _, d = data.shape
        pool = Knodes * self.num_windows
        box = torch.zeros((pool, d), dtype=data.dtype, device=data.device)
        flag = torch.zeros((pool,), dtype=data.dtype, device=data.device)
        return KWindows(centers=box, halfwidths=box.clone(), alive=flag,
                        counts=flag.clone())

    def init_state(self, theta, data):
        return _node_generators(self.seed, data.shape[0], data.device)

    def local_step(self, k, theta, state, data):
        # ``k`` indexes this executor's data slice; the pooled θ slots and
        # the per-node generators are indexed at the node's global position
        kg = _exec.node_global_index(k)
        win = kwindows(state[kg], data[k], num_windows=self.num_windows, r=self.r,
                       **self.kw)
        s = slice(kg * self.num_windows, (kg + 1) * self.num_windows)
        pool = KWindows(*(t.clone() for t in theta))
        for dst, src in zip(pool, win):
            dst[s] = src
        return pool, state

    def round_metric(self, theta, state, data):
        return torch.sum(theta.alive)

    def finalize(self, theta, state, data):
        return merge_overlapping_windows(theta)

    def predict(self, theta, X):
        """Cluster of each query point against the merged window set: the
        nearest capturing window's index, or -1 where no window captures."""
        return assign_points(X, theta)


def distributed_kwindows(
    seed,
    Xs: torch.Tensor,  # (Knodes, Nk, d)
    *,
    num_windows: int,
    r: float,
    ledger=None,
    device="cuda",
    **kw,
) -> KWindows:
    """[60]'s naive distributed k-windows: local runs, then the server
    merges ALL geometrically overlapping windows.

    Deprecation shim → ``api.fit(KWindowsStrategy(...),
    transport="sequential_server", schedule=round_robin(K, 1))``.  Pass a
    ``CommLedger`` as ``ledger`` to collect the protocol's byte accounting.
    """
    warnings.warn(
        "repro_torch.ml.kwindows.distributed_kwindows is a deprecation shim; use "
        'repro_torch.api.fit(KWindowsStrategy(...), Xs, transport="sequential_server")',
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.api import fit
    from repro_torch.core.schedules import round_robin

    strategy = KWindowsStrategy(seed, num_windows=num_windows, r=r, **kw)
    res = fit(
        strategy,
        Xs,
        transport="sequential_server",
        schedule=round_robin(Xs.shape[0], 1),
        tag="kwindows",
        device=device,
    )
    if ledger is not None:
        ledger.merge(res.ledger)
    return res.theta
