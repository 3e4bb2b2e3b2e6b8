"""Port parity: ``repro_torch.ml.kwindows`` against ``repro.ml.kwindows``
on the same numpy inputs, the port on the CPU.

k-windows decides by thresholds: a point is in a window iff its weighted
ℓ∞ distance is < 1, Phase 3 pre-filters pairs by dist < 2·radius, and the
server merges boxes that touch.  Each test runs the JAX functions op by
op (``jax.disable_jit()``, a context that restores itself) with the JAX
module's ``window_membership``, ``phase3_merging`` and ``boxes_overlap``
wrapped to record how close every such decision came to its threshold,
asserts that margin is above the tolerance, so no rounding can flip one,
and only then holds the port to that JAX run.  Windows agree to atol
1e-5 (centers are means whose sums run in another order), alive flags
and counts exactly.

``jax.random`` cannot be matched: the JAX package's initial windows are
handed to the port, by monkeypatching the port's ``init_windows`` where a
function draws them itself.
"""

from __future__ import annotations

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro.core import schedules as j_sched  # noqa: E402
from repro.ml import kwindows as jk  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch.core import schedules as t_sched  # noqa: E402
from repro_torch.core.allreduce import CommLedger  # noqa: E402
from repro_torch.ml import kwindows as tk  # noqa: E402

ATOL = 1e-5
#: a decision's least distance from its threshold: the window tolerance (a
#: center off by ATOL moves a weighted distance by ATOL / h, h ≥ r ≥ 1 here)
MARGIN = ATOL
#: fewer phase-1 steps and phase-2 rounds than the defaults: the JAX runs
#: that check the margins go op by op
FAST = dict(p1_iters=10, p2_rounds=2)


#: sites, windows a site, initial half-width: every test works at these
#: shapes, so the op-by-op JAX runs share their compiled primitives
K, W, R = 3, 9, 1.2


@pytest.fixture(scope="module")
def shards():
    """Three sites of 180 points, each holding all three blobs."""
    rng = np.random.default_rng(17)
    centers = np.asarray([(-5.0, -5.0), (0.0, 5.0), (5.0, -2.0)])
    X = np.concatenate([rng.normal(size=(K * 60, 2)) * 0.6 + c for c in centers])
    return X[rng.permutation(X.shape[0])].reshape(K, 180, 2).astype(np.float32)


@pytest.fixture(scope="module")
def blobs(shards):
    return shards[0]


def T(a) -> torch.Tensor:
    """A tensor owning a copy of ``a`` (JAX's numpy views are read-only)."""
    return torch.from_numpy(np.array(a))


def to_torch(win) -> tk.KWindows:
    return tk.KWindows(*(T(a) for a in win))


def jax_windows(seed, X, K, r):
    return jk.init_windows(jax.random.key(seed), jnp.asarray(X), K, r)


def assert_windows_close(wt, wj):
    np.testing.assert_allclose(wt.centers.numpy(), np.asarray(wj.centers), atol=ATOL)
    np.testing.assert_allclose(wt.halfwidths.numpy(), np.asarray(wj.halfwidths), atol=ATOL)
    np.testing.assert_array_equal(wt.alive.numpy(), np.asarray(wj.alive))
    np.testing.assert_array_equal(wt.counts.numpy(), np.asarray(wj.counts))


class margins:
    """``with margins() as m:`` runs JAX k-windows code op by op, with the
    JAX module's threshold decisions wrapped to record their margins; on
    leaving, the wrappers and the jit setting are restored.  Then
    ``m.check()``."""

    def __init__(self):
        self.seen = {}

    def see(self, what, values):
        v = np.asarray(values, np.float64)
        self.seen[what] = min(self.seen.get(what, np.inf), float(np.min(v, initial=np.inf)))

    def check(self):
        assert self.seen
        for what, m in self.seen.items():
            assert m > MARGIN, f"{what} margin {m} is inside {MARGIN}"

    def __enter__(self):
        member, phase3, overlap = jk.window_membership, jk.phase3_merging, jk.boxes_overlap

        def rec_member(X, win):
            z = np.abs(np.asarray(X)[:, None, :] - np.asarray(win.centers)[None]) / np.maximum(
                np.asarray(win.halfwidths)[None], 1e-12)
            self.see("membership", np.abs(z.max(-1) - 1.0)[:, np.asarray(win.alive) > 0])
            return member(X, win)

        def rec_phase3(X, win, **kw):
            c, h = (np.asarray(a, np.float64) for a in (win.centers, win.halfwidths))
            cd = np.sqrt(np.sum((c[:, None] - c[None]) ** 2, axis=-1))
            rad = h.max(axis=1)
            live = np.outer(np.asarray(win.alive) > 0, np.asarray(win.alive) > 0)
            self.see("near", np.abs(cd - 2.0 * np.maximum(rad[:, None], rad[None]))[
                np.triu(live, 1)])
            return phase3(X, win, **kw)

        def rec_overlap(win):
            c, h = (np.asarray(a, np.float64) for a in (win.centers, win.halfwidths))
            lo, hi = c - h, c + h
            live = np.outer(np.asarray(win.alive) > 0, np.asarray(win.alive) > 0)
            gaps = np.minimum(np.abs(lo[:, None] - hi[None]), np.abs(hi[:, None] - lo[None]))
            self.see("overlap", gaps[np.triu(live, 1)])
            return overlap(win)

        self._patch = pytest.MonkeyPatch.context()
        mp = self._patch.__enter__()
        mp.setattr(jk, "window_membership", rec_member)
        mp.setattr(jk, "phase3_merging", rec_phase3)
        mp.setattr(jk, "boxes_overlap", rec_overlap)
        self._nojit = jax.disable_jit()
        self._nojit.__enter__()
        return self

    def __exit__(self, *exc):
        self._nojit.__exit__(*exc)
        return self._patch.__exit__(*exc)


def test_membership_assign_and_masked_mean_match_jax(blobs):
    X = blobs
    win = jax_windows(0, X, W, 1.3)
    win = win._replace(alive=win.alive.at[3].set(0.0))
    with margins() as m:
        mj = jk.window_membership(jnp.asarray(X), win)
        aj = jk.assign_points(jnp.asarray(X), win)
        d2 = np.sum((X[:, None] - np.asarray(win.centers)[None]) ** 2, axis=-1)
        d2 = np.sort(np.where(np.asarray(mj), d2, np.inf), axis=1)
        two = np.isfinite(d2[:, 1])
        m.see("assign", d2[two, 1] - d2[two, 0])
    m.check()
    wt = to_torch(win)
    mt = tk.window_membership(T(X), wt)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(tk.assign_points(T(X), wt).numpy(), np.asarray(aj))
    fb = T(np.asarray(win.centers))
    ct, nt = tk._masked_mean(T(X), mt.float(), fb)
    cj, nj = jk._masked_mean(jnp.asarray(X), mj.astype(jnp.float32), win.centers)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=ATOL)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))


def test_phases_match_jax(blobs):
    """Phase 1 → 2 → 3 from the same initial windows."""
    X, Xj = blobs, jnp.asarray(blobs)
    win0 = jax_windows(1, X, W, R)
    with margins() as m:
        j1 = jk.phase1_movements(Xj, win0, iters=10)
        j2 = jk.phase2_enlargement(Xj, j1, rounds=2)
        j3 = jk.phase3_merging(Xj, j2)
    m.check()
    t1 = tk.phase1_movements(T(X), to_torch(win0), iters=10)
    assert_windows_close(t1, j1)
    t2 = tk.phase2_enlargement(T(X), t1, rounds=2)
    assert_windows_close(t2, j2)
    t3 = tk.phase3_merging(T(X), t2)
    assert_windows_close(t3, j3)
    assert int(t3.alive.sum()) < W  # phase 3 merged something


def test_kwindows_matches_jax(blobs, monkeypatch):
    X = blobs
    win0 = jax_windows(2, X, W, R)
    with margins() as m:
        wj = jk.kwindows(jax.random.key(2), jnp.asarray(X), num_windows=W, r=R, **FAST)
    m.check()
    monkeypatch.setattr(tk, "init_windows", lambda gen, X_, K, r: to_torch(win0))
    wt = tk.kwindows(torch.Generator().manual_seed(2), T(X), num_windows=W, r=R, **FAST)
    assert_windows_close(wt, wj)
    assert 3 <= int(wt.alive.sum()) <= 6


def test_boxes_overlap_and_server_merge_match_jax():
    rng = np.random.default_rng(4)
    win = jk.KWindows(
        centers=jnp.asarray(rng.uniform(-6, 6, size=(K * W, 2)), jnp.float32),
        halfwidths=jnp.asarray(rng.uniform(0.2, 0.8, size=(K * W, 2)), jnp.float32),
        alive=jnp.asarray((rng.uniform(size=K * W) > 0.2).astype(np.float32)),
        counts=jnp.asarray(rng.integers(1, 30, size=K * W).astype(np.float32)),
    )
    with margins() as m:
        ov = jk.boxes_overlap(win)
        wj = jk.merge_overlapping_windows(win)
    m.check()
    np.testing.assert_array_equal(tk.boxes_overlap(to_torch(win)).numpy(), np.asarray(ov))
    wt = tk.merge_overlapping_windows(to_torch(win))
    assert_windows_close(wt, wj)
    assert int(wt.alive.sum()) < int(win.alive.sum())


def test_init_windows_draws_distinct_points(blobs):
    X = T(blobs)
    w1 = tk.init_windows(torch.Generator().manual_seed(5), X, 12, 0.7)
    w2 = tk.init_windows(torch.Generator().manual_seed(5), X, 12, 0.7)
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))
    rows = [int(torch.nonzero((X == c).all(dim=1))[0]) for c in w1.centers]
    assert len(set(rows)) == 12  # without replacement
    assert bool((w1.halfwidths == 0.7).all()) and w1.halfwidths.shape == (12, 2)
    assert bool((w1.alive == 1).all()) and bool((w1.counts == 0).all())


def _patch_node_windows(monkeypatch, Xs, node_windows):
    """The port's init_windows returns the JAX package's windows of the
    node whose shard it is given."""
    shards = [T(x) for x in Xs]

    def init(gen, X, K, r):
        k = next(i for i, s in enumerate(shards) if torch.equal(X, s))
        return to_torch(node_windows[k])

    monkeypatch.setattr(tk, "init_windows", init)


def test_fit_kwindows_matches_jax(shards, monkeypatch):
    """fit(KWindowsStrategy) under one round-robin §5 pass: θ (the merged
    window set) and the handed-back trajectory agree, the ledger exactly."""
    Xs, r = shards, R
    key = jax.random.key(3)
    keys = jax.random.split(key, K)
    node_windows = [jk.init_windows(keys[k], jnp.asarray(Xs[k]), W, r) for k in range(K)]
    with margins() as m:
        pool = [jk.kwindows(keys[k], jnp.asarray(Xs[k]), num_windows=W, r=r, **FAST)
                for k in range(K)]
        jk.merge_overlapping_windows(jk.KWindows(*(jnp.concatenate(t) for t in zip(*pool))))
    m.check()
    rj = japi.fit(jk.KWindowsStrategy(key, num_windows=W, r=r, **FAST), jnp.asarray(Xs),
                  transport="sequential_server", schedule=j_sched.round_robin(K, 1))
    _patch_node_windows(monkeypatch, Xs, node_windows)
    rt = tapi.fit(tk.KWindowsStrategy(3, num_windows=W, r=r, **FAST), Xs,
                  transport="sequential_server", schedule=t_sched.round_robin(K, 1),
                  device="cpu")
    assert_windows_close(rt.theta, rj.theta)
    for a, b in zip(rt.trajectory, rj.trajectory):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    assert rt.ledger.summary() == rj.ledger.summary()
    assert rt.ledger.events == rj.ledger.events
    np.testing.assert_array_equal(rt.metrics["uplink_bytes_per_round"],
                                  rj.metrics["uplink_bytes_per_round"])
    # the §5 price: each contact pushes and hands back the pooled window set
    pool_bytes = K * W * (2 * 2 + 2) * 4
    assert rt.ledger.uplink_bytes == rt.ledger.downlink_bytes == K * pool_bytes
    np.testing.assert_array_equal(
        tk.KWindowsStrategy(3, num_windows=W, r=r).predict(rt.theta, T(Xs[0])).numpy(),
        np.asarray(jk.assign_points(jnp.asarray(Xs[0]), rj.theta)))


def test_distributed_kwindows_shim_is_the_fit(shards):
    Xs, r = shards, R
    res = tapi.fit(tk.KWindowsStrategy(7, num_windows=W, r=r, **FAST), Xs,
                   transport="sequential_server", schedule=t_sched.round_robin(K, 1),
                   tag="kwindows", device="cpu")
    ledger = CommLedger()
    with pytest.warns(DeprecationWarning, match="deprecation shim"):
        win = tk.distributed_kwindows(7, T(Xs), num_windows=W, r=r, ledger=ledger, **FAST,
                                      device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(win, res.theta))
    assert ledger.summary() == res.ledger.summary()
    assert ledger.events == res.ledger.events


def test_node_generators_are_seeded_per_node(blobs):
    """One generator per node, derived from the seed: the same seed gives
    the same windows, and nodes do not share a stream."""
    X = T(blobs)
    g1 = tk._node_generators(11, 3, X.device)
    g2 = tk._node_generators(torch.Generator().manual_seed(11), 3, X.device)
    draws = [[tk.init_windows(g, X, 4, 1.0).centers for g in gens] for gens in (g1, g2)]
    assert all(torch.equal(a, b) for a, b in zip(*draws))
    assert not torch.equal(draws[0][0], draws[0][1])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tk._node_generators(0, 2, X.device)
