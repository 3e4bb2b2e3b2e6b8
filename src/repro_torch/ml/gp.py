"""Distributed Gaussian Processes, paper §3.3 (port of ``repro.ml.gp``).

Exact GP regression and the distributed expert-combination models, with
the paper's formulas:

* ``poe``   — Product-of-Experts: (σ*)⁻² = Σ_k (σ_k*)⁻²;
* ``gpoe``  — generalized PoE [13]: (σ*)⁻² = Σ_k β_k (σ_k*)⁻²;
* ``bcm``   — Bayesian Committee Machine [67]:
              (σ*)⁻² = Σ_k (σ_k*)⁻² + (1 − K)·σ₀⁻²;
* ``gbcm``  — generalized/robust BCM [17]:
              (σ*)⁻² = Σ_k β_k (σ_k*)⁻² + (1 − Σ_k β_k)·σ₀⁻²;
* ``moe_predict`` — the [46] MoE with MAP proximity assignment;
* the sparse GP (Titsias [66]) from shard statistics aggregated by one
  Allreduce ([23]): ``distributed_sgpr``.

Hyperparameters are trained by Adagrad ascent on the exact (or
PoE-factorized: one term a node, summed by one Allreduce) log marginal
likelihood, the gradient from ``torch.func.grad``.  The reference's
``vmap`` over experts is a loop over them, its ``scan`` a Python loop.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.func import grad, vmap

from repro_torch.device import resolve_device, to_device
from repro_torch.utils.tree import tree_map

# ----------------------------------------------------------------------------
# Kernel + exact GP
# ----------------------------------------------------------------------------


class GPHypers(NamedTuple):
    log_lengthscale: torch.Tensor
    log_signal: torch.Tensor
    log_noise: torch.Tensor


def default_hypers(device="cuda") -> GPHypers:
    dev = resolve_device(device)
    return GPHypers(
        log_lengthscale=torch.tensor(0.0, device=dev),
        log_signal=torch.tensor(0.0, device=dev),
        log_noise=torch.tensor(-2.0, device=dev),
    )


def rbf(hyp: GPHypers, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    ell = torch.exp(hyp.log_lengthscale)
    sf2 = torch.exp(2.0 * hyp.log_signal)
    d2 = (
        torch.sum(A * A, dim=1)[:, None]
        - 2.0 * A @ B.T
        + torch.sum(B * B, dim=1)[None, :]
    )
    return sf2 * torch.exp(-0.5 * torch.clamp_min(d2, 0.0) / (ell * ell))


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor; NaN where the factorization fails (a matrix
    that f32 rounding left indefinite), as ``jnp.linalg.cholesky`` returns
    it, where ``torch.linalg.cholesky`` would raise.  No host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where(info == 0, L, torch.nan)


def gp_posterior(hyp: GPHypers, X, y, Xq):
    """Exact GP posterior mean/variance at query points (zero prior mean)."""
    sn2 = torch.exp(2.0 * hyp.log_noise)
    Kxx = rbf(hyp, X, X) + sn2 * _eye(X.shape[0], X)
    Lc = _cholesky(Kxx)
    alpha = torch.cholesky_solve(y[:, None], Lc)[:, 0]
    Kqx = rbf(hyp, Xq, X)
    mu = Kqx @ alpha
    v = torch.linalg.solve_triangular(Lc, Kqx.T, upper=False)
    var = torch.diag(rbf(hyp, Xq, Xq)) - torch.sum(v * v, dim=0)
    return mu, torch.clamp_min(var, 1e-10)


def log_marginal_likelihood(hyp: GPHypers, X, y):
    sn2 = torch.exp(2.0 * hyp.log_noise)
    N = X.shape[0]
    Kxx = rbf(hyp, X, X) + sn2 * _eye(N, X)
    Lc = _cholesky(Kxx)
    alpha = torch.cholesky_solve(y[:, None], Lc)[:, 0]
    return (
        -0.5 * y @ alpha
        - torch.sum(torch.log(torch.diag(Lc)))
        - 0.5 * N * math.log(2.0 * math.pi)
    )


def _adagrad_ascent(neg_obj, hyp, steps, lr):
    """Adagrad steps on a (normalized) negative objective — the paper's
    cited [19] adaptive procedure; robust to the LL's scale."""
    g_fn = grad(neg_obj)
    acc = tree_map(torch.zeros_like, hyp)
    for _ in range(steps):
        g = g_fn(hyp)
        acc = tree_map(lambda a, gi: a + gi * gi, acc, g)
        hyp = tree_map(lambda p, gi, a: p - lr * gi / (torch.sqrt(a) + 1e-8), hyp, g, acc)
    return hyp


def fit_hypers(X, y, *, steps: int = 100, lr: float = 0.1, hyp0: GPHypers | None = None,
               device="cuda") -> GPHypers:
    """Adaptive gradient ascent on the mean log marginal likelihood."""
    dev = resolve_device(device)
    X, y, hyp0 = to_device((X, y, hyp0), dev)
    hyp = default_hypers(dev) if hyp0 is None else hyp0
    N = X.shape[0]
    return _adagrad_ascent(lambda h: -log_marginal_likelihood(h, X, y) / N, hyp, steps, lr)


def fit_hypers_distributed(Xs, ys, *, steps: int = 100, lr: float = 0.1,
                           hyp0: GPHypers | None = None, ledger=None,
                           device="cuda") -> GPHypers:
    """PoE-factorized training: maximize Σ_k log p(y_k | X_k, θ).

    Each node computes the gradient of its local marginal-likelihood term
    and one Allreduce sums them.  Pass a ``CommLedger`` as ``ledger`` to
    account the per-step hyper-gradient Allreduce (one push + pull of the
    3-scalar hyper vector per node).
    """
    dev = resolve_device(device)
    Xs, ys, hyp0 = to_device((Xs, ys, hyp0), dev)
    hyp = default_hypers(dev) if hyp0 is None else hyp0
    K = Xs.shape[0]
    N = K * Xs.shape[1]

    def neg_total(h):
        lls = torch.stack([log_marginal_likelihood(h, Xs[k], ys[k]) for k in range(K)])
        return -torch.sum(lls) / N

    hyp = _adagrad_ascent(neg_total, hyp, steps, lr)
    if ledger is not None:
        for _ in range(steps):
            ledger.record_allreduce(hyp, K, tag="gp-hyper-grad")
    return hyp


# ----------------------------------------------------------------------------
# Expert-combination rules (the paper's §3.3 formulas)
# ----------------------------------------------------------------------------


class ExpertPreds(NamedTuple):
    mu: torch.Tensor  # (K, Q) per-expert posterior means
    var: torch.Tensor  # (K, Q) per-expert posterior variances


def expert_predictions(hyp: GPHypers, Xs, ys, Xq) -> ExpertPreds:
    preds = [gp_posterior(hyp, Xs[k], ys[k], Xq) for k in range(Xs.shape[0])]
    return ExpertPreds(mu=torch.stack([p[0] for p in preds]),
                       var=torch.stack([p[1] for p in preds]))


def poe(preds: ExpertPreds):
    prec = torch.sum(1.0 / preds.var, dim=0)
    var = 1.0 / prec
    mu = var * torch.sum(preds.mu / preds.var, dim=0)
    return mu, var


def gpoe(preds: ExpertPreds, beta: torch.Tensor | None = None):
    K = preds.mu.shape[0]
    if beta is None:
        # Σβ = 1 → falls back to the prior
        beta = torch.full((K,), 1.0 / K, dtype=preds.mu.dtype, device=preds.mu.device)
    prec = torch.sum(beta[:, None] / preds.var, dim=0)
    var = 1.0 / prec
    mu = var * torch.sum(beta[:, None] * preds.mu / preds.var, dim=0)
    return mu, var


def bcm(preds: ExpertPreds, prior_var: torch.Tensor):
    K = preds.mu.shape[0]
    prec = torch.sum(1.0 / preds.var, dim=0) + (1.0 - K) / prior_var
    var = 1.0 / prec
    mu = var * torch.sum(preds.mu / preds.var, dim=0)
    return mu, var


def gbcm(preds: ExpertPreds, prior_var: torch.Tensor, beta: torch.Tensor | None = None):
    """Robust BCM; default β_k = ½(log σ₀² − log σ_k²) (differential entropy)."""
    if beta is None:
        beta_kq = 0.5 * (torch.log(prior_var)[None, :] - torch.log(preds.var))
    else:
        beta_kq = torch.broadcast_to(beta[:, None], preds.mu.shape)
    prec = torch.sum(beta_kq / preds.var, dim=0) + (
        1.0 - torch.sum(beta_kq, dim=0)
    ) / prior_var
    prec = torch.clamp_min(prec, 1e-10)
    var = 1.0 / prec
    mu = var * torch.sum(beta_kq * preds.mu / preds.var, dim=0)
    return mu, var


def prior_variance(hyp: GPHypers, Xq) -> torch.Tensor:
    return torch.diag(rbf(hyp, Xq, Xq))


# ----------------------------------------------------------------------------
# Sparse GP (Titsias [66]) + distributed aggregation ([23])
# ----------------------------------------------------------------------------


class SGPRStats(NamedTuple):
    """Per-shard sufficient statistics of the variational sparse GP:
    A = Kmn Knm, b = Kmn y, t = Σ_n k(x_n, x_n) and the count — all
    additive over shards, so one Allreduce aggregates them ([23])."""

    A: torch.Tensor  # (M, M)
    b: torch.Tensor  # (M,)
    t: torch.Tensor  # scalar Σ k(x,x)
    n: torch.Tensor  # scalar count


def sgpr_local_stats(hyp: GPHypers, Z, X, y) -> SGPRStats:
    Kmn = rbf(hyp, Z, X)  # (M, Nk)
    return SGPRStats(
        A=Kmn @ Kmn.T,
        b=Kmn @ y,
        t=torch.sum(vmap(lambda x: rbf(hyp, x[None], x[None])[0, 0])(X)),
        n=torch.tensor(float(X.shape[0]), dtype=X.dtype, device=X.device),
    )


def sgpr_aggregate(stats_stacked: SGPRStats) -> SGPRStats:
    """The central-server Allreduce over per-node statistics."""
    return SGPRStats(
        A=torch.sum(stats_stacked.A, dim=0),
        b=torch.sum(stats_stacked.b, dim=0),
        t=torch.sum(stats_stacked.t),
        n=torch.sum(stats_stacked.n),
    )


def sgpr_posterior(hyp: GPHypers, Z, stats: SGPRStats, Xq):
    """Titsias posterior from aggregated statistics:
    μ* = σ⁻² K*m Σ⁻¹ b, var* = K** − K*m (Kmm⁻¹ − Σ⁻¹) Km*, with
    Σ = Kmm + σ⁻² A (solves, no explicit inverse)."""
    M = Z.shape[0]
    sn2 = torch.exp(2.0 * hyp.log_noise)
    Kmm = rbf(hyp, Z, Z) + 1e-6 * _eye(M, Z)
    Sigma = Kmm + stats.A / sn2
    Kqm = rbf(hyp, Xq, Z)
    alpha = torch.linalg.solve(Sigma, stats.b) / sn2
    mu = Kqm @ alpha
    v1 = torch.linalg.solve(Kmm, Kqm.T)
    v2 = torch.linalg.solve(Sigma, Kqm.T)
    var = (
        torch.diag(rbf(hyp, Xq, Xq))
        - torch.sum(Kqm.T * v1, dim=0)
        + torch.sum(Kqm.T * v2, dim=0)
    )
    return mu, torch.clamp_min(var, 1e-10)


def sgpr_elbo(hyp: GPHypers, Z, stats: SGPRStats):
    """Collapsed Titsias ELBO from aggregated statistics, with ``stats.t``
    taken as yᵀy (the quadratic term), as the reference computes it."""
    M = Z.shape[0]
    N = stats.n
    sn2 = torch.exp(2.0 * hyp.log_noise)
    Kmm = rbf(hyp, Z, Z) + 1e-6 * _eye(M, Z)
    Sigma = Kmm + stats.A / sn2
    Lk = _cholesky(Kmm)
    Ls = _cholesky(Sigma)
    # log|Qnn + σ²I| = log|Σ| − log|Kmm| + N log σ²
    logdet = 2.0 * torch.sum(torch.log(torch.diag(Ls))) - 2.0 * torch.sum(
        torch.log(torch.diag(Lk))
    ) + N * torch.log(sn2)
    quad = (stats.t - (stats.b @ torch.linalg.solve(Sigma, stats.b)) / sn2) / sn2
    return -0.5 * (logdet + quad + N * math.log(2.0 * math.pi))


def distributed_sgpr(hyp: GPHypers, Z, Xs, ys, Xq, *, ledger=None, device="cuda"):
    """[23]'s construction end to end: local statistics per node, one
    central aggregation, the posterior from the aggregate.  Returns
    ``(mu, var, per-node-stats-bytes)``, the bytes measured by the wire
    layer: (M² + M + 2)·4, independent of N.  Pass a ``CommLedger`` as
    ``ledger`` to record the K stat pushes."""
    from repro_torch.api.wire import DenseWire

    hyp, Z, Xs, ys, Xq = to_device((hyp, Z, Xs, ys, Xq), resolve_device(device))
    per = [sgpr_local_stats(hyp, Z, Xs[k], ys[k]) for k in range(Xs.shape[0])]
    stats = SGPRStats(*(torch.stack(f) for f in zip(*per)))
    mu, var = sgpr_posterior(hyp, Z, sgpr_aggregate(stats), Xq)
    wire = DenseWire().measure(per[0])
    if ledger is not None:
        for k in range(Xs.shape[0]):
            ledger.record_push(per[0], tag=f"sgpr-stats-node{k}")
    return mu, var, wire


# ----------------------------------------------------------------------------
# MoE with MAP proximity assignment ([46])
# ----------------------------------------------------------------------------


def moe_map_assign(X, inducing_means, V_diag):
    """ẑ_n = argmin_p (x_n − m_p)ᵀ V⁻¹ (x_n − m_p) — fast expert allocation."""
    diff = X[:, None, :] - inducing_means[None, :, :]  # (N, P, d)
    d2 = torch.sum(diff * diff / V_diag[None, None, :], dim=-1)
    return torch.argmin(d2, dim=1)


def moe_predict(hyp: GPHypers, X, y, Xq, inducing_means, V_diag, *, device="cuda"):
    """Hard-assignment MoE: each query point is answered by its MAP expert
    (a fixed-shape masked GP per expert: other experts' points get a huge
    noise term)."""
    hyp, X, y, Xq, inducing_means, V_diag = to_device(
        (hyp, X, y, Xq, inducing_means, V_diag), resolve_device(device))
    P = inducing_means.shape[0]
    z_train = moe_map_assign(X, inducing_means, V_diag)
    z_query = moe_map_assign(Xq, inducing_means, V_diag)

    def expert(p):
        m = (z_train == p).to(X.dtype)
        sn2 = torch.exp(2.0 * hyp.log_noise)
        noise = sn2 + 1e6 * (1.0 - m)
        Lc = _cholesky(rbf(hyp, X, X) + torch.diag(noise))
        alpha = torch.cholesky_solve((y * m)[:, None], Lc)[:, 0]
        Kqx = rbf(hyp, Xq, X)
        mu = Kqx @ alpha
        v = torch.linalg.solve_triangular(Lc, Kqx.T, upper=False)
        var = torch.diag(rbf(hyp, Xq, Xq)) - torch.sum(v * v, dim=0)
        return mu, torch.clamp_min(var, 1e-10)

    outs = [expert(p) for p in range(P)]
    mus = torch.stack([o[0] for o in outs])
    vars_ = torch.stack([o[1] for o in outs])
    sel = torch.nn.functional.one_hot(z_query, P).T.to(X.dtype)  # (P, Q)
    return torch.sum(mus * sel, dim=0), torch.sum(vars_ * sel, dim=0)
