"""Distributed parameter estimation in probabilistic graphical models,
paper §3.4 (port of ``repro.ml.graphical``).

The Gaussian MRF (precision matrix Θ) by the Maximum Pseudo-Likelihood
Estimator: the conditional of x_i given the rest is
N(−Σ_{j≠i} (θ_ij/θ_ii) x_j, 1/θ_ii), so the negative pseudo-log-likelihood
is smooth and convex in Θ for θ_ii > 0, and [38]'s consensus formulation
runs on the consensus-ADMM engine of ``repro_torch.core.admm``: node k
holds a sample shard, the consensus variable is the shared Θ.
"""

from __future__ import annotations

import torch
from torch.func import grad, vmap

from repro_torch.core.admm import consensus_admm, gradient_local_prox
from repro_torch.device import resolve_device, to_device


def _sym(theta_flat: torch.Tensor, d: int) -> torch.Tensor:
    """Vector (d·(d+1)/2) of upper-triangle entries → symmetric (d, d).

    A gather rather than an indexed write, so it runs under ``vmap`` and
    ``grad``; the lower triangle is filled from the upper one as the
    reference's ``Th + triu(Th, 1).T``."""
    r, c = torch.triu_indices(d, d, device=theta_flat.device)
    pos = torch.zeros((d, d), dtype=torch.long, device=theta_flat.device)
    pos[r, c] = torch.arange(r.numel(), device=theta_flat.device)
    upper = torch.ones((d, d), dtype=torch.bool, device=theta_flat.device).triu()
    Th = torch.where(upper, theta_flat[pos], 0.0)
    return Th + torch.triu(Th, 1).T


def flatten_sym(Theta: torch.Tensor) -> torch.Tensor:
    d = Theta.shape[0]
    r, c = torch.triu_indices(d, d, device=Theta.device)
    return Theta[r, c]


def neg_pseudo_loglik(theta_flat: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """−(1/N) Σ_n Σ_i log p(x_ni | x_n,−i; Θ) for a Gaussian MRF:

    log p(x_i|x_−i) = ½ log θ_ii − (Θx)_i² / (2 θ_ii) − ½ log 2π,

    with a softplus barrier (``logaddexp(x, 0)``, the reference's
    ``jax.nn.softplus``) keeping θ_ii > 0 along the path."""
    N, d = X.shape
    Th = _sym(theta_flat, d)
    diag = torch.diagonal(Th)
    diag_safe = torch.clamp_min(diag, 1e-4)
    r = X @ Th  # (N, d): row n, col i = (Θ x_n)_i
    ll = 0.5 * torch.log(diag_safe)[None, :] - r ** 2 / (2.0 * diag_safe)[None, :]
    barrier = torch.sum(torch.logaddexp(-(diag - 1e-3) * 100.0, torch.zeros_like(diag))) * 1e-2
    return -torch.mean(torch.sum(ll, dim=1)) + barrier


def mple_centralized(X, *, iters: int = 500, lr: float = 0.05, device="cuda"):
    """Adagrad descent on the pseudo-likelihood (reference solver)."""
    X = to_device(X, resolve_device(device))
    d = X.shape[1]
    theta = flatten_sym(torch.eye(d, dtype=X.dtype, device=X.device))
    g_fn = grad(neg_pseudo_loglik)
    acc = torch.zeros_like(theta)
    for _ in range(iters):
        g = g_fn(theta, X)
        acc = acc + g * g
        theta = theta - lr * g / (torch.sqrt(acc) + 1e-8)
    return _sym(theta, d)


def mple_consensus(Xs, *, rho: float = 1.0, iters: int = 60, inner_iters: int = 40,
                   inner_lr: float = 0.05, device="cuda"):
    """[38]: distributed MPLE as a consensus problem solved with ADMM.

    Each node runs the prox of its local pseudo-likelihood (inner gradient
    loop); the z-update is the Allreduce average.  Returns (Θ, result)."""
    Xs = to_device(Xs, resolve_device(device))
    K, Nk, d = Xs.shape
    dim = d * (d + 1) // 2
    node_grads = vmap(grad(neg_pseudo_loglik))

    def grad_f(theta_rows):
        return node_grads(theta_rows, Xs)

    local_prox = gradient_local_prox(grad_f, inner_iters=inner_iters, lr=inner_lr)
    theta0 = flatten_sym(torch.eye(d, dtype=Xs.dtype, device=Xs.device))[None].repeat(K, 1)
    res = consensus_admm(local_prox, K, dim, rho=rho, g="none", iters=iters, theta0=theta0)
    return _sym(res.z, d), res


def sample_gmrf(gen: torch.Generator, Theta: torch.Tensor, n: int) -> torch.Tensor:
    """Exact samples from N(0, Θ⁻¹), drawn from ``gen`` on its device."""
    Theta = Theta.to(gen.device)
    d = Theta.shape[0]
    cov = torch.linalg.inv(Theta)
    L = torch.linalg.cholesky(cov + 1e-9 * torch.eye(d, dtype=Theta.dtype, device=gen.device))
    z = torch.randn((n, d), generator=gen, dtype=Theta.dtype, device=gen.device)
    return z @ L.T


def support_f1(Theta_hat: torch.Tensor, Theta_true: torch.Tensor, thresh=0.1):
    """Edge-recovery F1 between estimated and true off-diagonal supports."""
    d = Theta_true.shape[0]
    mask = ~torch.eye(d, dtype=torch.bool, device=Theta_true.device)
    pred = (torch.abs(Theta_hat) > thresh) & mask
    true = (torch.abs(Theta_true) > 1e-9) & mask
    tp = torch.sum(pred & true)
    prec = tp / torch.clamp_min(torch.sum(pred), 1)
    rec = tp / torch.clamp_min(torch.sum(true), 1)
    return 2 * prec * rec / torch.clamp_min(prec + rec, 1e-9)
