"""Distributed linear & logistic regression, paper §3.1 (port of
``repro.ml.linear``).

* the losses ``lsq_loss`` / ``logistic_loss``;
* ``distributed_gd``       — deprecation shim →
  ``api.fit(GradientDescent(...), transport="allreduce")``;
* ``admm_lasso``           — deprecation shim →
  ``api.fit(ProxStrategy(lasso_prox_builder), transport="admm_consensus",
  g="l1")``; ``ista_lasso`` is its centralized check;
* ``distributed_lbfgs``    — deprecation shim →
  ``api.fit(LBFGS(...), transport="allreduce")`` ([5]: one Allreduce per
  iteration);
* ``private_second_order`` — [6]'s privacy scheme: nodes send only
  W^(k) = X^(k)ᵀX^(k) and V^(k) = X^(k)ᵀY^(k).

The shims keep the reference's signatures and result types, plus
``device=`` (``"cuda"`` by default); new code calls
``repro_torch.api.fit``.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, NamedTuple

import torch

from repro_torch.api.engine import fit
from repro_torch.api.strategy import LBFGS, GradientDescent, ProxStrategy
from repro_torch.core.allreduce import CommLedger, server_allreduce
from repro_torch.device import resolve_device, to_device


def _deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"repro_torch.ml.linear.{old} is a deprecation shim; use {new}",
        DeprecationWarning,
        stacklevel=3,
    )


@contextlib.contextmanager
def _true_f32():
    """f32 matrix products in full f32 (no TF32) inside the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


# ----------------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------------


def lsq_loss(theta: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """0.5‖y − Xθ‖² / N (the paper's linear-regression f)."""
    r = X @ theta - y
    return 0.5 * torch.mean(r * r)


def logistic_loss(theta: torch.Tensor, X: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean logistic loss, labels y ∈ {-1, +1}.  ``logaddexp(0, −m)`` as in
    the JAX package (``softplus`` switches to the identity past a
    threshold, which changes values)."""
    margins = y * (X @ theta)
    return torch.mean(torch.logaddexp(torch.zeros((), dtype=margins.dtype,
                                                  device=margins.device), -margins))


# ----------------------------------------------------------------------------
# Allreduce gradient descent ([47], [5]) — shim over the unified engine
# ----------------------------------------------------------------------------


class GDResult(NamedTuple):
    theta: torch.Tensor
    losses: torch.Tensor
    ledger: CommLedger


def distributed_gd(Xs, ys, *, loss: Callable = lsq_loss, lr: float = 0.1,
                   steps: int = 200, l2: float = 0.0, theta0=None,
                   device="cuda") -> GDResult:
    """Synchronous distributed GD: one Allreduce of the gradient per step."""
    _deprecated(
        "distributed_gd",
        'repro_torch.api.fit(GradientDescent(loss), data, transport="allreduce")',
    )
    res = fit(GradientDescent(loss, lr=lr, l2=l2), (Xs, ys), transport="allreduce",
              steps=steps, theta0=theta0, tag="gd", device=device)
    return GDResult(theta=res.theta, losses=res.trajectory, ledger=res.ledger)


# ----------------------------------------------------------------------------
# Consensus LASSO via ADMM (Douglas-Rachford splitting, §3.1)
# ----------------------------------------------------------------------------


def lasso_prox_builder(data):
    """Closed-form ridge subproblem prox for consensus LASSO, the per-node
    factors XᵀX and Xᵀy computed once::

        api.fit(api.ProxStrategy(lasso_prox_builder), (Xs, ys),
                transport="admm_consensus", steps=50, g="l1", g_lam=0.1)
    """
    Xs, ys = data
    n = Xs.shape[-1]
    XtX = torch.einsum("kni,knj->kij", Xs, Xs)  # (K, n, n)
    Xty = torch.einsum("kni,kn->ki", Xs, ys)  # (K, n)
    eye = torch.eye(n, dtype=Xs.dtype, device=Xs.device)[None]

    def local_prox(v, u, rho_):
        return torch.linalg.solve(XtX + rho_ * eye, Xty + rho_ * v)

    return local_prox


def admm_lasso(Xs, ys, *, lam: float = 0.1, rho: float = 1.0, iters: int = 200,
               device="cuda"):
    """Distributed LASSO: min Σ_k 0.5‖y_k − X_k θ‖² + λ‖θ‖₁; returns the
    ``core.admm.ADMMResult``."""
    _deprecated(
        "admm_lasso",
        'repro_torch.api.fit(ProxStrategy(...), data, transport="admm_consensus", '
        'g="l1")',
    )
    res = fit(ProxStrategy(lasso_prox_builder), (Xs, ys), transport="admm_consensus",
              steps=iters, rho=rho, g="l1", g_lam=lam, tag="lasso", device=device)
    return res.metrics["admm"]


def centralized_lasso_objective(theta, X, y, lam):
    """0.5‖Xθ − y‖² + λ‖θ‖₁ on the pooled data."""
    return 0.5 * torch.sum((X @ theta - y) ** 2) + lam * torch.sum(torch.abs(theta))


def ista_lasso(X, y, lam, iters: int = 2000, *, device="cuda"):
    """Centralized ISTA reference for validating the distributed solution."""
    X, y = to_device((X, y), resolve_device(device))
    L = torch.linalg.matrix_norm(X, 2) ** 2
    theta = torch.zeros(X.shape[1], dtype=X.dtype, device=X.device)
    for _ in range(iters):
        g = X.T @ (X @ theta - y)
        v = theta - g / L
        theta = torch.sign(v) * torch.clamp_min(torch.abs(v) - lam / L, 0.0)
    return theta


# ----------------------------------------------------------------------------
# Distributed L-BFGS ([5]: one Allreduce per iteration) — shim
# ----------------------------------------------------------------------------


class LBFGSResult(NamedTuple):
    theta: torch.Tensor
    losses: torch.Tensor
    ledger: CommLedger


def distributed_lbfgs(Xs, ys, *, loss: Callable = logistic_loss, history: int = 8,
                      steps: int = 60, lr: float = 1.0, l2: float = 1e-4,
                      device="cuda") -> LBFGSResult:
    """L-BFGS where only the GRADIENT crosses the network ([5])."""
    _deprecated(
        "distributed_lbfgs",
        'repro_torch.api.fit(LBFGS(loss), data, transport="allreduce")',
    )
    res = fit(LBFGS(loss, history=history, lr=lr, l2=l2), (Xs, ys),
              transport="allreduce", steps=steps, tag="lbfgs", device=device)
    return LBFGSResult(theta=res.theta, losses=res.trajectory, ledger=res.ledger)


# ----------------------------------------------------------------------------
# Privacy-preserving regression via second-order statistics ([6])
# ----------------------------------------------------------------------------


def private_second_order(Xs, ys, l2: float = 0.0, *, device="cuda"):
    """θ = (Σ_k X_kᵀX_k + l2·I)⁻¹ Σ_k X_kᵀy_k — only the (n×n)+(n,)
    statistics are transmitted; raw data points never leave a node.

    Returns ``(theta, ledger)``; the ledger shows the wire cost is
    K·(n² + n) numbers, independent of the dataset size N.  The products
    run in full f32 (no TF32), as the reference's do.
    """
    Xs, ys = to_device((Xs, ys), resolve_device(device))
    n = Xs.shape[-1]
    with _true_f32():
        Wk = torch.einsum("kni,knj->kij", Xs, Xs)  # computed at nodes
        Vk = torch.einsum("kni,kn->ki", Xs, ys)
        W = server_allreduce(Wk, op="sum") + l2 * torch.eye(n, dtype=Xs.dtype,
                                                            device=Xs.device)
        V = server_allreduce(Vk, op="sum")
        theta = torch.linalg.solve(W, V)
    ledger = CommLedger()
    ledger.record_push((Wk, Vk), tag="second-order-stats")
    ledger.record_pull(theta, tag="theta")
    return theta, ledger
