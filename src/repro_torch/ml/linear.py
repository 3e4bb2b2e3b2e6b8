"""Linear and logistic regression (port of the losses and the consensus
LASSO pieces of ``repro.ml.linear``; the deprecated ``distributed_*`` /
``admm_lasso`` shims, ``ista_lasso`` and ``private_second_order`` are not
ported yet — see ``ROADMAP.md``)."""

from __future__ import annotations

import torch


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


def centralized_lasso_objective(theta, X, y, lam):
    """0.5‖Xθ − y‖² + λ‖θ‖₁ on the pooled data."""
    return 0.5 * torch.sum((X @ theta - y) ** 2) + lam * torch.sum(torch.abs(theta))
