"""Linear and logistic regression losses (port of the loss half of
``repro.ml.linear``; the deprecated ``distributed_*`` shims and the ADMM
LASSO builders are not ported yet — see ``ROADMAP.md``)."""

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
