"""Global-variable-consensus ADMM (Douglas-Rachford splitting), paper
§3.1/§3.2 (port of ``repro.core.admm``).

    minimize  Σ_k f_k(θ^(k)) + g(z)    s.t.  θ^(k) = z  for all k

Scaled-dual form, one iteration:

    θ^(k) ← argmin_θ  f_k(θ) + (ρ/2)‖θ − z + u^(k)‖²      (parallel at nodes)
    z     ← prox_{g/(Kρ)}( mean_k(θ^(k) + u^(k)) )         (Allreduce #1)
    u^(k) ← u^(k) + θ^(k) − z                              (local)

The z-update's mean is the first Allreduce, the residual norms the second.
The reference's ``lax.scan`` over iterations is a Python loop here.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.device import resolve_device

# ----------------------------------------------------------------------------
# Proximal operators for the global regularizer g
# ----------------------------------------------------------------------------


def prox_l1(v: torch.Tensor, lam: float) -> torch.Tensor:
    """Soft threshold — g(z) = lam * ||z||_1 (LASSO)."""
    return torch.sign(v) * torch.clamp_min(torch.abs(v) - lam, 0.0)


def prox_l2sq(v: torch.Tensor, lam: float) -> torch.Tensor:
    """g(z) = (lam/2) * ||z||_2^2 (ridge)."""
    return v / (1.0 + lam)


def prox_none(v: torch.Tensor, lam: float) -> torch.Tensor:
    return v


PROX = {"l1": prox_l1, "l2sq": prox_l2sq, "none": prox_none}


class ADMMState(NamedTuple):
    theta: torch.Tensor  # (K, n) per-node primal variables
    z: torch.Tensor  # (n,) global consensus variable
    u: torch.Tensor  # (K, n) scaled duals
    primal_res: torch.Tensor  # scalar ‖θ − z‖
    dual_res: torch.Tensor  # scalar ρ‖z − z_prev‖
    it: torch.Tensor


class ADMMResult(NamedTuple):
    z: torch.Tensor
    state: ADMMState
    history: torch.Tensor  # (iters, 2) primal/dual residuals


def consensus_admm(
    local_prox: Callable[[torch.Tensor, torch.Tensor, float], torch.Tensor],
    num_nodes: int,
    dim: int,
    *,
    rho: float = 1.0,
    g: str = "none",
    g_lam: float = 0.0,
    iters: int = 100,
    theta0: torch.Tensor | None = None,
    device="cuda",
) -> ADMMResult:
    """Run consensus ADMM.

    Args:
      local_prox: ``(v, u, rho) -> argmin_θ f_k(θ) + (rho/2)||θ - v||²`` for
        all nodes at once: it receives the ``(K, n)`` matrix ``v`` and
        returns the ``(K, n)`` matrix of per-node minimizers.
      num_nodes: K.
      dim: n.
      g: global regularizer — "l1", "l2sq" or "none".
      g_lam: its weight λ.
      iters: fixed iteration count (residuals recorded every iteration).
      theta0: initial (K, n) primal variables; the state lives on its
        device.  Zeros on ``device`` when it is None.
      device: where the zero state is made when ``theta0`` is None —
        ``"cuda"`` by default, which raises without a GPU; pass ``"cpu"``
        for the plain path.
    """
    prox_g = PROX[g]
    K = num_nodes
    if theta0 is None:
        theta0 = torch.zeros((K, dim), device=resolve_device(device))
    theta = theta0
    device = theta.device
    z = torch.zeros((dim,), device=device)
    u = torch.zeros((K, dim), device=device)
    inf = torch.tensor(float("inf"), device=device)
    state = ADMMState(theta, z, u, inf, inf, torch.tensor(0, device=device))
    hist = []
    for _ in range(iters):
        # -- stage 1: parallel local prox at every node
        v = state.z[None, :] - state.u  # (K, n)
        theta = local_prox(v, state.u, rho)
        # -- stage 2: Allreduce #1 — averaged consensus + global prox
        avg = torch.mean(theta + state.u, dim=0)
        z_new = prox_g(avg, g_lam / (K * rho))
        # -- stage 3: dual ascent
        u = state.u + theta - z_new[None, :]
        # -- Allreduce #2 — residual norms for the stopping diagnostic
        primal = torch.linalg.norm(theta - z_new[None, :])
        dual = rho * math.sqrt(K) * torch.linalg.norm(z_new - state.z)
        state = ADMMState(theta, z_new, u, primal, dual, state.it + 1)
        hist.append(torch.stack([primal, dual]))
    history = torch.stack(hist) if hist else torch.zeros((0, 2), device=device)
    return ADMMResult(z=state.z, state=state, history=history)


def gradient_local_prox(
    grad_f: Callable[[torch.Tensor], torch.Tensor],
    *,
    inner_iters: int = 25,
    lr: float = 0.1,
) -> Callable:
    """Build a ``local_prox`` from per-node loss gradients.

    ``grad_f(theta)``: (K, n) -> (K, n), the gradient of each node's local
    objective f_k at its own θ row (``torch.func.vmap(torch.func.grad(f))``
    where the reference writes ``jax.vmap(jax.grad(f))``).  The prox
    subproblem ``argmin f_k(θ) + (ρ/2)||θ − v||²`` is solved with
    ``inner_iters`` steps of gradient descent.
    """

    def local_prox(v: torch.Tensor, u: torch.Tensor, rho: float) -> torch.Tensor:
        theta = v
        for _ in range(inner_iters):
            g = grad_f(theta) + rho * (theta - v)
            theta = theta - lr * g
        return theta

    return local_prox
