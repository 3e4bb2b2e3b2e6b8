"""Distributed Support Vector Machines, paper §3.2 (port of
``repro.ml.svm``).

* ``dual_svm``        — kernel SVM dual by projected gradient ascent (the
                        box-constrained QP max_{α∈[0,C]^N} 1ᵀα − ½αᵀQα);
* ``cascade_svm``     — [25]: nodes train locally and push only their
                        Support Vectors; the server retrains on the union
                        and feeds it back (``CascadeStrategy`` on ``fit``);
* ``consensus_svm``   — [22]: the primal hinge-loss consensus problem on
                        the ADMM engine (smoothed-hinge local prox by inner
                        gradient descent);
* ``weighted_dual_consensus`` — the paper's own §3.2 proposal: an
                        ℓ1-penalized local dual per node, weighted by local
                        example counts.

The reference's ``lax.scan`` loops are Python loops, its ``vmap`` over
nodes a loop over node rows.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.func import grad, vmap

from repro_torch.api import executor as _exec
from repro_torch.api.engine import fit
from repro_torch.api.strategy import ProxStrategy, Strategy
from repro_torch.core.admm import gradient_local_prox
from repro_torch.core.allreduce import CommLedger
from repro_torch.device import resolve_device, to_device

# ----------------------------------------------------------------------------
# Kernels
# ----------------------------------------------------------------------------


def linear_kernel(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B.T


def rbf_kernel(A: torch.Tensor, B: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    d2 = (
        torch.sum(A * A, dim=1)[:, None]
        - 2.0 * A @ B.T
        + torch.sum(B * B, dim=1)[None, :]
    )
    return torch.exp(-gamma * torch.clamp_min(d2, 0.0))


# ----------------------------------------------------------------------------
# Dual SVM (single node / server-side solver)
# ----------------------------------------------------------------------------


class SVMModel(NamedTuple):
    alpha: torch.Tensor  # (N,) dual variables
    X: torch.Tensor  # training points (needed for kernel decisions)
    y: torch.Tensor  # labels in {-1, +1}
    sv_mask: torch.Tensor  # alpha > tol


def dual_svm(X, y, *, C: float = 1.0, kernel=linear_kernel, iters: int = 500,
             mask=None, sv_tol: float = 1e-5, device="cuda") -> SVMModel:
    """Projected gradient ascent on the SVM dual.

    max_α 1ᵀα − ½ αᵀ Q α,  Q = (y yᵀ) ∘ K,  0 ≤ α ≤ C.

    ``mask`` marks valid rows (1) vs padding (0), so cascades train on a
    fixed-shape pool.
    """
    X, y, mask = to_device((X, y, mask), resolve_device(device))
    N = X.shape[0]
    m = torch.ones((N,), dtype=X.dtype, device=X.device) if mask is None else mask
    Kx = kernel(X, X) * m[:, None] * m[None, :]
    Q = (y[:, None] * y[None, :]) * Kx
    del Kx
    # Lipschitz constant of the gradient by 20 steps of power iteration
    v = torch.ones((N,), dtype=X.dtype, device=X.device) / np.sqrt(N)
    for _ in range(20):
        w = Q @ v
        v = w / torch.clamp_min(torch.linalg.norm(w), 1e-12)
    L = torch.clamp_min(torch.abs(v @ (Q @ v)), 1e-6)
    alpha = torch.zeros((N,), dtype=X.dtype, device=X.device)
    for _ in range(iters):
        g = 1.0 - Q @ alpha
        alpha = torch.clamp(alpha + g / L, 0.0, C) * m
    return SVMModel(alpha=alpha, X=X, y=y, sv_mask=(alpha > sv_tol) & (m > 0))


def decision_function(model: SVMModel, Xq: torch.Tensor, kernel=linear_kernel):
    """f(x) = Σ_{i: SV} α_i y_i k(x, x_i) — only SVs contribute."""
    coeff = model.alpha * model.y * model.sv_mask
    return kernel(Xq, model.X) @ coeff


# ----------------------------------------------------------------------------
# Cascade SVM ([25])
# ----------------------------------------------------------------------------


class CascadeResult(NamedTuple):
    model: SVMModel
    rounds: int
    ledger: CommLedger
    sv_counts: list


class CascadeStrategy(Strategy):
    """[25]'s cascade as a Strategy on the unified engine.

    θ is the global-SV boolean mask over the pooled dataset; each round's
    message is the per-node SV mask (node k trains on its shard ∪ the
    current global SVs), aggregation is the set union
    (``aggregate_op="any"``) and the apply step is the server's retrain on
    the union.  Every node's training set overlaps the shared SV pool, so
    the strategy reads the whole dataset (``replicate_data``) and finds
    its nodes from ``node_shard_index``.  The byte hooks charge only the
    SV points pushed and broadcast — semantic compression a wire codec
    cannot know about::

        res = api.fit(CascadeStrategy(C=1.0), (Xs, ys), transport="allreduce",
                      steps=5, device="cuda")
        res.theta            # the final SVMModel
    """

    aggregate_op = "any"
    replicate_data = True

    def __init__(self, *, C: float = 1.0, kernel=linear_kernel, iters: int = 500):
        self.C = C
        self.kernel = kernel
        self.iters = iters

    def _pooled(self, data):
        Xs, ys = data
        Knodes, Nk, n = Xs.shape
        return Xs.reshape(Knodes * Nk, n), ys.reshape(Knodes * Nk)

    def init_theta(self, data):
        Xs, _ = data
        return torch.zeros((Xs.shape[0] * Xs.shape[1],), dtype=torch.bool, device=Xs.device)

    def init_state(self, theta, data):
        X, _ = self._pooled(data)
        return (torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device), theta)

    def _train(self, data, mask):
        X, y = self._pooled(data)
        return dual_svm(X, y, C=self.C, kernel=self.kernel, iters=self.iters, mask=mask,
                        device=X.device)

    def local_updates(self, theta, state, data, batch):
        Xs, _ = data
        Knodes, Nk, _ = Xs.shape
        node_of = torch.arange(Knodes, device=Xs.device).repeat_interleave(Nk)
        # each shard trains its own contiguous node slice (all K locally)
        K_local = Knodes // _exec.num_node_shards()
        k0 = _exec.node_shard_index() * K_local
        masks = [
            self._train(data, ((node_of == k) | theta).to(Xs.dtype)).sv_mask
            for k in range(k0, k0 + K_local)
        ]
        return torch.stack(masks), state

    def apply_update(self, theta, pushed, state, data):
        model = self._train(data, pushed.to(data[0].dtype))
        return model.sv_mask, (model.alpha, pushed)

    def round_metric(self, theta, state, data):
        return theta  # trajectory = the global SV mask per round

    def _point_bytes(self, data, count):
        Xs, _ = data
        n = Xs.shape[-1]
        return count.to(torch.float32) * (n + 1) * 4.0  # f32 point + label

    def uplink_bytes(self, msgs_hat, data):
        # one union push per round: only the SV identities move
        union = _exec.aggregate(msgs_hat, op="any")
        return self._point_bytes(data, torch.sum(union))

    def downlink_bytes(self, theta, data):
        # broadcast of the new global SV set
        return self._point_bytes(data, torch.sum(theta))

    def finalize(self, theta, state, data):
        X, y = self._pooled(data)
        alpha, _ = state
        return SVMModel(alpha=alpha, X=X, y=y, sv_mask=theta)

    def predict(self, theta, X):
        """Decision values f(x) for query points (``theta`` is the
        finalized ``SVMModel``); sign(f) is the class label."""
        return decision_function(theta, X, kernel=self.kernel)


def cascade_svm(Xs, ys, *, C: float = 1.0, kernel=linear_kernel, max_rounds: int = 5,
                iters: int = 500, device="cuda") -> CascadeResult:
    """Cascade SVM: only Support Vectors cross the network ([25]).

    Deprecation shim → ``api.fit(CascadeStrategy(...), transport="allreduce")``.
    The engine runs ``max_rounds`` rounds (a stable SV set is a fixed
    point); the rounds, SV counts and ledger reported here stop at the
    first round whose SV set equals the previous one.
    """
    warnings.warn(
        "repro_torch.ml.svm.cascade_svm is a deprecation shim; use "
        'repro_torch.api.fit(CascadeStrategy(...), data, transport="allreduce")',
        DeprecationWarning,
        stacklevel=2,
    )
    N = Xs.shape[0] * Xs.shape[1]
    res = fit(CascadeStrategy(C=C, kernel=kernel, iters=iters), (Xs, ys),
              transport="allreduce", steps=max_rounds, tag="cascade", device=device)
    masks = res.trajectory.cpu().numpy()  # (max_rounds, N) bool

    prev = np.zeros((N,), dtype=bool)
    rounds = max_rounds
    for r in range(max_rounds):
        if bool((masks[r] == prev).all()):
            rounds = r + 1
            break
        prev = masks[r]

    sv_counts = [int(masks[r].sum()) for r in range(rounds)]
    ledger = CommLedger()
    for r in range(rounds):
        up = int(res.metrics["uplink_bytes_per_round"][r])
        down = int(res.metrics["downlink_bytes_per_round"][r])
        ledger.uplink_bytes += up
        ledger.downlink_bytes += down
        ledger.events.append(("push", f"svs-r{r}", up))
        ledger.events.append(("pull", f"global-svs-r{r}", down))
    return CascadeResult(model=res.theta, rounds=rounds, ledger=ledger, sv_counts=sv_counts)


# ----------------------------------------------------------------------------
# Consensus SVM via ADMM ([22])
# ----------------------------------------------------------------------------


def smooth_hinge(m: torch.Tensor, eps: float = 0.1) -> torch.Tensor:
    """Huberized hinge — smooth surrogate so the local prox can use gradients."""
    return torch.where(
        m >= 1.0,
        0.0,
        torch.where(m <= 1.0 - eps, 1.0 - m - eps / 2.0, (1.0 - m) ** 2 / (2 * eps)),
    )


def _consensus_svm_prox_builder(inner_iters: int, inner_lr: float):
    """Smoothed-hinge local prox by inner gradient descent — the paper's
    "several proximity functions carried in parallel at each node"."""

    def build(data):
        Xs, ys = data
        Nk = Xs.shape[1]

        def node_loss(theta, X, y):
            return torch.sum(smooth_hinge(y * (X @ theta)))

        node_grads = vmap(grad(node_loss))

        def node_grad(theta_rows):
            return node_grads(theta_rows, Xs, ys)

        return gradient_local_prox(node_grad, inner_iters=inner_iters, lr=inner_lr / Nk)

    return build


def consensus_svm(Xs, ys, *, lam: float = 1e-2, rho: float = 1.0, iters: int = 100,
                  inner_iters: int = 50, inner_lr: float = 0.5, device="cuda"):
    """Primal consensus SVM: min Σ_k Σ_i hinge(y_i θᵀx_i) + (λ/2)‖z‖².

    Deprecation shim → ``api.fit(ProxStrategy(...),
    transport="admm_consensus", g="l2sq")``; returns the ``ADMMResult``.
    """
    warnings.warn(
        "repro_torch.ml.svm.consensus_svm is a deprecation shim; use "
        'repro_torch.api.fit(ProxStrategy(...), data, transport="admm_consensus")',
        DeprecationWarning,
        stacklevel=2,
    )
    res = fit(ProxStrategy(_consensus_svm_prox_builder(inner_iters, inner_lr)),
              (Xs, ys), transport="admm_consensus", steps=iters, rho=rho, g="l2sq",
              g_lam=lam, tag="consensus-svm", device=device)
    return res.metrics["admm"]


# ----------------------------------------------------------------------------
# The paper's own proposal: weighted dual consensus
# ----------------------------------------------------------------------------


def weighted_dual_consensus(Xs, ys, *, C: float = 1.0, kernel=linear_kernel,
                            iters: int = 300, sparsity_lam: float = 0.05,
                            node_weights=None, device="cuda"):
    """§3.2's sketched idea, made concrete: node k maximizes

        1ᵀα − ½αᵀQ_kα − (λ/w_k)‖α‖₁   s.t. 0 ≤ α ≤ C

    (an ℓ1-penalized dual; the ℓ1 prox is a shift since α ≥ 0) with
    per-node weights ∝ local example counts, and the global decision
    function sums the per-node SV expansions.  Returns the (K, Nk) α's and
    the joint decision function.
    """
    Xs, ys, node_weights = to_device((Xs, ys, node_weights), resolve_device(device))
    Knodes, Nk, _ = Xs.shape
    if node_weights is None:
        node_weights = torch.full((Knodes,), float(Nk), dtype=Xs.dtype, device=Xs.device)
    w = node_weights / torch.sum(node_weights)

    def solve_node(X, y, wk):
        Q = (y[:, None] * y[None, :]) * kernel(X, X)
        L = torch.clamp_min(torch.linalg.matrix_norm(Q, ord=float("inf")), 1e-6)
        shift = sparsity_lam / torch.clamp_min(wk * Knodes, 1e-6)
        alpha = torch.zeros((X.shape[0],), dtype=X.dtype, device=X.device)
        for _ in range(iters):
            g = 1.0 - Q @ alpha - shift  # ℓ1 prox on α ≥ 0 is a shift
            alpha = torch.clamp(alpha + g / L, 0.0, C)
        return alpha

    alphas = torch.stack([solve_node(Xs[k], ys[k], w[k]) for k in range(Knodes)])

    def decide(Xq):
        coeff = alphas * w[:, None] * Knodes
        return torch.sum(torch.stack([
            kernel(Xq, Xs[k]) @ (coeff[k] * ys[k]) for k in range(Knodes)
        ]), dim=0)

    return alphas, decide
