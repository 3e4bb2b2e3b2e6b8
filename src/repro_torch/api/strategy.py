"""Strategy layer — the per-node learner F^(k) (port of
``repro.api.strategy``).

The paper's §5 observation is that ANY local learning method F^(k) can sit
behind the client-server protocol; a ``Strategy`` is that method, written
once and runnable under every transport:

* server family (``local_step``)       — F^(k): θ → θ', for
  ``sequential_server`` / ``stale_server``;
* update family (``local_updates`` / ``aggregate`` / ``apply_update``) —
  per-node messages + one aggregation + a global apply, for ``allreduce``
  / ``delay_line``.

* consensus family (``make_local_prox`` / ``dim``) — the per-node prox
  of consensus ADMM, for ``admm_consensus``.

Ported: ``Strategy``, ``FunctionStrategy``, ``GradientDescent``,
``LBFGS``, ``ProxStrategy`` and ``OptimizerStrategy``; the cascade SVM and
k-windows strategies live next to their algorithms in ``ml/``.  The
per-node gradient is ``torch.func.vmap`` over ``torch.func.grad`` (the
reference's ``jax.vmap(jax.grad(loss))``); ``OptimizerStrategy``, one
logical node, takes its gradient with ``torch.autograd.grad`` instead,
because ``torch.func`` transforms refuse the saved-tensor hooks of the
non-reentrant checkpointing that ``remat_policy`` turns on.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad, vmap

from repro_torch.api import executor as _exec
from repro_torch.core.allreduce import server_allreduce
from repro_torch.optim.optimizers import apply_updates
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_unflatten

PyTree = Any


class _NodeMap:
    """``fn(θ, X_k, y_k)`` for every node k, stacked: one ``vmap`` over the
    K nodes.  Where a sweep batches θ over its scenarios, the nodes are
    mapped OUTSIDE the scenarios instead: θ's (S, …) values are read out of
    the sweep's batch, ``vmap`` over the nodes of ``vmap`` over the
    scenarios runs on them, and the (S, K, …) result goes back into the
    batch.  A node's matrix-vector products then become one matrix product
    with the S scenarios as its columns, reading X once; mapped inside the
    scenarios, they would be batched products whose batching rule copies
    X once per scenario."""

    def __init__(self, fn: Callable):
        self._local = vmap(fn, in_dims=(None, 0, 0))
        self._swept = vmap(vmap(fn, in_dims=(0, None, None)), in_dims=(None, 0, 0))

    def __call__(self, theta, Xs, ys):
        thetas, level = _exec.scenario_split(theta)
        if level is None:
            return self._local(theta, Xs, ys)
        return _exec.scenario_join(self._swept(thetas, Xs, ys).movedim(1, 0), level)


class Strategy:
    """Base strategy.  Subclasses override the families they support."""

    #: messages from ``local_updates`` carry a leading node axis
    stacked_msgs: bool = True
    #: communication rounds charged before the loop (e.g. an initial
    #: gradient Allreduce): the engine adds them to the ledger
    init_rounds: int = 0
    #: reduction the base ``aggregate`` applies over the node axis ("sum" /
    #: "mean" / "max" / "any", the set union of boolean masks)
    aggregate_op: str = "sum"
    #: True when every node's computation reads the whole dataset (the
    #: cascade SVM's shared SV pool): a mesh executor replicates the data,
    #: and the strategy finds its nodes from ``node_shard_index``
    replicate_data: bool = False
    #: False when the update step cannot run under ``torch.func.vmap``: a
    #: sweep then runs the scenarios in turn inside each round
    vmappable: bool = True

    def init_theta(self, data) -> PyTree:
        raise NotImplementedError(
            f"{type(self).__name__} cannot derive θ_0 from data; pass theta0="
        )

    def init_state(self, theta: PyTree, data):
        return ()

    def num_nodes(self, data) -> int:
        if data is None:
            raise ValueError(
                f"{type(self).__name__}.num_nodes needs data with a leading "
                "node axis (or override num_nodes)"
            )
        return tree_leaves(data)[0].shape[0]

    # -- server family -------------------------------------------------------
    def local_step(self, k: int, theta: PyTree, state, data):
        """F^(k): one local run on node ``k``'s shard.  Returns (θ', state)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support server transports"
        )

    # -- update family -------------------------------------------------------
    def local_updates(self, theta: PyTree, state, data, batch):
        """All nodes' messages for this round (stacked on axis 0).
        Returns (msgs, state)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support update transports"
        )

    def aggregate(self, msgs: PyTree) -> PyTree:
        return _exec.aggregate(msgs, op=self.aggregate_op)

    def apply_update(self, theta: PyTree, agg: PyTree, state, data):
        """Apply the aggregated message.  Returns (θ', state)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support update transports"
        )

    # -- consensus family ----------------------------------------------------
    def make_local_prox(self, data) -> Callable:
        raise NotImplementedError(
            f"{type(self).__name__} does not support the admm_consensus "
            "transport (implement make_local_prox)"
        )

    def dim(self, data) -> int:
        """Consensus-variable dimension for admm_consensus."""
        raise NotImplementedError

    # -- diagnostics ---------------------------------------------------------
    def round_metric(self, theta: PyTree, state, data):
        """Per-round scalar stacked into the trajectory by update
        transports."""
        return torch.zeros(())

    def summary(self, theta: PyTree, data) -> dict:
        """Final metrics dict merged into ``FitResult.metrics``."""
        return {}

    def finalize(self, theta: PyTree, state, data) -> PyTree:
        return theta

    def predict(self, theta: PyTree, X: PyTree) -> PyTree:
        raise NotImplementedError(
            f"{type(self).__name__} does not implement predict()"
        )

    # -- wire-cost hooks -----------------------------------------------------
    def uplink_bytes(self, msgs_hat: PyTree, data):
        """Override to report a round's semantic (data-dependent) push cost;
        None → the wire's measurement."""
        return None

    def downlink_bytes(self, theta: PyTree, data):
        """Override a round's broadcast cost; None → K dense copies of θ."""
        return None


class FunctionStrategy(Strategy):
    """Wrap a bare update function ``F(k, θ) -> θ'`` (the paper's notation)
    as a server-family strategy::

        strategy = api.FunctionStrategy(F, num_nodes=K)
        res = api.fit(strategy, transport="sequential_server",
                      schedule=schedules.round_robin(K, 50), theta0=theta0,
                      device="cuda")
    """

    def __init__(self, F: Callable, *, num_nodes: int, metric: Callable | None = None):
        self._F = F
        self._num_nodes = num_nodes
        self._metric = metric

    def num_nodes(self, data) -> int:
        return self._num_nodes

    def local_step(self, k, theta, state, data):
        return self._F(k, theta), state

    def round_metric(self, theta, state, data):
        if self._metric is None:
            return torch.zeros(())
        return self._metric(theta)

    def summary(self, theta, data) -> dict:
        if self._metric is None:
            return {}
        return {"final_metric": self._metric(theta)}


class GradientDescent(Strategy):
    """Full-batch distributed GD on sharded ``data = (Xs, ys)``, Xs (K, N, d).

    Under ``allreduce`` each node pushes its weighted local gradient and
    receives the global sum; under the server transports each contact is
    one local gradient step::

        res = api.fit(api.GradientDescent(lsq_loss, lr=0.1), (Xs, ys),
                      transport="allreduce", steps=100, device="cuda")
        res.metrics["loss"]            # final mean loss over all nodes
    """

    def __init__(self, loss: Callable, *, lr: float = 0.1, l2: float = 0.0):
        self.loss = loss
        self.lr = lr
        self.l2 = l2
        self._grad_local = _NodeMap(grad(loss))
        self._loss_local = _NodeMap(loss)

    def init_theta(self, data):
        Xs, _ = data
        return torch.zeros((Xs.shape[-1],), dtype=torch.float32, device=Xs.device)

    def _weights(self, data):
        Xs, _ = data
        K, Nk = Xs.shape[0], Xs.shape[1]
        K_all = K * _exec.num_node_shards()
        return torch.full((K,), Nk / (K_all * Nk), dtype=torch.float32,
                          device=Xs.device)

    def local_step(self, k, theta, state, data):
        Xs, ys = data
        g = grad(self.loss)(theta, Xs[k], ys[k])
        return theta - self.lr * (g + self.l2 * theta), state

    def local_updates(self, theta, state, data, batch):
        Xs, ys = data
        gs = self._grad_local(theta, Xs, ys)
        return gs * self._weights(data)[:, None], state

    def apply_update(self, theta, agg, state, data):
        g = agg + self.l2 * theta
        return theta - self.lr * g, state

    def round_metric(self, theta, state, data):
        Xs, ys = data
        return _exec.metric_mean(torch.mean(self._loss_local(theta, Xs, ys)))

    def summary(self, theta, data) -> dict:
        return {"loss": self.round_metric(theta, (), data)}

    def predict(self, theta, X):
        """Linear score X @ θ — regression values (lsq) or logits."""
        return X @ theta


class _LBFGSState(NamedTuple):
    g: torch.Tensor
    S: torch.Tensor
    Y: torch.Tensor
    rho: torch.Tensor
    valid: torch.Tensor
    it: torch.Tensor
    theta_prop: torch.Tensor


def _two_loop(g, S, Y, rho, valid):
    """L-BFGS two-loop recursion over the m history rows with a validity
    mask (the reference's two ``lax.scan``s, as loops)."""
    m = S.shape[0]
    q = g
    alphas = [None] * m
    for i in reversed(range(m)):
        v = valid[i] > 0
        alphas[i] = torch.where(v, rho[i] * torch.dot(S[i], q), 0.0)
        q = q - alphas[i] * Y[i] * torch.where(v, 1.0, 0.0)
    num = torch.sum(S * Y, dim=1)
    den = torch.sum(Y * Y, dim=1)
    on = valid > 0
    gamma = torch.where(
        torch.any(on),
        torch.sum(torch.where(on, num, 0.0))
        / torch.clamp_min(torch.sum(torch.where(on, den, 0.0)), 1e-12),
        1.0,
    )
    r_vec = gamma * q
    for i in range(m):
        v = valid[i] > 0
        beta = torch.where(v, rho[i] * torch.dot(Y[i], r_vec), 0.0)
        r_vec = r_vec + (alphas[i] - beta) * S[i] * torch.where(v, 1.0, 0.0)
    return r_vec


class LBFGS(Strategy):
    """[5]'s distributed L-BFGS: ONE gradient Allreduce per iteration; the
    (s, y) history and the two-loop recursion run identically on every
    node.  ``aggregate_op = "mean"``; ``init_rounds = 1`` charges the
    initial global gradient to the ledger::

        res = api.fit(api.LBFGS(lsq_loss), (Xs, ys),
                      transport="allreduce", steps=25, device="cuda")
        res.ledger.rounds    # steps + 1
    """

    init_rounds = 1  # the initial global gradient
    aggregate_op = "mean"

    def __init__(self, loss: Callable, *, history: int = 8, lr: float = 1.0,
                 l2: float = 1e-4):
        self.loss = loss
        self.history = history
        self.lr = lr
        self.l2 = l2
        self._grad_local = _NodeMap(grad(loss))
        self._loss_local = _NodeMap(loss)

    def init_theta(self, data):
        Xs, _ = data
        return torch.zeros((Xs.shape[-1],), dtype=torch.float32, device=Xs.device)

    def init_state(self, theta, data):
        Xs, ys = data
        n, m = theta.shape[0], self.history
        g0 = server_allreduce(self._grad_local(theta, Xs, ys), op="mean") + self.l2 * theta
        zeros = dict(dtype=theta.dtype, device=theta.device)
        return _LBFGSState(
            g=g0,
            S=torch.zeros((m, n), **zeros),
            Y=torch.zeros((m, n), **zeros),
            rho=torch.zeros((m,), **zeros),
            valid=torch.zeros((m,), **zeros),
            it=torch.zeros((), dtype=torch.int32, device=theta.device),
            theta_prop=theta,
        )

    def local_updates(self, theta, state, data, batch):
        Xs, ys = data
        d = -_two_loop(state.g, state.S, state.Y, state.rho, state.valid)
        theta_prop = theta + self.lr * d
        return self._grad_local(theta_prop, Xs, ys), state._replace(theta_prop=theta_prop)

    def apply_update(self, theta, agg, state, data):
        theta_new = state.theta_prop
        g_new = agg + self.l2 * theta_new
        s = theta_new - theta
        yv = g_new - state.g
        sy = torch.dot(s, yv)
        ok = sy > 1e-10  # curvature condition

        def push(buf, row):
            return torch.where(ok, torch.cat([buf[1:], row[None]]), buf)

        new_state = _LBFGSState(
            g=g_new,
            S=push(state.S, s),
            Y=push(state.Y, yv),
            rho=push(state.rho, 1.0 / torch.clamp_min(sy, 1e-12)),
            valid=push(state.valid, torch.ones((), dtype=sy.dtype, device=sy.device)),
            it=state.it + 1,
            theta_prop=state.theta_prop,
        )
        return theta_new, new_state

    def round_metric(self, theta, state, data):
        Xs, ys = data
        return _exec.metric_mean(torch.mean(self._loss_local(theta, Xs, ys)))

    def summary(self, theta, data) -> dict:
        return {"loss": self.round_metric(theta, (), data)}

    def predict(self, theta, X):
        return X @ theta


class ProxStrategy(Strategy):
    """Consensus-family strategy: per-node proximity operators for the
    ``admm_consensus`` transport (the paper's Douglas-Rachford three-stage
    algorithm).  ``make_prox(data)`` builds the local prox
    ``(v, u, rho) -> (K, n)`` over all nodes — closed form or inner
    gradient loop::

        res = api.fit(api.ProxStrategy(lasso_prox_builder), (Xs, ys),
                      transport="admm_consensus", steps=50,
                      g="l1", g_lam=0.1, device="cuda")

    Consensus runs wrap ``core.admm``'s own loop, so they are one-shot
    (no warm start / resume), need a lossless wire, and run on the local
    executor only.
    """

    def __init__(self, make_prox: Callable, *, dim: int | None = None):
        self._make_prox = make_prox
        self._dim = dim

    def make_local_prox(self, data):
        return self._make_prox(data)

    def dim(self, data) -> int:
        if self._dim is not None:
            return self._dim
        Xs = data[0] if isinstance(data, tuple) else data
        return Xs.shape[-1]


class OptimizerStrategy(Strategy):
    """Single-stream optimizer training (the ``launch/train.py`` workload):
    one logical push per step whose message is the gradient of ``loss_fn``
    on the round's batch, applied through a ``repro_torch.optim``
    optimizer.  Compose with ``delay_line`` for §5 bounded staleness and a
    compressed wire for the low-communication push::

        strategy = api.OptimizerStrategy(loss_fn, adam(3e-4))
        res = api.fit(strategy, None, transport="delay_line", staleness=1,
                      wire="topk:0.05+ef", stream=batches, theta0=params,
                      device="cuda")

    One logical node (``num_nodes == 1``, ``stacked_msgs = False``).  The
    state is ``(opt_state, loss)``, the loss being the round's batch loss
    before the update.  Not vmappable (its gradient is
    ``torch.autograd.grad``): a sweep runs its scenarios in turn inside each
    round, S copies of the training state side by side.
    """

    stacked_msgs = False
    vmappable = False
    #: the aggregate() override is the identity on ONE message, so a zeroed
    #: (fault-masked) message drops out like a sum term: a dead round
    #: applies a zero gradient
    fault_maskable = True

    def __init__(self, loss_fn: Callable, optimizer, *, has_aux: bool = False,
                 predict_fn: Callable | None = None):
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.has_aux = has_aux
        self.predict_fn = predict_fn

    def num_nodes(self, data) -> int:
        return 1

    def init_state(self, theta, data):
        device = tree_leaves(theta)[0].device
        return (self.optimizer.init(theta), torch.zeros((), device=device))

    def local_updates(self, theta, state, data, batch):
        leaves, spec = tree_flatten(theta)
        xs = [x.detach().requires_grad_() for x in leaves]
        with torch.enable_grad():
            out = self.loss_fn(tree_unflatten(xs, spec), batch)
            loss = out[0] if self.has_aux else out
            grads = torch.autograd.grad(loss, xs, materialize_grads=True)
        return tree_unflatten(list(grads), spec), (state[0], loss.detach())

    def aggregate(self, msgs):
        return msgs  # one logical node — nothing to reduce

    def apply_update(self, theta, agg, state, data):
        updates, opt_state = self.optimizer.update(agg, state[0], theta)
        return apply_updates(theta, updates), (opt_state, state[1])

    def round_metric(self, theta, state, data):
        return state[1]  # loss on the round's batch (pre-update)

    def predict(self, theta, X):
        """Serving an optimizer-trained model is workload-specific (for an
        LM, ``repro_torch.serve.ContinuousLMEngine``): inject it as
        ``predict_fn(θ, X)``."""
        if self.predict_fn is None:
            raise NotImplementedError(
                "OptimizerStrategy needs predict_fn= to be served (e.g. a "
                "closure over repro_torch.serve.ContinuousLMEngine)")
        return self.predict_fn(theta, X)
