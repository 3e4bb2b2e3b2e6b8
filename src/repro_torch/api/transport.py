"""Transport layer — WHO talks to whom, and when (port of
``repro.api.transport``).

* ``sequential_server`` — the §5 central information server with the
  sequential handoff (round-robin ≡ mini-batch GD); wraps ``core.server``.
* ``stale_server``      — the literal §5 text: the pusher receives θ_{t-1}.
* ``allreduce``         — the two-phase central-server Allreduce of §3.1.
* ``delay_line``        — the aggregate is applied D rounds late; wraps
  ``core.staleness``.
* ``admm_consensus``    — global-variable-consensus ADMM (three-stage
  Douglas-Rachford, two Allreduces per iteration); wraps ``core.admm``.

A transport builds the per-round step, calling back into the strategy for
local computation, into the wire for encoding and byte metering, and into
the executor's primitive set for everything that depends on where the
nodes live.  Fault plans (``api.faults``) are host-side numpy draws, so a
round's participation, straggler lag and quorum decision are Python values
here; the reference's jit-argument masks select the same rows and the same
rollback.  The reference's comm/compute overlap branch is mesh-only and is
not ported.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.api import executor as _exec
from repro_torch.api.faults import FaultCarry
from repro_torch.api.strategy import Strategy
from repro_torch.core.admm import consensus_admm
from repro_torch.core.server import contact, init_server
from repro_torch.core.staleness import delay_init, delay_push_pop, delay_push_read
from repro_torch.utils.tree import tree_leaves, tree_map, tree_stack

PyTree = Any


class RawRun(NamedTuple):
    theta: PyTree
    trajectory: PyTree
    uplink: np.ndarray  # (T,) per-round uplink bytes
    downlink: np.ndarray  # (T,) per-round downlink bytes
    rounds_per_step: int  # ledger rounds charged per loop step
    event_kind: str  # ledger event tag ("contact" / "allreduce")
    extras: dict
    carry: Any  # opaque resume state


class Transport:
    name = "transport"

    def run(self, strategy, data, *, wire, schedule, steps, stream, theta0, carry,
            executor, faults=None) -> RawRun:
        raise NotImplementedError


def _resolve_theta0(strategy, data, theta0):
    return strategy.init_theta(data) if theta0 is None else theta0


def _unwrap_fault_carry(carry, faults, name):
    """Split a resume carry into (inner carry, plan round offset)."""
    if faults is None:
        if isinstance(carry, FaultCarry):
            raise ValueError(
                f"transport {name!r}: carry= comes from a faults= fit — "
                "pass the same FaultPlan to resume it"
            )
        return carry, 0
    if carry is None:
        return None, 0
    if not isinstance(carry, FaultCarry):
        raise ValueError(
            f"transport {name!r}: resuming under faults= needs the carry "
            "of a faulted fit (a FaultCarry); this one is from a "
            "fault-free fit"
        )
    return carry.inner, int(carry.next_round)


def _uplink_array(ups: list) -> np.ndarray:
    """Per-round value-dependent byte counts (f32, as the reference's), up
    or down."""
    return torch.stack([torch.as_tensor(u).cpu() for u in ups]).numpy()


class ServerTransport(Transport):
    """The §5 central information server under a contact schedule::

        res = api.fit(api.GradientDescent(lsq_loss, lr=0.1), (Xs, ys),
                      transport="sequential_server",
                      schedule=schedules.round_robin(K, rounds), device="cuda")
    """

    def __init__(self, handoff: str):
        if handoff not in ("sequential", "stale"):
            raise ValueError(f"unknown handoff {handoff!r}")
        self.handoff = handoff
        self.name = (
            "sequential_server" if handoff == "sequential" else "stale_server"
        )

    def run(self, strategy, data, *, wire, schedule, steps, stream, theta0, carry,
            executor, faults=None):
        if schedule is None:
            raise ValueError(
                f"transport {self.name!r} needs a contact schedule= "
                "(see repro_torch.core.schedules)"
            )
        K = strategy.num_nodes(data)
        carry, t0 = _unwrap_fault_carry(carry, faults, self.name)
        if faults is not None and (faults.straggler > 0 or faults.quorum is not None):
            raise ValueError(
                f"transport {self.name!r} contacts ONE node per round — "
                "straggler/quorum fault modes only apply to update "
                "transports (allreduce/delay_line); use dropout_p alone"
            )
        if carry is None:
            theta0 = _resolve_theta0(strategy, data, theta0)
            carry = (
                init_server(theta0),
                strategy.init_state(theta0, data),
                wire.init_state(theta0, K),
            )
        theta_template = carry[0].theta
        handoff = self.handoff
        down_const = wire.measure(theta_template)  # dense θ handed back
        static_up = wire.push_bytes(theta_template)
        if faults is not None and static_up is None:
            raise ValueError(
                f"faults= with wire {wire.name!r}: per-contact survivor "
                "accounting needs a shape-static push cost "
                "(wire.push_bytes); value-dependent wires (thresh) are "
                "not supported under faults"
            )
        sched = np.asarray(torch.as_tensor(schedule).cpu(), dtype=np.int64).reshape(-1)
        T = len(sched)
        if faults is not None:
            draws = faults.draws(t0, T, K)
            # the contacted node answers iff its uniform clears dropout_p
            alive_np = draws.u[np.arange(T), sched] >= faults.dropout_p
        else:
            alive_np = np.ones((T,), dtype=bool)

        def make_step(shard_data):
            def step(c, xt):
                k, alive = xt
                server, sstate, wstate = c
                if not alive:
                    # dead contact: a no-op round — the server keeps its
                    # state, the node's wire state does not commit, and the
                    # trajectory records the unchanged θ
                    return c, (server.theta, None)
                theta_start = (
                    server.theta if handoff == "sequential" else server.theta_prev
                )
                k_loc, mine = _exec.local_node(k)
                theta_new, sstate = strategy.local_step(
                    k_loc, theta_start, sstate, shard_data
                )
                wstate_new, theta_push, up = wire.encode_push(
                    wstate, k_loc, theta_start, theta_new
                )
                theta_push = _exec.from_owner(theta_push, mine)
                wstate = _exec.commit_owner(wstate_new, wstate, mine)
                server, received = contact(server, theta_push, handoff=handoff)
                return (server, sstate, wstate), (received, up)

            return step

        (server, sstate, wstate), ys = executor.run_server(
            strategy=strategy, data=data, carry=carry, make_step=make_step,
            schedule=zip(sched.tolist(), alive_np.tolist()),
        )
        theta = executor.finalize(strategy, server.theta, sstate, data)
        traj = tree_stack([y[0] for y in ys])
        alive_i = alive_np.astype(np.int64)
        if static_up is not None:
            # exact integer accounting: a dropped contact costs nothing
            ups = alive_i * static_up
        else:
            ups = _uplink_array([y[1] for y in ys])
        downs = alive_i * down_const
        out_carry = (server, sstate, wstate)
        if faults is not None:
            out_carry = FaultCarry(inner=out_carry, next_round=t0 + T)
        return RawRun(
            theta=theta,
            trajectory=traj,
            uplink=ups,
            downlink=downs,
            rounds_per_step=1,
            event_kind="contact",
            extras={"faults": faults.describe()} if faults is not None else {},
            carry=out_carry,
        )


class UpdateTransport(Transport):
    """Synchronous Allreduce (staleness=0) or the bounded-staleness delay
    line (staleness=D>0): every round all nodes push an update message;
    the aggregate is applied — possibly D rounds late::

        api.fit(strategy, data, transport="allreduce", steps=100, device="cuda")
        api.fit(strategy, data, transport="delay_line", staleness=2,
                steps=100, device="cuda")
    """

    def __init__(self, staleness: int = 0):
        if staleness < 0:
            raise ValueError("staleness must be >= 0")
        self.staleness = staleness
        self.name = "allreduce" if staleness == 0 else "delay_line"

    def run(self, strategy, data, *, wire, schedule, steps, stream, theta0, carry,
            executor, faults=None):
        K = strategy.num_nodes(data)
        stacked = strategy.stacked_msgs
        if stream is not None:
            T = tree_leaves(stream)[0].shape[0]
        elif steps is not None:
            T = steps
        else:
            raise ValueError(
                f"transport {self.name!r} needs steps= or a stream= with a "
                "leading time axis"
            )
        carry, t0 = _unwrap_fault_carry(carry, faults, self.name)
        draws = None
        if faults is not None:
            if faults.quorum is not None and faults.quorum > K:
                raise ValueError(
                    f"quorum={faults.quorum} can never be met by K={K} nodes"
                )
            if strategy.aggregate_op != "sum" or (
                type(strategy).aggregate is not Strategy.aggregate
                and not getattr(strategy, "fault_maskable", False)
            ):
                raise ValueError(
                    f"faults= masks dropped nodes out of a SUM aggregate; "
                    f"{type(strategy).__name__} declares "
                    f"aggregate_op={strategy.aggregate_op!r} or overrides "
                    "aggregate() (set fault_maskable = True only if the "
                    "override is linear)"
                )
            if (type(strategy).uplink_bytes is not Strategy.uplink_bytes
                    or type(strategy).downlink_bytes is not Strategy.downlink_bytes):
                raise ValueError(
                    f"faults= meters survivors host-side from the plan's "
                    f"draws; {type(strategy).__name__}'s byte-accounting "
                    "overrides would disagree with it"
                )
            draws = faults.draws(t0, T, K)
        straggler = 0 if faults is None else faults.straggler
        D_buf = self.staleness + straggler

        if carry is None:
            th0 = _resolve_theta0(strategy, data, theta0)
            carry = (
                th0,
                strategy.init_state(th0, data),
                wire.init_state(th0, K, stacked=stacked),
                delay_init(tree_map(torch.zeros_like, th0), D_buf)
                if D_buf > 0 else (),
            )
        theta_template = carry[0]
        push_bytes = wire.push_bytes(theta_template)
        # static byte accounting unless the strategy prices its own pushes
        # or broadcasts (the cascade SVM's SVs-only messages)
        up_is_static = (type(strategy).uplink_bytes is Strategy.uplink_bytes
                        and push_bytes is not None)
        down_is_static = type(strategy).downlink_bytes is Strategy.downlink_bytes
        if faults is not None and not up_is_static:
            raise ValueError(
                f"faults= with wire {wire.name!r}: per-survivor byte "
                "accounting needs a shape-static push cost "
                "(wire.push_bytes); value-dependent wires (thresh) are "
                "not supported under faults"
            )

        def round_inputs(t):
            batch = None if stream is None else tree_map(lambda s: s[t], stream)
            if draws is None:
                return None, batch
            return (draws.u[t], draws.lag[t]), batch

        def make_step(shard_data):
            def step(c, xt):
                fault_t, batch = xt
                theta, sstate, wstate, delay = c
                msgs, sstate = strategy.local_updates(theta, sstate, shard_data, batch)
                wstate_new, msgs_hat, up_wire = wire.encode_updates(
                    wstate, msgs, stacked=stacked)
                del msgs  # a θ-sized tree: let it go before the apply
                if fault_t is not None and not stacked:
                    # one logical node: alive[0] gates the push and the
                    # wire state
                    u_t, lag_t = fault_t
                    alive = u_t >= faults.dropout_p
                    live = int(alive.sum())
                    if not alive[0]:
                        msgs_hat = tree_map(torch.zeros_like, msgs_hat)
                    else:
                        wstate = wstate_new
                elif fault_t is not None:
                    # participation: node k answers iff u_t[k] clears
                    # dropout_p; dead rows send zeros and keep their wire
                    # state (EF residuals must not absorb a discarded push)
                    u_t, lag_t = fault_t
                    alive = u_t >= faults.dropout_p
                    live = int(alive.sum())
                    rows = torch.from_numpy(_exec.local_rows(alive))

                    def _rows(n, o):
                        sel = rows.to(n.device).reshape((-1,) + (1,) * (n.dim() - 1))
                        return torch.where(sel, n, o)

                    msgs_hat = tree_map(
                        lambda x: _rows(x, torch.zeros_like(x)), msgs_hat
                    )
                    wstate = tree_map(_rows, wstate_new, wstate)
                else:
                    wstate = wstate_new
                up = strategy.uplink_bytes(msgs_hat, shard_data)
                if up is None and not up_is_static:
                    up = _exec.sum_bytes(up_wire)
                agg = _exec.broadcast(strategy.aggregate(msgs_hat))
                if straggler > 0:
                    # the round completes when its slowest LIVE node
                    # responds: read the line at base + max live lag
                    lag_eff = int(np.max(np.where(alive, lag_t, 0)))
                    delay, agg = delay_push_read(delay, agg, self.staleness + lag_eff)
                elif D_buf > 0:
                    delay, agg = delay_push_pop(delay, agg)
                theta_new, sstate = strategy.apply_update(theta, agg, sstate, shard_data)
                down = None
                if not down_is_static:
                    down = strategy.downlink_bytes(theta_new, shard_data)
                    if down is None:
                        down = torch.tensor(float(K * wire.measure(theta_new)))
                new_c = (theta_new, sstate, wstate, delay)
                if fault_t is not None and faults.quorum is not None \
                        and live < faults.quorum:
                    # below quorum the server discards the round: the
                    # whole carry rolls back
                    new_c = c
                m = strategy.round_metric(new_c[0], new_c[1], shard_data)
                return new_c, (m, up, down)

            return step

        carry, ys = executor.run_update(
            strategy=strategy, data=data, carry=carry, make_step=make_step,
            xs=round_inputs, length=T,
        )
        theta, sstate = carry[0], carry[1]
        theta = executor.finalize(strategy, theta, sstate, data)
        traj = torch.stack([y[0] for y in ys]) if ys else torch.zeros((0,))
        down_unit = wire.measure(theta_template)
        if faults is not None:
            # exact host-side survivor accounting from the same draws the
            # step masked with: uplink charges live pushes; downlink hands
            # θ back to survivors, only when quorum committed
            live_np = (draws.u >= faults.dropout_p).sum(axis=1).astype(np.int64)
            ups = live_np * int(push_bytes)
            commit = (
                live_np >= faults.quorum if faults.quorum is not None
                else np.ones_like(live_np, dtype=bool)
            )
            downs = np.where(commit, live_np, 0) * int(down_unit)
        else:
            if up_is_static:
                ups = np.full((T,), push_bytes * (K if stacked else 1), dtype=np.int64)
            else:
                ups = _uplink_array([y[1] for y in ys])
            if down_is_static:
                downs = np.full((T,), K * down_unit, dtype=np.int64)
            else:
                downs = _uplink_array([y[2] for y in ys])
        out_carry = carry
        if faults is not None:
            out_carry = FaultCarry(inner=carry, next_round=t0 + T)
        return RawRun(
            theta=theta,
            trajectory=traj,
            uplink=ups,
            downlink=downs,
            rounds_per_step=1,
            event_kind="allreduce",
            extras={"faults": faults.describe()} if faults is not None else {},
            carry=out_carry,
        )


class AdmmTransport(Transport):
    """Global-variable-consensus ADMM: the strategy supplies the per-node
    prox; every iteration costs two Allreduces of the consensus variable
    (z-update mean + residual norms), which is what the ledger charges::

        api.fit(api.ProxStrategy(lasso_prox_builder), (Xs, ys),
                transport="admm_consensus", steps=50, g="l1", g_lam=0.1,
                device="cuda")

    Wraps ``core.admm.consensus_admm``'s own three-stage loop rather than
    the executor step protocol, so runs are one-shot (no ``theta0=`` /
    ``carry=``), need a lossless wire (compressing consensus pushes would
    change the algorithm), and run on the local executor only.
    """

    name = "admm_consensus"

    def __init__(self, *, rho: float = 1.0, g: str = "none", g_lam: float = 0.0):
        self.rho = rho
        self.g = g
        self.g_lam = g_lam

    def run(self, strategy, data, *, wire, schedule, steps, stream, theta0, carry,
            executor, faults=None):
        if faults is not None:
            raise ValueError(
                "admm_consensus wraps core.admm's own synchronous loop — "
                "consensus ADMM has no masked-participation form here; "
                "faults= applies to server/allreduce/delay_line transports"
            )
        if steps is None:
            raise ValueError("transport 'admm_consensus' needs steps= (iterations)")
        if theta0 is not None or carry is not None:
            raise ValueError(
                "admm_consensus runs are one-shot: warm-start (theta0=) and "
                "resume (carry=) are not supported — rerun with more steps"
            )
        if not wire.lossless:
            raise ValueError(
                "admm_consensus needs a lossless wire (dense) — compressing "
                "the consensus pushes would change the algorithm"
            )
        if not isinstance(executor, _exec.LocalExecutor):
            raise ValueError(
                "admm_consensus wraps core.admm's own inner loop — it runs "
                f"on the local executor only, not {executor.name!r}"
            )
        local_prox = strategy.make_local_prox(data)
        K = strategy.num_nodes(data)
        dim = strategy.dim(data)
        # zeros, as the reference's default, on the data's device
        zeros = torch.zeros((K, dim), device=tree_leaves(data)[0].device)
        res = consensus_admm(
            local_prox, K, dim, rho=self.rho, g=self.g, g_lam=self.g_lam,
            iters=steps, theta0=zeros,
        )
        theta = executor.finalize(strategy, res.z, res.state, data)
        # two Allreduces of the (dim,) consensus variable per iteration
        per_iter = 2 * K * wire.measure(res.z)
        ups = np.full((steps,), per_iter, dtype=np.int64)
        return RawRun(
            theta=theta,
            trajectory=res.history,
            uplink=ups,
            downlink=ups,
            rounds_per_step=2,
            event_kind="allreduce",
            extras={"admm": res},
            carry=res.state,
        )


TRANSPORTS = (
    "sequential_server",
    "stale_server",
    "delay_line",
    "allreduce",
    "admm_consensus",
)


def make_transport(spec: str | Transport, **options) -> Transport:
    """Resolve a transport spec; ``options`` are transport-specific
    (``staleness`` for delay_line; ``rho``/``g``/``g_lam`` for
    admm_consensus)."""
    if isinstance(spec, Transport):
        if options:
            raise ValueError("transport options only apply to string specs")
        return spec
    if spec == "sequential_server":
        _expect(options, ())
        return ServerTransport("sequential")
    if spec == "stale_server":
        _expect(options, ())
        return ServerTransport("stale")
    if spec == "allreduce":
        _expect(options, ())
        return UpdateTransport(staleness=0)
    if spec == "delay_line":
        _expect(options, ("staleness",))
        return UpdateTransport(staleness=options.get("staleness", 1))
    if spec == "admm_consensus":
        _expect(options, ("rho", "g", "g_lam"))
        return AdmmTransport(**options)
    raise ValueError(f"unknown transport {spec!r} — one of {TRANSPORTS}")


def _expect(options: dict, allowed: tuple):
    unknown = set(options) - set(allowed)
    if unknown:
        raise TypeError(f"unexpected transport options: {sorted(unknown)}")
