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
nodes live; the executor owns the loop's placement (the local loop, the
mesh ranks, the scenario sweep, or a sweep on each mesh rank).  Fault
plans (``api.faults``) are host-side numpy draws, so without a swept fault
parameter a round's participation, straggler lag and quorum decision are
Python values; with ``dropout_p`` swept they become per-scenario tensor
masks, as the reference's jit-argument masks are.
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
from repro_torch.core.staleness import (
    DelayLine,
    delay_init,
    delay_push_pop,
    delay_push_read,
)
from repro_torch.telemetry import trace as _trace
from repro_torch.utils.tree import tree_leaves, tree_map

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


class ServerTransport(Transport):
    """The §5 central information server under a contact schedule::

        res = api.fit(api.GradientDescent(lsq_loss, lr=0.1), (Xs, ys),
                      transport="sequential_server",
                      schedule=schedules.round_robin(K, rounds), device="cuda")

    The per-contact step is written against the executor primitives, so
    it places wherever ``run_server`` can put it: locally
    ``local_node`` / ``from_owner`` / ``commit_owner`` are identities; on a
    mesh executor the contacted node's ``local_step`` runs on the rank
    that owns it, the other ranks add zeros to its push, and the per-node
    wire state commits on the owner only — bitwise the local walk.
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
                up = None
                if mine:
                    theta_new, sstate = strategy.local_step(
                        k_loc, theta_start, sstate, shard_data
                    )
                    wstate_new, theta_push, up = wire.encode_push(
                        wstate, k_loc, theta_start, theta_new
                    )
                else:
                    # only the owner computes; the others add zeros to its
                    # push (θ_start stands in for the shape)
                    wstate_new, theta_push = wstate, theta_start
                theta_push = _exec.from_owner(theta_push, mine)
                if static_up is None:
                    up = _exec.from_owner(
                        up if mine else torch.zeros((), device=theta_start.device), mine)
                else:
                    up = None  # exact integer accounting after the run
                wstate = _exec.commit_owner(wstate_new, wstate, mine)
                server, received = contact(server, theta_push, handoff=handoff)
                return (server, sstate, wstate), (received, up)

            return step

        (server, sstate, wstate), ys = executor.run_server(
            strategy=strategy, data=data, carry=carry, make_step=make_step,
            schedule=zip(sched.tolist(), alive_np.tolist()), wire=wire,
        )
        theta = executor.finalize(strategy, server.theta, sstate, data)
        traj = ys[0]
        alive_i = alive_np.astype(np.int64)
        if static_up is not None:
            # exact integer accounting: a dropped contact costs nothing
            ups = alive_i * static_up
        else:
            ups = ys[1].cpu().numpy()
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


def _device_of(tree) -> torch.device:
    return next(x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)).device


def _where_rows(sel, n, o):
    """Rows of ``n`` where ``sel`` (a (K,) numpy or tensor mask) holds, of
    ``o`` elsewhere."""
    if isinstance(sel, np.ndarray):
        sel = torch.from_numpy(sel).to(n.device)
    return torch.where(sel.reshape((-1,) + (1,) * (n.dim() - 1)), n, o)


def _tree_where(cond, new, old):
    """``new`` where the (possibly scenario-batched) flag ``cond`` holds,
    ``old`` elsewhere, leaf by leaf on each leaf's device."""
    return tree_map(
        lambda n, o: torch.where(cond.to(n.device), n, o)
        if isinstance(n, torch.Tensor) else n, new, old)


class UpdateTransport(Transport):
    """Synchronous Allreduce (staleness=0) or the bounded-staleness delay
    line (staleness=D>0): every round all nodes push an update message;
    the aggregate is applied — possibly D rounds late::

        api.fit(strategy, data, transport="allreduce", steps=100, device="cuda")
        api.fit(strategy, data, transport="delay_line", staleness=2,
                steps=100, device="cuda")

    Every round all nodes work, so the loop places on every executor: the
    local loop, the mesh / multipod ranks, the scenario sweep and
    ``mesh+sweep``.  A swept ``"staleness"`` supersedes the transport's own
    D: one delay line of depth max D shared by all scenarios, read at each
    scenario's own index.  Without a swept fault parameter the plan's
    draws are host arrays and a round's participation, straggler lag and
    quorum decision are Python values; with ``dropout_p`` swept they are
    tensors, and the dead rows and the quorum rollback are ``torch.where``
    selects per scenario.  On a mesh executor with ``overlap`` a
    delay-tolerant round (D ≥ 1) runs its outermost hop as an asynchronous
    collective, waited on where the delay line takes it a round later —
    bitwise the synchronous schedule.
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
        p_sweep = executor.swept("dropout_p")
        draws = None
        if faults is None:
            if p_sweep is not None:
                raise ValueError(
                    "sweep={'dropout_p': ...} needs faults=FaultPlan(...) — "
                    "the plan supplies the shared per-round draws the swept "
                    "thresholds compare against"
                )
        else:
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
        stal_sweep = executor.swept("staleness")
        if stal_sweep is not None:
            D_buf = max(1, int(torch.as_tensor(stal_sweep).max()))
        else:
            D_buf = self.staleness
        straggler = 0 if faults is None else faults.straggler
        D_buf += straggler
        resolved0 = None
        if carry is None and executor.swept("theta0") is None:
            resolved0 = _resolve_theta0(strategy, data, theta0)

        def make_carry(theta0=resolved0):
            th0 = theta0 if theta0 is not None else _resolve_theta0(strategy, data, None)
            return (
                th0,
                strategy.init_state(th0, data),
                wire.init_state(th0, K, stacked=stacked),
                delay_init(tree_map(torch.zeros_like, th0), D_buf) if D_buf > 0 else (),
            )

        if carry is not None:
            theta_template = executor.scenario_template(carry[0])
        elif resolved0 is not None:
            theta_template = resolved0
        else:
            theta_template = executor.scenario_template(executor.swept("theta0"))
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

        # a round's scalar statistics (metric mean, byte sum) complete in
        # one collective after the loop, on the stacked (T,) outputs
        defer_ok = bool(getattr(strategy, "defer_stats", True))
        stats = _exec.StatsDeferral()
        overlap_active = (
            bool(getattr(executor, "overlap", False))
            and D_buf >= 1
            and stal_sweep is None
            and executor.num_scenarios is None
            and stacked
            and strategy.aggregate_op == "sum"
            and type(strategy).aggregate is Strategy.aggregate
            and type(strategy).uplink_bytes is Strategy.uplink_bytes
            # a quorum abort would have to recall an in-flight partial
            and faults is None
        )
        if draws is not None and p_sweep is not None:
            # a swept threshold compares on the device, per scenario
            dev = _device_of(theta_template)
            fault_u = torch.from_numpy(draws.u).to(dev)
            fault_lag = torch.from_numpy(draws.lag).to(dev)
        elif draws is not None:
            fault_u, fault_lag = draws.u, draws.lag

        def round_inputs(t):
            batch = None if stream is None else tree_map(lambda s: s[t], stream)
            if draws is None:
                return None, batch
            return (fault_u[t], fault_lag[t]), batch

        def make_step(shard_data, sweep_delay):
            """The round's step for the node slice placed here (all of it
            locally, the rank's rows on a mesh); ``sweep_delay`` is the
            scenario's staleness under a staleness sweep, else None.  A
            round is four phases; with an ambient tracer each runs inside
            its ``fit/round/<phase>`` span."""

            def update(theta, sstate, batch):
                return strategy.local_updates(theta, sstate, shard_data, batch)

            def encode(wstate, msgs, fault_t):
                """The wire: encode, participation, the uplink count."""
                wstate_new, msgs_hat, up_wire = wire.encode_updates(
                    wstate, msgs, stacked=stacked)
                alive = live = None
                if fault_t is not None:
                    # participation: node k answers iff u_t[k] clears
                    # dropout_p; dead rows send zeros and keep their wire
                    # state (EF residuals must not absorb a discarded push)
                    u_t, _ = fault_t
                    alive = u_t >= faults.dropout_p
                    live = alive.sum()
                    if stacked:
                        rows = _exec.local_rows(alive)
                        msgs_hat = tree_map(
                            lambda x: _where_rows(rows, x, torch.zeros_like(x)), msgs_hat)
                        wstate = tree_map(lambda n, o: _where_rows(rows, n, o),
                                          wstate_new, wstate)
                    elif isinstance(alive, torch.Tensor):
                        a0 = alive[0]
                        msgs_hat = tree_map(
                            lambda x: torch.where(a0, x, torch.zeros_like(x)), msgs_hat)
                        wstate = _tree_where(a0, wstate_new, wstate)
                    elif alive[0]:
                        # one logical node: alive[0] gates the push and the
                        # wire state
                        wstate = wstate_new
                    else:
                        msgs_hat = tree_map(torch.zeros_like, msgs_hat)
                else:
                    wstate = wstate_new
                up = strategy.uplink_bytes(msgs_hat, shard_data)
                if up is None and not up_is_static:
                    with _exec.deferring(stats if defer_ok else None):
                        up = _exec.sum_bytes(up_wire)
                return wstate, msgs_hat, up, alive, live

            def aggregate(c0, sstate, wstate, msgs_hat, alive, live, fault_t):
                """The aggregate through to the applied update, the downlink
                count and the quorum rollback to ``c0``, the pre-round
                carry."""
                theta, _, _, delay = c0
                if overlap_active:
                    buf2, pending, step0 = delay
                    # last round's outermost hop has run while this round's
                    # local compute was enqueued; start this round's now
                    part = _exec.aggregate_partial(msgs_hat)
                    agg_done = pending.wait()
                    pending = _exec.aggregate_complete(part, async_op=True)
                    if D_buf > 1:
                        buf2, agg = delay_push_pop(buf2, agg_done)
                    else:
                        agg = agg_done
                    delay = (buf2, pending, step0)
                else:
                    agg = _exec.broadcast(strategy.aggregate(msgs_hat))
                    if straggler > 0:
                        # the round completes when its slowest LIVE node
                        # responds: read the line at base + max live lag
                        base = self.staleness if sweep_delay is None else sweep_delay
                        lag_t = fault_t[1]
                        if isinstance(alive, torch.Tensor):
                            lag_eff = torch.max(torch.where(alive, lag_t, 0))
                        else:
                            lag_eff = int(np.max(np.where(alive, lag_t, 0)))
                        delay, agg = delay_push_read(delay, agg, base + lag_eff)
                    elif sweep_delay is not None:
                        delay, agg = delay_push_read(delay, agg, sweep_delay)
                    elif D_buf > 0:
                        delay, agg = delay_push_pop(delay, agg)
                theta_new, sstate = strategy.apply_update(theta, agg, sstate, shard_data)
                down = None
                if not down_is_static:
                    down = strategy.downlink_bytes(theta_new, shard_data)
                    if down is None:
                        down = torch.tensor(float(K * wire.measure(theta_new)))
                new_c = (theta_new, sstate, wstate, delay)
                if fault_t is not None and faults.quorum is not None:
                    # below quorum the server discards the round: the
                    # whole carry rolls back
                    proceed = live >= faults.quorum
                    if isinstance(proceed, torch.Tensor):
                        new_c = _tree_where(proceed, new_c, c0)
                    elif not proceed:
                        new_c = c0
                return new_c, down

            def metric(c):
                with _exec.deferring(stats if defer_ok else None):
                    return strategy.round_metric(c[0], c[1], shard_data)

            tracer = _trace.current_tracer()
            if tracer is not None:
                update = tracer.spanned("fit/round/update", update)
                encode = tracer.spanned("fit/round/wire", encode)
                aggregate = tracer.spanned("fit/round/aggregate", aggregate)
                metric = tracer.spanned("fit/round/metric", metric)

            def step(c, xt):
                fault_t, batch = xt
                msgs, sstate = update(c[0], c[1], batch)
                wstate, msgs_hat, up, alive, live = encode(c[2], msgs, fault_t)
                del msgs  # a θ-sized tree: let it go before the apply
                new_c, down = aggregate(c, sstate, wstate, msgs_hat, alive, live, fault_t)
                return new_c, (metric(new_c), up, down)

            return step

        def enter_loop(c):
            # standard carry → overlapped carry: the delay line's newest
            # slot becomes the in-flight outer hop (masked to the hop's
            # root ranks, so completing it gives the replicated value
            # exactly); older slots stay a depth-(D-1) line.  Resume
            # carries stay interchangeable between overlap on and off.
            theta, sstate, wstate, delay = c
            newest = tree_map(lambda b: b[D_buf - 1], delay.buffer)
            pending = _exec.aggregate_complete(_exec.mask_to_root(newest), async_op=True)
            buf2 = ()
            if D_buf > 1:
                buf2 = DelayLine(buffer=tree_map(lambda b: b[:D_buf - 1], delay.buffer),
                                 step=delay.step)
            return (theta, sstate, wstate, (buf2, pending, delay.step))

        def exit_loop(c, ys):
            m, up, down = ys
            if overlap_active:
                # overlapped carry → standard carry: complete the last
                # round's hop and append it as the newest slot
                theta, sstate, wstate, (buf2, pending, step0) = c
                done = pending.wait()
                if D_buf > 1:
                    delay = DelayLine(
                        buffer=tree_map(lambda b, d: torch.cat([b, d[None]], dim=0),
                                        buf2.buffer, done),
                        step=buf2.step)
                else:
                    delay = DelayLine(buffer=tree_map(lambda d: d[None], done),
                                      step=step0 + T)
                c = (theta, sstate, wstate, delay)
            if stats.metric:
                m = _exec.metric_mean(m)
            if stats.bytes:
                up = _exec.sum_bytes(up)
            return c, (m, up, down)

        carry, ys = executor.run_update(
            strategy=strategy, data=data, carry=carry, make_carry=make_carry,
            make_step=make_step, xs=round_inputs, length=T, wire=wire,
            enter_loop=enter_loop if overlap_active else None,
            exit_loop=exit_loop if (overlap_active or defer_ok) else None,
            sweep_targets=(faults,) + tuple(getattr(wire, "stages", ())),
        )
        theta, sstate = carry[0], carry[1]
        theta = executor.finalize(strategy, theta, sstate, data)
        traj = ys[0] if T else torch.zeros((0,))
        down_unit = wire.measure(theta_template)
        if faults is not None:
            # exact host-side survivor accounting from the same draws the
            # step masked with: uplink charges live pushes; downlink hands
            # θ back to survivors, only when quorum committed
            p_vals = (
                torch.as_tensor(p_sweep).double().reshape(-1).cpu().numpy()
                if p_sweep is not None else np.asarray([faults.dropout_p])
            )
            live_np = (draws.u[None] >= p_vals[:, None, None]).sum(axis=2).astype(np.int64)
            ups = live_np * int(push_bytes)
            commit = (
                live_np >= faults.quorum if faults.quorum is not None
                else np.ones_like(live_np, dtype=bool)
            )
            downs = np.where(commit, live_np, 0) * int(down_unit)
            if p_sweep is None:
                ups, downs = ups[0], downs[0]
        else:
            if up_is_static:
                ups = np.full((T,), push_bytes * (K if stacked else 1), dtype=np.int64)
            else:
                ups = ys[1].cpu().numpy()
            if down_is_static:
                downs = np.full((T,), K * down_unit, dtype=np.int64)
            else:
                downs = ys[2].cpu().numpy()
        S = executor.num_scenarios
        if S is not None:
            # static costs are the same in every scenario
            if ups.ndim == 1:
                ups = np.broadcast_to(ups, (S, T)).copy()
            if downs.ndim == 1:
                downs = np.broadcast_to(downs, (S, T)).copy()
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
