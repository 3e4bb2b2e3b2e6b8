"""Per-phase device timings for ``fit(..., trace="phases")`` (port of
``repro.telemetry.phases``).

A host span around queued CUDA work measures submission, not execution,
and fencing inside the fit's loop would change what the fit does between
rounds.  So ``trace="phases"`` never touches the fit: after it completes,
:func:`profile_phases` replays the round's parts as **standalone** probes
at the run's shapes, each run once to warm up and then timed once under a
``torch.cuda.synchronize()`` fence inside its span:

* ``phase/local_step``       — per-node gradients + stack reduce + apply:
  the compute floor every executor shares;
* ``phase/encode``           — the wire's stacked encode (top-k select /
  quantize / EF residual, through the wire kernels on the card) on the
  run's own first-round messages;
* ``hop/<name>``             — one span per reduction hop of the mesh /
  multipod topology (``core/topology.py``): ``steps`` sums of one message
  row over just that hop's process group;
* ``phase/stats_completion`` — the deferred ``metric_mean`` completion (a
  trajectory-shaped mean over the node axis).

Each probe runs ``steps`` rounds, so its span compares with ``fit/loop``.
Probes are best-effort: one that does not apply (messages that are not
stacked, a strategy without data) is skipped, bumps the
``phases/skipped`` counter and sets ``<name>/skipped`` to the reason.
"""

from __future__ import annotations

import torch

from repro_torch.api.executor import MeshExecutor, SweepExecutor, _fence
from repro_torch.core.allreduce import hierarchical_allreduce, mesh_allreduce
from repro_torch.launch.mesh import axis_group
from repro_torch.utils.tree import tree_leaves, tree_map

__all__ = ["profile_phases"]


def _fenced(tracer, name, prog, *args, **tags):
    """Warm ``prog`` outside the span, then time one fenced call inside it.
    Any failure marks the probe skipped instead of failing the fit."""
    try:
        _fence(prog(*args))
        with tracer.span(name, **tags):
            _fence(prog(*args))
        return True
    except Exception as e:  # probe inapplicable: record why, move on
        tracer.count("phases/skipped")
        tracer.gauge(f"{name}/skipped", type(e).__name__)
        return False


def _tree_reduce_stack(msgs, op: str):
    red = torch.mean if op == "mean" else torch.sum
    return tree_map(lambda m: red(m, dim=0), msgs)


def _consume(tree):
    """One scalar folding every leaf (the probe's output)."""
    return sum(torch.sum(leaf) for leaf in tree_leaves(tree) if isinstance(leaf, torch.Tensor))


def profile_phases(tracer, strategy, data, *, wire, transport, executor, schedule=None,
                   steps=None, stream=None, theta0=None) -> None:
    """Record the per-phase probe spans for one fit configuration (see the
    module docstring).  Called by ``api.fit`` when ``trace="phases"``."""
    if isinstance(executor, SweepExecutor):
        executor = executor.inner  # probe one scenario's placement
    if steps is not None:
        T = int(steps)
    elif schedule is not None:
        T = len(schedule)
    else:
        T = 1
    tname = getattr(transport, "name", str(transport))

    theta = theta0 if theta0 is not None else strategy.init_theta(data)
    try:
        state = strategy.init_state(theta, data)
    except Exception:
        state = ()
    batch = None if stream is None else tree_map(lambda s: s[0], stream)
    op = strategy.aggregate_op

    # -- phase/local_step: grads + stack reduce + apply, no wire, no mesh
    msgs = None
    if strategy.stacked_msgs:
        try:
            msgs, _ = strategy.local_updates(theta, state, data, batch)
        except Exception:
            tracer.count("phases/skipped")
            tracer.gauge("phase/local_step/skipped", "local_updates")
        if msgs is not None:

            def local_prog(th, st, d):
                for _ in range(T):
                    m, st2 = strategy.local_updates(th, st, d, batch)
                    th, st = strategy.apply_update(th, _tree_reduce_stack(m, op), st2, d)
                return _consume(th)

            _fenced(tracer, "phase/local_step", local_prog, theta, state, data,
                    steps=T, transport=tname)

    # -- phase/encode: the wire's stacked encode at the real message shape
    if msgs is not None:
        try:
            K = strategy.num_nodes(data)
            wstate = wire.init_state(theta, K, stacked=True)
        except Exception:
            wstate = None
            tracer.count("phases/skipped")
            tracer.gauge("phase/encode/skipped", "init_state")
        if wstate is not None:

            def encode_prog(ws, m):
                acc = torch.zeros((), device=tree_leaves(m)[0].device)
                for _ in range(T):
                    ws, m_hat, _up = wire.encode_updates(ws, m, stacked=True)  # reprolint: disable=ledger-completeness -- timing probe; the traced fit already accounted these bytes
                    acc = acc + _consume(m_hat)
                return ws, acc

            _fenced(tracer, "phase/encode", encode_prog, wstate, msgs, steps=T, wire=wire.name)

    # -- hop/<name> + phase/stats_completion: mesh placements only
    if not isinstance(executor, MeshExecutor) or msgs is None:
        return
    try:
        r = executor.resolve()
        K = strategy.num_nodes(data)
        ctx = executor._placement_context(r, K)
    except Exception:
        tracer.count("phases/skipped")
        tracer.gauge("hop/skipped", "resolve")
        return
    # this rank's first node's message: the reference reduces row 0 of each
    # shard's slice
    one = tree_map(lambda x: x[ctx.shard * ctx.nodes_per_shard], msgs)

    def hop_loop(group):
        def prog(v):
            acc = tree_map(torch.zeros_like, v)
            for _ in range(T):
                red = hierarchical_allreduce(v, [group], op="sum")
                acc = tree_map(torch.add, acc, red)
            return acc

        return prog

    for hop in r.topology.hops:
        _fenced(tracer, f"hop/{hop.name}", hop_loop(axis_group(r.mesh, hop.axes)), one,
                axes="+".join(hop.axes), steps=T)

    # the deferred metric_mean completion: a (T,)-per-node mean over the nodes
    def stats_prog(v):
        return mesh_allreduce(torch.sum(v, dim=0), ctx.node_group, op="mean")

    dev = tree_leaves(msgs)[0].device
    _fenced(tracer, "phase/stats_completion", stats_prog,
            torch.ones((ctx.nodes_per_shard, T), device=dev), steps=T)
