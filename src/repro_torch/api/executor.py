"""Executor layer — WHERE a fit runs (port of ``repro.api.executor``, local
executor only).

``LocalExecutor`` stacks the K logical nodes on one device and walks the
rounds in a Python loop (the reference's ``lax.scan``).  The primitive set
the transports and strategies are written against (``aggregate``,
``broadcast``, ``local_rows``, ``local_node``, ``node_global_index``,
``node_shard_index``, ``from_owner``, ``commit_owner``, ``metric_mean``,
``sum_bytes``) is the
local identity: aggregation is the stacked ``server_allreduce`` and every
cross-shard step is a no-op.  The reference's ``StatsDeferral`` defers cross-shard metric
and byte collectives; locally there are none, so it has no counterpart.

Not ported yet: the mesh, multipod, sweep and serve executors and their
compositions (``ROADMAP.md`` queue 1, item 8), and the program cache
(``cached_program``/``dispatch``) — PyTorch runs eagerly, so there is no
compiled program to cache.
"""

from __future__ import annotations

from typing import Any

from repro_torch.core.allreduce import server_allreduce

PyTree = Any

_NOT_PORTED = "ROADMAP.md queue 1, item 8 (executors beyond local)"


# ----------------------------------------------------------------------------
# The primitive set, as the local identity
# ----------------------------------------------------------------------------


def num_node_shards() -> int:
    """How many shards the node axis is split over: 1 locally."""
    return 1


def node_shard_index() -> int:
    """Index of this shard along the node axis: 0 locally.  Strategies that
    replicate the data (``replicate_data``) find their node slice from it."""
    return 0


def local_rows(x):
    """This shard's slice of a replicated node-axis array: all of it."""
    return x


def node_global_index(k_local):
    """Global index of shard-local node ``k_local``: the identity locally.
    Server-family strategies that index replicated per-node structures (a
    pooled θ slot block, per-node generators) use it, as the k-windows
    strategy does."""
    return k_local


def local_node(k):
    """``(k_local, mine)`` for global node ``k``: ``(k, True)`` locally."""
    return k, True


def from_owner(tree: PyTree, mine) -> PyTree:
    """Replicate the owning shard's value: the identity locally."""
    return tree


def commit_owner(new: PyTree, old: PyTree, mine) -> PyTree:
    """Commit a shard-local state update on the owner: ``new`` locally."""
    return new


def aggregate(stacked: PyTree, op: str = "sum") -> PyTree:
    """Reduce per-node messages over the stacked node axis."""
    return server_allreduce(stacked, op=op)


def broadcast(tree: PyTree) -> PyTree:
    """Phase 2 of the §3.1 two-step protocol: the aggregate is already one
    replicated value, so this is the identity (it marks the downlink)."""
    return tree


def metric_mean(x: PyTree) -> PyTree:
    """Complete a node-mean statistic across shards: the identity locally."""
    return x


def sum_bytes(x):
    """Total a shard-local byte count across shards: the identity locally."""
    return x


# ----------------------------------------------------------------------------
# Executors
# ----------------------------------------------------------------------------


class Executor:
    """Owns where a fit's per-round loop runs.  Transports hand it a
    ``make_step`` factory and the per-round inputs; the executor places
    the loop.  Two hooks, one per transport family: ``run_update``
    (allreduce / delay_line) and ``run_server`` (the §5 server)."""

    name = "executor"

    def finalize(self, strategy, theta, state, data):
        return strategy.finalize(theta, state, data)

    def run_update(self, *, strategy, data, carry, make_step, xs, length):
        raise NotImplementedError

    def run_server(self, *, strategy, data, carry, make_step, schedule):
        raise NotImplementedError


class LocalExecutor(Executor):
    """K logical nodes stacked on one device, one Python loop over rounds::

        res = api.fit(strategy, data, transport="allreduce", steps=100,
                      executor="local", device="cuda")
    """

    name = "local"

    def run_update(self, *, strategy, data, carry, make_step, xs, length):
        """Run ``length`` rounds of ``make_step(data)``; ``xs(t)`` gives
        round t's input.  Returns (carry, per-round outputs)."""
        step = make_step(data)
        ys = []
        for t in range(length):
            carry, y = step(carry, xs(t))
            ys.append(y)
        return carry, ys

    def run_server(self, *, strategy, data, carry, make_step, schedule):
        """Run one contact per schedule entry; ``schedule`` yields the
        per-contact inputs.  Returns (carry, per-contact outputs)."""
        step = make_step(data)
        ys = []
        for xt in schedule:
            carry, y = step(carry, xt)
            ys.append(y)
        return carry, ys


EXECUTORS = ("local",)


def make_executor(spec) -> Executor:
    """Resolve an executor spec: ``None``/``"local"`` or an ``Executor``."""
    if isinstance(spec, Executor):
        return spec
    if spec is None or spec == "local":
        return LocalExecutor()
    raise NotImplementedError(
        f"executor {spec!r} is not ported yet ({_NOT_PORTED}); "
        "repro_torch runs executor='local'"
    )
