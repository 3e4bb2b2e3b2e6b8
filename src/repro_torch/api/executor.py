"""Executor layer — WHERE a fit runs (port of ``repro.api.executor``).

The Strategy / Transport / Wire decomposition says what is learned, who
talks to whom and what crosses the network; the executor owns where the
per-round loop is placed:

* ``local``    — K logical nodes stacked on one device, one Python loop
  over rounds (the reference's ``lax.scan``);
* ``mesh``     — the nodes placed on the ``("data",)`` axis of a
  ``torch.distributed`` device mesh (``launch.mesh``): each rank holds
  K/ranks nodes of the data and of the wire's per-node state, θ and the
  strategy state stay replicated, and ``aggregate`` completes the rank's
  partial sum with collectives over the axis process groups (gloo on the
  CPU, NCCL on the card); the wire encodes per rank, so its kernels run
  on each rank's rows;
* ``multipod`` — the ``("pod", "data")`` placement: the same loop, with
  the reduction staged intra-pod first and inter-pod last and the ledger
  decomposed by tier;
* ``sweep``    — S scenarios (step sizes, regularizers, wire or fault
  parameters, staleness levels, initial points) batched with
  ``torch.func.vmap`` over each round's step: one pass over the data for
  all S, the wire kernels launched once on S·K rows (they are custom ops
  with a ``vmap`` rule), a ``FitResult`` with a leading S axis and one
  ``CommLedger`` per scenario;
* ``serve``    — trains exactly like ``local``, then publishes the
  finalized model (optionally) and stands it up behind a
  ``repro_torch.serve.ServeEngine`` (``metrics["serve_engine"]``).

Executors compose: ``SweepExecutor(params, inner=MeshExecutor(...))``
(``"mesh+sweep"`` / ``"multipod+sweep"`` with ``fit(..., sweep={...})``)
runs the scenario batch inside each rank's loop, and the collectives carry
the S axis in one launch.  The §5 server transports place on the mesh
executors too: each contact's ``local_step`` runs on the rank that owns
the contacted node and ``from_owner`` hands its push to every rank with
one sum of the owner's value and zeros — exact, so local ≡ mesh bitwise.

Transports write their step against the primitive set below
(``aggregate``, ``broadcast``, ``local_rows``, ``local_node``,
``from_owner``, ``commit_owner``, ``metric_mean``, ``sum_bytes``,
``node_shard_index``, ``node_global_index``, …).  The primitives read an
ambient placement context (``executing``) that the mesh executors
install; outside one they are the local identity.

Running a mesh (see ``launch.mesh``): every rank calls ``fit`` with the
same global data, after ``torch.distributed.init_process_group`` (or
inside ``launch.mesh.run_ranks``); without a process group the mesh is a
world of one on this process's device.  On one H100 NCCL takes a world of
one only; placement across ranks runs on the CPU with gloo.

Every executor runs its loop through ``dispatch(label, run, *args)``:
with an ambient tracer (``fit(..., tracer=...)``) the loop is one
``dispatch/<label>`` span, fenced with ``torch.cuda.synchronize()`` so it
covers device completion, and one ``program_cache/uncached`` count.  The
reference caches its compiled programs (``cached_program``) and tags a
dispatch ``hit`` or ``miss``; PyTorch runs eagerly, so there is no program
to cache and every dispatch is ``uncached`` (``ROADMAP.md`` queue 3, item
20), as the reference's are when no cache key is given.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.func import vmap

from repro_torch.core.allreduce import (
    complete_allreduce,
    hierarchical_allreduce,
    mesh_allreduce,
    partial_allreduce,
    server_allreduce,
)
from repro_torch.core.topology import Topology
from repro_torch.launch.mesh import (
    axis_group,
    axis_index,
    axis_names,
    axis_sizes,
    batch_axes,
    make_multipod_mesh,
    make_node_mesh,
    mesh_device,
)
from repro_torch.sharding.rules import current_mesh_context
from repro_torch.telemetry import trace as _trace
from repro_torch.utils.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten

PyTree = Any

# ----------------------------------------------------------------------------
# Ambient execution context + the primitive set
# ----------------------------------------------------------------------------

_ctx = threading.local()


class ExecContext(NamedTuple):
    """Placement installed by a running mesh executor."""

    node_axis: Any  # the mesh axes carrying nodes (a tuple); None = stacked
    num_shards: int  # how many ranks the node axis is split over
    #: reduction topology ``aggregate`` stages through
    topology: Any = None
    #: logical nodes hosted per rank (K / num_shards)
    nodes_per_shard: int | None = None
    #: stage the innermost hop as reduce-scatter → outer hops → all-gather
    reduce_scatter: bool = False
    #: this rank's linear index along the node axes (row-major)
    shard: int = 0
    #: this rank's coordinate along each node axis
    axis_coords: tuple = ()
    #: one process group per topology hop, innermost first (None: a
    #: world of one, the collective is the identity)
    hop_groups: tuple = ()
    #: the joint group over every node axis
    node_group: Any = None


def current_exec_context() -> ExecContext | None:
    return getattr(_ctx, "value", None)


@contextmanager
def executing(ctx: ExecContext | None):
    prev = current_exec_context()
    _ctx.value = ctx
    try:
        yield
    finally:
        _ctx.value = prev


def _placed() -> ExecContext | None:
    ctx = current_exec_context()
    return None if ctx is None or ctx.node_axis is None else ctx


def node_axis():
    """The mesh axis name(s) carrying the node dimension, or None when the
    nodes are stacked locally."""
    ctx = current_exec_context()
    return None if ctx is None else ctx.node_axis


def num_node_shards() -> int:
    """How many ranks the node axis is split over (1 locally).  Strategies
    that derive per-node weights from ``data.shape[0]`` multiply by it."""
    ctx = current_exec_context()
    return 1 if ctx is None else ctx.num_shards


def node_shard_index() -> int:
    """This rank's linear index along the node axes (0 locally), so a
    strategy on replicated data finds the global nodes it owns
    (``shard * K_local + arange(K_local)``)."""
    ctx = _placed()
    return 0 if ctx is None else ctx.shard


def node_global_index(k_local):
    """Global index of rank-local node ``k_local`` (the identity locally):
    server strategies that index replicated per-node structures — a pooled
    θ slot block, per-node generators — find the global position with it
    while reading their data at the local index (the k-windows strategy)."""
    ctx = _placed()
    if ctx is None:
        return k_local
    return ctx.shard * ctx.nodes_per_shard + k_local


def local_rows(x):
    """This rank's rows of a replicated leading-node-axis array (all of it
    locally): a fault plan's global (K,) masks, cut to the rank's nodes so
    the masked aggregate does not depend on the placement."""
    ctx = _placed()
    if ctx is None:
        return x
    kl = ctx.nodes_per_shard
    return x[ctx.shard * kl:(ctx.shard + 1) * kl]


def local_node(k):
    """``(k_local, mine)`` for global node ``k``: ``mine`` is True on
    exactly the rank that hosts it, ``k_local`` its index in the rank's
    slice (clamped into range elsewhere).  ``(k, True)`` locally."""
    ctx = _placed()
    if ctx is None:
        return k, True
    kl = ctx.nodes_per_shard
    off = int(k) - ctx.shard * kl
    return min(max(off, 0), kl - 1), 0 <= off < kl


def from_owner(tree: PyTree, mine) -> PyTree:
    """Hand the owning rank's ``tree`` to every rank (the identity
    locally): the owner's value plus zeros from the others, one sum — exact
    in floating point.  Every rank passes a tree of the same structure."""
    ctx = _placed()
    if ctx is None:
        return tree

    def sel(x):
        if x.dtype == torch.bool:
            return mesh_allreduce(x if mine else torch.zeros_like(x), ctx.node_group, "any")
        return mesh_allreduce(x if mine else torch.zeros_like(x), ctx.node_group)

    return tree_map(sel, tree)


def commit_owner(new: PyTree, old: PyTree, mine) -> PyTree:
    """Commit a rank-local state update on the owner only (``new``
    locally): per-node wire state stays right under a mesh-placed server
    transport."""
    ctx = _placed()
    if ctx is None or mine:
        return new
    return old


def aggregate(stacked: PyTree, op: str = "sum") -> PyTree:
    """Reduce per-node messages over the node axis wherever it lives: the
    rank's stacked axis 0, then — under a mesh placement — the collectives
    staged hop by hop through the ambient ``Topology``.  Locally this IS
    ``server_allreduce``."""
    reduced = server_allreduce(stacked, op=op)
    ctx = _placed()
    if ctx is not None:
        reduced = hierarchical_allreduce(reduced, ctx.hop_groups, op=op,
                                         reduce_scatter=ctx.reduce_scatter)
    return reduced


def aggregate_partial(stacked: PyTree, op: str = "sum") -> PyTree:
    """First half of the overlap split of ``aggregate``: the rank's stack
    sum plus every hop but the outermost.  Sum only: a mean's final divide
    cannot move across rounds bitwise."""
    if op != "sum":
        raise ValueError(
            f"aggregate_partial only supports op='sum' (got {op!r}) — the "
            "overlap split defers the outermost hop, and a mean's final "
            "divide cannot move across rounds bit-exactly"
        )
    reduced = server_allreduce(stacked, op="sum")
    ctx = _placed()
    if ctx is not None:
        reduced = partial_allreduce(reduced, ctx.hop_groups)
    return reduced


def aggregate_complete(pending: PyTree, *, async_op: bool = False):
    """Second half of the overlap split: the outermost hop's sum over an
    ``aggregate_partial`` result.  With ``async_op`` a
    ``core.allreduce.PendingSum`` whose ``wait()`` gives the tree; the
    identity (already complete) locally."""
    ctx = _placed()
    if ctx is None:
        return complete_allreduce(pending, (None,), async_op=async_op)
    return complete_allreduce(pending, ctx.hop_groups, async_op=async_op)


def mask_to_root(tree: PyTree) -> PyTree:
    """Zero ``tree`` except on the ranks at index 0 of the outermost hop's
    axes: a complete (replicated) value becomes valid
    ``aggregate_complete`` input, since the completing sum adds one copy
    and zeros.  The identity locally."""
    ctx = _placed()
    if ctx is None:
        return tree
    outer = ctx.topology.hops[-1].axes
    coords = dict(zip(ctx.node_axis, ctx.axis_coords))
    keep = all(coords[a] == 0 for a in outer)
    return tree if keep else tree_map(torch.zeros_like, tree)


def broadcast(tree: PyTree) -> PyTree:
    """Phase 2 of the §3.1 two-step protocol: the aggregate is already
    replicated under every placement, so this is the identity (it marks
    the downlink)."""
    return tree


class StatsDeferral:
    """Flags for deferred statistics collectives.

    A round's scalar statistics (``metric_mean``'s mean, ``sum_bytes``'s
    sum) would each be one tiny collective a round.  Both are elementwise
    across rounds, so reducing the stacked (T,) outputs once after the
    loop is bitwise the same.  A transport installs one with ``deferring``
    around its step and completes what got deferred after the loop.  Valid
    only where the statistic call is the outermost operation of its
    expression; strategies that post-process it set ``defer_stats =
    False``."""

    __slots__ = ("metric", "bytes")

    def __init__(self):
        self.metric = False
        self.bytes = False


_defer = threading.local()


@contextmanager
def deferring(stats: StatsDeferral | None):
    """Route ``metric_mean`` / ``sum_bytes`` into deferred mode: they record
    the need on ``stats`` and return their input unchanged."""
    prev = getattr(_defer, "value", None)
    _defer.value = stats
    try:
        yield
    finally:
        _defer.value = prev


def metric_mean(x: PyTree) -> PyTree:
    """Complete a node-mean statistic across ranks (a mean collective);
    the identity locally."""
    ctx = _placed()
    if ctx is None:
        return x
    stats = getattr(_defer, "value", None)
    if stats is not None:
        stats.metric = True
        return x
    return mesh_allreduce(x, ctx.node_group, "mean")


def sum_bytes(x):
    """Total a rank-local byte count across ranks; the identity locally."""
    ctx = _placed()
    if ctx is None:
        return x
    stats = getattr(_defer, "value", None)
    if stats is not None:
        stats.bytes = True
        return x
    return mesh_allreduce(x, ctx.node_group, "sum")


# ----------------------------------------------------------------------------
# Loop helpers
# ----------------------------------------------------------------------------


def _stack_trees(trees: list, dim: int = 0):
    """Stack same-structure trees along ``dim`` (tensor leaves; other leaves
    — None, ints — must agree and pass through)."""
    cols = [tree_flatten(t)[0] for t in trees]
    spec = tree_flatten(trees[0])[1]
    leaves = [
        torch.stack(col, dim=dim) if isinstance(col[0], torch.Tensor) else col[0]
        for col in zip(*cols)
    ]
    return tree_unflatten(leaves, spec)


def _unstack_tree(tree, n: int) -> list:
    """The ``n`` slices of ``tree`` along its leading axis (non-tensor leaves
    shared)."""
    leaves, spec = tree_flatten(tree)
    return [
        tree_unflatten([x[s] if isinstance(x, torch.Tensor) else x for x in leaves], spec)
        for s in range(n)
    ]


def _stack_rounds(ys: list, dim: int = 0):
    """Per-round output tuples → one tuple of round-stacked trees (an
    output that is None every round stays None)."""
    if not ys:
        return ys
    return tuple(
        None if ys[0][i] is None else _stack_trees([y[i] for y in ys], dim)
        for i in range(len(ys[0]))
    )


def _run_rounds(step, carry, xs, length: int, enter_loop=None, exit_loop=None):
    if enter_loop is not None:
        carry = enter_loop(carry)
    ys = []
    for t in range(length):
        carry, y = step(carry, xs(t))
        ys.append(y)
    ys = _stack_rounds(ys)
    if exit_loop is not None:
        carry, ys = exit_loop(carry, ys)
    return carry, ys


def _vmapped(fn, in_dims):
    """``torch.func.vmap(fn)`` for functions whose outputs hold non-tensor
    leaves (None, ints) that are the same in every scenario: those pass
    through.  Random draws inside are shared by all scenarios
    (``randomness="same"``): the wires' noise and masks do not depend on
    the scenario."""

    def run(*args):
        box = {}

        def flat(*a):
            leaves, spec = tree_flatten(fn(*a))
            box["spec"] = spec
            box["kinds"] = [x if not isinstance(x, torch.Tensor) else _TENSOR for x in leaves]
            return tuple(x for x in leaves if isinstance(x, torch.Tensor))

        outs = iter(vmap(flat, in_dims=in_dims, randomness="same")(*args))
        leaves = [next(outs) if k is _TENSOR else k for k in box["kinds"]]
        return tree_unflatten(leaves, box["spec"])

    return run


_TENSOR = object()


def scenario_split(x):
    """``(values, level)`` for a tensor batched by an enclosing sweep's
    ``vmap``: its values with the scenario axis first, read outside the
    batch, and the batch's level (for ``scenario_join``).  ``(x, None)``
    for anything else.  Host-side draws keyed on per-scenario state (the
    DP wire's round counters) read their keys through it."""
    from torch._C import _functorch

    if not isinstance(x, torch.Tensor) or not _functorch.is_batchedtensor(x):
        return x, None
    level = _functorch.maybe_get_level(x)
    return _functorch.get_unwrapped(x).movedim(_functorch.maybe_get_bdim(x), 0), level


def scenario_join(x: torch.Tensor, level: int) -> torch.Tensor:
    """Hand ``x`` (scenario axis first) into the batch at ``level``: each
    scenario sees its own slice."""
    from torch._C import _functorch

    return _functorch._add_batch_dim(x, 0, level)


def _as_array(v) -> torch.Tensor:
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    return t.float() if t.dtype == torch.float64 else t


# ----------------------------------------------------------------------------
# Dispatch (the reference's program cache, without a cache)
# ----------------------------------------------------------------------------

#: dispatches since the last ``clear_program_cache``; ``hits`` / ``misses``
#: / ``size`` stay 0 (nothing is compiled, so nothing is cached)
_PROGRAM_CACHE_STATS = {"hits": 0, "misses": 0, "uncached": 0}
_STATS_LOCK = threading.Lock()  # rank threads of one process dispatch at once


def program_cache_stats() -> dict:
    with _STATS_LOCK:
        return {"size": 0, **_PROGRAM_CACHE_STATS}


def clear_program_cache() -> None:
    with _STATS_LOCK:
        for k in _PROGRAM_CACHE_STATS:
            _PROGRAM_CACHE_STATS[k] = 0


def _fence(out) -> None:
    if any(isinstance(x, torch.Tensor) and x.is_cuda for x in tree_leaves(out)):
        torch.cuda.synchronize()


def dispatch(label: str, run, *args):
    """``run(*args)`` — one executor loop — with observability: when a
    tracer is ambient the call is a ``dispatch/<label>`` span tagged
    ``cache="uncached"`` and fenced with ``torch.cuda.synchronize()`` (a
    pure wait: traced dispatch stays bitwise), beside a
    ``program_cache/uncached`` count.  Without a tracer it is ``run(*args)``."""
    with _STATS_LOCK:
        _PROGRAM_CACHE_STATS["uncached"] += 1
    t = _trace.current_tracer()
    if t is None:
        return run(*args)
    t.count("program_cache/uncached")
    with t.span(f"dispatch/{label}", cache="uncached"):
        out = run(*args)
        _fence(out)
    return out


def _walk_schedule(step, carry, schedule):
    """The §5 contact walk: one ``step`` a contact, outputs stacked."""
    ys = []
    for xt in schedule:
        carry, y = step(carry, xt)
        ys.append(y)
    return carry, _stack_rounds(ys)


# ----------------------------------------------------------------------------
# Executors
# ----------------------------------------------------------------------------


class Executor:
    """Owns where a fit's per-round loop runs.

    Transports hand it ``make_carry`` / ``make_step`` factories and the
    per-round inputs; the executor places the loop and installs the
    ambient context the step's primitives resolve against.  Two hooks,
    one per transport family:

    * ``run_update(make_carry, make_step, …)`` — update transports
      (``allreduce`` / ``delay_line``): every round all nodes step, so the
      loop places anywhere (ranks, scenarios, or both).
      ``make_step(shard_data, sweep_delay)`` builds the round's step for
      the node slice placed here; ``xs(t)`` gives round t's input.
    * ``run_server(make_step, schedule, …)`` — server transports: ONE node
      steps per contact.  The local and mesh executors place this; the
      sweep raises.

    Both return ``(carry, ys)``, ``ys`` the per-round outputs stacked
    along the round axis (after the scenario axis under a sweep)."""

    name = "executor"
    #: number of scenarios for batched executors; None = unbatched
    num_scenarios: int | None = None
    #: True when this executor wants a delay-tolerant transport to run the
    #: outermost hop as an asynchronous collective (the mesh ``overlap=``)
    overlap: bool = False

    def swept(self, key: str):
        """The per-scenario values swept for ``key`` (None when not swept)."""
        return None

    def scenario_template(self, tree: PyTree) -> PyTree:
        """One scenario's slice of a possibly scenario-batched tree (for
        byte accounting from shapes)."""
        return tree

    def finalize(self, strategy, theta, state, data):
        return strategy.finalize(theta, state, data)

    def extra_metrics(self) -> dict:
        """Executor-specific entries ``fit`` merges into ``metrics`` (the
        serving executor's live engine)."""
        return {}

    def ledger_hops(self, strategy, data):
        """Per-tier decomposition of the per-round node messages —
        ``[(tier, messages, price_per_byte), ...]`` summing to K — or None
        for flat accounting."""
        return None

    def run_update(self, *, strategy, data, carry, make_carry, make_step, xs, length,
                   wire=None, enter_loop=None, exit_loop=None, sweep_targets=()):
        raise NotImplementedError

    def run_server(self, *, strategy, data, carry, make_step, schedule, wire=None):
        raise ValueError(
            "server transports walk one contact schedule sequentially — "
            f"executor {self.name!r} cannot place them; use "
            "executor='local' (or 'mesh'/'multipod' to run each contact's "
            "local_step on the shard owning the contacted node)"
        )


class LocalExecutor(Executor):
    """K logical nodes stacked on one device, one Python loop over rounds::

        res = api.fit(strategy, data, transport="allreduce", steps=100,
                      executor="local", device="cuda")
    """

    name = "local"

    def run_update(self, *, strategy, data, carry, make_carry, make_step, xs, length,
                   wire=None, enter_loop=None, exit_loop=None, sweep_targets=()):
        if carry is None:
            carry = make_carry()
        return dispatch(f"{self.name}-update", _run_rounds, make_step(data, None), carry, xs,
                        length, enter_loop, exit_loop)

    def run_server(self, *, strategy, data, carry, make_step, schedule, wire=None):
        return dispatch(f"{self.name}-server", _walk_schedule, make_step(data), carry,
                        schedule)


class ServingExecutor(LocalExecutor):
    """Train exactly like ``local``, then stand the finalized model up
    behind a ``repro_torch.serve.ServeEngine`` — the train → serve executor
    swap.  ``fit(..., executor="serve")`` returns a ``FitResult`` whose
    ``metrics["serve_engine"]`` already answers requests (and, with
    ``registry=`` / ``publish_as=``, has been published first)::

        res = api.fit(strategy, data, transport="allreduce", steps=400,
                      executor=api.ServingExecutor(), device="cuda")
        y = res.metrics["serve_engine"].predict(Xq)

    ``mesh=`` places the engine's θ on that mesh (``ServeEngine(mesh=)``);
    other keywords go to the engine."""

    name = "serve"

    def __init__(self, *, mesh=None, registry=None, publish_as: str | None = None,
                 **engine_kw):
        if (registry is None) != (publish_as is None):
            raise ValueError("publishing needs both registry= and publish_as=")
        self._mesh = mesh
        self._registry = registry
        self._publish_as = publish_as
        self._engine_kw = engine_kw
        self.engine = None

    def finalize(self, strategy, theta, state, data):
        from repro_torch.serve.engine import ServeEngine

        final = super().finalize(strategy, theta, state, data)
        if self._registry is not None:
            self._registry.publish(self._publish_as, final)
        self.engine = ServeEngine(strategy, final, mesh=self._mesh, **self._engine_kw)
        return final

    def extra_metrics(self) -> dict:
        return {} if self.engine is None else {"serve_engine": self.engine}


class ResolvedPlacement(NamedTuple):
    """A mesh executor's resolved placement."""

    mesh: Any
    axes: tuple  # ordered node axes
    num_shards: int
    topology: Topology


def _rows_of(tree, shard: int, kl: int, dim: int = 0):
    return tree_map(lambda x: x.narrow(dim, shard * kl, kl), tree)


def _gather_rows(tree, ctx: ExecContext, device: torch.device, dim: int = 0):
    """Reassemble per-rank rows (along ``dim``) into the global layout on
    every rank, in shard order."""
    group = ctx.node_group
    if group is None:
        return tree
    if dist.get_rank(group) != ctx.shard:
        raise RuntimeError(
            "the node axes' process group orders ranks unlike the mesh "
            f"(group rank {dist.get_rank(group)}, shard {ctx.shard})")
    n = dist.get_world_size(group)

    def gather(x):
        y = x.to(device).contiguous()
        parts = [torch.empty_like(y) for _ in range(n)]
        dist.all_gather(parts, y, group=group)
        return torch.cat(parts, dim=dim).to(x.device)

    return tree_map(gather, tree)


class MeshExecutor(Executor):
    """Place the K nodes on the data axis of a ``torch.distributed`` mesh.

    Update transports run their whole loop on every rank: each rank holds
    K/ranks nodes of the data (and the wire's per-node state, e.g. EF
    residuals), θ and the strategy state stay replicated, and
    ``aggregate`` completes the rank's partial sums with collectives over
    the axis groups, staged hop by hop through the mesh's ``Topology``
    (a 1-D mesh is one collective).  The wire encodes per rank.  Server
    transports place too (``run_server``).  A ``SweepExecutor(...,
    inner=MeshExecutor(...))`` runs its scenario batch inside each rank's
    loop through ``place_update``::

        res = api.fit(strategy, data, transport="allreduce", steps=100,
                      executor="mesh", device="cpu")   # every rank calls it

    Strategies with ``replicate_data=True`` (the cascade SVM) get the
    whole data on every rank and find their nodes from
    ``node_shard_index()``.  The mesh: ``mesh=`` if given, else the active
    ``sharding.rules.MeshContext``'s, else a 1-D ``("data",)`` mesh over
    the world (``launch.mesh.make_node_mesh``).

    ``reduce_scatter``: ``"auto"`` is off (the reference turns it on only
    on a TPU), ``True`` stages the innermost hop as reduce-scatter →
    all-gather.  ``overlap``: delay-tolerant transports run the outermost
    hop as an asynchronous collective, waited on where the delay line reads
    it.  Both change no bit of a fit."""

    name = "mesh"

    def __init__(self, mesh=None, *, reduce_scatter: bool | str = "auto",
                 overlap: bool = True):
        self._mesh = mesh
        self.reduce_scatter = reduce_scatter
        self.overlap = bool(overlap)

    def _rs_active(self) -> bool:
        if self.reduce_scatter == "auto":
            return False
        return bool(self.reduce_scatter)

    def _default_mesh(self):
        return make_node_mesh()

    def _topology(self, axes, mesh) -> Topology:
        return Topology.from_mesh(axes)

    def _validate_mesh(self, mesh) -> None:
        pass

    def resolve(self) -> ResolvedPlacement:
        """The mesh and node axes: ``mesh=`` if given, else the active
        ``sharding.rules.MeshContext``'s mesh and node axes, else the
        default mesh over the world."""
        mesh, axes = self._mesh, None
        if mesh is None:
            mc = current_mesh_context()
            if mc is not None:
                mesh, axes = mc.mesh, mc.node_axes
            else:
                mesh = self._default_mesh()
        self._validate_mesh(mesh)
        if axes is None:
            axes = batch_axes(mesh)
        if not axes:
            raise ValueError(
                f"mesh {mesh} has no 'data'/'pod' axis to place nodes on")
        topology = self._topology(axes, mesh)
        sizes = axis_sizes(mesh)
        ndev = 1
        for a in axes:
            ndev *= sizes[a]
        return ResolvedPlacement(mesh=mesh, axes=axes, num_shards=ndev, topology=topology)

    def _placement_context(self, r: ResolvedPlacement, K: int) -> ExecContext:
        sizes = axis_sizes(r.mesh)
        coords = tuple(axis_index(r.mesh, a) for a in r.axes)
        shard = 0
        for a, c in zip(r.axes, coords):
            shard = shard * sizes[a] + c
        return ExecContext(
            node_axis=r.axes, num_shards=r.num_shards, topology=r.topology,
            nodes_per_shard=K // r.num_shards, reduce_scatter=self._rs_active(),
            shard=shard, axis_coords=coords,
            hop_groups=tuple(axis_group(r.mesh, h.axes) for h in r.topology.hops),
            node_group=axis_group(r.mesh, r.axes),
        )

    def _check_divisible(self, K: int, ndev: int) -> None:
        if K % ndev != 0:
            raise ValueError(f"{K} nodes cannot be placed evenly on {ndev} mesh shards")

    def place_update(self, *, strategy, data, carry, body, scenario_axis: bool = False):
        """Run an update-family loop ``body(carry, shard_data)`` on this rank
        with the placement context installed: the data cut to the rank's
        nodes (whole for ``replicate_data`` strategies), the wire state
        (carry[2]) to its rows — on axis 1 when a sweep composes with this
        placement (``scenario_axis``) — and reassembled after."""
        from repro_torch.api.strategy import Strategy

        r = self.resolve()
        if data is None:
            raise ValueError(
                "mesh executor needs data with a leading node axis to shard")
        if not strategy.stacked_msgs:
            raise ValueError(
                "mesh executor needs per-node stacked messages "
                "(strategy.stacked_msgs=True)")
        if type(strategy).aggregate is not Strategy.aggregate:
            raise NotImplementedError(
                f"{type(strategy).__name__} overrides aggregate(); the mesh "
                "executor only places op-based reductions (set aggregate_op "
                "to 'sum'/'mean'/'max'/'any' instead)")
        K = strategy.num_nodes(data)
        self._check_divisible(K, r.num_shards)
        ctx = self._placement_context(r, K)
        kl, wdim = ctx.nodes_per_shard, (1 if scenario_axis else 0)
        shard_data = data if strategy.replicate_data else _rows_of(data, ctx.shard, kl)
        theta, sstate, wstate, delay = carry
        wstate = _rows_of(wstate, ctx.shard, kl, wdim)
        with executing(ctx):
            (theta, sstate, wstate, delay), ys = dispatch(
                f"{self.name}-update", body, (theta, sstate, wstate, delay), shard_data)
        wstate = _gather_rows(wstate, ctx, mesh_device(r.mesh), wdim)
        return (theta, sstate, wstate, delay), ys

    def run_update(self, *, strategy, data, carry, make_carry, make_step, xs, length,
                   wire=None, enter_loop=None, exit_loop=None, sweep_targets=()):
        if carry is None:
            carry = make_carry()

        def body(c, d):
            return _run_rounds(make_step(d, None), c, xs, length, enter_loop, exit_loop)

        return self.place_update(strategy=strategy, data=data, carry=carry, body=body)

    def run_server(self, *, strategy, data, carry, make_step, schedule, wire=None):
        """Place the §5 sequential schedule: the data shards over the node
        axis, each contact's ``local_step`` runs on the rank that owns the
        contacted node (``local_node``), and ``from_owner`` hands its push
        to every rank — bitwise the local walk, because adding the other
        ranks' zeros is exact.  The strategy state stays replicated: a
        ``local_step`` must pass it through or update it the same way on
        every rank (true of every server strategy here; per-node state
        belongs in the wire state, which shards with its node)."""
        if data is None:
            raise ValueError(
                "mesh-placed server transports need data with a leading "
                "node axis to shard; closure-based strategies "
                "(FunctionStrategy over captured data) run executor='local'")
        if strategy.replicate_data:
            raise ValueError(
                f"{type(strategy).__name__} declares replicate_data=True — "
                "its contacts read the whole dataset, so there is nothing "
                "to place; use executor='local' for server transports")
        r = self.resolve()
        K = strategy.num_nodes(data)
        self._check_divisible(K, r.num_shards)
        ctx = self._placement_context(r, K)
        kl = ctx.nodes_per_shard
        server, sstate, wstate = carry
        wstate = _rows_of(wstate, ctx.shard, kl)
        with executing(ctx):
            (server, sstate, wstate), ys = dispatch(
                f"{self.name}-server", _walk_schedule,
                make_step(_rows_of(data, ctx.shard, kl)), (server, sstate, wstate), schedule)
        wstate = _gather_rows(wstate, ctx, mesh_device(r.mesh))
        return (server, sstate, wstate), ys


class MultiPodExecutor(MeshExecutor):
    """The production placement: nodes on ``("pod", "data")`` of a
    multipod mesh, the ledger decomposed by reduction tier.

    The loop is ``MeshExecutor``'s on the same mesh — both stage the
    reduction intra-pod first and inter-pod last through the mesh's
    ``Topology`` — so θ is bitwise ``executor="mesh"``'s.  What changes is
    the accounting: ``ledger_hops`` attributes the per-round messages to
    tiers (K − P intra-pod pushes, P inter-pod root pushes for P pods),
    each priced per byte, so ``ledger.summary()["by_hop"]`` reports the
    cheap-vs-expensive split.  ``calibrate=True`` measures the prices on
    the mesh (``core.topology.calibrate_prices``); explicit
    ``intra_price`` / ``inter_price`` win over it.  The mesh: ``mesh=`` if
    given, else the active ``sharding.rules.MeshContext``'s, else
    ``launch.mesh.make_multipod_mesh()`` over the world."""

    name = "multipod"

    def __init__(self, mesh=None, *, intra_price: float | None = None,
                 inter_price: float | None = None, calibrate: bool = False,
                 reduce_scatter: bool | str = "auto", overlap: bool = True):
        super().__init__(mesh, reduce_scatter=reduce_scatter, overlap=overlap)
        self._intra_price = intra_price
        self._inter_price = inter_price
        self._calibrate = calibrate

    def _default_mesh(self):
        return make_multipod_mesh()

    def _topology(self, axes, mesh) -> Topology:
        intra_p, inter_p = self._intra_price, self._inter_price
        if self._calibrate:
            from repro_torch.core.topology import calibrate_prices

            prices = calibrate_prices(mesh)
            if intra_p is None:
                intra_p = prices["intra_pod"]
            if inter_p is None:
                inter_p = prices["inter_pod"]
        return Topology.from_mesh(axes, intra_price=intra_p, inter_price=inter_p)

    def _validate_mesh(self, mesh) -> None:
        if "pod" not in axis_names(mesh):
            raise ValueError(
                f"multipod executor needs a mesh with a 'pod' axis, got "
                f"axes {axis_names(mesh)} — build one with "
                "launch.mesh.make_multipod_mesh()")

    def ledger_hops(self, strategy, data):
        r = self.resolve()
        return r.topology.hop_messages(strategy.num_nodes(data), axis_sizes(r.mesh))


class SweepExecutor(Executor):
    """Batch S scenarios with ``torch.func.vmap`` over each round's step.

    ``params`` maps names to length-S values (lists, numpy arrays or
    tensors; a pytree for ``theta0``):

    * a strategy attribute (``"lr"``, ``"l2"``, …) — rebound to the
      scenario's value while the step runs, so any scalar hyperparameter a
      strategy reads from ``self`` sweeps without the strategy knowing;
    * a wire attribute (names the strategy lacks are looked up on the
      wire, then on the fault plan and a chain's stages) — the threshold
      wire's ``"tau"``, the DP wire's ``"dp_sigma"`` / ``"dp_clip"``, the
      plan's ``"dropout_p"`` (its masks become tensors);
    * ``"staleness"`` — one delay line of depth max D, read at each
      scenario's own index (``core.staleness.delay_push_read``);
    * ``"theta0"`` — an (S, …)-batched initial parameter.

    Every round runs ONCE for all S scenarios: a per-node matrix-vector
    product becomes one product with S columns, and the wire kernels (custom
    ops with a ``vmap`` rule) launch once on S·K rows.  Random draws inside
    the step (DP noise, secagg masks) are shared by the scenarios, as their
    streams do not depend on the scenario.  A strategy that cannot run
    under ``vmap`` declares ``vmappable = False`` (``OptimizerStrategy``,
    whose gradient is ``torch.autograd.grad``): its scenarios then run in
    turn inside each round.

    ``inner=`` composes with a mesh placement (``"mesh+sweep"`` /
    ``"multipod+sweep"``): each rank runs the scenario batch on its nodes,
    and each collective carries all S scenarios in one launch::

        sw = api.SweepExecutor({"lr": [0.02, 0.1]}, inner=api.MeshExecutor())
        res = api.fit(strategy, data, transport="allreduce", steps=200,
                      executor=sw, device="cpu")

    ``FitResult.theta`` / ``.trajectory`` / ``metrics["carry"]`` gain a
    leading S axis (the carry resumes a later sweep of the same shape), and
    ``ledger`` is a list of S ``CommLedger``s (with the multipod inner's
    per-hop split in each)."""

    name = "sweep"
    RESERVED = ("staleness", "theta0")

    def __init__(self, params: dict, *, inner: "Executor | str | None" = None):
        if not params:
            raise ValueError("sweep executor needs at least one swept parameter")
        # a list or array is one swept value a scenario; a dict (a pytree
        # θ0) holds one batched array a leaf.  float64 becomes float32, as
        # jnp.asarray makes it in the reference
        self.params = {
            k: tree_map(_as_array, v) if isinstance(v, dict) else _as_array(v)
            for k, v in params.items()
        }
        counts = {}
        for k, v in self.params.items():
            leaves = tree_leaves(v)
            if not leaves:
                raise ValueError(f"swept parameter {k!r} has no array leaves")
            per_leaf = {int(leaf.shape[0]) for leaf in leaves}
            if len(per_leaf) != 1:
                raise ValueError(
                    f"swept parameter {k!r} leaves disagree on scenario count")
            counts[k] = per_leaf.pop()
        if len(set(counts.values())) != 1:
            raise ValueError(f"swept parameters disagree on scenario count: {counts}")
        self.num_scenarios = next(iter(counts.values()))
        if inner is not None and not isinstance(inner, Executor):
            inner = make_executor(inner)
        if isinstance(inner, SweepExecutor):
            raise ValueError(
                f"sweep cannot nest a {inner.name!r} executor — inner= "
                "takes a mesh placement (MeshExecutor/MultiPodExecutor) "
                "or None/local")
        if isinstance(inner, LocalExecutor):
            inner = None  # a local inner is the plain sweep
        if inner is not None and not isinstance(inner, MeshExecutor):
            raise ValueError(
                f"unsupported sweep inner executor {inner.name!r} — use "
                "MeshExecutor/MultiPodExecutor (or None for the local vmap)")
        self.inner = inner
        if inner is not None:
            self.name = f"{inner.name}+sweep"

    def swept(self, key: str):
        return self.params.get(key)

    def scenario_template(self, tree: PyTree) -> PyTree:
        return tree_map(lambda x: x[0], tree)

    def finalize(self, strategy, theta, state, data):
        from repro_torch.api.strategy import Strategy

        if type(strategy).finalize is Strategy.finalize:
            return theta
        S = self.num_scenarios
        return _stack_trees([
            strategy.finalize(th, st, data)
            for th, st in zip(_unstack_tree(theta, S), _unstack_tree(state, S))
        ])

    def ledger_hops(self, strategy, data):
        # a multipod inner keeps its per-hop pricing, for every scenario
        return None if self.inner is None else self.inner.ledger_hops(strategy, data)

    def _resolve_targets(self, strategy, wire, extra=()):
        attrs = {k: v for k, v in self.params.items() if k not in self.RESERVED}
        targets = {}
        for k in attrs:
            if hasattr(strategy, k):
                targets[k] = strategy
            elif wire is not None and hasattr(wire, k):
                targets[k] = wire
            else:
                for obj in extra:
                    if obj is not None and hasattr(obj, k):
                        targets[k] = obj
                        break
                else:
                    raise ValueError(
                        f"swept parameter {k!r} is not an attribute of "
                        f"{type(strategy).__name__}, the wire, or the fault "
                        f"plan (reserved keys: {self.RESERVED})")
        return attrs, targets

    @staticmethod
    @contextmanager
    def _rebound(targets, vals):
        """Rebind swept attributes for the duration of one step (the saved
        values are restored after)."""
        saved = {k: getattr(targets[k], k) for k in vals}
        try:
            for k, v in vals.items():
                setattr(targets[k], k, v)
            yield
        finally:
            for k, v in saved.items():
                setattr(targets[k], k, v)

    def run_update(self, *, strategy, data, carry, make_carry, make_step, xs, length,
                   wire=None, enter_loop=None, exit_loop=None, sweep_targets=()):
        # enter_loop is the overlap hook: a sweep never turns overlap on
        # (Executor.overlap stays False), so only exit_loop is threaded.
        # The swept values are on the fit's device (``fit`` moves them).
        attrs, targets = self._resolve_targets(strategy, wire, sweep_targets)
        S = self.num_scenarios
        stal = self.params.get("staleness")
        theta0s = self.params.get("theta0")

        def vals_of(s):
            return {k: v[s] for k, v in attrs.items()}

        if carry is None:
            # each scenario's start, built as a solo fit builds it
            if attrs or theta0s is not None:
                starts = []
                for s in range(S):
                    with self._rebound(targets, vals_of(s)):
                        starts.append(make_carry() if theta0s is None else make_carry(
                            theta0=tree_map(lambda x: x[s], theta0s)))
                carry = _stack_trees(starts)
            else:  # only "staleness" swept: every scenario starts alike
                c0 = make_carry()
                carry = tree_map(
                    lambda x: x.unsqueeze(0).expand((S,) + tuple(x.shape)).clone()
                    if isinstance(x, torch.Tensor) else x, c0)

        if getattr(strategy, "vmappable", True):

            def body(c, d):
                def one(vals, st, c1, xt):
                    with self._rebound(targets, vals):
                        return make_step(d, st)(c1, xt)

                vstep = _vmapped(one, ({k: 0 for k in attrs},
                                       None if stal is None else 0, 0, None))
                ys = []
                for t in range(length):
                    c, y = vstep(attrs, stal, c, xs(t))
                    ys.append(y)
                ys = _stack_rounds(ys, dim=1)
                if exit_loop is not None:
                    c, ys = exit_loop(c, ys)
                return c, ys
        else:

            def body(c, d):
                # in turn: each scenario's step alone, inside every round
                cs = _unstack_tree(c, S)
                ys = []
                for t in range(length):
                    xt = xs(t)
                    yt = []
                    for s in range(S):
                        with self._rebound(targets, vals_of(s)):
                            st = None if stal is None else int(stal[s])
                            cs[s], y = make_step(d, st)(cs[s], xt)
                        yt.append(y)
                    ys.append(_stack_rounds(yt))
                ys = _stack_rounds(ys, dim=1)
                c = _stack_trees(cs)
                if exit_loop is not None:
                    c, ys = exit_loop(c, ys)
                return c, ys

        if self.inner is None:
            return dispatch(f"{self.name}-update", body, carry, data)
        return self.inner.place_update(strategy=strategy, data=data, carry=carry,
                                       body=body, scenario_axis=True)

    def run_server(self, *, strategy, data, carry, make_step, schedule, wire=None):
        raise ValueError(
            "server transports walk one contact schedule sequentially — "
            "the sweep executor cannot batch them; use executor='local' "
            "(or 'mesh'/'multipod' for shard placement)"
        )


EXECUTORS = ("local", "mesh", "multipod", "sweep", "serve")
#: composed spec strings: the sweep's scenario batch inside a mesh placement
COMPOSED_EXECUTORS = ("mesh+sweep", "multipod+sweep")


def make_executor(spec, sweep_params: dict | None = None) -> Executor:
    """Resolve an executor spec: an ``Executor`` instance, ``None`` /
    ``"local"``, ``"mesh"``, ``"multipod"``, ``"sweep"`` or a composed
    ``"mesh+sweep"`` / ``"multipod+sweep"``.  The sweep specs take their
    scenario values as ``sweep_params`` (what ``fit``'s ``sweep=``
    forwards)::

        make_executor("mesh+sweep", {"lr": [0.02, 0.1]})
        # ≡ SweepExecutor({"lr": ...}, inner=MeshExecutor())

    ``"serve"`` is a ``ServingExecutor`` (local fit, the finalized model
    handed to a ``ServeEngine``)."""
    if isinstance(spec, Executor):
        if sweep_params is not None:
            raise ValueError(
                "sweep= only applies to string executor specs — configure "
                "SweepExecutor(params, inner=...) directly instead")
        return spec
    parts = tuple((spec or "local").split("+"))
    if "sweep" in parts:
        inner_parts = tuple(p for p in parts if p != "sweep")
        if len(inner_parts) + 1 != len(parts) or inner_parts not in (
            (), ("local",), ("mesh",), ("multipod",)
        ):
            raise ValueError(
                f"unknown executor {spec!r} — sweep composes as {COMPOSED_EXECUTORS}")
        if sweep_params is None:
            raise ValueError(
                "the sweep executor needs scenario parameters — pass "
                "fit(..., sweep={'lr': [...], ...}) alongside the spec "
                "string, or a configured api.SweepExecutor({...})")
        return SweepExecutor(sweep_params, inner=inner_parts[0] if inner_parts else None)
    if sweep_params is not None:
        base = spec or "local"
        hint = (
            f"executor='{base}+sweep' (or 'sweep')"
            if base in ("local", "mesh", "multipod")
            else f"one of {COMPOSED_EXECUTORS} or 'sweep'"
        )
        raise ValueError(f"sweep= scenario parameters need a sweep executor — {hint}")
    if spec is None or spec == "local":
        return LocalExecutor()
    if spec == "mesh":
        return MeshExecutor()
    if spec == "multipod":
        return MultiPodExecutor()
    if spec == "serve":
        return ServingExecutor()
    raise ValueError(f"unknown executor {spec!r} — one of {EXECUTORS}")
