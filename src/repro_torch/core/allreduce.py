"""Allreduce primitives + byte-accurate communication accounting (port of
``repro.core.allreduce``).

The paper (§3.1) observes that the MPI ``Allreduce`` used by [47] and [5]
"can be simulated by a two step communication with a central server".
Both forms are here:

* ``server_allreduce`` — the two-phase simulation over a leading node axis
  of K logical nodes on one device (the local executor);
* ``psum_allreduce`` / ``pmean_allreduce`` / ``mesh_allreduce`` — the
  native collective over a ``torch.distributed`` process group (the mesh
  executors: gloo on the CPU, NCCL on the card), with the same ``op``
  vocabulary;
* ``hierarchical_allreduce`` — one staged collective per reduction hop of a
  ``core.topology.Topology`` (intra-pod first, inter-pod last), optionally
  with the innermost hop as reduce-scatter → outer hops → all-gather; and
  ``partial_allreduce`` / ``complete_allreduce``, its two halves for the
  comm/compute overlap (the outer half can run as an ``async_op``
  collective).

Where the reference names mesh axes, these functions take the axes'
process groups, one per hop, innermost first; a group of None (a world of
one with no process group, ``launch.mesh.SoloMesh``) is the identity.
Every collective goes through one custom op, ``repro_torch::staged_reduce``,
whose ``vmap`` rule moves the scenario axis into the tensor, so a sweep's S
scenarios ride ONE collective (``torch.distributed.all_reduce`` itself has
no batching rule).

``CommLedger`` counts bytes under the paper's client-server cost model,
optionally decomposed by reduction tier.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.utils.tree import tree_bytes, tree_flatten, tree_map, tree_unflatten

PyTree = Any

#: process groups by the name the custom op carries them under
_GROUPS: dict = {}


def _group_name(group) -> str:
    name = f"pg{id(group)}"
    _GROUPS[name] = group  # held here, so the id is never reused
    return name


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


@torch.library.custom_op("repro_torch::staged_reduce", mutates_args=())
def _staged_reduce(x: torch.Tensor, groups: str, op: str, scatter: bool) -> torch.Tensor:
    """``x`` reduced over each of ``groups`` (registered names, comma
    separated) in turn, innermost first; a new tensor.  ``scatter`` stages the first group as reduce-scatter →
    the other groups → all-gather where x's leading axis tiles over it;
    each element then sees the same additions in the same order."""
    y = x.contiguous().clone()
    gs = [_GROUPS[g] for g in groups.split(",")]
    n = dist.get_world_size(gs[0])
    if scatter and op == "sum" and n > 1 and y.dim() >= 1 and y.shape[0] % n == 0:
        part = torch.empty((y.shape[0] // n,) + tuple(y.shape[1:]), dtype=y.dtype,
                           device=y.device)
        dist.reduce_scatter_tensor(part, y, op=dist.ReduceOp.SUM, group=gs[0])
        for g in gs[1:]:
            dist.all_reduce(part, op=dist.ReduceOp.SUM, group=g)
        parts = [torch.empty_like(part) for _ in range(n)]
        dist.all_gather(parts, part, group=gs[0])
        return torch.cat(parts)
    for g in gs:
        dist.all_reduce(y, op=_REDUCE_OPS[op], group=g)
    return y


@_staged_reduce.register_fake
def _(x, groups, op, scatter):
    return torch.empty_like(x)


def _staged_reduce_vmap(info, in_dims, x, groups, op, scatter):
    # the scenario axis goes INTO the collective: one launch for all S.  A
    # reduce-scatter tiles the scenario's own leading axis, so the batch
    # sits second there
    bd = in_dims[0]
    if bd is None:
        return _staged_reduce(x, groups, op, scatter), None
    if scatter and x.dim() >= 2:
        return _staged_reduce(x.movedim(bd, 1), groups, op, True), 1
    return _staged_reduce(x.movedim(bd, 0), groups, op, False), 0


torch.library.register_vmap("repro_torch::staged_reduce", _staged_reduce_vmap)


def _reduce(x: torch.Tensor, groups, op: str = "sum", scatter: bool = False) -> torch.Tensor:
    names = [_group_name(g) for g in groups if g is not None]
    if not names:
        return x  # a world of one: the identity
    return _staged_reduce(x, ",".join(names), op, scatter)


def psum_allreduce(tree: PyTree, group) -> PyTree:
    """Sum every leaf over the ranks of ``group`` (a ``ProcessGroup``, or
    None for a world of one)."""
    return tree_map(lambda x: _reduce(x, [group]), tree)


def pmean_allreduce(tree: PyTree, group) -> PyTree:
    n = _group_size(group)
    return tree_map(lambda x: _reduce(x, [group]) / n, tree)


def mesh_allreduce(tree: PyTree, group, op: str = "sum") -> PyTree:
    """The native collective with ``server_allreduce``'s ``op`` vocabulary
    — the §3.1 equivalence made literal.  ``op="any"`` is the union of
    boolean masks, a sum of int32s."""
    if op == "sum":
        return psum_allreduce(tree, group)
    if op == "mean":
        return pmean_allreduce(tree, group)
    if op == "max":
        return tree_map(lambda x: _reduce(x, [group], "max"), tree)
    if op == "any":
        return tree_map(lambda x: _reduce(x.to(torch.int32), [group]) > 0, tree)
    raise ValueError(f"unknown op: {op!r}")


def hierarchical_allreduce(tree: PyTree, groups, op: str = "sum", *,
                           reduce_scatter: bool = False) -> PyTree:
    """Topology-aware allreduce: one staged collective per reduction hop.

    ``groups`` holds one process group per hop, innermost (cheapest)
    first.  A single hop over all node axes is exactly ``mesh_allreduce``.
    ``op="mean"`` stages as a sum per hop with ONE final division by the
    total fan-in, so the result does not depend on how the hops split the
    axes.  ``reduce_scatter=True`` restages the innermost hop as
    reduce-scatter → outer hops → all-gather for leaves whose leading axis
    tiles over it (the others take the staged sums)."""
    if op in ("sum", "mean"):
        out = tree_map(lambda x: _reduce(x, groups, "sum", reduce_scatter), tree)
        if op == "mean":
            denom = 1.0
            for g in groups:
                denom *= _group_size(g)
            out = tree_map(lambda x: x / denom, out)
        return out
    for g in groups:
        tree = mesh_allreduce(tree, g, op=op)
    return tree


def partial_allreduce(tree: PyTree, groups) -> PyTree:
    """The synchronous front of an overlapped hierarchical sum: every hop
    but the outermost (on a flat topology none: the whole reduction is
    deferred)."""
    return tree_map(lambda x: _reduce(x, list(groups[:-1])), tree)


class PendingSum:
    """An outermost hop in flight (``complete_allreduce(async_op=True)``):
    ``wait()`` returns the completed tree."""

    def __init__(self, tree: PyTree, works: list):
        self._tree = tree
        self._works = works

    def wait(self) -> PyTree:
        for w in self._works:
            w.wait()
        self._works = []
        return self._tree


def complete_allreduce(tree: PyTree, groups, *, async_op: bool = False):
    """The deferred back half of an overlapped hierarchical sum: the
    outermost hop only.  With ``async_op`` the collective is started and a
    ``PendingSum`` returned, so it runs while the next round's local
    compute is enqueued."""
    group = groups[-1]
    if not async_op:
        return psum_allreduce(tree, group)
    if group is None:
        return PendingSum(tree, [])
    leaves, spec = tree_flatten(tree)
    outs, works = [], []
    for x in leaves:
        y = x.contiguous().clone()
        works.append(dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group, async_op=True))
        outs.append(y)
    return PendingSum(tree_unflatten(outs, spec), works)


def server_allreduce(stacked: PyTree, op: str = "sum") -> PyTree:
    """Two-phase central-server Allreduce over a leading node axis: the
    server receives all K estimates (the stacked layout itself), reduces,
    and every node receives the same global value (one copy here)."""
    if op == "sum":
        return tree_map(lambda x: torch.sum(x, dim=0), stacked)
    if op == "mean":
        return tree_map(lambda x: torch.mean(x, dim=0), stacked)
    if op == "max":
        return tree_map(lambda x: torch.amax(x, dim=0), stacked)
    if op == "any":
        return tree_map(lambda x: torch.any(x, dim=0), stacked)
    raise ValueError(f"unknown op: {op!r}")


@dataclass
class CommLedger:
    """Byte accounting under the paper's strict client-server cost model.

    Totals optionally decompose by reduction tier (``hops``): which link a
    byte crossed, priced per byte per hop.  Tier bytes always sum to the
    undifferentiated flat totals.
    """

    uplink_bytes: int = 0
    downlink_bytes: int = 0
    rounds: int = 0
    events: list = field(default_factory=list)
    #: per-tier attribution: name -> {uplink_bytes, downlink_bytes,
    #: priced_cost}; empty for flat (single-tier) accounting
    hops: dict = field(default_factory=dict)

    def record_allreduce(self, tree: PyTree, num_nodes: int, tag: str = "") -> None:
        """One Allreduce = K pushes of |θ| + K pulls of |θ|."""
        nbytes = tree_bytes(tree)
        self.uplink_bytes += num_nodes * nbytes
        self.downlink_bytes += num_nodes * nbytes
        self.rounds += 1
        self.events.append(("allreduce", tag, num_nodes * nbytes * 2))

    def _hop_add(
        self, hop: str, up: int, down: int, price_per_byte: float = 1.0
    ) -> None:
        bucket = self.hops.setdefault(
            hop, {"uplink_bytes": 0, "downlink_bytes": 0, "priced_cost": 0.0}
        )
        bucket["uplink_bytes"] += up
        bucket["downlink_bytes"] += down
        bucket["priced_cost"] += (up + down) * price_per_byte

    def record_hop(
        self,
        tree: PyTree,
        hop: str,
        fanin: int,
        *,
        price_per_byte: float = 1.0,
        tag: str = "",
    ) -> None:
        """One reduction stage of a hierarchical Allreduce: ``fanin``
        messages of |tree| climb the tier and ``fanin`` copies come back —
        charged to the hop's bucket AND the global totals."""
        nbytes = tree_bytes(tree) * fanin
        self.uplink_bytes += nbytes
        self.downlink_bytes += nbytes
        self._hop_add(hop, nbytes, nbytes, price_per_byte)
        self.events.append(("hop", tag or hop, nbytes * 2))

    def attribute_hops(self, hop_messages) -> None:
        """Decompose the ledger's CURRENT totals across tiers.

        ``hop_messages`` is ``[(tier, messages, price_per_byte), ...]``;
        each tier gets its message-weighted share, the integer remainder
        goes to the outermost hop, so tier bytes sum exactly to the totals.
        """
        total_m = sum(m for _, m, _ in hop_messages)
        if total_m <= 0:
            # legal exactly when there is nothing to attribute (every
            # participant of every round dropped); buckets still appear
            if self.uplink_bytes or self.downlink_bytes:
                raise ValueError(
                    "hop attribution needs a positive message count "
                    f"({self.uplink_bytes}B up / {self.downlink_bytes}B down "
                    "unattributed)"
                )
            for name, _, price in hop_messages:
                self._hop_add(name, 0, 0, price)
            return
        up_rem, down_rem = self.uplink_bytes, self.downlink_bytes
        for i, (name, m, price) in enumerate(hop_messages):
            if i == len(hop_messages) - 1:
                up_h, down_h = up_rem, down_rem
            else:
                up_h = self.uplink_bytes * m // total_m
                down_h = self.downlink_bytes * m // total_m
                up_rem -= up_h
                down_rem -= down_h
            self._hop_add(name, up_h, down_h, price)

    def record_push(self, tree: PyTree, tag: str = "") -> None:
        """One node→server push (the §5 protocol is push+pull per contact)."""
        nbytes = tree_bytes(tree)
        self.uplink_bytes += nbytes
        self.events.append(("push", tag, nbytes))

    def record_pull(self, tree: PyTree, tag: str = "") -> None:
        nbytes = tree_bytes(tree)
        self.downlink_bytes += nbytes
        self.events.append(("pull", tag, nbytes))

    def record_inference(self, request: PyTree, response: PyTree, tag: str = "") -> None:
        """One served batch: clients upload request features, download
        predictions."""
        up = tree_bytes(request)
        down = tree_bytes(response)
        self.uplink_bytes += up
        self.downlink_bytes += down
        self.events.append(("inference", tag, up + down))

    def merge(self, other: "CommLedger") -> None:
        """Fold another ledger's accounting into this one."""
        self.uplink_bytes += other.uplink_bytes
        self.downlink_bytes += other.downlink_bytes
        self.rounds += other.rounds
        self.events.extend(other.events)
        for name, b in other.hops.items():
            bucket = self.hops.setdefault(
                name,
                {"uplink_bytes": 0, "downlink_bytes": 0, "priced_cost": 0.0},
            )
            bucket["uplink_bytes"] += b["uplink_bytes"]
            bucket["downlink_bytes"] += b["downlink_bytes"]
            bucket["priced_cost"] += b["priced_cost"]

    @property
    def total_bytes(self) -> int:
        return self.uplink_bytes + self.downlink_bytes

    def priced_cost(self) -> float:
        """Byte total weighted by per-hop link prices; bytes not attributed
        to any tier are priced at 1.0 (the flat model)."""
        attributed = 0
        cost = 0.0
        for b in self.hops.values():
            attributed += b["uplink_bytes"] + b["downlink_bytes"]
            cost += b["priced_cost"]
        return cost + (self.total_bytes - attributed)

    def summary(self) -> dict:
        def hop_entry(b):
            nbytes = b["uplink_bytes"] + b["downlink_bytes"]
            return {
                "uplink_bytes": b["uplink_bytes"],
                "downlink_bytes": b["downlink_bytes"],
                "total_bytes": nbytes,
                "price_per_byte": b["priced_cost"] / nbytes if nbytes else 1.0,
            }

        return {
            "uplink_bytes": self.uplink_bytes,
            "downlink_bytes": self.downlink_bytes,
            "total_bytes": self.total_bytes,
            "rounds": self.rounds,
            "by_hop": {name: hop_entry(b) for name, b in self.hops.items()},
            "priced_cost": self.priced_cost(),
        }
