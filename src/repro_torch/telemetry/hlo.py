"""Collective-byte accounting and an operation census (port of
``repro.telemetry.hlo``).

The reference parses the per-device HLO text of a compiled program.  The
port compiles nothing, so it records what runs: ``CollectiveRecorder`` is a
``TorchDispatchMode`` that sees every collective as it is dispatched —
the functional collectives ``DTensor`` issues when it redistributes
(``_c10d_functional.*``, ``_dtensor.shard_dim_alltoall``) and the eager
``torch.distributed`` ones (``c10d.allreduce_`` …), on a fake world, on
gloo ranks or on NCCL alike.  Each record holds the kind (the reference's
names: ``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
``collective-permute``), the bytes of this rank's result and the ranks of
its group.  ``collective_stats`` sums them into the reference's keys.

Per-tier attribution: given a rank → pod map (``mesh_pod_map``),
``collective_stats(..., pod_of=...)`` classifies each collective as
``intra_pod`` (its group stays inside one pod) or ``inter_pod`` (it spans
pods); a record without a group lands in ``unattributed``.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
import torch.utils._pytree as pytree

_COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)

#: dispatcher op name → collective kind, and which argument names its group
_KINDS = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
}


@dataclass(frozen=True)
class CollectiveRecord:
    kind: str  # one of _COLLECTIVES
    bytes: int  # this rank's result
    ranks: tuple | None  # the group's ranks (global), None when unknown


def on_dtensor(types) -> bool:
    """Whether a dispatched op has ``DTensor`` arguments: a mode that
    returns ``NotImplemented`` for it lets ``DTensor`` run the op and then
    sees the ops on the local shards."""
    return any(issubclass(t, DTensor) for t in types)


def on_fake(types) -> bool:
    """Whether a dispatched op runs on ``FakeTensor``s: ``DTensor``'s
    sharding propagation runs each new op once on fake tensors of the
    *global* shapes to learn its output's shape, which is no rank's
    work."""
    return any(issubclass(t, FakeTensor) for t in types)


def _op_name(func) -> str:
    return func._schema.name.replace("::", ".")


def _group_ranks(args, kwargs) -> tuple | None:
    """The global ranks of the group a collective names: a group name
    (functional collectives) or a ``ProcessGroup`` (eager ones)."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    for a in list(args) + list(kwargs.values()):
        try:
            if isinstance(a, str):
                pg = _resolve_process_group(a)
            elif isinstance(a, dist.ProcessGroup):
                pg = a
            else:
                continue
            return tuple(dist.get_process_group_ranks(pg))
        except (ValueError, RuntimeError, KeyError):
            continue
    return None


def tensor_bytes(tree) -> int:
    """Bytes of every tensor in ``tree``."""
    return sum(int(t.numel()) * t.element_size()
               for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor))


def _staged_records(args) -> list:
    """The port's staged reduction (``core.allreduce``'s
    ``repro_torch::staged_reduce``, whose collectives run inside one op):
    an all-reduce over each group in turn, or with ``scatter`` a
    reduce-scatter over the first, all-reduces of the part over the rest
    and an all-gather over the first — the sequence it runs."""
    from repro_torch.core.allreduce import _GROUPS

    x, names, op, scatter = args[:4]
    groups = [_GROUPS[g] for g in names.split(",")]
    ranks = [tuple(dist.get_process_group_ranks(g)) for g in groups]
    nbytes = tensor_bytes(x)
    n = len(ranks[0])
    if scatter and op == "sum" and n > 1 and x.dim() >= 1 and x.shape[0] % n == 0:
        part = nbytes // n
        return ([CollectiveRecord("reduce-scatter", part, ranks[0])]
                + [CollectiveRecord("all-reduce", part, r) for r in ranks[1:]]
                + [CollectiveRecord("all-gather", nbytes, ranks[0])])
    return [CollectiveRecord("all-reduce", nbytes, r) for r in ranks]


def collective_records(func, args, kwargs, out) -> list:
    """The records of one dispatched op (none when it is no collective).
    An in-place eager collective's result is its tensor arguments."""
    name = _op_name(func)
    if name == "repro_torch.staged_reduce":
        return _staged_records(args)
    kind = _KINDS.get(name)
    if kind is None:
        return []
    result = out
    if name.startswith("c10d."):
        result = args[1] if kind == "all-gather" and len(args) > 1 else args[0]
    return [CollectiveRecord(kind, tensor_bytes(result), _group_ranks(args, kwargs))]


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective dispatched while it is active.  Ops on a
    tensor subclass (a ``DTensor``) are passed down, so what is recorded is
    each rank's own traffic: the collectives ``DTensor`` issues on the
    local shards.  Ops on fake tensors (``DTensor``'s shape propagation)
    run unrecorded."""

    def __init__(self):
        super().__init__()
        self.records: list[CollectiveRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if on_dtensor(types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not on_fake(types):
            self.record(func, args, kwargs, out)
        return out

    def record(self, func, args, kwargs, out) -> None:
        self.records += collective_records(func, args, kwargs, out)


def mesh_pod_map(mesh, pod_axes=("pod",)) -> dict:
    """Map each rank of ``mesh`` to its pod id, from the mesh axis
    coordinates — the ``pod_of`` input to ``collective_stats``.  Meshes
    without a pod axis map everything to pod 0 (every collective
    classifies as intra_pod)."""
    from repro_torch.launch.mesh import axis_names, axis_sizes

    names = list(axis_names(mesh))
    sizes = axis_sizes(mesh)
    shape = tuple(sizes[a] for a in names)
    n = int(np.prod(shape))
    coords = np.unravel_index(np.arange(n), shape)
    pod = np.zeros(n, dtype=int)
    for a in pod_axes:
        if a in names:
            i = names.index(a)
            pod = pod * shape[i] + coords[i]
    ranks = getattr(mesh, "mesh", None)
    ranks = ranks.reshape(-1).tolist() if ranks is not None else range(n)
    return {int(r): int(p) for r, p in zip(ranks, pod)}


def _classify_groups(groups, pod_of) -> str:
    for grp in groups:
        pods = {pod_of.get(d, d) for d in grp}
        if len(pods) > 1:
            return "inter_pod"
    return "intra_pod"


def collective_stats(records, *, pod_of: dict | None = None) -> dict:
    """Per-collective-kind {count, bytes} from recorded collectives.

    With ``pod_of`` (rank → pod id, see ``mesh_pod_map``) the result also
    carries ``by_tier``: the same bytes attributed to ``intra_pod`` /
    ``inter_pod`` links by each collective's group (records without one
    land in ``unattributed``) — comparable against the ledger's per-hop
    split.  A record is a ``CollectiveRecord`` or a dict with ``kind``,
    ``bytes`` and ``groups`` (a list of rank lists) or ``ranks``.
    """
    stats = defaultdict(lambda: {"count": 0, "bytes": 0})
    tiers = defaultdict(lambda: {"count": 0, "bytes": 0})
    for r in records:
        if isinstance(r, dict):
            kind, nbytes = r["kind"], int(r["bytes"])
            groups = r.get("groups")
            if groups is None and r.get("ranks") is not None:
                groups = [list(r["ranks"])]
        else:
            kind, nbytes = r.kind, int(r.bytes)
            groups = [list(r.ranks)] if r.ranks is not None else None
        if kind not in _COLLECTIVES:
            raise ValueError(f"unknown collective kind {kind!r}")
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += nbytes
        if pod_of is not None:
            tier = _classify_groups(groups, pod_of) if groups is not None else "unattributed"
            tiers[tier]["count"] += 1
            tiers[tier]["bytes"] += nbytes
    out = dict(stats)
    out["total_bytes"] = sum(v["bytes"] for v in stats.values())
    out["total_count"] = sum(v["count"] for v in stats.values())
    if pod_of is not None:
        out["by_tier"] = dict(tiers)
    return out


#: the reference's census kinds, as the dispatcher names their counterparts
_CENSUS_DEFAULT = ("mm", "bmm", "addmm", "baddbmm", "convolution")


def op_census(counts, ops=_CENSUS_DEFAULT) -> dict:
    """The counts of ``ops`` (names without namespace, e.g. ``"mm"``) and
    of every custom kernel op of the port (``repro_torch.*``) among
    ``counts``, operation name → times dispatched (a
    ``telemetry.costprobe.CostCounter``'s ``counts``)."""
    census = defaultdict(int)
    for name, n in counts.items():
        ns, _, op = name.partition(".")
        if op in ops or ns == "repro_torch":
            census[op if ns == "aten" else name] += n
    return dict(census)
