"""Sharding rules: logical-axis activation constraints and name-based
parameter specs (port of ``repro.sharding.rules``).

Strategy (the reference's ``DESIGN.md`` §5):

* params — tensor parallel on the ``model`` axis (attention heads, FFN
  hidden, experts, vocab), optional FSDP on the ``data``/``pod`` axes for
  architectures whose parameter and optimizer state exceed one device;
* activations — batch on (``pod``, ``data``); sequence on ``data`` when the
  batch is too small to shard; hidden/heads on ``model``.

A spec is a ``P``: one entry per tensor dimension, each None, a mesh axis
name or a tuple of axis names (major first), as the reference's
``PartitionSpec``.  On a ``torch.distributed`` ``DeviceMesh`` a spec becomes
``DTensor`` placements, one per mesh dimension (``spec_placements``): a
dimension over several axes is ``Shard(d)`` on each, split in mesh order,
which is JAX's major-first order when the axes are listed in mesh order.

A ``MeshContext`` (set by the launcher) carries the mesh and the
logical→physical axis map; model code calls ``maybe_shard(x, "batch",
"seq", None)``, which redistributes a ``DTensor`` to those placements under
a context (eager torch's ``with_sharding_constraint``) and returns ``x``
itself without one, or for a plain tensor.
"""

from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.placement_types import _StridedShard

from repro_torch.launch.mesh import SoloMesh, axis_names, axis_sizes

_ctx = threading.local()


class P(tuple):
    """A partition spec: ``P("data", None, ("pod", "model"))``.  A tuple of
    its entries, so it equals the reference's ``PartitionSpec`` entry for
    entry (``tuple(p) == tuple(jax_p)``); a leaf of every tree helper."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"


def _is_spec(x) -> bool:
    return isinstance(x, P)


@dataclass
class MeshContext:
    mesh: object  # a DeviceMesh or a SoloMesh
    # logical axis name -> physical mesh axis (or tuple of axes) or None
    logical: dict = field(default_factory=dict)
    fsdp: bool = False

    @property
    def batch_axes(self):
        return self.logical.get("batch")

    @property
    def model_axis(self):
        return self.logical.get("model")

    @property
    def node_axes(self) -> tuple:
        """Physical mesh axes that place the paper's K nodes (data
        parallelism) — what the mesh executor shards the node axis over."""
        return tuple(a for a in axis_names(self.mesh) if a in ("pod", "data"))

    @property
    def pod_axis(self) -> str | None:
        """The inter-pod tier's mesh axis, when this mesh spans pods."""
        return "pod" if "pod" in axis_names(self.mesh) else None

    @property
    def intra_pod_axes(self) -> tuple:
        """Node axes below the pod tier (the cheap intra-pod reduction)."""
        return tuple(a for a in self.node_axes if a != "pod")

    def topology(self, **prices):
        """The reduction ``core.topology.Topology`` this mesh implies:
        hierarchical (intra-pod sum + inter-pod all-reduce) when a pod
        axis exists, flat otherwise.  ``prices`` forwards
        ``intra_price``/``inter_price`` per-byte hop prices."""
        from repro_torch.core.topology import Topology

        return Topology.from_mesh(self.node_axes, **prices)


def set_mesh_context(ctx: MeshContext | None):
    _ctx.value = ctx


def current_mesh_context() -> MeshContext | None:
    return getattr(_ctx, "value", None)


# ----------------------------------------------------------------------------
# Specs → DTensor placements
# ----------------------------------------------------------------------------

def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec, mesh) -> tuple:
    """``DTensor`` placements (one per mesh dimension) for ``spec``.  A
    dimension over axes listed in mesh order is ``Shard(d)`` on each; two
    axes listed against mesh order (the major one later in the mesh, as
    ``ep2d``'s ``("model", "data")`` on a ``("data", "model")`` mesh) make
    the earlier mesh dimension a strided shard, so the blocks still fall
    major-first, as JAX lays them out."""
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in mesh axes {names}")
        dims = [names.index(a) for a in axes]
        if dims == sorted(dims):
            for i in dims:
                out[i] = Shard(d)
        elif len(dims) == 2:
            major, minor = dims
            out[major] = Shard(d)
            out[minor] = _StridedShard(d, split_factor=sizes[axes[0]])
        else:
            raise NotImplementedError(
                f"spec entry {entry} lists more than two axes out of mesh order {names}")
    return tuple(out)


def shard_count(entry, mesh) -> int:
    """How many blocks one spec entry splits its dimension into."""
    sizes = axis_sizes(mesh)
    n = 1
    for a in _entry_axes(entry):
        n *= sizes[a]
    return n


def check_divisible(shape, spec, mesh, what: str = "leaf") -> None:
    """Raise as JAX's ``device_put`` does when a sharded dimension does not
    split evenly: the port never pads a shard silently."""
    for d, entry in enumerate(spec):
        n = shard_count(entry, mesh)
        if n > 1 and shape[d] % n:
            raise ValueError(
                f"{what} of shape {tuple(shape)} with spec {spec}: dimension {d} "
                f"({shape[d]}) is not divisible by {n} shards")


def local_shape(shape, spec, mesh) -> tuple:
    """The per-rank block shape of a tensor of ``shape`` under ``spec``
    (dimensions divisible, as ``check_divisible`` ensures)."""
    return tuple(s // shard_count(spec[d], mesh) if d < len(spec) else s
                 for d, s in enumerate(shape))


def maybe_shard(x: torch.Tensor, *logical_axes) -> torch.Tensor:
    """Apply a sharding constraint if a mesh context is active.

    ``logical_axes`` entries are logical names ("batch", "seq", "model",
    "expert", ...) or None; unknown names map to None (replicated).  A
    ``DTensor`` is redistributed to the spec's placements, and its gradient
    is laid out by the same spec on the way back, as JAX's constraint binds
    the cotangent too: a gradient summed from column-parallel products
    arrives as a partial sum, which ``DTensor`` would otherwise carry into
    the next product and meet by gathering that product's weight.  A plain
    tensor, or a context over a ``SoloMesh``, leaves ``x`` as it is.
    """
    ctx = current_mesh_context()
    if ctx is None or not isinstance(x, DTensor) or isinstance(ctx.mesh, SoloMesh):
        return x
    spec = P(*[ctx.logical.get(a) if a is not None else None for a in logical_axes])
    placements = spec_placements(spec, ctx.mesh)
    if tuple(x.placements) != placements:
        x = x.redistribute(ctx.mesh, placements)
    return pin_grad(x)


def pin_grad(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself, whose gradient is redistributed to ``x``'s placements
    on the way back (``from_local``'s backward does that); a plain tensor,
    or one that needs no gradient, as it is."""
    if not isinstance(x, DTensor) or not x.requires_grad:
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def _shards_on(x, dim: int) -> int:
    n = 1
    for size, pl in zip(x.device_mesh.shape, x.placements):
        if pl.is_shard(dim):
            n *= size
    return n


def unshard_dim(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dimension ``dim`` whole on every rank: a ``DTensor``
    sharded on it is all-gathered along it; anything else is ``x``."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    if _shards_on(x, dim) == 1:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if pl.is_shard(dim) else pl for pl in x.placements])


def splits_evenly(x: torch.Tensor, dim: int, n: int) -> bool:
    """Whether ``n`` blocks of dimension ``dim`` fall whole on the shards
    of ``x``: always for a plain tensor, for a ``DTensor`` when ``n`` is a
    multiple of the number of shards along ``dim``."""
    return not isinstance(x, DTensor) or n % _shards_on(x, dim % x.ndim) == 0


def replicated_where_sharded(x: torch.Tensor, like: torch.Tensor, dim: int) -> bool:
    """Whether ``x`` and ``like`` are ``DTensor``s and ``x`` is replicated
    on every mesh dimension that shards ``like`` on dimension ``dim``: then
    sharding ``x`` like ``like`` there is a local slice."""
    if not (isinstance(x, DTensor) and isinstance(like, DTensor)):
        return False
    dim = dim % like.ndim
    return all(xp.is_replicate() for xp, lp in zip(x.placements, like.placements)
               if lp.is_shard(dim))


def split_dim(x: torch.Tensor, dim: int, *sizes) -> torch.Tensor:
    """``x`` with dimension ``dim`` unflattened into ``sizes`` (heads ×
    head dim, KV heads × group).  A ``DTensor`` sharded on that dimension
    into more blocks than ``sizes[0]`` divides (4 KV heads over a model
    axis of 16) is first replicated along it: ``DTensor`` refuses such a
    view, where XLA's SPMD partitioner would tile the new dimensions
    jointly."""
    dim = dim % x.ndim
    if not splits_evenly(x, dim, sizes[0]):
        x = unshard_dim(x, dim)
    return x.reshape(*x.shape[:dim], *sizes, *x.shape[dim + 1:])


# ----------------------------------------------------------------------------
# Parameter partition specs (name-based rules)
# ----------------------------------------------------------------------------
#
# Each rule: (path regex, spec tail).  Tails hold the physical axis names
# (fsdp may be None) of the *unstacked* leaf; leading stack dimensions are
# padded with None on the left to the leaf's ndim.

def _pad(spec_tail: tuple, ndim: int) -> P:
    pad = ndim - len(spec_tail)
    if pad < 0:  # leaf smaller than rule (e.g. reduced configs) — replicate
        return P()
    return P(*((None,) * pad + spec_tail))


def _rules(model, fsdp, expert_axes=None):
    # NOTE: order matters — first match wins.
    e = expert_axes if expert_axes is not None else model
    e_fsdp = None if expert_axes is not None else fsdp
    return [
        # embeddings / lm head: vocab over model, d over fsdp
        (r"embed/embedding$", (model, fsdp)),
        (r"lm_head/kernel$", (fsdp, model)),
        # MoE experts: expert dim over model (expert parallelism); with
        # ``expert_axes`` the expert dim spans several axes (2-D EP) and is
        # never FSDP-gathered
        (r"experts/w_gate$", (e, e_fsdp, None)),
        (r"experts/w_up$", (e, e_fsdp, None)),
        (r"experts/w_down$", (e, None, e_fsdp)),
        (r"router/kernel$", (None, None)),
        # attention (GQA)
        (r"\bwq/kernel$", (fsdp, model)),
        (r"\bwk/kernel$", (fsdp, model)),
        (r"\bwv/kernel$", (fsdp, model)),
        (r"\bwo/kernel$", (model, fsdp)),
        (r"\bw(q|k|v)/bias$", (model,)),
        # MLA
        (r"w_dq/kernel$", (fsdp, None)),
        (r"w_uq/kernel$", (None, model)),
        (r"w_dkv/kernel$", (fsdp, None)),
        (r"w_kr/kernel$", (fsdp, None)),
        (r"w_uk/kernel$", (None, model)),
        (r"w_uv/kernel$", (None, model)),
        (r"w_o/kernel$", (model, fsdp)),
        # dense FFN
        (r"w_gate/kernel$", (fsdp, model)),
        (r"w_up/kernel$", (fsdp, model)),
        (r"w_down/kernel$", (model, fsdp)),
        (r"w_in/kernel$", (fsdp, model)),
        (r"w_out/kernel$", (model, fsdp)),
        # mamba
        (r"in_proj/kernel$", (fsdp, model)),
        (r"conv_w$", (None, model)),
        (r"conv_b$", (model,)),
        (r"x_proj/kernel$", (model, None)),
        (r"dt_proj/kernel$", (None, model)),
        (r"dt_proj/bias$", (model,)),
        (r"A_log$", (model, None)),
        (r"\bD$", (model,)),
        (r"out_proj/kernel$", (model, fsdp)),
        # mLSTM
        (r"up_proj/kernel$", (fsdp, model)),
        (r"down_proj/kernel$", (model, fsdp)),
        (r"w_[ifzo]/kernel$", (fsdp, None)),
        (r"mh_norm/scale$", (model,)),
        # sLSTM ffn
        (r"ffn_up/kernel$", (fsdp, model)),
        (r"ffn_down/kernel$", (model, fsdp)),
        # everything else (norms, biases, small projections): replicated
    ]


def _path_str(path) -> str:
    return "/".join(
        str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path)


def partition_params(params, *, model_axis="model", fsdp_axis=None,
                     expert_axes=None):
    """Build a ``P`` tree matching ``params`` via name rules.
    ``model_axis=None`` disables tensor parallelism (pure DP/FSDP);
    ``expert_axes`` overrides the expert-dim sharding (2-D EP)."""
    rules = _rules(model_axis, fsdp_axis, expert_axes)
    compiled = [(re.compile(rx), tail) for rx, tail in rules]

    def assign(path, leaf):
        pstr = _path_str(path)
        for rx, tail in compiled:
            if rx.search(pstr):
                return _pad(tail, leaf.ndim)
        return P()

    return pytree.tree_map_with_path(assign, params)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``):
    ``placements`` are its ``DTensor`` placements; ``put(x)`` places one
    tensor by it."""

    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return spec_placements(self.spec, self.mesh)

    def put(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.mesh, SoloMesh):
            return x
        check_divisible(x.shape, self.spec, self.mesh)
        return distribute_tensor(x, self.mesh, self.placements)


def make_shardings(mesh, spec_tree):
    """A ``NamedSharding`` for every spec in ``spec_tree`` on ``mesh``."""
    return pytree.tree_map(lambda s: NamedSharding(mesh, s), spec_tree, is_leaf=_is_spec)


def place(mesh, tree, spec_tree):
    """Put each tensor of ``tree`` on ``mesh`` by its spec: a ``DTensor``
    made with ``distribute_tensor`` (rank 0's values are the global ones,
    as one host array is JAX's); the tree itself on a ``SoloMesh``.
    Leaves that are ``DTensor``s already, and non-tensor leaves (a cache's
    fill index), pass through.  A
    dimension its axes do not divide raises, as ``jax.device_put`` does."""
    if isinstance(mesh, SoloMesh):
        return tree
    leaves, treedef = pytree.tree_flatten(tree)
    specs = treedef.flatten_up_to(spec_tree)
    out = [x if not isinstance(x, torch.Tensor) or isinstance(x, DTensor)
           else NamedSharding(mesh, spec).put(x) for x, spec in zip(leaves, specs)]
    return pytree.tree_unflatten(out, treedef)


def place_params(mesh, params, *, model_axis="model", fsdp_axis=None,
                 expert_axes=None):
    """Partition ``params`` by the name rules and put them on ``mesh`` in
    one step.  Axis names absent from the mesh degrade to replication, so
    callers (e.g. the serving engine) can pass any mesh — a pure-data mesh
    simply replicates every parameter.  On a ``SoloMesh`` (no process
    group) the parameters come back as they are."""
    names = axis_names(mesh)
    model = model_axis if model_axis in names else None
    fsdp = fsdp_axis if fsdp_axis and fsdp_axis in names else None
    if expert_axes is not None:
        ea = (expert_axes,) if isinstance(expert_axes, str) else expert_axes
        if not all(a in names for a in ea):
            expert_axes = None
    spec = partition_params(
        params, model_axis=model, fsdp_axis=fsdp, expert_axes=expert_axes
    )
    return place(mesh, params, spec)
