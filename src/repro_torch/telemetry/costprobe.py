"""Per-device FLOPs, bytes and collective bytes of a step, counted as it
runs on shapes alone (port of ``repro.telemetry.costprobe``).

The reference lowers small *unrolled* probe programs and extrapolates,
because XLA's ``cost_analysis()`` counts a ``while`` body once.  The
port's layers and time loops are Python loops, so ONE pass counts every
layer, every microbatch and every step of sLSTM's recurrence — the
reference's analytic sLSTM correction has no counterpart, and
``n_probes`` is 1.

The pass runs the step from ``launch.specs.build_jitted`` on arguments
that hold no storage: tensors on the ``meta`` device, and on a device mesh
``DTensor``s whose local shards are such tensors, placed by the specs.
``CostCounter`` (a ``TorchDispatchMode``) sees each op on the local shards
(``DTensor``'s own ops are passed down to them), so every count is this
rank's:

* ``flops`` — the products, by ``torch.utils.flop_counter``'s formulas
  (those ``FlopCounterMode`` applies: mm, bmm, addmm, baddbmm,
  convolution, attention);
* ``bytes`` — the operands and results of every dispatched op that is not
  a view: an upper bound on memory traffic, as XLA's "bytes accessed" is;
* ``coll`` — the bytes of this rank's collectives
  (the records of ``telemetry.hlo.CollectiveRecorder``, which it extends).

``FakeTensorMode`` is not used: ``DTensor`` computes the offsets of a
strided shard with ``torch.arange(...).tolist()``, which a fake tensor
refuses (torch 2.13), while meta shards let ``DTensor``'s index arithmetic
run on real host tensors.
"""

from __future__ import annotations

from collections import defaultdict

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor
from torch.utils.flop_counter import flop_registry

from repro_torch.launch import specs as S
from repro_torch.launch.mesh import SoloMesh
from repro_torch.models.config import ModelConfig
from repro_torch.sharding.rules import (
    check_divisible,
    local_shape,
    set_mesh_context,
    spec_placements,
)
from repro_torch.telemetry.hlo import CollectiveRecorder, tensor_bytes


class CostCounter(CollectiveRecorder):
    """Counts FLOPs, bytes and ops, and records the collectives, of what
    runs while active on plain tensors (a ``DTensor``'s ops by those on
    its local shards)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.counts: dict = defaultdict(int)

    def record(self, func, args, kwargs, out) -> None:
        packet = func.overloadpacket
        self.counts[str(packet).replace("::", ".")] += 1
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        if not func.is_view:
            self.bytes += tensor_bytes((args, kwargs)) + tensor_bytes(out)
        super().record(func, args, kwargs, out)

    def costs(self) -> dict:
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": float(sum(r.bytes for r in self.records))}


def abstract_args(mesh, args, spec_trees):
    """``args`` (trees of meta tensors) as this rank holds them under the
    specs: on a device mesh each tensor a ``DTensor`` over a meta local
    shard of the block's shape (a dimension the mesh does not divide
    raises, as ``jax.device_put`` does); on a ``SoloMesh`` the meta tensors
    themselves.  Non-tensor leaves (a cache's fill index) pass through."""
    if isinstance(mesh, SoloMesh):
        return args

    def one(tree, spec_tree):
        leaves, treedef = pytree.tree_flatten(tree)
        out = []
        for x, spec in zip(leaves, treedef.flatten_up_to(spec_tree)):
            if not isinstance(x, torch.Tensor):
                out.append(x)
                continue
            check_divisible(x.shape, spec, mesh)
            loc = torch.empty(local_shape(x.shape, spec, mesh), dtype=x.dtype, device="meta")
            out.append(DTensor.from_local(
                loc, mesh, spec_placements(spec, mesh), run_check=False,
                shape=x.shape, stride=x.stride()))
        return pytree.tree_unflatten(out, treedef)

    return tuple(one(a, s) for a, s in zip(args, spec_trees))


def local_bytes(tree) -> int:
    """Bytes this rank holds of ``tree``: a ``DTensor``'s local shard, a
    plain tensor whole."""
    return tensor_bytes(pytree.tree_map(
        lambda x: x.to_local() if isinstance(x, DTensor) else x, tree))


def run_abstract(cfg: ModelConfig, kind: str, mesh, B: int, S_len: int, *,
                 mla_absorb: bool = False, microbatches: int = 1,
                 strategy: str = "tp", seed: int = 0, memory: bool = False) -> dict:
    """Run the step of (cfg, kind, B, S_len) once on storage-free arguments
    placed on ``mesh`` under its mesh context, counting as it goes.

    Returns ``counter`` (a ``CostCounter``), ``args`` (this rank's
    arguments), ``params_shape`` and, with ``memory=True``, ``peak`` — the
    per-device peak of ``torch.distributed._tools.mem_tracker.MemTracker``
    over the step, arguments included, by memory kind.
    """
    set_mesh_context(S.make_mesh_context_for(mesh, cfg, B, strategy=strategy))
    try:
        step, args, params_shape = S.build_jitted(
            cfg, kind, mesh, B, S_len, mla_absorb=mla_absorb,
            microbatches=microbatches, strategy=strategy, seed=seed)
        args = abstract_args(mesh, args, step.specs)
        counter = CostCounter()
        peak = None
        if memory:
            from torch.distributed._tools.mem_tracker import MemTracker

            tracker = MemTracker()
            tracker.track_external(*[x for x in pytree.tree_leaves(args)
                                     if isinstance(x, torch.Tensor)])
            with tracker, counter:
                step(*args)
            peak = {str(dev): {str(k).split(".")[-1]: int(v) for k, v in kinds.items()}
                    for dev, kinds in tracker.get_tracker_snapshot("peak").items()}
        else:
            with counter:
                step(*args)
    finally:
        set_mesh_context(None)
    return {"counter": counter, "args": args, "params_shape": params_shape, "peak": peak}


def probe_costs(
    cfg: ModelConfig,
    kind: str,
    mesh,
    B_full: int,
    S_len: int,
    *,
    mla_absorb: bool = False,
    strategy: str = "tp",
) -> dict:
    """Per-device {flops, bytes, coll} of the step at (B_full, S_len),
    counted in one pass (``n_probes`` 1: the port's loops are Python
    loops, so nothing is counted once for many trips)."""
    out = run_abstract(cfg, kind, mesh, B_full, S_len, mla_absorb=mla_absorb,
                       strategy=strategy)
    return dict(out["counter"].costs(), n_probes=1)
