"""Rank programs for the port's sharding tests: each runs on every rank of
a gloo world started by ``repro_torch.launch.mesh.run_ranks`` and returns
a dict of numpy arrays and flags.

This module imports no JAX: each rank imports it, and the tests hold the
ranks' results to the JAX package in the test process.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.ml.linear import lsq_loss

#: the leaves placed in the parity test, by path: the reduced dense+MoE
#: tree's names (``tests/test_sharding.py``'s ``_params``), with sizes every
#: mesh axis of a (2, 2, 2) mesh divides
LEAF_SHAPES = {
    "embed/embedding": (512, 64),
    "lm_head/kernel": (64, 512),
    "seg0/l0/mixer/wq/kernel": (2, 64, 64),
    "seg0/l0/mixer/wo/kernel": (2, 64, 64),
    "seg0/l0/ffn/experts/w_gate": (2, 4, 64, 32),
    "seg0/l0/ffn/experts/w_down": (2, 4, 32, 64),
    "final_norm/scale": (64,),
}

#: (model_axis, fsdp_axis, expert_axes) of each placement case; fsdp over
#: ("pod", "data") is a dimension split over two axes, pod-major, and
#: expert_axes ("model", "data") one split against mesh order
PLACEMENT_CASES = {
    "tp": ("model", None, None),
    "tp+fsdp": ("model", "data", None),
    "fsdp_pod_data": ("model", ("pod", "data"), None),
    "ep2d": ("model", ("pod", "data"), ("model", "data")),
}


def leaf_values() -> dict:
    """Seeded values of every leaf, nested by path."""
    rng = np.random.default_rng(0)
    tree: dict = {}
    for path, shape in LEAF_SHAPES.items():
        node = tree
        *head, last = path.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = rng.normal(size=shape).astype(np.float32)
    return tree


def flat(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def linear_problem(K=8, Nk=10, n=5, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(K, Nk, n)).astype(np.float32)
    w = rng.normal(size=(n,)).astype(np.float32)
    return X, np.einsum("kni,i->kn", X, w).astype(np.float32)


def _local(x):
    from torch.distributed.tensor import DTensor

    return (x.to_local() if isinstance(x, DTensor) else x).detach().numpy()


def sharding_program(rank, world, workdir):
    """Placement on a (2, 2, 2) ("pod", "data", "model") mesh, serving on a
    (4, 2) ("data", "model") mesh, a restore onto shardings, an ambient
    multipod ``MeshContext`` driving both mesh executors."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import checkpoint
    from repro_torch.launch.mesh import make_multipod_mesh
    from repro_torch.serve import MicroBatcher, ModelRegistry, ServeEngine
    from repro_torch.sharding.rules import (
        MeshContext,
        make_shardings,
        partition_params,
        place,
        place_params,
        set_mesh_context,
    )

    out = {"rank": rank}
    mesh = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    params = torch.utils._pytree.tree_map(torch.from_numpy, leaf_values())
    for case, (model, fsdp, experts) in PLACEMENT_CASES.items():
        spec = partition_params(params, model_axis=model, fsdp_axis=fsdp, expert_axes=experts)
        placed = place(mesh, params, spec)
        out[f"place/{case}"] = {k: _local(v) for k, v in flat(placed).items()}
        out[f"full/{case}"] = all(
            np.array_equal(v.full_tensor().numpy(), flat(leaf_values())[k])
            for k, v in flat(placed).items())
    placed = place_params(mesh, params, model_axis="model", fsdp_axis="data")
    out["place_params"] = {k: _local(v) for k, v in flat(placed).items()}

    # serving: θ placed on a (4, 2) mesh, requests split over "data"
    mesh42 = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    X, y = linear_problem()
    gd = api.GradientDescent(lsq_loss, lr=0.1)
    res = api.fit(gd, (X, y), transport="allreduce", steps=100, executor="mesh",
                  device="cpu")
    eng = ServeEngine(gd, res.theta, mesh=mesh42)
    Xq = np.random.default_rng(5).normal(size=(6, 5)).astype(np.float32)
    bat = MicroBatcher(eng, max_batch=8)
    tickets = [bat.submit(x) for x in Xq]
    bat.flush()
    out["serve"] = {"theta": _local(res.theta),
                    "preds": np.asarray([t.result().numpy() for t in tickets]),
                    "uplink": eng.ledger.uplink_bytes,
                    "downlink": eng.ledger.downlink_bytes,
                    "events": [e[0] for e in eng.ledger.events]}

    # restore onto shardings: rank 0 writes, every rank restores its block
    if rank == 0:
        checkpoint.save(workdir, 1, params)
        ModelRegistry(workdir).publish("theta", params)
    torch.distributed.barrier()
    like = torch.utils._pytree.tree_map(torch.zeros_like, params)
    spec = partition_params(params, model_axis="model", fsdp_axis=("pod", "data"))
    restored = checkpoint.restore(workdir, 1, like, shardings=make_shardings(mesh, spec))
    out["restore"] = {k: _local(v) for k, v in flat(restored).items()}
    # the same blocks through the registry (rank 0 published before)
    loaded = ModelRegistry(workdir).load("theta", like=like,
                                         shardings=make_shardings(mesh, spec))
    out["registry"] = {k: _local(v) for k, v in flat(loaded).items()}

    # an ambient multipod MeshContext supplies the mesh to both executors
    set_mesh_context(MeshContext(mesh=make_multipod_mesh(), logical={}))
    try:
        flat_fit = api.fit(api.GradientDescent(lsq_loss, lr=0.1), (X, y),
                           transport="allreduce", steps=10, executor="mesh", device="cpu")
        hier_fit = api.fit(api.GradientDescent(lsq_loss, lr=0.1), (X, y),
                           transport="allreduce", steps=10, executor="multipod",
                           device="cpu")
    finally:
        set_mesh_context(None)
    out["context"] = {"flat": _local(flat_fit.theta), "hier": _local(hier_fit.theta),
                      "by_hop": hier_fit.ledger.summary()["by_hop"]}

    return out


def shard_digest(x: np.ndarray) -> str:
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(x).tobytes()).hexdigest()


def staged_program(rank, world):
    """A staged hierarchical all-reduce (intra-pod over "data", then
    inter-pod over "pod") on a (2, world/2) multipod mesh, recorded."""
    from repro_torch.core import allreduce as ar
    from repro_torch.launch.mesh import axis_group, make_multipod_mesh
    from repro_torch.telemetry import hlo

    pods = make_multipod_mesh()
    hops = (axis_group(pods, "data"), axis_group(pods, "pod"))
    x = torch.full((16,), float(rank))
    with hlo.CollectiveRecorder() as rec:
        total = ar.hierarchical_allreduce(x, hops)
    pod_of = hlo.mesh_pod_map(pods)
    return {"sum": total.numpy(), "stats": hlo.collective_stats(rec.records, pod_of=pod_of),
            "tiers": [hlo._classify_groups([list(r.ranks)], pod_of) for r in rec.records],
            "ranks": [r.ranks for r in rec.records]}
