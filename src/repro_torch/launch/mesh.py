"""Node meshes over ``torch.distributed`` (port of the node-placement half
of ``repro.launch.mesh``), and a launcher for a world of ranks.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``: named axes over
the ranks of an initialized process group, with one process group per
axis.  The mesh executors place the K logical nodes on its ``("pod",
"data")`` axes and reduce over the axis groups.  Where no process group is
initialized, ``make_node_mesh`` / ``make_multipod_mesh`` return a
``SoloMesh``: a world of one on this process's device, every axis of size
1 and every collective over it the identity.

``run_ranks`` starts a world of processes on this host (gloo on the CPU,
NCCL with one card a rank) with a ``file://`` rendezvous in a temporary
directory, so launches running side by side never share a port::

    from repro_torch.launch.mesh import run_ranks

    def program(rank, world):            # a module-level function
        res = api.fit(..., executor="mesh", device="cpu")
        return res.theta.numpy()

    thetas = run_ranks(program, 8, backend="gloo")   # one result a rank

``torchrun --nproc-per-node 8 script.py`` works as well: the script calls
``torch.distributed.init_process_group("gloo")`` and the executors find
the world from it.

``make_production_mesh`` (16×16, or 2×16×16 with pods) and
``make_host_mesh`` (1×1) are the activation meshes of the launch specs and
the dry run: ``("data", "model")`` / ``("pod", "data", "model")`` device
meshes over the initialized world (``launch.dryrun`` brings up a fake world
of 256 or 512 ranks for them).
"""

from __future__ import annotations

import os
import pickle
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist


class SoloMesh:
    """A world of one with no process group: the placement a mesh executor
    takes when ``torch.distributed`` is not initialized.  Every axis has
    size 1, its group is None and every collective over it the identity."""

    def __init__(self, mesh_dim_names: tuple, device_type: str = "cpu"):
        self.mesh_dim_names = tuple(mesh_dim_names)
        self.shape = (1,) * len(self.mesh_dim_names)
        self.device_type = device_type

    def __repr__(self) -> str:
        return f"SoloMesh({self.mesh_dim_names}, device_type={self.device_type!r})"


def _device_type() -> str:
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return "cuda"
    return "cpu"


#: meshes made by the factories, one per (world, shape, axes, device
#: type): making a mesh creates process groups, which every rank must do
#: together, so a second fit reuses the first one's
_MESHES: dict = {}


def _mesh(shape: tuple, names: tuple, device_type: str | None):
    device_type = device_type or _device_type()
    if not dist.is_initialized():
        if any(s != 1 for s in shape):
            raise ValueError(
                f"a {shape} mesh needs an initialized process group of "
                f"{int(torch.tensor(shape).prod())} ranks (see run_ranks)")
        return SoloMesh(names, device_type)
    from torch.distributed.device_mesh import init_device_mesh

    # the world's group object itself keys the cache (and stays alive in
    # it), so a world brought up after another was destroyed never finds
    # the old world's mesh
    key = (dist.group.WORLD, tuple(shape), tuple(names), device_type)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(device_type, tuple(shape),
                                        mesh_dim_names=tuple(names))
    return _MESHES[key]


def make_node_mesh(num_devices: int | None = None, *, device_type: str | None = None):
    """1-D ``("data",)`` mesh over the world's ranks — the mesh executor's
    default placement (K must be a multiple of the rank count; each rank
    hosts K/ranks nodes).  A ``SoloMesh`` when no process group is
    initialized."""
    n = num_devices if num_devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    return _mesh((n,), ("data",), device_type)


def make_multipod_mesh(num_pods: int | None = None, num_devices: int | None = None, *,
                       device_type: str | None = None):
    """2-D ``("pod", "data")`` mesh over the world's ranks — the multipod
    executor's default placement: the pod axis carries the expensive
    inter-pod tier, the data axis the cheap intra-pod reduction.  2 pods
    when the rank count splits evenly, else 1."""
    n = num_devices if num_devices is not None else (
        dist.get_world_size() if dist.is_initialized() else 1)
    if num_pods is None:
        num_pods = 2 if n % 2 == 0 else 1
    if n % num_pods:
        raise ValueError(f"{n} devices do not split into {num_pods} pods")
    return _mesh((num_pods, n // num_pods), ("pod", "data"), device_type)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """16×16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.  A device
    mesh over the initialized world, which must hold exactly that many
    ranks (``launch.dryrun`` brings up a fake one)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 512 if multi_pod else 256
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(
            f"the {'x'.join(map(str, shape))} production mesh needs a world of {n} "
            f"ranks, not {world}")
    return _mesh(shape, axes, device_type)


def make_host_mesh(*, device_type: str | None = None):
    """1×1 ``("data", "model")`` mesh for smoke tests and examples: a
    ``SoloMesh`` when no process group is up, a device mesh of one rank
    under a world of one."""
    return _mesh((1, 1), ("data", "model"), device_type)


def axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names)


def axis_sizes(mesh) -> dict:
    """Axis name → number of ranks along it."""
    return {a: int(s) for a, s in zip(axis_names(mesh), tuple(mesh.shape))}


def batch_axes(mesh) -> tuple:
    """The axes that carry data parallelism (the paper's 'nodes')."""
    return tuple(a for a in axis_names(mesh) if a in ("pod", "data"))


def data_axis_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    s = 1
    for a in batch_axes(mesh):
        s *= sizes[a]
    return s


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis`` (0 on a ``SoloMesh``)."""
    if isinstance(mesh, SoloMesh):
        return 0
    return int(mesh.get_local_rank(axis))


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on under ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_ranks(mesh) -> tuple:
    """The ranks of the mesh in row-major order (``(0,)`` for a world of
    one)."""
    if isinstance(mesh, SoloMesh):
        return (0,)
    return tuple(int(r) for r in mesh.mesh.reshape(-1).tolist())


#: joint groups over several axes, created once per mesh and axis set
_JOINT_GROUPS: dict = {}


def axis_group(mesh, axes):
    """The process group reducing over ``axes`` of ``mesh`` that holds this
    rank: the mesh's own group for one axis, a group made once (every rank
    of the world must ask for it together) for several.  None on a
    ``SoloMesh``: the collective is the identity."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if isinstance(mesh, SoloMesh):
        return None
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    key = (id(mesh), axes)
    if key not in _JOINT_GROUPS:
        names = axis_names(mesh)
        ranks = mesh.mesh
        rest = [i for i, a in enumerate(names) if a not in axes]
        order = rest + [names.index(a) for a in axes]
        size = 1
        for a in axes:
            size *= axis_sizes(mesh)[a]
        blocks = ranks.permute(order).reshape(-1, size).tolist()
        if len(blocks) == 1 and len(blocks[0]) == dist.get_world_size():
            group = dist.group.WORLD
        else:
            group, _ = dist.new_subgroups_by_enumeration(blocks)
        _JOINT_GROUPS[key] = (mesh, group)  # the mesh kept alive with its id
    return _JOINT_GROUPS[key][1]


# ---------------------------------------------------------------------------
# A world of ranks on this host
# ---------------------------------------------------------------------------


def _rank_main(rank, fn, world_size, backend, workdir, args, timeout_s):
    torch.set_num_threads(1)
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(workdir, 'rendezvous')}",
        world_size=world_size, rank=rank, timeout=timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world_size, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world_size: int, *, backend: str = "gloo", args: tuple = (),
              timeout: float = 300.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` new processes
    that share one process group, and return the ranks' results in rank
    order (each must pickle).  ``fn`` must be importable by name (a
    module-level function).  Each rank uses one CPU thread (gloo) or card
    ``rank % device_count`` (NCCL).  A world that has not finished within
    ``timeout`` seconds is killed and ``TimeoutError`` raised; a rank that
    raises stops the others and its error is raised here."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as workdir:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world_size, backend, workdir, args, timeout),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"{world_size} ranks of {getattr(fn, '__name__', fn)} did "
                        f"not finish within {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        out = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
