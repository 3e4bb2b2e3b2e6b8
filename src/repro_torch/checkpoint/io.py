"""Checkpoints in the reference's on-disk format (port of
``repro.checkpoint.io``).

A pytree is flattened to ``path -> array`` with the reference's keys
(dict keys, sequence indices and NamedTuple fields joined by ``/``) and
stored as one ``step_XXXXXXXX.npz`` per step beside a JSON manifest of the
keys.  The write goes to a temporary file that ``os.replace`` moves into
place, so a killed run never leaves a half-written checkpoint visible.  A
checkpoint the JAX package wrote restores here, and one written here
restores there.

numpy has no bfloat16 of its own: JAX writes ``ml_dtypes.bfloat16``
leaves, which ``np.savez`` stores as raw 2-byte voids (``|V2``).  The port
writes its bf16 leaves the same way and reads every ``|V2`` leaf back as
bf16 through its 16 bits.  ``restore(shardings=)`` places each leaf on
its mesh (``sharding.rules.NamedSharding``), as ``jax.device_put`` does
there.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.device import resolve_device

_BF16_VOID = np.dtype("V2")


def _key(path) -> str:
    return "/".join(
        str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p)))) for p in path)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(_BF16_VOID)
        return x.numpy()
    return np.asarray(x)


def _to_tensor(arr: np.ndarray, dtype, device) -> torch.Tensor:
    if not (arr.flags.c_contiguous and arr.flags.writeable):
        arr = np.array(arr, order="C")  # keeps 0-d arrays 0-d
    if arr.dtype == _BF16_VOID:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def _flatten(tree) -> dict:
    return {_key(path): _to_numpy(leaf)
            for path, leaf in pytree.tree_flatten_with_path(tree)[0]}


def _path(ckpt_dir: str, step: int, ext: str) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}.{ext}")


def _load(ckpt_dir: str, step: int) -> dict:
    with np.load(_path(ckpt_dir, step, "npz")) as data:
        return {k: data[k] for k in data.files}


def save(ckpt_dir: str, step: int, tree) -> str:
    """Write ``tree`` (tensors, numpy arrays or numbers) as step ``step``;
    returns the ``.npz`` path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    flat = _flatten(tree)
    path = _path(ckpt_dir, step, "npz")
    fd, tmp = tempfile.mkstemp(dir=ckpt_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    with open(_path(ckpt_dir, step, "json"), "w") as f:
        json.dump({"step": step, "keys": sorted(flat)}, f)
    return path


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [
        int(m.group(1))
        for fn in os.listdir(ckpt_dir)
        if (m := re.match(r"step_(\d+)\.npz$", fn))
    ]
    return max(steps) if steps else None


def restore_dict(ckpt_dir: str, step: int, *, device="cuda"):
    """Restore WITHOUT a template: nested dicts rebuilt from the
    ``/``-joined keys (a single ``""`` key is a bare-array checkpoint), as
    tensors on ``device``.  Trees of NamedTuples or lists need
    ``restore(..., like=)``."""
    dev = resolve_device(device)
    flat = _load(ckpt_dir, step)
    if set(flat) == {""}:
        return _to_tensor(flat[""], None, dev)
    tree: dict = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _to_tensor(arr, None, dev)
    return tree


def restore(ckpt_dir: str, step: int, like, *, shardings=None):
    """Restore into the structure of ``like`` (a pytree of tensors): each
    leaf takes its template's type and device; a shape that differs
    raises ``ValueError``.  ``shardings`` (a matching pytree of
    ``sharding.rules.NamedSharding``) places each leaf on its mesh by its
    spec: a ``DTensor`` on a device mesh, the tensor itself on a
    ``SoloMesh``."""
    flat = _load(ckpt_dir, step)
    paths, spec = pytree.tree_flatten_with_path(like)
    shard_leaves = (pytree.tree_leaves(shardings, is_leaf=lambda s: hasattr(s, "spec"))
                    if shardings is not None else None)
    leaves = []
    for i, (path, leaf) in enumerate(paths):
        key = _key(path)
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
        x = _to_tensor(arr, leaf.dtype, leaf.device)
        leaves.append(shard_leaves[i].put(x) if shard_leaves is not None else x)
    return pytree.tree_unflatten(leaves, spec)
