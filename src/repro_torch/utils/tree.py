"""Pytree arithmetic helpers (port of ``repro.utils.tree``), plus
``tree_stack`` and torch's flatten / unflatten under the reference's
names.

Pytrees are ``torch.utils._pytree`` trees: dicts, lists, tuples and
NamedTuples of tensors.  Unlike ``jax.tree``, dict leaves come in insertion
order, not sorted key order.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils import _pytree as pytree

tree_map = pytree.tree_map
tree_leaves = pytree.tree_leaves
tree_flatten = pytree.tree_flatten
tree_unflatten = pytree.tree_unflatten


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(s, a):
    return tree_map(lambda x: s * x, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y, elementwise over matching pytrees."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_dot(a, b):
    """Σ over leaves of ⟨a, b⟩, a 0-d tensor (leaves summed in the tree's
    order, from 0.0)."""
    return sum((torch.vdot(x.reshape(-1), y.reshape(-1))
                for x, y in zip(tree_leaves(a), tree_leaves(b))), torch.zeros(()))


def tree_norm(a):
    return torch.sqrt(tree_dot(a, a))


def tree_size(a) -> int:
    """Total number of scalar elements in the pytree."""
    return sum(int(x.numel()) for x in tree_leaves(a))


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    return all(bool(torch.allclose(x, y, rtol=rtol, atol=atol))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_bytes(a) -> int:
    """Total bytes of the pytree's leaves (tensors or numpy arrays)."""
    return sum(
        int(x.nbytes) if isinstance(x, np.ndarray) else int(x.numel()) * x.element_size()
        for x in tree_leaves(a)
    )


def tree_stack(trees: list):
    """Stack a list of same-structure trees along a new leading axis (what
    ``lax.scan`` does to its per-step outputs)."""
    cols = [tree_leaves(t) for t in trees]
    spec = tree_flatten(trees[0])[1]
    return tree_unflatten([torch.stack(leaves) for leaves in zip(*cols)], spec)
