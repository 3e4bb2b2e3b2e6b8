"""Pytree helpers (port of the parts of ``repro.utils.tree`` the port uses;
the rest — scale, axpy, dot, norm, … — come with the slices that need
them).

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
