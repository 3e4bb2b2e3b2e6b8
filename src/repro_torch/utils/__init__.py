"""Pytree helpers (port of ``repro.utils``)."""

from repro_torch.utils import tree
from repro_torch.utils.tree import (
    tree_add,
    tree_allclose,
    tree_axpy,
    tree_bytes,
    tree_cast,
    tree_dot,
    tree_norm,
    tree_scale,
    tree_size,
    tree_sub,
    tree_zeros_like,
)

__all__ = [
    "tree",
    "tree_add",
    "tree_sub",
    "tree_scale",
    "tree_axpy",
    "tree_zeros_like",
    "tree_dot",
    "tree_norm",
    "tree_size",
    "tree_bytes",
    "tree_allclose",
    "tree_cast",
]
