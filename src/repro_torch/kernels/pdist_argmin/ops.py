"""Nearest-centroid assignment, kernel-backed.

Counterpart of ``repro.kernels.pdist_argmin.ops.pdist_argmin``: for CUDA
tensors the kernel that ``kernel.route`` names for the metric (l2: tensor
cores; l1, l∞: CUDA cores), for CPU ones the plain version
(``ref.pdist_argmin_ref``, the direct form both kernels are held to), and an
error for any other device.  Unlike the JAX wrapper
nothing is padded: the kernel masks its own ragged tail.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.pdist_argmin import kernel, ref


def pdist_argmin(X: torch.Tensor, C: torch.Tensor, *, metric: str = "l2", bn: int = 128):
    """``(assignments int32 (N,), min distance f32 (N,))`` of points X
    (N, d) against centroids C (K, d); l2 distances are squared.

    ``bn`` is the JAX wrapper's point-block size, kept for the signature;
    it changes no result here (the kernel's block is fixed, the plain
    version has none)."""
    if X.device.type == "cuda":
        return kernel.pdist_argmin(X.contiguous(), C.contiguous(), metric)
    if X.device.type == "cpu":
        return ref.pdist_argmin_ref(X, C, metric)
    raise ValueError(f"pdist_argmin: no kernel for device {X.device}")
