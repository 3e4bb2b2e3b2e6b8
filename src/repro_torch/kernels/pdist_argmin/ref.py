"""Plain PyTorch nearest-centroid assignment (port of
``repro.kernels.pdist_argmin.ref``): the CPU path, and what
``chip_smoke.py`` holds the CUDA kernel to on the card.

It materialises the (N, K, d) differences, so on the card it is run on a
chunk of points, never on a whole data set.
"""

from __future__ import annotations

import torch

METRICS = ("l2", "l1", "linf")


def pdist_argmin_ref(X: torch.Tensor, C: torch.Tensor, metric: str = "l2"):
    """``(idx int32 (N,), dist f32 (N,))``: per point of X (N, d), the first
    index of its nearest row of C (K, d) and that distance, in f32.  l2 is
    squared, in the direct form Σ(x − c)²."""
    diff = X[:, None, :].float() - C[None, :, :].float()
    if metric == "l2":
        d = torch.sum(diff * diff, dim=-1)  # squared — same argmin
    elif metric == "l1":
        d = torch.sum(torch.abs(diff), dim=-1)
    elif metric == "linf":
        d = torch.amax(torch.abs(diff), dim=-1)
    else:
        raise ValueError(metric)
    # torch.argmin, like jnp.argmin, returns the first index of a tie
    return torch.argmin(d, dim=1).to(torch.int32), torch.amin(d, dim=1)
