"""Plain PyTorch versions of the top-k encode kernels (the CPU path, and
what ``chip_smoke.py`` holds the CUDA kernel to on the card)."""

from __future__ import annotations

import torch


def encode_threshold_ref(c: torch.Tensor, t: torch.Tensor, *, with_residual: bool):
    """``(o, res | None, count)`` for rows ``c`` (K, n) and thresholds
    ``t`` (K,).  Dropped entries are +0.0 — what the jitted JAX wire writes
    (XLA turns ``c * keep`` into a select under jit) — so ``torch.where``,
    not a multiply."""
    keep = c.abs() >= t[:, None]
    o = torch.where(keep, c, 0.0)
    res = c - o if with_residual else None
    return o, res, keep.sum(dim=1, dtype=torch.int32)
