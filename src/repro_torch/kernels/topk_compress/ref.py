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


#: thresholds a count evaluates at once (the JAX kernel's NCAND)
NCAND = 128
#: elements a chunk of the plain count compares at once (its (chunk, 128)
#: boolean table stays at 256 MB)
_COUNT_CHUNK = 1 << 21


def count_ge_ref(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """(128,) int64: for each threshold t_j, #{i : |x_i| >= t_j}, x
    compared in f32.  Exact integers; every element of x counts and
    nothing else (the JAX kernel also counts its zero padding where a
    threshold is <= 0)."""
    a = x.reshape(-1).float().abs()
    t = thresholds.reshape(NCAND).float()
    counts = torch.zeros((NCAND,), dtype=torch.int64, device=x.device)
    for s in range(0, a.numel(), _COUNT_CHUNK):
        counts += (a[s:s + _COUNT_CHUNK, None] >= t[None, :]).sum(dim=0)
    return counts


def apply_threshold_ref(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """``where(|x| >= t, x, +0.0)`` in x's type, |x| compared in f32 with
    the f32 scalar ``thresh``."""
    t = thresh.reshape(()).float()
    return torch.where(x.float().abs() >= t, x, torch.zeros((), dtype=x.dtype,
                                                             device=x.device))


def topk_sparsify_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Exact top-k by magnitude (port of ``ref.topk_sparsify_ref``): x
    times 1{|x| >= the k-th largest |x|}, so ties keep more than k and a
    dropped negative entry is −0.0."""
    flat = x.reshape(-1).abs()
    k = max(1, min(int(k), flat.numel()))
    thresh = torch.topk(flat, k).values[-1]
    return x * (x.abs() >= thresh).to(x.dtype)
