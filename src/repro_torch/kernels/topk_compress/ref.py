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


def _order_key(t: torch.Tensor) -> torch.Tensor:
    """int64 keys that order f32 ``t`` like the floats, with -0.0 and +0.0
    equal and every NaN after +inf (the count kernel's ``order_key``)."""
    b = t.contiguous().view(torch.int32).long()
    key = torch.where(b >= 0, b, b ^ 0x7FFFFFFF)
    key = torch.where(t == 0, torch.zeros_like(key), key)
    return torch.where(torch.isnan(t), torch.full_like(key, 0x7FFFFFFF), key)


def count_ge_ranked(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """``count_ge_ref``'s counts computed as the CUDA count kernel computes
    them (test-only; its arithmetic cannot run off the card): a stable
    rank sort of the thresholds, NaN last, laid out padded (s_j at j +
    j // 32); each element's bin by 7 halving steps and a last compare
    over the padded positions; a histogram of bins; bin b is rank
    r = b - b // 33 = #{j : |x| >= s_j}; and counts[perm[j]] = the sum
    over ranks j + 1..128."""
    a = x.reshape(-1).float().abs().cpu()
    t = thresholds.reshape(NCAND).float().cpu()
    key = _order_key(t)
    idx = torch.arange(NCAND)
    before = (key[:, None] < key[None, :]) | ((key[:, None] == key[None, :])
                                             & (idx[:, None] < idx[None, :]))
    rank = before.sum(dim=0)  # rank[j] = #{i : t_i precedes t_j}
    padded = torch.full((NCAND + NCAND // 32,), float("nan"))
    padded[rank + rank // 32] = t
    perm = torch.empty_like(idx)
    perm[rank] = idx
    bins = torch.zeros((NCAND + NCAND // 32,), dtype=torch.int64)
    for c in range(0, a.numel(), _COUNT_CHUNK):
        ac = a[c:c + _COUNT_CHUNK]
        upper = ac >= padded[64]  # s_63
        pb = torch.where(upper, 66, 0)
        pb = pb + 33 * (ac >= torch.where(upper, padded[97], padded[31])).long()
        for half in (16, 8, 4, 2, 1):
            pb = pb + half * (ac >= padded[pb + half - 1]).long()
        bins += torch.bincount(pb + (ac >= padded[pb]).long(), minlength=bins.numel())
    b = torch.arange(bins.numel())
    hist = torch.zeros((NCAND + 1,), dtype=torch.int64).index_add_(0, b - b // 33, bins)
    suffix = hist[1:].flip(0).cumsum(0).flip(0)  # suffix[j] = ranks j + 1..128
    counts = torch.empty((NCAND,), dtype=torch.int64)
    counts[perm] = suffix
    return counts.to(x.device)


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
