"""CUDA launches of the top-k kernels: the fused wire encode
(``csrc/wire_kernels.cu``) and the count and mask of ``topk_sparsify``
(``csrc/topk_sparsify.cu``).

Replaces ``repro.kernels.topk_compress.kernel``'s ``_encode_kernel``
(survivors + EF residual + survivor count) and ``_select_kernel`` (the same
without the residual).  Where the Pallas kernel walks one leaf's padded
(nb, 8, 1024) tiles in order and carries the count in VMEM scratch, this
kernel takes the (K, n) messages of all K nodes of one leaf at once, masks
the ragged row ends itself, and runs a grid of a few blocks an SM shared
among the rows, four 16-byte loads in flight a thread.  The count is an
integer sum through the warp and the block: a row of one block writes it,
a row of several adds one atomic a block to a count the launch zeroes
first, so the wrapper needs no fill.  Bound by bytes: 12 n (encode) or
8 n (select).

``count_ge`` and ``apply_threshold`` replace ``_count_kernel`` and
``_mask_kernel``.  The count runs blocks in parallel where the Pallas
kernel walks padded (nb, 8, 1024) tiles in order carrying f32 counts:
each block sorts the 128 thresholds, ranks each element by a branch-free
binary search of the sorted list (8 compares), adds it to a histogram of
ranks and turns the histogram's suffix sums into counts (``ref.count_ge_ranked`` does the same
in torch), integers with one 64-bit atomic per block and threshold, exact
at any size.  The mask is one streaming pass over a grid
that covers x once, each thread with two 16-byte loads in flight where x
starts on 16 bytes.  Neither pads: the kernels mask their own ragged
tails.  Bound by bytes: 4 n (2 n in bf16) a count, twice that a mask.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.topk_compress import ref


def encode_threshold(c: torch.Tensor, t: torch.Tensor, *, with_residual: bool):
    """Launch on CUDA ``c`` (K, n) with per-row thresholds ``t`` (K,):
    returns ``(o, res | None, count)`` with ``o = c if |c| >= t else +0``,
    ``res = c - o`` and ``count`` the int32 survivors per row."""
    build.check_rows(c, "topk encode c")
    build.check_vector(t, "topk encode threshold", c)
    lib = build.library()
    o = torch.empty_like(c)
    res = torch.empty_like(c) if with_residual else None
    count = torch.empty((c.shape[0],), dtype=torch.int32, device=c.device)
    with torch.cuda.device(c.device):
        status = lib.repro_topk_encode(
            c.data_ptr(), t.data_ptr(), o.data_ptr(),
            res.data_ptr() if with_residual else None, count.data_ptr(),
            c.shape[0], c.shape[1], build.stream_of(c),
        )
    build.check(status, "topk encode")
    kernels.LAUNCHES["topk_encode" if with_residual else "topk_select"] += 1
    return o, res, count


_SPARSIFY_DTYPES = (torch.float32, torch.bfloat16)


def _check_flat(x, what: str) -> None:
    """A contiguous f32 or bf16 CUDA tensor, read as its flat elements."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if x.dtype not in _SPARSIFY_DTYPES:
        raise ValueError(f"{what}: expected float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


def _check_thresholds(t, n: int, what: str, x) -> None:
    if not (isinstance(t, torch.Tensor) and t.device == x.device
            and t.dtype == torch.float32 and t.numel() == n and t.is_contiguous()):
        raise ValueError(
            f"{what}: expected {n} contiguous float32 threshold(s) on {x.device}")


def count_ge(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """Launch on CUDA ``x`` (any shape, f32 or bf16, contiguous) with 128
    f32 ``thresholds`` in any order: the (128,) int64 counts of
    |x| >= t_j, exact."""
    _check_flat(x, "topk count x")
    _check_thresholds(thresholds, ref.NCAND, "topk count", x)
    lib = build.library("topk_sparsify")
    counts = torch.zeros((ref.NCAND,), dtype=torch.int64, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.repro_count_ge(
            x.data_ptr(), x.numel(), thresholds.data_ptr(), counts.data_ptr(),
            int(x.dtype == torch.bfloat16), build.stream_of(x),
        )
    build.check(status, "topk count")
    kernels.LAUNCHES["topk_count"] += 1
    return counts


def apply_threshold(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Launch on CUDA ``x`` (f32 or bf16, contiguous) with one f32
    ``thresh`` on the card: ``where(|x| >= t, x, +0.0)`` in x's type and
    shape."""
    _check_flat(x, "topk mask x")
    _check_thresholds(thresh, 1, "topk mask", x)
    lib = build.library("topk_sparsify")
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        status = lib.repro_apply_threshold(
            x.data_ptr(), x.numel(), thresh.data_ptr(), out.data_ptr(),
            int(x.dtype == torch.bfloat16), build.stream_of(x),
        )
    build.check(status, "topk mask")
    kernels.LAUNCHES["topk_mask"] += 1
    return out
