"""CUDA launch of the nearest-centroid kernel (``csrc/pdist_argmin.cu``).

Replaces ``repro.kernels.pdist_argmin.kernel``'s ``_pdist_kernel``.  Where
the Pallas kernel keeps all of C resident in VMEM and walks point blocks
padded to ``bn``, this kernel stages C through shared memory in tiles of
16 centroids × 128 coordinates, runs one thread per point and masks the
ragged tail itself, so nothing is padded.  l2 is the direct form Σ(x − c)²
on the CUDA cores, not the TPU kernel's expanded form on its matrix unit.
Bound by arithmetic: 3·N·K·d f32 operations.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.pdist_argmin.ref import METRICS

_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, what: str, device=None) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"pdist_argmin {what}: expected a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"pdist_argmin {what}: on {x.device}, X is on {device}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"pdist_argmin {what}: expected a contiguous (rows, d) matrix")
    if x.dtype not in _DTYPES:
        raise ValueError(
            f"pdist_argmin {what}: expected float32 or bfloat16, got {x.dtype}")


def pdist_argmin(X: torch.Tensor, C: torch.Tensor, metric: str = "l2"):
    """Launch on CUDA ``X`` (N, d) and ``C`` (K, d) of one type (f32 or
    bf16): ``(idx int32 (N,), dist f32 (N,))``, the first index of each
    point's nearest centroid and its distance (l2 squared)."""
    _check(X, "X")
    _check(C, "C", X.device)
    if C.dtype != X.dtype:
        raise ValueError(
            f"pdist_argmin: X and C must share a type, got {X.dtype}, {C.dtype}")
    if metric not in METRICS:
        raise ValueError(metric)
    N, d = X.shape
    K = C.shape[0]
    if C.shape[1] != d or N < 1 or not 1 <= K < 2**31 or not 1 <= d < 2**31:
        raise ValueError(
            f"pdist_argmin: unsupported shapes X {tuple(X.shape)}, C {tuple(C.shape)}")
    lib = build.library("pdist_argmin")
    idx = torch.empty((N,), dtype=torch.int32, device=X.device)
    dist = torch.empty((N,), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        status = lib.repro_pdist_argmin(
            X.data_ptr(), C.data_ptr(), idx.data_ptr(), dist.data_ptr(), N, K, d,
            METRICS.index(metric), int(X.dtype == torch.bfloat16), build.stream_of(X),
        )
    build.check(status, "pdist_argmin")
    kernels.LAUNCHES["pdist_argmin"] += 1
    return idx, dist
