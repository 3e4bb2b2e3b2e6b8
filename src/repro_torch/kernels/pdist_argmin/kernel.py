"""CUDA launch of nearest-centroid assignment: two kernels, routed by metric.

Both replace ``repro.kernels.pdist_argmin.kernel``'s ``_pdist_kernel``.
Where the Pallas kernel keeps all of C resident in VMEM and walks point
blocks padded to ``bn``, these kernels stream C through shared memory in
tiles and mask the ragged tail of X themselves, so X is never padded.

The route is a fixed function of the metric (``ROUTES``), not a fallback:

- l2 → ``csrc/pdist_argmin_tc.cu``: the TPU kernel's expanded form
  ‖x‖² − 2x·c + ‖c‖² with the cross term on the tensor cores (``wgmma``;
  3xTF32 in f32, one bf16 product in bf16), the best and second-best
  kept in registers, the winner's distance recomputed in the direct form,
  and the rows whose top-2 gap is inside the expanded form's error bound
  re-run in the direct form by a second kernel; counted as
  ``pdist_argmin_tc``.  Bound by the products: 3·2·N·K·d at 495 TF32
  TFLOP/s (bf16: 2·N·K·d at 989).
- l1, l∞ → ``csrc/pdist_argmin.cu``: neither metric has a matrix-product
  form, so it runs on the CUDA cores, bound by instruction issue (a
  subtract and an add or max a term).  A persistent grid: each block owns a
  range of points, stages C in shared memory once (in tiles when it does not
  fit), brings its points in with coalesced loads and keeps each point in
  registers (d ≤ 64; chunks of 64 columns above), with one broadcast of a
  centroid row feeding several running sums.  Rows wider than one staged
  centroid row (d > ``MAX_D_STAGED``) take a second kernel of the same
  source: d is cut into splits, each block carries its points' partials for
  16 centroids in registers across the split's 64-column chunks of C, and
  a merge folds the splits and takes the first least index.  Counted as
  ``pdist_argmin`` (one count a call on either path).
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels.pdist_argmin.ref import METRICS

_DTYPES = (torch.float32, torch.bfloat16)
#: metric -> the kernel that runs it (its ``kernels.LAUNCHES`` name)
ROUTES = {"l2": "pdist_argmin_tc", "l1": "pdist_argmin", "linf": "pdist_argmin"}
#: centroids a tensor-core n-tile (``kBN`` in the source); C is padded to it
TILE_N = 64
#: the widest rows the CUDA-core kernel stages whole: one centroid row, d
#: rounded up to 4 floats, in a block's 232,448 bytes of shared memory;
#: wider rows take the split kernel (``plan_wide``)
MAX_D_STAGED = 232448 // 4 - 4
#: the split kernel: points a block, centroids a block, columns a chunk
WIDE_POINTS, WIDE_CENTROIDS, WIDE_CHUNK = 256, 16, 64
#: split-kernel blocks an SM the plan aims for
WIDE_BLOCKS_PER_SM = 8


def plan_wide(N: int, K: int, d: int, sms: int) -> tuple[int, int]:
    """``(jlen, nsplit)`` of the split kernel: the columns a split covers (a
    multiple of ``WIDE_CHUNK``) and ceil(d / jlen), so that the grid of
    point tiles × centroid groups × splits reaches ``WIDE_BLOCKS_PER_SM``
    blocks on each of ``sms`` SMs where d allows it."""
    cells = -(-N // WIDE_POINTS) * -(-K // WIDE_CENTROIDS)
    want = max(1, -(-WIDE_BLOCKS_PER_SM * sms // cells))
    jlen = -(-d // want)
    jlen = max(WIDE_CHUNK, -(-jlen // WIDE_CHUNK) * WIDE_CHUNK)
    return jlen, -(-d // jlen)


def route(metric: str) -> str:
    """The kernel that runs ``metric``."""
    if metric not in ROUTES:
        raise ValueError(metric)
    return ROUTES[metric]


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


def _validate(X, C, metric: str):
    _check(X, "X")
    _check(C, "C", X.device)
    if C.dtype != X.dtype:
        raise ValueError(
            f"pdist_argmin: X and C must share a type, got {X.dtype}, {C.dtype}")
    if metric not in METRICS:
        raise ValueError(metric)
    N, d = X.shape
    K = C.shape[0]
    if C.shape[1] != d or N < 1 or not 1 <= K < 2**31 - TILE_N or not 1 <= d < 2**31:
        raise ValueError(
            f"pdist_argmin: unsupported shapes X {tuple(X.shape)}, C {tuple(C.shape)}")
    return N, K, d


def pdist_argmin(X: torch.Tensor, C: torch.Tensor, metric: str = "l2"):
    """Launch on CUDA ``X`` (N, d) and ``C`` (K, d) of one type (f32 or
    bf16) the kernel ``route(metric)`` names: ``(idx int32 (N,), dist f32
    (N,))``, the first index of each point's nearest centroid and its
    distance (l2 squared)."""
    _validate(X, C, metric)
    if route(metric) == "pdist_argmin_tc":
        return nearest_l2_tc(X, C)[:2]
    return pdist_argmin_cuda_cores(X, C, metric)


def pdist_argmin_cuda_cores(X: torch.Tensor, C: torch.Tensor, metric: str = "l1"):
    """The CUDA-core kernel (``csrc/pdist_argmin.cu``) under l1 or l∞:
    ``(idx int32 (N,), dist f32 (N,))``."""
    N, K, d = _validate(X, C, metric)
    if route(metric) != "pdist_argmin":
        raise ValueError(f"pdist_argmin: the CUDA-core kernel takes l1 and linf, not {metric}")
    lib = build.library("pdist_argmin")
    idx = torch.empty((N,), dtype=torch.int32, device=X.device)
    dist = torch.empty((N,), dtype=torch.float32, device=X.device)
    bf16 = int(X.dtype == torch.bfloat16)
    with torch.cuda.device(X.device):
        if d <= MAX_D_STAGED:
            status = lib.repro_pdist_argmin(
                X.data_ptr(), C.data_ptr(), idx.data_ptr(), dist.data_ptr(), N, K, d,
                METRICS.index(metric), bf16, build.stream_of(X),
            )
        else:  # rows wider than a staged centroid row: splits of d, then the merge
            jlen, nsplit = plan_wide(N, K, d, build.sm_count(X.device))
            if nsplit > 65535 or -(-K // WIDE_CENTROIDS) > 65535:
                raise ValueError(f"pdist_argmin: unsupported shapes X {tuple(X.shape)}, "
                                 f"C {tuple(C.shape)} (grid)")
            part = torch.empty((nsplit, K, N), dtype=torch.float32, device=X.device)
            status = lib.repro_pdist_argmin_wide(
                X.data_ptr(), C.data_ptr(), idx.data_ptr(), dist.data_ptr(), part.data_ptr(),
                N, K, d, jlen, nsplit, METRICS.index(metric), bf16, build.stream_of(X),
            )
    build.check(status, "pdist_argmin")
    kernels.LAUNCHES["pdist_argmin"] += 1
    return idx, dist


def nearest_l2_tc(X: torch.Tensor, C: torch.Tensor):
    """The tensor-core l2 route (``csrc/pdist_argmin_tc.cu``: the tile
    preparation, the product kernel and the direct-form recheck, on the
    current stream with no host synchronisation): ``(idx int32 (N,), dist
    f32 (N,), rechecked int32 (1,))``, the last the number of rows the
    guard re-ran in the direct form."""
    N, K, d = _validate(X, C, "l2")
    if N >= 2**31:
        raise ValueError(f"pdist_argmin: {N} points, the l2 route takes < 2^31")
    bf16 = int(X.dtype == torch.bfloat16)
    lib = build.library("pdist_argmin_tc")
    dev = X.device
    image = torch.empty((lib.repro_pdist_argmin_tc_image_bytes(K, d, bf16),),
                        dtype=torch.uint8, device=dev)
    c2 = torch.empty((-(-K // TILE_N) * TILE_N,), dtype=torch.float32, device=dev)
    scratch = torch.zeros((2,), dtype=torch.int32, device=dev)  # max ‖c‖², flag count
    flagged = torch.empty((N,), dtype=torch.int32, device=dev)
    idx = torch.empty((N,), dtype=torch.int32, device=dev)
    dist = torch.empty((N,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = lib.repro_pdist_argmin_tc(
            X.data_ptr(), C.data_ptr(), idx.data_ptr(), dist.data_ptr(), N, K, d, bf16,
            image.data_ptr(), c2.data_ptr(), scratch.data_ptr(), flagged.data_ptr(),
            build.stream_of(X),
        )
    build.check(status, "pdist_argmin_tc")
    kernels.LAUNCHES["pdist_argmin_tc"] += 1
    return idx, dist, scratch[1:]
