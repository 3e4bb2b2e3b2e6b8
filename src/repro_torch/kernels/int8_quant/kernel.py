"""CUDA launches of the int8 wire kernels (``csrc/wire_kernels.cu``).

Replace ``repro.kernels.int8_quant.kernel``'s ``_absmax_kernel`` (streaming
per-lane max of |x| carried across grid steps in VMEM) and
``_quant_kernel`` (clip(round(x/s))·s in one pass).  On Hopper the blocks
run in no order, so absmax reduces in registers, warp shuffles and shared
memory over a grid of a few blocks an SM and meets across blocks in one
``atomicMax`` per block and row on the bits of |x| (exact: non-negative
floats order like their bit patterns).  Both take the
(K, n) stack of one leaf, one scale per row.  Bound by bytes: 4 n (absmax)
and 8 n (quant-dequant).
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build


def absmax(x: torch.Tensor) -> torch.Tensor:
    """Launch on CUDA ``x`` (K, n): the (K,) f32 row maxima of |x|."""
    build.check_rows(x, "int8 absmax x")
    lib = build.library()
    out = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        status = lib.repro_absmax(
            x.data_ptr(), out.data_ptr(), x.shape[0], x.shape[1],
            build.stream_of(x),
        )
    build.check(status, "int8 absmax")
    kernels.LAUNCHES["int8_absmax"] += 1
    return out


def quant_dequant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch on CUDA ``x`` (K, n) with per-row ``scale`` (K,):
    ``clip(rint(x / s), ±127)`` through int8, times ``s``."""
    build.check_rows(x, "int8 quant x")
    build.check_vector(scale, "int8 quant scale", x)
    lib = build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        status = lib.repro_quant_dequant(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(),
            x.shape[0], x.shape[1], build.stream_of(x),
        )
    build.check(status, "int8 quant")
    kernels.LAUNCHES["int8_quant"] += 1
    return out
