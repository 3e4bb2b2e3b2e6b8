"""CUDA launches of the int8 wire kernels (``csrc/wire_kernels.cu``).

Replace ``repro.kernels.int8_quant.kernel``'s ``_absmax_kernel`` (streaming
per-lane max of |x| carried across grid steps in VMEM) and
``_quant_kernel`` (clip(round(x/s))·s in one pass).  On Hopper the blocks
run in no order, so absmax reduces in registers, warp shuffles and shared
memory over a grid of a few blocks an SM and meets across blocks in one
``atomicMax`` per block and row on the bits of |x| (exact: non-negative
floats order like their bit patterns).  All take the
(K, n) stack of one leaf, one scale per row.  Bound by bytes: 4 n (absmax)
and 8 n (quant-dequant).

``int8_encode`` is the whole int8 wire encode of a leaf: the EF add, the
row max, the scale, the round trip and the residual.  A row of at most
``one_launch_max()`` (16,384) elements takes one launch (route A: one
block a row holds it in registers; counted as ``int8_encode``), a longer
one absmax then quant-dequant on ``m + r`` (route B; counted as
``int8_absmax`` and ``int8_quant``).  Bound by bytes: 16 n with EF and 8 n
without (route A), 24 n and 12 n (route B).
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


def one_launch_max() -> int:
    """The longest row ``int8_encode`` takes in one launch (route A)."""
    return int(build.library().repro_int8_encode_one_launch_max())


def int8_encode(m: torch.Tensor, r: torch.Tensor | None = None):
    """Launch on CUDA ``m`` (K, n), with EF residuals ``r`` (K, n) or none:
    ``(out, res | None, scale)`` for ``c = m + r``, ``scale`` (K,) =
    ``clamp_min(max |c|, 1e-12) * (1/127)``, ``out`` = ``clip(rint(c /
    s), ±127)`` through int8 times ``s`` and ``res = c - out``."""
    build.check_rows(m, "int8 encode m")
    if r is not None:
        build.check_rows(r, "int8 encode r")
        if r.shape != m.shape or r.device != m.device:
            raise ValueError(f"int8 encode r: expected {tuple(m.shape)} on {m.device}")
    lib = build.library()
    rows, n = m.shape
    one_launch = n <= one_launch_max()
    out = torch.empty_like(m)
    res = None if r is None else torch.empty_like(m)
    scale = torch.empty((rows,), dtype=torch.float32, device=m.device)
    bits = None if one_launch else torch.empty((rows,), dtype=torch.int32, device=m.device)
    with torch.cuda.device(m.device):
        status = lib.repro_int8_encode(
            m.data_ptr(), None if r is None else r.data_ptr(), out.data_ptr(),
            None if res is None else res.data_ptr(), scale.data_ptr(),
            None if bits is None else bits.data_ptr(), rows, n, build.stream_of(m),
        )
    build.check(status, "int8 encode")
    if one_launch:
        kernels.LAUNCHES["int8_encode"] += 1
    else:
        kernels.LAUNCHES["int8_absmax"] += 1
        kernels.LAUNCHES["int8_quant"] += 1
    return out, res, scale
