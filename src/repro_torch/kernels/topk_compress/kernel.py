"""CUDA launch of the fused top-k wire encode (``csrc/wire_kernels.cu``).

Replaces ``repro.kernels.topk_compress.kernel``'s ``_encode_kernel``
(survivors + EF residual + survivor count) and ``_select_kernel`` (the same
without the residual).  Where the Pallas kernel walks one leaf's padded
(nb, 8, 1024) tiles in order and carries the count in VMEM scratch, this
kernel takes the (K, n) messages of all K nodes of one leaf at once, masks
the ragged row ends itself and sums the count with warp shuffles and one
integer atomic per warp.  Bound by bytes: 12 n (encode) or 8 n (select).
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build


def encode_threshold(c: torch.Tensor, t: torch.Tensor, *, with_residual: bool):
    """Launch on CUDA ``c`` (K, n) with per-row thresholds ``t`` (K,):
    returns ``(o, res | None, count)`` with ``o = c if |c| >= t else +0``,
    ``res = c - o`` and ``count`` the int32 survivors per row."""
    build.check_rows(c, "topk encode c")
    build.check_vector(t, "topk encode threshold", c)
    lib = build.library()
    o = torch.empty_like(c)
    res = torch.empty_like(c) if with_residual else None
    count = torch.zeros((c.shape[0],), dtype=torch.int32, device=c.device)
    with torch.cuda.device(c.device):
        status = lib.repro_topk_encode(
            c.data_ptr(), t.data_ptr(), o.data_ptr(),
            res.data_ptr() if with_residual else None, count.data_ptr(),
            c.shape[0], c.shape[1], build.stream_of(c),
        )
    build.check(status, "topk encode")
    kernels.LAUNCHES["topk_encode" if with_residual else "topk_select"] += 1
    return o, res, count
