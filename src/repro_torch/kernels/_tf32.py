"""TF32 rounding as the 3xTF32 kernels do it (``tf32_rn`` in
``csrc/pdist_argmin_tc.cu`` and ``csrc/flash_attention_tf32.cu``), for the
plain versions that emulate or image their operands."""

from __future__ import annotations

import torch


def tf32_round(v: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (ties to even) as an f32 whose low 13
    bits are zero, by rounding the bits as the kernel does; inf and NaN
    pass unchanged."""
    u = v.float().contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    special = (u & 0x7F800000) == 0x7F800000
    r = torch.where(special, u, (u + 0xFFF + ((u >> 13) & 1)) & 0xFFFFE000)
    r = torch.where(r >= 2**31, r - 2**32, r)
    return r.to(torch.int32).view(torch.float32)
