"""Single-token decode attention, kernel-backed.

Counterpart of ``repro.kernels.decode_attention.ops.decode_attention``:
q (B, Hq, D), any G = Hq / Hkv, against k/v (B, S, Hkv, D) with per-row
``valid_len`` (B,) or a scalar.  The CUDA kernel runs for CUDA tensors;
its plain version (``ref.decode_attention_plain``) for CPU ones.  Unlike
the JAX wrapper S is not padded: the kernel masks its own ragged tail.  A
head width that is no multiple of 8 (below 256) is padded with zero
columns to the next one, as the JAX wrapper pads T and S, with the true
width's scale; such calls are counted in ``kernels.PADS``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._heads import run_padded
from repro_torch.kernels.decode_attention import kernel, ref


def decode_attention(q, k, v, valid_len) -> torch.Tensor:
    """(B, Hq, D) attention of one query token per row over the first
    ``valid_len`` keys of its row, in q's type."""
    if q.device.type == "cuda":
        vl = torch.as_tensor(valid_len, device=q.device).to(torch.int32)
        vl = vl.reshape(-1).expand(q.shape[0]).contiguous()
        return run_padded(kernel.decode_attention, "decode_attention", q, k, v, vl)
    if q.device.type == "cpu":
        return ref.decode_attention_plain(q, k, v, valid_len)
    raise ValueError(f"decode attention: no kernel for device {q.device}")
