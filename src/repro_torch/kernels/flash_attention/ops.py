"""Forward flash attention in the model layout, kernel-backed.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``:
q (B, T, Hq, D), k/v (B, S, Hkv, D), the semantics of the model's cache-free
``_sdpa`` path.  The CUDA kernel runs for CUDA tensors and reads the layout
through its strides, so none of the JAX wrapper's transposes and padding
to block multiples exist; the plain version (``ref.attention_ref``) runs
for CPU tensors; any other device raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """(B, T, Hq, D) attention of q over k/v in q's type.

    ``bq`` and ``bk`` are the JAX wrapper's block sizes, kept for the
    signature; they change no result here (the kernel's tiles are fixed,
    the plain version has none)."""
    if q.device.type == "cuda":
        return kernel.flash_attention(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset)
    if q.device.type == "cpu":
        out = ref.attention_ref(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, q_offset=q_offset)
        return out.transpose(1, 2)
    raise ValueError(f"flash attention: no kernel for device {q.device}")
