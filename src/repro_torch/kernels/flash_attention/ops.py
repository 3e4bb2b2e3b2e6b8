"""Forward flash attention in the model layout, kernel-backed.

Counterpart of ``repro.kernels.flash_attention.ops.flash_attention``:
q (B, T, Hq, D), k/v (B, S, Hkv, D), the semantics of the model's cache-free
``_sdpa`` path.  For CUDA tensors the kernel that ``kernel.route`` names for
the type runs (bf16: tensor cores; f32: 3xTF32 on the tensor cores),
reading the layout through its strides, so none of the JAX wrapper's
transposes and padding to block multiples exist; a head width that is no
multiple of 8 (below 256) is padded with zero columns to the next one, as
the JAX wrapper pads T and S, with the true width's scale (counted in
``kernels.PADS``).  For CPU tensors that kernel's plain version runs
(``ref.attention_bf16p`` for bf16, ``ref.attention_ref`` for f32); any
other device raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._heads import run_padded
from repro_torch.kernels.flash_attention import kernel, ref

#: kernel name -> its plain version, in the (B, H, T, D) layout
PLAIN = {"flash_attention_tf32": ref.attention_ref, "flash_attention_tc": ref.attention_bf16p}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """(B, T, Hq, D) attention of q over k/v in q's type.

    ``bq`` and ``bk`` are the JAX wrapper's block sizes, kept for the
    signature; they change no result here (the kernels' tiles are fixed,
    and so are their plain versions')."""
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cuda":
        return run_padded(kernel.flash_attention, "flash_attention", q, k, v, **kw)
    if q.device.type == "cpu":
        plain = PLAIN[kernel.route(q.dtype)]
        out = plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), **kw)
        return out.transpose(1, 2)
    raise ValueError(f"flash attention: no kernel for device {q.device}")
