"""CUDA launch of forward flash attention (``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.kernel``'s ``_flash_kernel``.
Where the Pallas kernel walks the grid (B, Hq, T/bq, S/bk) in order on
(B, H, T, D) operands padded to block multiples, carrying (m, l, acc) in
VMEM, this kernel runs one block per (b, h, 64-row query tile), loops over
64-key tiles itself from the window's left edge to the causal diagonal,
reads the model layout (B, T, H, D) through its strides and masks the
ragged edges itself, so nothing is transposed or padded.  f32 online
softmax and accumulators on the CUDA cores, output rounded once to q's
type.  Bound by operations: 4·B·Hq·D per visible (query, key) pair.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

#: the head widths the kernel is instantiated for (those of the decode
#: kernel: every config of the repo and every shape of the JAX tests)
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_INT_MAX = 2**31 - 1


def _check(x, what: str, device=None) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"flash attention {what}: expected a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"flash attention {what}: on {x.device}, q is on {device}")
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError(
            f"flash attention {what}: expected a (B, T, H, D) tensor whose last "
            f"dimension is contiguous, got shape {tuple(x.shape)}, strides {x.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Launch on CUDA ``q`` (B, T, Hq, D), ``k``/``v`` (B, S, Hkv, D) of
    one type (f32 or bf16), any strides with D contiguous: the contiguous
    (B, T, Hq, D) attention output in q's type."""
    _check(q, "q")
    _check(k, "k", q.device)
    _check(v, "v", q.device)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"flash attention: q, k, v must share float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, T, Hq, D = q.shape
    Bk, S, Hkv, Dk = k.shape
    if v.shape != k.shape or Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(
            f"flash attention: q {tuple(q.shape)} does not match k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash attention: no kernel for D={D} (D in {HEAD_DIMS})")
    if min(B, T, S, Hq) < 1 or max(T, S, abs(q_offset) + T + S) > _INT_MAX:
        raise ValueError(
            f"flash attention: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not 0 <= window <= _INT_MAX:
        raise ValueError(f"flash attention: window {window} out of range")
    lib = build.library("flash_attention")
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    strides = (ctypes.c_longlong * 9)(*(s for x in (q, k, v) for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        status = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            B, T, S, Hq, Hq // Hkv, D, int(bool(causal)), int(window), int(q_offset),
            int(q.dtype == torch.bfloat16), build.stream_of(q),
        )
    build.check(status, "flash attention")
    kernels.LAUNCHES["flash_attention"] += 1
    return out
