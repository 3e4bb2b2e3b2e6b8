"""CUDA launch of decode attention (``csrc/decode_attention.cu``).

Replaces ``repro.kernels.decode_attention.kernel``'s ``_decode_kernel``:
one query token per row against a dense KV cache view, the G query heads
of a GQA group sharing each staged K/V tile.  Where the Pallas kernel walks
(B, Hkv, Sp/bk) in order with an additive (B, Sp) bias row, this kernel runs
one block per (kv head, row), reads the row's valid length from the device
itself and stops at it, so neither the bias row nor padding of S exists.
Bound by bytes: the valid rows of K and V, read once.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build

#: the GQA group sizes and head widths the kernel is instantiated for — every
#: config of the repo and every shape of the JAX package's tests
GROUPS = (1, 2, 4, 6, 8)
HEAD_DIMS = (8, 16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def _check(x, what: str, device=None, *, rows: bool = True) -> None:
    """A contiguous CUDA operand on ``device``; ``rows``: read in 16-byte
    chunks, so its base must be 16-byte aligned."""
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"decode attention {what}: expected a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(
            f"decode attention {what}: on {x.device}, q is on {device}")
    if not x.is_contiguous():
        raise ValueError(f"decode attention {what}: expected a contiguous tensor")
    if rows and x.data_ptr() % 16:
        raise ValueError(f"decode attention {what}: base pointer is not 16-byte aligned")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor) -> torch.Tensor:
    """Launch on CUDA ``q`` (B, Hq, D), ``k``/``v`` (B, S, Hkv, D) of one
    type (f32 or bf16) and ``valid_len`` (B,) int32: the (B, Hq, D)
    attention output in q's type."""
    _check(q, "q")
    _check(k, "k", q.device)
    _check(v, "v", q.device)
    _check(valid_len, "valid_len", q.device, rows=False)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"decode attention: q, k, v must share float32 or bfloat16, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"decode attention: expected q (B, Hq, D) and k, v (B, S, Hkv, D), "
            f"got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, D = q.shape
    Bk, S, Hkv, Dk = k.shape
    if Bk != B or Dk != D or Hq % Hkv:
        raise ValueError(
            f"decode attention: q {tuple(q.shape)} does not match k {tuple(k.shape)}")
    G = Hq // Hkv
    if G not in GROUPS or D not in HEAD_DIMS:
        raise ValueError(
            f"decode attention: no kernel for G={G}, D={D} "
            f"(G in {GROUPS}, D in {HEAD_DIMS})")
    if not (1 <= B <= 65535 and 1 <= Hkv <= 65535 and S >= 1):
        raise ValueError(f"decode attention: unsupported shape {tuple(k.shape)}")
    if valid_len.dtype != torch.int32 or valid_len.shape != (B,):
        raise ValueError(
            f"decode attention valid_len: expected int32 ({B},), got "
            f"{valid_len.dtype} {tuple(valid_len.shape)}")
    lib = build.library("decode_attention")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        status = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
            out.data_ptr(), B, S, Hkv, G, D, int(q.dtype == torch.bfloat16),
            build.stream_of(q),
        )
    build.check(status, "decode attention")
    kernels.LAUNCHES["decode_attention"] += 1
    return out
