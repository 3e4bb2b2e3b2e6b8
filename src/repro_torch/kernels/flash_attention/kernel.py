"""CUDA launch of forward flash attention: two kernels, routed by type.

Both replace ``repro.kernels.flash_attention.kernel``'s ``_flash_kernel``.
Where the Pallas kernel walks the grid (B, Hq, T/bq, S/bk) in order on
(B, H, T, D) operands padded to block multiples, carrying (m, l, acc) in
VMEM, each kernel runs one block per (b, h, query tile), loops over key
tiles itself from the window's left edge to the causal diagonal, reads the
model layout (B, T, H, D) through its strides and masks the ragged edges
itself, so nothing is transposed or padded.  Bound by operations:
4·B·Hq·D per visible (query, key) pair.

The route is a fixed function of the type (``ROUTES``), not a fallback:

- bf16 → ``csrc/flash_attention_tc.cu``: both products on the tensor
  cores (``wgmma``, f32 accumulators), P rounded to bf16 for P·V, counted
  as ``flash_attention_tc``;
- f32 → ``csrc/flash_attention.cu``: everything in f32 on the CUDA cores,
  which holds the 2e-5 f32 limit that TF32 or bf16 products would not,
  counted as ``flash_attention``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build

#: the head widths the kernels are instantiated for (those of the decode
#: kernel: every config of the repo and every shape of the JAX tests)
HEAD_DIMS = (8, 16, 32, 64, 128)
#: operand type -> the kernel that runs it (its ``kernels.LAUNCHES`` name)
ROUTES = {torch.float32: "flash_attention", torch.bfloat16: "flash_attention_tc"}
_INT_MAX = 2**31 - 1


def route(dtype) -> str:
    """The kernel that runs operands of ``dtype``."""
    if dtype not in ROUTES:
        raise ValueError(
            f"flash attention: q, k, v must share float32 or bfloat16, got {dtype}")
    return ROUTES[dtype]


def _check(x, what: str, device=None) -> None:
    if not isinstance(x, torch.Tensor) or x.device.type != "cuda":
        raise ValueError(f"flash attention {what}: expected a CUDA tensor")
    if device is not None and x.device != device:
        raise ValueError(f"flash attention {what}: on {x.device}, q is on {device}")
    if x.dim() != 4 or x.stride(3) != 1:
        raise ValueError(
            f"flash attention {what}: expected a (B, T, H, D) tensor whose last "
            f"dimension is contiguous, got shape {tuple(x.shape)}, strides {x.stride()}")


def _validate(q, k, v, window: int, q_offset: int):
    _check(q, "q")
    _check(k, "k", q.device)
    _check(v, "v", q.device)
    if k.dtype != q.dtype or v.dtype != q.dtype or q.dtype not in ROUTES:
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
    return B, T, S, Hq, Hkv, D


def _launch(name: str, q, k, v, *, causal: bool, window: int, q_offset: int):
    """Launch ``name``'s kernel (checked operands) and count it there."""
    B, T, S, Hq, Hkv, D = _validate(q, k, v, window, q_offset)
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    c_strides = (ctypes.c_longlong * 9)(*strides)
    if name == "flash_attention_tc":
        # its last argument: whether cp.async may copy 16 bytes (8 bf16
        # elements) from every row, i.e. every base and stride is on 16 bytes
        mode = int(all(s % 8 == 0 for s in strides)
                   and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
        fn = build.library("flash_attention_tc").repro_flash_attention_tc
    else:  # its last argument: the element type
        mode = int(q.dtype == torch.bfloat16)
        fn = build.library("flash_attention").repro_flash_attention
    with torch.cuda.device(q.device):
        status = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), c_strides,
            B, T, S, Hq, Hq // Hkv, D, int(bool(causal)), int(window), int(q_offset),
            mode, build.stream_of(q),
        )
    build.check(status, name.replace("_", " "))
    kernels.LAUNCHES[name] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Launch on CUDA ``q`` (B, T, Hq, D), ``k``/``v`` (B, S, Hkv, D) of
    one type (f32 or bf16), any strides with D contiguous: the contiguous
    (B, T, Hq, D) attention output in q's type, from the kernel that
    ``route(q.dtype)`` names."""
    _check(q, "q")
    return _launch(route(q.dtype), q, k, v, causal=causal, window=window,
                   q_offset=q_offset)


def flash_attention_cuda_cores(q, k, v, *, causal: bool = True, window: int = 0,
                               q_offset: int = 0) -> torch.Tensor:
    """The f32 CUDA-core kernel on f32 or bf16 operands, whatever the
    route: how ``chip_smoke.py`` times it beside the tensor-core kernel on
    the same bf16 inputs.  Counted as ``flash_attention``."""
    return _launch("flash_attention", q, k, v, causal=causal, window=window,
                   q_offset=q_offset)
