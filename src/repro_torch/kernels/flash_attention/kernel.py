"""CUDA launch of forward flash attention: two kernels, routed by type.

Both replace ``repro.kernels.flash_attention.kernel``'s ``_flash_kernel``.
Where the Pallas kernel walks the grid (B, Hq, T/bq, S/bk) in order on
(B, H, T, D) operands padded to block multiples, carrying (m, l, acc) in
VMEM, each kernel runs one block per (b, h, query tile), loops over key
tiles itself from the window's left edge to the causal diagonal, reads the
model layout (B, T, H, D) through its strides and masks the ragged edges
itself, so nothing is padded (the f32 route's prep kernel writes k and vᵀ
once a call in the tiles its tensor cores read; ``ops`` pads a head width
that is no multiple of 8 with zero columns).  Bound by operations:
4·B·Hq·D per visible (query, key) pair.

The route is a fixed function of the type (``ROUTES``), not a fallback:

- bf16 → ``csrc/flash_attention_tc.cu``: both products on the tensor
  cores (``wgmma``, f32 accumulators), P rounded to bf16 for P·V, counted
  as ``flash_attention_tc``;
- f32 → ``csrc/flash_attention_tf32.cu``: both products on the tensor
  cores as three TF32 products a term (lo·hi + hi·lo + hi·hi of each
  value's split into hi = tf32(v) and lo = tf32(v − hi)), which holds the
  2e-5 f32 limit that one TF32 product would not.  Two launches a call:
  the prep kernel writes k and vᵀ as hi/lo planes in the tiles the tensor
  cores read (``tf32_image``, counted as ``flash_attention_tf32_prep``),
  then the attention kernel (counted as ``flash_attention_tf32``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels._heads import head_dim_error

# The kernels' domain: the head widths ``_heads.head_dim_error`` takes,
# multiples of 8 up to 256 (``ops.flash_attention`` pads any other D up to
# 256 with zero columns), any G, causal or not, any window and query offset;
# the f32 route runs D 8, 16 and 32 in tiles of their own width and any other
# D in the width class (64, 128, 256) at or above it; the bf16 route has
# exact instantiations at D 8, 16, 32, 64 and 128 and classes for the rest.
#: operand type -> the kernel that runs it (its ``kernels.LAUNCHES`` name)
ROUTES = {torch.float32: "flash_attention_tf32", torch.bfloat16: "flash_attention_tc"}
_INT_MAX = 2**31 - 1


def _check_head_dim(D: int) -> None:
    why = head_dim_error(D, "ops.flash_attention")
    if why:
        raise ValueError(f"flash attention: {why}")


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
    _check_head_dim(D)
    if min(B, T, S, Hq) < 1 or max(T, S, abs(q_offset) + T + S) > _INT_MAX:
        raise ValueError(
            f"flash attention: unsupported shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if not 0 <= window <= _INT_MAX:
        raise ValueError(f"flash attention: window {window} out of range")
    return B, T, S, Hq, Hkv, D


def tf32_image(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The f32 route's prep kernel on CUDA f32 ``k``/``v`` (B, S, Hkv, D):
    the flat f32 image of their 64-key tiles as the tensor cores read them
    (``ref.tf32_image_ref`` is its plain version, bitwise).  Counted as
    ``flash_attention_tf32_prep``."""
    _check(k, "k")
    _check(v, "v", k.device)
    if k.dtype != torch.float32 or v.dtype != torch.float32 or v.shape != k.shape:
        raise ValueError(f"flash attention prep: k, v must be f32 of one shape, got "
                         f"{k.dtype} {tuple(k.shape)}, {v.dtype} {tuple(v.shape)}")
    B, S, Hkv, D = k.shape
    _check_head_dim(D)
    if max(B, S, Hkv) > _INT_MAX:
        raise ValueError(f"flash attention prep: unsupported shape {tuple(k.shape)}")
    lib = build.library("flash_attention_tf32")
    nbytes = lib.repro_flash_tf32_image_bytes(B, S, Hkv, D)
    image = torch.empty((nbytes // 4,), dtype=torch.float32, device=k.device)
    c_strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    with torch.cuda.device(k.device):
        status = lib.repro_flash_tf32_prep(k.data_ptr(), v.data_ptr(), image.data_ptr(),
                                           c_strides, B, S, Hkv, D, build.stream_of(k))
    build.check(status, "flash attention tf32 prep")
    kernels.LAUNCHES["flash_attention_tf32_prep"] += 1
    return image


def tf32_attend(q: torch.Tensor, image: torch.Tensor, S: int, Hkv: int, *,
                causal: bool = True, window: int = 0, q_offset: int = 0,
                scale_d: int | None = None) -> torch.Tensor:
    """The f32 route's attention kernel alone: CUDA f32 ``q`` (B, T, Hq, D)
    over ``image``, the prepared tiles of k/v (B, S, Hkv, D) that
    ``tf32_image`` wrote.  Counted as ``flash_attention_tf32``."""
    _check(q, "q")
    B, T, Hq, D = q.shape
    _check_head_dim(D)
    if q.dtype != torch.float32 or Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash attention tf32: unsupported q {q.dtype} {tuple(q.shape)}, "
                         f"Hkv {Hkv}")
    lib = build.library("flash_attention_tf32")
    if not (isinstance(image, torch.Tensor) and image.device == q.device
            and image.dtype == torch.float32 and image.is_contiguous()
            and image.numel() * 4 == lib.repro_flash_tf32_image_bytes(B, S, Hkv, D)):
        raise ValueError("flash attention tf32: image is not the prepared tiles of "
                         f"({B}, {S}, {Hkv}, {D}) k/v")
    if not 0 <= window <= _INT_MAX or max(T, S, abs(q_offset) + T + S) > _INT_MAX:
        raise ValueError(f"flash attention tf32: unsupported window {window} or shapes")
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    c_strides = (ctypes.c_longlong * 3)(*q.stride()[:3])
    with torch.cuda.device(q.device):
        status = lib.repro_flash_attention_tf32(
            q.data_ptr(), image.data_ptr(), out.data_ptr(), c_strides, B, T, S, Hq, Hq // Hkv,
            D, int(bool(causal)), int(window), int(q_offset), scale_d or D, build.stream_of(q))
    build.check(status, "flash attention tf32")
    kernels.LAUNCHES["flash_attention_tf32"] += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale_d: int | None = None) -> torch.Tensor:
    """Launch on CUDA ``q`` (B, T, Hq, D), ``k``/``v`` (B, S, Hkv, D) of
    one type (f32 or bf16), any strides with D contiguous: the contiguous
    (B, T, Hq, D) attention output in q's type, from the kernel that
    ``route(q.dtype)`` names (each launch counted where it happens).  The
    logits are scaled by ``scale_d ** -0.5`` (default D: the true head
    width of operands padded with zero columns)."""
    _check(q, "q")
    name = route(q.dtype)
    B, T, S, Hq, Hkv, D = _validate(q, k, v, window, q_offset)
    if name == "flash_attention_tf32":  # the prep kernel, then attention on its image
        return tf32_attend(q, tf32_image(k, v), S, Hkv, causal=causal, window=window,
                           q_offset=q_offset, scale_d=scale_d)
    out = torch.empty((B, T, Hq, D), dtype=q.dtype, device=q.device)
    strides = [s for x in (q, k, v) for s in x.stride()[:3]]
    c_strides = (ctypes.c_longlong * 9)(*strides)
    # the last argument: whether cp.async may copy 16 bytes (8 bf16 elements)
    # from every row, i.e. every base and stride is on 16 bytes
    aligned = int(all(s % 8 == 0 for s in strides)
                  and all(x.data_ptr() % 16 == 0 for x in (q, k, v)))
    with torch.cuda.device(q.device):
        status = build.library("flash_attention_tc").repro_flash_attention_tc(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), c_strides,
            B, T, S, Hq, Hq // Hkv, D, int(bool(causal)), int(window), int(q_offset),
            aligned, scale_d or D, build.stream_of(q),
        )
    build.check(status, "flash attention tc")
    kernels.LAUNCHES[name] += 1
    return out
