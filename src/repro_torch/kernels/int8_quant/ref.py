"""Plain PyTorch versions of the int8 wire kernels (the CPU path, and what
``chip_smoke.py`` holds the CUDA kernels to on the card)."""

from __future__ import annotations

import torch


def absmax_ref(x: torch.Tensor) -> torch.Tensor:
    """(K,) row maxima of |x| for ``x`` (K, n)."""
    return x.abs().amax(dim=1)


def quant_dequant_ref(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x / s), ±127)`` through int8, times ``s``, per row.
    ``torch.round`` rounds half to even like ``jnp.round``, and the divide
    is IEEE, so this is bitwise the jitted JAX formula."""
    s = scale[:, None]
    q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return q.to(x.dtype) * s


def int8_encode_ref(m: torch.Tensor, r: torch.Tensor | None = None):
    """The int8 wire encode of rows ``m`` (K, n) with EF residuals ``r``:
    ``(out, res | None, scale)`` for ``c = m + r``, composed of the two
    halves above as the wire composed them before the encode was one
    kernel: ``scale = clamp_min(absmax(c), 1e-12) * (1/127)``, ``out =
    quant_dequant(c, scale)``, ``res = c - out``."""
    c = m if r is None else m + r
    scale = torch.clamp_min(absmax_ref(c), 1e-12) * (1.0 / 127.0)
    out = quant_dequant_ref(c, scale)
    return out, (None if r is None else c - out), scale


def int8_roundtrip_ref(x: torch.Tensor):
    """The whole tensor as one row: ``(dequantised x, scale)`` with
    ``scale = max(max |x|, 1e-12) / 127`` (a true divide, as the JAX
    package's un-jitted ``int8_roundtrip_ref``), composed from the two
    halves above."""
    row = x.reshape(1, -1)
    scale = torch.clamp_min(absmax_ref(row), 1e-12) / 127.0
    return quant_dequant_ref(row, scale).reshape(x.shape), scale[0]
