"""Int8 symmetric quantization round trip, kernel-fused.

Counterpart of ``repro.kernels.int8_quant.ops``: ``scale = max(|x|,
1e-12)/127`` and ``out = clip(round(x/scale))·scale``, bitwise what the
jitted JAX package computes.  Under ``jit`` XLA rewrites the division by
the constant 127 into a multiply by its f32 reciprocal (``x / scale``
stays a true division), so the scale here is ``max(|x|, 1e-12) *
(1/127)`` — a true ``/ 127`` differs from it in the last bit for some
inputs.  Each function takes the (K, …) stack of one leaf, one scale per
node row; the CUDA kernels run for CUDA tensors and their plain versions
for CPU ones.

``int8_encode`` is the wire's whole encode of a leaf (EF add, scale,
round trip, residual), one launch where a row fits on chip;
``int8_roundtrip`` is that encode without a residual.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.int8_quant import kernel, ref


def _rows(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).contiguous()


def absmax(x: torch.Tensor) -> torch.Tensor:
    """(K,) f32 maxima of |x| over each row of ``x`` (K, …)."""
    rows = _rows(x)
    if rows.device.type == "cuda":
        return kernel.absmax(rows)
    if rows.device.type == "cpu":
        return ref.absmax_ref(rows)
    raise ValueError(f"int8 absmax: no kernel for device {x.device}")


def quant_dequant(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``clip(round(x/scale))·scale`` per row of ``x`` (K, …), shaped like
    ``x``."""
    rows = _rows(x)
    if rows.device.type == "cuda":
        return kernel.quant_dequant(rows, scale).view(x.shape)
    if rows.device.type == "cpu":
        return ref.quant_dequant_ref(rows, scale).view(x.shape)
    raise ValueError(f"int8 quant: no kernel for device {x.device}")


def _encode(m: torch.Tensor, r: torch.Tensor | None):
    """``(out, res | None, scale)`` of rows ``m`` (K, n) and ``r``: the
    kernel for CUDA tensors, the plain version for CPU ones."""
    if m.device.type == "cuda":
        return kernel.int8_encode(m, r)
    if m.device.type == "cpu":
        return ref.int8_encode_ref(m, r)
    raise ValueError(f"int8 encode: no kernel for device {m.device}")


@torch.library.custom_op("repro_torch::int8_encode", mutates_args=())
def _int8_encode_op(m: torch.Tensor,
                    r: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The int8 wire encode of the stack ``m`` (R, …) and its residuals
    ``r``: one launch where a row fits on chip.  Without ``r`` the second
    output is empty."""
    out, res, scale = _encode(_rows(m), None if r is None else _rows(r))
    res = m.new_empty((0,)) if res is None else res.view(m.shape)
    return out.view(m.shape), res, scale


@_int8_encode_op.register_fake
def _(m, r):
    res = m.new_empty((0,)) if r is None else torch.empty_like(m)
    return torch.empty_like(m), res, m.new_empty((m.shape[0],))


def _int8_encode_vmap(info, in_dims, m, r):
    # (S, R, …) scenarios fold into S·R rows, one scale a row: the encode
    # launches once for all S
    def batched(x, dim):
        return x.movedim(dim, 0) if dim is not None else x.expand((info.batch_size,) + x.shape)

    m = batched(m, in_dims[0])
    S, R = m.shape[0], m.shape[1]
    fold = (S * R,) + tuple(m.shape[2:])
    if r is not None:
        r = batched(r, in_dims[1]).reshape(fold)
    out, res, scale = _int8_encode_op(m.reshape(fold), r)
    res = res.new_empty((S, 0)) if r is None else res.view(m.shape)
    return (out.view(m.shape), res, scale.view(S, R)), (0, 0, 0)


torch.library.register_vmap("repro_torch::int8_encode", _int8_encode_vmap)


def int8_encode(m: torch.Tensor, r: torch.Tensor | None = None):
    """The int8 wire encode of the stacked leaf ``m`` (K, …), plus EF
    residuals ``r`` (same shape) when given: per node row ``c = m + r``,
    ``scale = clamp_min(max |c|, 1e-12) * (1/127)``, ``out =
    clip(round(c / scale), ±127)·scale`` and ``res = c - out``.  Returns
    ``(out, res | None, scale)`` with ``scale`` (K,).  For one unstacked
    leaf call ``int8_encode(x[None])``.

    A row of at most 16,384 elements is one launch on the card, a longer
    one two (``kernel.int8_encode``).  A custom op
    (``repro_torch::int8_encode``): under ``torch.func.vmap`` the S
    scenarios' stacks run as one call on S·K rows."""
    out, res, scale = _int8_encode_op(m, r)
    return out, (None if r is None else res), scale


@torch.library.custom_op("repro_torch::int8_roundtrip", mutates_args=())
def _int8_roundtrip_op(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    out, _, scale = _encode(_rows(x), None)
    return out.view(x.shape), scale


@_int8_roundtrip_op.register_fake
def _(x):
    return torch.empty_like(x), x.new_empty((x.shape[0],))


def _int8_roundtrip_vmap(info, in_dims, x):
    # (S, K, …) scenarios fold into S·K rows, one scale a row: the encode
    # launches once for all S
    x = x.movedim(in_dims[0], 0)
    S, K = x.shape[0], x.shape[1]
    out, scale = _int8_roundtrip_op(x.reshape((S * K,) + tuple(x.shape[2:])))
    return (out.view(x.shape), scale.view(S, K)), (0, 0)


torch.library.register_vmap("repro_torch::int8_roundtrip", _int8_roundtrip_vmap)


def int8_roundtrip(x: torch.Tensor):
    """``(dequantized, scale)`` for the stacked leaf ``x`` (K, …), with
    ``scale`` the (K,) per-row scales: ``int8_encode(x)`` without a
    residual.  For one unstacked leaf call ``int8_roundtrip(x[None])``.  A
    custom op (``repro_torch::int8_roundtrip``): under ``torch.func.vmap``
    the S scenarios' stacks run as one encode on S·K rows."""
    return _int8_roundtrip_op(x)
