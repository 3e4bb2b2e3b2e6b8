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
"""

from __future__ import annotations

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


@torch.library.custom_op("repro_torch::int8_roundtrip", mutates_args=())
def _int8_roundtrip_op(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    m = absmax(x)
    scale = torch.clamp_min(m, 1e-12) * (1.0 / 127.0)
    return quant_dequant(x, scale), scale


@_int8_roundtrip_op.register_fake
def _(x):
    return torch.empty_like(x), x.new_empty((x.shape[0],))


def _int8_roundtrip_vmap(info, in_dims, x):
    # (S, K, …) scenarios fold into S·K rows, one scale a row: the absmax
    # and quant kernels launch once for all S
    x = x.movedim(in_dims[0], 0)
    S, K = x.shape[0], x.shape[1]
    out, scale = _int8_roundtrip_op(x.reshape((S * K,) + tuple(x.shape[2:])))
    return (out.view(x.shape), scale.view(S, K)), (0, 0)


torch.library.register_vmap("repro_torch::int8_roundtrip", _int8_roundtrip_vmap)


def int8_roundtrip(x: torch.Tensor):
    """``(dequantized, scale)`` for the stacked leaf ``x`` (K, …), with
    ``scale`` the (K,) per-row scales.  For one unstacked leaf call
    ``int8_roundtrip(x[None])``.  A custom op
    (``repro_torch::int8_roundtrip``): under ``torch.func.vmap`` the S
    scenarios' stacks run as one absmax and one quant launch on S·K rows."""
    return _int8_roundtrip_op(x)
