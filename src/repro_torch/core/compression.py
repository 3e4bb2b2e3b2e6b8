"""Low-communication-overhead push path (port of ``repro.core.compression``).

The update-compression family on arbitrary parameter pytrees:

* ``topk``      — keep the k largest-magnitude entries per leaf;
* ``threshold`` — keep entries with ``|x| >= tau`` (value-dependent count);
* ``randk``     — keep a given random mask, rescaled by 1/fraction;
* ``int8``      — per-leaf symmetric linear quantization;
* error feedback — carry what was not transmitted into the next update.

Compressed representations stay dense-with-zeros; ``wire_bytes`` is what
would cross the wire (4-byte index + value per kept entry for the sparse
codecs, 1 byte/entry + a 4-byte scale for int8), as an f32 scalar tensor
like the JAX package's.

Dropped entries are written as +0.0 (``torch.where``): the JAX package
runs every wire under ``jit``, where XLA turns ``x * mask`` into a select
that writes +0.0, and these formulas match that bit for bit.  ``randk``
takes its mask as an input — ``jax.random`` bits cannot be reproduced in
torch, so callers (and the parity tests) pass the mask in.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

#: leaves below this element count skip the kernels (``kernel_plan``
#: reports the split so the wire layer can surface which path ran)
_KERNEL_MIN_SIZE = 256


def _kernel_eligible(x: torch.Tensor, *, min_size: int = _KERNEL_MIN_SIZE) -> bool:
    """Kernel path gate: at least ``min_size`` elements, and f32 — the
    fused kernels carry thresholds and scales in f32."""
    return x.numel() >= min_size and x.dtype == torch.float32


def kernel_plan(tree: PyTree, *, min_size: int = _KERNEL_MIN_SIZE) -> dict:
    """How many leaves take the kernel path vs the reference fallback."""
    hits = sum(_kernel_eligible(x, min_size=min_size) for x in tree_leaves(tree))
    misses = len(tree_leaves(tree)) - hits
    return {"kernel_leaves": hits, "fallback_leaves": misses, "min_size": min_size}


class Compressed(NamedTuple):
    tree: PyTree  # dense-with-zeros (topk/randk/threshold) or dequantized (int8)
    wire_bytes: torch.Tensor  # f32 scalar: bytes on the wire


def _topk_k(fraction: float, x: torch.Tensor) -> int:
    return max(1, int(round(fraction * x.numel())))


def _sparse_bytes(fraction: float, leaves) -> float:
    # 4-byte index + value bytes per kept entry
    return float(sum(_topk_k(fraction, x) * (4 + x.element_size()) for x in leaves))


def topk_rows(c: torch.Tensor, k: int) -> torch.Tensor:
    """Reference top-k of each row of ``c`` (K, n): entries at or above the
    row's exact k-th magnitude survive, the rest are +0.0."""
    k = max(1, min(int(k), c.shape[1]))
    t = torch.topk(c.abs(), k, dim=1).values[:, -1:]
    return torch.where(c.abs() >= t, c, 0.0)


def int8_rows(c: torch.Tensor) -> torch.Tensor:
    """Reference int8 round trip of each row of ``c`` (K, n), one scale per
    row: ``clip(round(c/s), ±127)·s`` with ``s = max(|c|, 1e-12)/127``,
    the division by 127 taken as a multiply by its f32 reciprocal, as XLA
    compiles it under jit (see ``kernels/int8_quant/ops.py``)."""
    m = c.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp_min(m, 1e-12) * (1.0 / 127.0)
    q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
    return q.to(c.dtype) * scale


def topk_compress(tree: PyTree, fraction: float, *, use_kernel: bool = False) -> Compressed:
    """Keep the top ``fraction`` of entries per leaf by magnitude."""

    def leaf(x):
        k = _topk_k(fraction, x)
        if use_kernel and _kernel_eligible(x):
            from repro_torch.kernels.topk_compress import ops as tk_ops

            return tk_ops.topk_encode(x[None], k=k)[0][0]
        return topk_rows(x.reshape(1, -1), k).view(x.shape)

    out = tree_map(leaf, tree)
    return Compressed(out, torch.tensor(_sparse_bytes(fraction, tree_leaves(tree))))


def threshold_compress(tree: PyTree, tau) -> Compressed:
    """Magnitude-threshold sparsification: keep entries with |x| ≥ tau.
    The on-device representation is shape-static; only ``wire_bytes``
    (survivors × (4 + itemsize), in f32) depends on the data."""

    def keep(x):
        return x.abs() >= torch.as_tensor(tau, dtype=x.dtype, device=x.device)

    out = tree_map(lambda x: torch.where(keep(x), x, 0.0), tree)
    nbytes = sum(
        keep(x).sum().to(torch.float32) * (4 + x.element_size())
        for x in tree_leaves(tree)
    )
    return Compressed(out, torch.as_tensor(nbytes, dtype=torch.float32))


def randk_compress(masks: PyTree, tree: PyTree, fraction: float) -> Compressed:
    """Random-k sparsification with the given boolean ``masks`` (one per
    leaf, e.g. ``uniform < fraction``), rescaled by 1/fraction to stay
    unbiased."""

    def leaf(m, x):
        return torch.where(m, x, 0.0) / torch.tensor(fraction, dtype=x.dtype)

    out = tree_map(leaf, masks, tree)
    return Compressed(out, torch.tensor(_sparse_bytes(fraction, tree_leaves(tree))))


def int8_compress(tree: PyTree, *, use_kernel: bool = False) -> Compressed:
    """Per-leaf symmetric int8 quantization (quantize→dequantize roundtrip)."""

    def leaf(x):
        if use_kernel and _kernel_eligible(x):
            from repro_torch.kernels.int8_quant import ops as q8_ops

            return q8_ops.int8_roundtrip(x[None])[0][0]
        return int8_rows(x.reshape(1, -1)).view(x.shape)

    out = tree_map(leaf, tree)
    nbytes = sum(x.numel() * 1 + 4 for x in tree_leaves(tree))
    return Compressed(out, torch.tensor(float(nbytes)))


class EFState(NamedTuple):
    """Error-feedback residual (one entry per parameter leaf)."""

    residual: PyTree


def ef_init(tree: PyTree) -> EFState:
    return EFState(tree_map(torch.zeros_like, tree))


def ef_compress(state: EFState, update: PyTree, compressor) -> tuple[EFState, Compressed]:
    """Error-feedback wrapper: compress (update + residual), carry the rest."""
    corrected = tree_map(torch.add, update, state.residual)
    comp = compressor(corrected)
    new_residual = tree_map(torch.sub, corrected, comp.tree)
    return EFState(new_residual), comp


def raw_bytes(tree: PyTree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))
