"""Hand-written CUDA kernels of the port, one package per JAX kernel package.

Each ``<name>/`` mirrors ``repro.kernels.<name>``: ``ref.py`` holds the
plain PyTorch version of every kernel, ``kernel.py`` the ctypes wrapper that
launches the CUDA kernel, and ``ops.py`` the public functions that take the
plain version for a CPU tensor and the kernel for a CUDA tensor (and raise
for anything else — there is no silent fallback).

``LAUNCHES`` counts kernel launches by kernel name.  A wrapper adds one
exactly where it launches, so a run can show that its main path went
through the kernels::

    from repro_torch import kernels
    kernels.reset_launches()
    ...                                  # drive a fit or a server on the card
    kernels.LAUNCHES["topk_encode"]      # launches since the reset

``PADS`` counts the calls whose operands an attention wrapper padded with
zero columns to a head width its kernels take (a D that is no multiple of
8), by the wrapper's name: one copy of q, k and v that a run can see.
"""

from __future__ import annotations

#: the kernels of this package, by the name their wrapper counts under
KERNEL_NAMES = (
    "topk_encode", "topk_select", "int8_absmax", "int8_quant", "int8_encode",
    "decode_attention", "decode_attention_merge", "pdist_argmin", "pdist_argmin_tc",
    "flash_attention_tf32_prep", "flash_attention_tf32", "flash_attention_tc", "topk_count",
    "topk_mask",
)

#: launches per kernel name since the last ``reset_launches``
LAUNCHES: dict = dict.fromkeys(KERNEL_NAMES, 0)

#: the wrappers that pad head widths
PADDED_NAMES = ("decode_attention", "flash_attention")
#: padded calls per wrapper since the last ``reset_launches``
PADS: dict = dict.fromkeys(PADDED_NAMES, 0)


def reset_launches() -> None:
    LAUNCHES.update(dict.fromkeys(KERNEL_NAMES, 0))
    PADS.update(dict.fromkeys(PADDED_NAMES, 0))
