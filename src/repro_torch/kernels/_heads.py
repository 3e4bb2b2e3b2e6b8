"""Head widths of the attention kernels (decode and flash): the widths they
take, and the zero-column pad that brings any other width up to one."""

from __future__ import annotations

import torch

from repro_torch import kernels

#: the widest head the kernels take (no public decoder's is wider)
MAX_HEAD_DIM = 256
#: head widths the kernels take are multiples of this: a row of 16-byte
#: chunks in bf16
HEAD_ALIGN = 8


def head_dim_error(D: int, ops: str) -> str | None:
    """Why the kernels take no head width D, or None when they do; ``ops``
    names the wrapper that pads."""
    if 1 <= D <= MAX_HEAD_DIM and D % HEAD_ALIGN == 0:
        return None
    if D > MAX_HEAD_DIM:
        return (f"no kernel for D={D}: the kernels take head widths up to {MAX_HEAD_DIM} "
                f"(wgmma's N is at most 256, and a 64-row output tile of D f32 columns "
                f"is already 128 registers a thread at D 256; no public decoder's head "
                f"is wider)")
    return (f"no kernel for D={D}: the kernels take D a multiple of {HEAD_ALIGN} from "
            f"{HEAD_ALIGN} to {MAX_HEAD_DIM} ({ops} pads other widths)")


def padded_width(D: int) -> int:
    """The head width the kernels run a D of 1..256 at: D rounded up to a
    multiple of ``HEAD_ALIGN``."""
    return -(-D // HEAD_ALIGN) * HEAD_ALIGN


def pad_heads(x: torch.Tensor, width: int) -> torch.Tensor:
    """``x`` with zero columns appended to its last dimension up to ``width``."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1])).contiguous()


def run_padded(launch, name: str, q, k, v, *args, **kw):
    """``launch(q, k, v, *args, **kw)`` at a head width the kernels take.  A
    D of 1..256 that is no multiple of ``HEAD_ALIGN`` is padded with zero
    columns (one copy of q, k and v, counted in ``kernels.PADS[name]``), the
    logits keep the true D's scale (``scale_d=D``) and the output's first D
    columns come back; any other D goes to ``launch`` as it is, which runs
    it or refuses it."""
    D = q.shape[-1]
    Dp = padded_width(D)
    if Dp == D or D > MAX_HEAD_DIM:
        return launch(q, k, v, *args, **kw)
    kernels.PADS[name] += 1
    out = launch(pad_heads(q, Dp), pad_heads(k, Dp), pad_heads(v, Dp), *args, scale_d=D, **kw)
    return out[..., :D].contiguous()
