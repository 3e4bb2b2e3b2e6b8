"""CUDA launch of decode attention (``csrc/decode_attention.cu``).

Replaces ``repro.kernels.decode_attention.kernel``'s ``_decode_kernel``:
one query token per row against a dense KV cache view, the G query heads
of a GQA group sharing each staged K/V tile.  Where the Pallas kernel walks
(B, Hkv, Sp/bk) in order with an additive (B, Sp) bias row, the split
kernel runs one block per (kv head, row, run of ``chunk`` keys), takes
the group's heads eight at a time inside the block (any G), reads the
row's valid length from the device itself and stops at it, so neither the
bias row nor padding of S exists; its f32 partials (m, l, acc) are merged
by a second kernel (``decode_attention_merge``).  ``plan_splits`` picks the
run from S and the card's SM count.  Bound by bytes: the valid rows of K
and V, read once.
"""

from __future__ import annotations

import torch

from repro_torch import kernels
from repro_torch.kernels import build
from repro_torch.kernels._heads import MAX_HEAD_DIM, head_dim_error

# The kernels' domain: any GQA group G = Hq / Hkv >= 1 (MQA included) and
# the head widths ``_heads.head_dim_error`` takes, multiples of 8 up to 256
# (``ops.decode_attention`` pads any other D up to 256 with zero columns);
# D 8, 16, 32, 64 and 128 run exact instantiations, the rest width classes.
_DTYPES = (torch.float32, torch.bfloat16)
#: K/V rows a block stages at a time; a split covers a multiple of it
TILE = 64
#: blocks an SM the split aims for
BLOCKS_PER_SM = 2
#: the C interface's row counts (B, B·Hq) are ints
_INT_MAX = 2**31 - 1


def plan_splits(B: int, Hkv: int, S: int, sms: int) -> tuple[int, int]:
    """``(chunk, n_split)``: the keys a split covers (``TILE`` times a power
    of two) and ceil(S / chunk), so that B·Hkv·n_split blocks reach
    ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs where S allows it."""
    want = -(-BLOCKS_PER_SM * sms // (B * Hkv))
    chunk = TILE
    while chunk * 2 * want <= S:
        chunk *= 2
    return chunk, -(-S // chunk)


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


def _checked(q, k, v, valid_len) -> None:
    """Raise unless the operands are ones the split kernel takes."""
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
    why = head_dim_error(D, "ops.decode_attention")
    if why:
        raise ValueError(f"decode attention: {why}")
    if not (B >= 1 and 1 <= Hkv <= 65535 and S >= 1 and B * Hq <= _INT_MAX):
        raise ValueError(f"decode attention: unsupported shape {tuple(k.shape)}")
    if valid_len.dtype != torch.int32 or valid_len.shape != (B,):
        raise ValueError(
            f"decode attention valid_len: expected int32 ({B},), got "
            f"{valid_len.dtype} {tuple(valid_len.shape)}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid_len: torch.Tensor, *, scale_d: int | None = None) -> torch.Tensor:
    """Launch on CUDA ``q`` (B, Hq, D), ``k``/``v`` (B, S, Hkv, D) of one
    type (f32 or bf16) and ``valid_len`` (B,) int32: the (B, Hq, D)
    attention output in q's type: the split kernel, then the merge.  The
    logits are scaled by ``scale_d ** -0.5`` (default D: the true head
    width of operands padded with zero columns)."""
    _checked(q, k, v, valid_len)
    B, _, _ = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    chunk, n_split = plan_splits(B, Hkv, S, build.sm_count(q.device))
    if n_split > 65535:
        raise ValueError(f"decode attention: S={S} needs {n_split} splits (grid.z)")
    part_acc, part_ml = _split(q, k, v, valid_len, chunk, n_split, scale_d)
    return decode_merge(part_acc, part_ml, q.dtype).view(q.shape)


def _split(q, k, v, valid_len, chunk: int, n_split: int, scale_d: int | None):
    """Launch the split kernel on checked operands: the f32 partials
    ``(part_acc (B·Hq, n_split, D), part_ml (B·Hq, n_split, 2))``."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    part_acc = torch.empty((B * Hq, n_split, D), dtype=torch.float32, device=q.device)
    part_ml = torch.empty((B * Hq, n_split, 2), dtype=torch.float32, device=q.device)
    lib = build.library("decode_attention")
    with torch.cuda.device(q.device):
        status = lib.repro_decode_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), valid_len.data_ptr(),
            part_acc.data_ptr(), part_ml.data_ptr(), B, S, Hkv, Hq // Hkv, D, chunk, n_split,
            scale_d or D, int(q.dtype == torch.bfloat16), build.stream_of(q),
        )
    build.check(status, "decode attention")
    kernels.LAUNCHES["decode_attention"] += 1
    return part_acc, part_ml


def decode_partials(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: torch.Tensor, chunk: int, *, scale_d: int | None = None):
    """The split kernel alone, on the operands ``decode_attention`` takes,
    with splits of ``chunk`` keys (a positive multiple of ``TILE``):
    ``(part_acc, part_ml)`` as ``ref.decode_partials_plain`` gives them."""
    S = k.shape[1]
    if not (isinstance(chunk, int) and chunk >= TILE and chunk % TILE == 0):
        raise ValueError(f"decode attention: chunk {chunk} is no multiple of {TILE}")
    _checked(q, k, v, valid_len)
    return _split(q, k, v, valid_len, chunk, -(-S // chunk), scale_d)


def decode_merge(part_acc: torch.Tensor, part_ml: torch.Tensor, dtype) -> torch.Tensor:
    """Launch the merge on the split kernel's partials: the (B·Hq, D)
    rows in ``dtype``, viewed as ``(B, Hq, D)`` by the caller."""
    rows, n_split, D = part_acc.shape
    for x, last in ((part_acc, D), (part_ml, 2)):
        _check(x, "partials", part_acc.device)
        if x.dtype != torch.float32 or x.shape != (rows, n_split, last):
            raise ValueError(
                f"decode attention partials: expected float32 ({rows}, {n_split}, {last}), "
                f"got {x.dtype} {tuple(x.shape)}")
    if dtype not in _DTYPES or not 1 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"decode attention merge: no kernel for {dtype}, D={D} "
                         f"(float32 or bfloat16, D from 1 to {MAX_HEAD_DIM})")
    out = torch.empty((rows, D), dtype=dtype, device=part_acc.device)
    lib = build.library("decode_attention")
    with torch.cuda.device(part_acc.device):
        status = lib.repro_decode_merge(
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), rows, n_split, D,
            int(dtype == torch.bfloat16), build.stream_of(part_acc),
        )
    build.check(status, "decode attention merge")
    kernels.LAUNCHES["decode_attention_merge"] += 1
    return out
