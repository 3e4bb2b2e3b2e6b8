"""Plain PyTorch versions of single-token decode attention (the CPU path,
and what ``chip_smoke.py`` holds the CUDA kernel to on the card).

Shapes as in the JAX package: q (B, Hq, D), one query token per row; k and
v (B, S, Hkv, D) with Hq = G·Hkv (GQA); ``valid_len`` (B,) or a scalar —
keys s < valid_len attend.
"""

from __future__ import annotations

import torch

#: the additive mask value of the TPU kernel and its XLA mirror
NEG_INF = -1e30


def _key_mask(valid_len, B: int, S: int, device) -> torch.Tensor:
    """(B, S) bool: key s of row b attends iff s < valid_len[b]."""
    vl = torch.as_tensor(valid_len, device=device).reshape(-1).expand(B)
    return torch.arange(S, device=device)[None, :] < vl[:, None]


def decode_attention_ref(q, k, v, valid_len) -> torch.Tensor:
    """Port of ``ref.decode_attention_ref``: masked logits, softmax, @ v,
    in f32 (a row with no valid key gives NaN, as there)."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    logits = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * (D ** -0.5)
    mask = _key_mask(valid_len, B, S, q.device)
    logits = logits.masked_fill(~mask[:, None, None, :], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v.float())
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_attention_plain(q, k, v, valid_len, *, scale: float | None = None) -> torch.Tensor:
    """The kernel's single-pass math as ``ops.decode_attention_xla`` writes
    it: additive 0/−1e30 bias, max → exp → masked p @ v → divide by l,
    guarded by l > 0 (a row with no valid key gives 0), all in f32 and
    rounded once to q's type.  ``scale`` (default D ** -0.5) multiplies
    the logits: the true width's, for operands padded with zero columns."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    mask = _key_mask(valid_len, B, S, q.device)
    bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * (D ** -0.5 if scale is None else scale)
    s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(bias > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = acc / torch.where(l > 0.0, l, 1.0)
    return out.reshape(B, Hq, D).to(q.dtype)


def decode_partials_plain(q, k, v, valid_len, chunk: int, *, scale: float | None = None):
    """The split kernel's arithmetic: for each run of ``chunk`` keys (any
    ``chunk`` >= 1 here), the f32 partial over its keys below valid_len —
    m (−1e30 where the run has none), l = Σ exp(s − m) and the unnormalised
    acc = Σ exp(s − m) v, masked p exactly 0.  Returns ``(part_acc
    (B·Hq, n_split, D), part_ml (B·Hq, n_split, 2))``, n_split =
    ceil(S / chunk), as the kernel writes them; ``scale`` as in
    ``decode_attention_plain``."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    n_split = -(-S // chunk)
    pad = n_split * chunk - S
    mask = _key_mask(valid_len, B, S, q.device)
    mask = torch.nn.functional.pad(mask, (0, pad), value=False)
    mask = mask.reshape(B, 1, 1, n_split, chunk)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * (D ** -0.5 if scale is None else scale)
    s = torch.nn.functional.pad(s, (0, pad)).reshape(B, Hkv, G, n_split, chunk)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, 0, 0, pad))
    acc = torch.einsum("bhgnc,bnchd->bhgnd", p, vf.reshape(B, n_split, chunk, Hkv, D))
    part_ml = torch.stack([m, p.sum(dim=-1)], dim=-1)
    return acc.reshape(B * Hq, n_split, D), part_ml.reshape(B * Hq, n_split, 2)


def decode_merge_plain(part_acc, part_ml, dtype) -> torch.Tensor:
    """The merge kernel's arithmetic: w_i = exp(m_i − max_i m_i), out =
    Σ w_i acc_i / Σ w_i l_i (by 1 where that is 0), rounded once to
    ``dtype``; (B·Hq, D)."""
    m, l = part_ml[..., 0], part_ml[..., 1]
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))
    den = (w * l).sum(dim=-1, keepdim=True)
    acc = (w[..., None] * part_acc).sum(dim=-2)
    return (acc / torch.where(den > 0.0, den, 1.0)).to(dtype)


def decode_attention_split_plain(q, k, v, valid_len, chunk: int) -> torch.Tensor:
    """Split-and-merge decode attention over runs of ``chunk`` keys: the
    two kernels' arithmetic end to end, (B, Hq, D) in q's type."""
    part_acc, part_ml = decode_partials_plain(q, k, v, valid_len, chunk)
    return decode_merge_plain(part_acc, part_ml, q.dtype).reshape(q.shape)
