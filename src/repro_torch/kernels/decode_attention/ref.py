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


def decode_attention_plain(q, k, v, valid_len) -> torch.Tensor:
    """The kernel's single-pass math as ``ops.decode_attention_xla`` writes
    it: additive 0/−1e30 bias, max → exp → masked p @ v → divide by l,
    guarded by l > 0 (a row with no valid key gives 0), all in f32 and
    rounded once to q's type."""
    B, Hq, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    mask = _key_mask(valid_len, B, S, q.device)
    bias = torch.where(mask, 0.0, NEG_INF).to(torch.float32)[:, None, None, :]
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k.float()) * (D ** -0.5)
    s = s + bias
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(bias > NEG_INF / 2, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    out = acc / torch.where(l > 0.0, l, 1.0)
    return out.reshape(B, Hq, D).to(q.dtype)
