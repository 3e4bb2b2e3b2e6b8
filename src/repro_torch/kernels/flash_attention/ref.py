"""Plain PyTorch version of flash attention (the CPU path, and what
``chip_smoke.py`` holds the CUDA kernel to on the card): a port of
``repro.kernels.flash_attention.ref.attention_ref``."""

from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, T, D), k/v (B, Hkv, S, D) with Hq = G·Hkv: the (B, Hq, T, D)
    attention output in q's type.  Query t sits at position t + q_offset
    and sees key s iff s <= t + q_offset (causal) and s > t + q_offset -
    window (window > 0).  Logits and softmax in f32; a row that sees no key
    gives 0 (the reference's ``isnan → 0``)."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, T, D).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * (D ** -0.5)
    qpos = torch.arange(T, device=q.device)[:, None] + q_offset
    kpos = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully masked rows
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.float())
    return out.reshape(B, Hq, T, D).to(q.dtype)
