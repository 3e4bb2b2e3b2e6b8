"""Plain PyTorch versions of flash attention (the CPU path, and what
``chip_smoke.py`` holds the CUDA kernels to on the card): a port of
``repro.kernels.flash_attention.ref.attention_ref``, and the tensor-core
kernel's arithmetic with P rounded to bf16."""

from __future__ import annotations

import torch

#: the masked logit of the TPU kernel
NEG_INF = -1e30


def _mask(T: int, S: int, causal: bool, window: int, q_offset: int, device):
    """(T, S) bool: query t sits at position t + q_offset and sees key s
    iff s <= t + q_offset (causal) and s > t + q_offset - window
    (window > 0)."""
    qpos = torch.arange(T, device=device)[:, None] + q_offset
    kpos = torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Hq, T, D), k/v (B, Hkv, S, D) with Hq = G·Hkv: the (B, Hq, T, D)
    attention output in q's type.  Logits and softmax in f32; a row that
    sees no key gives 0 (the reference's ``isnan → 0``)."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, T, D).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * (D ** -0.5)
    mask = _mask(T, S, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully masked rows
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.float())
    return out.reshape(B, Hq, T, D).to(q.dtype)


def attention_bf16p(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, bk: int = 64) -> torch.Tensor:
    """The tensor-core kernel's arithmetic, in the layout of
    ``attention_ref``: f32 logits, an online softmax over ``bk``-key tiles
    with f32 running (m, l), masked logits −1e30 with p exactly 0, p rounded
    to bf16 for the P·V product (f32 sums) while l sums the f32 p, and the
    divide by l where l > 0 (by 1 elsewhere, so a row that sees no key
    gives 0); rounded once to q's type."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, T, D).float()
    kf, vf = k.float(), v.float()
    mask = _mask(T, S, causal, window, q_offset, q.device)
    m = torch.full(qg.shape[:-1], NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qg)
    for k0 in range(0, S, bk):
        keep = mask[:, k0:k0 + bk]
        s = torch.einsum("bhgtd,bhsd->bhgts", qg, kf[:, :, k0:k0 + bk]) * (D ** -0.5)
        s = torch.where(keep, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(keep, torch.exp(s - m_new[..., None]), 0.0)
        l = alpha * l + p.sum(dim=-1)
        pv = torch.einsum("bhgts,bhsd->bhgtd", p.bfloat16().float(), vf[:, :, k0:k0 + bk])
        acc = acc * alpha[..., None] + pv
        m = m_new
    out = acc / torch.where(l > 0.0, l, 1.0)[..., None]
    return out.reshape(B, Hq, T, D).to(q.dtype)
