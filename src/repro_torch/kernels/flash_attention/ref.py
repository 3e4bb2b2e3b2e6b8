"""Plain PyTorch versions of flash attention (the CPU path, and what
``chip_smoke.py`` holds the CUDA kernels to on the card): a port of
``repro.kernels.flash_attention.ref.attention_ref``, the bf16 tensor-core
kernel's arithmetic with P rounded to bf16, and the f32 route's prep
kernel (``tf32_image_ref``, bitwise)."""

from __future__ import annotations

import torch

from repro_torch.kernels._tf32 import tf32_round

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
                  q_offset: int = 0, scale: float | None = None) -> torch.Tensor:
    """q (B, Hq, T, D), k/v (B, Hkv, S, D) with Hq = G·Hkv: the (B, Hq, T, D)
    attention output in q's type.  Logits and softmax in f32; a row that
    sees no key gives 0 (the reference's ``isnan → 0``).  ``scale``
    (default D ** -0.5) multiplies the logits: the true width's, for
    operands padded with zero columns."""
    B, Hq, T, D = q.shape
    Hkv, S = k.shape[1], k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, T, D).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * (
        D ** -0.5 if scale is None else scale)
    mask = _mask(T, S, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    probs = torch.nan_to_num(probs, nan=0.0)  # fully masked rows
    out = torch.einsum("bhgts,bhsd->bhgtd", probs, v.float())
    return out.reshape(B, Hq, T, D).to(q.dtype)


def attention_bf16p(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0, bk: int = 64, scale: float | None = None) -> torch.Tensor:
    """The tensor-core kernel's arithmetic, in the layout of
    ``attention_ref``: f32 logits, an online softmax over ``bk``-key tiles
    with f32 running (m, l), masked logits −1e30 with p exactly 0, p rounded
    to bf16 for the P·V product (f32 sums) while l sums the f32 p, and the
    divide by l where l > 0 (by 1 elsewhere, so a row that sees no key
    gives 0); rounded once to q's type; ``scale`` as in ``attention_ref``."""
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
        s = torch.einsum("bhgtd,bhsd->bhgts", qg, kf[:, :, k0:k0 + bk]) * (
            D ** -0.5 if scale is None else scale)
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


# ----------------------------------------------------------------------------
# The f32 route (csrc/flash_attention_tf32.cu): the prep kernel's image.
# ----------------------------------------------------------------------------

#: keys a prepared tile (the kernel's kBK)
TF32_TILE = 64
def vt_key_at(pk: torch.Tensor) -> torch.Tensor:
    """The key that the prep writes at position ``pk`` of a tile's Vᵀ rows
    (the kernel's ``key_at``): positions 0..3 of each 8 hold keys 0, 2, 4, 6
    and positions 4..7 keys 1, 3, 5, 7."""
    lo = pk & 7
    return (pk & ~7) | torch.where(lo < 4, 2 * lo, 2 * (lo - 4) + 1)


#: head widths that run tiles of their own width; any other multiple of 8
#: up to 256 runs in the width class at or above it (``width_class``)
OWN_WIDTHS = (8, 16, 32)


def width_class(D: int) -> int:
    """The width the kernels lay a head of D columns out at: D itself for
    ``OWN_WIDTHS``, else 64, 128 or 256 at or above it (zero past D)."""
    if D in OWN_WIDTHS:
        return D
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _tf32_tile_blocks(Dc: int) -> tuple[int, int]:
    """(32-column blocks of a K row, 64-row blocks of Vᵀ) at width class Dc."""
    return -(-Dc // 32), 1 if Dc < 64 else Dc // 64


def tf32_image_ref(k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The f32 route's prep kernel on k/v (B, S, Hkv, D) f32: the flat f32
    image of every (b, hkv, 64-key tile), each tile K's hi plane, K's lo
    plane, Vᵀ's hi plane, Vᵀ's lo plane.  K: 32-column blocks of 64 key rows
    × 32 floats; Vᵀ: 64-row blocks (a row a head column, zero past D) of two
    32-key blocks, keys ordered by ``vt_key_at``; every block in the 128-byte
    swizzle (float w of row r is column 4·((w // 4) ^ (r % 8)) + w % 4);
    zero past S.  hi = tf32(x), lo = tf32(x − hi).  The blocks are those of
    ``width_class(D)``, zero past D; at class 256 each of K's 64-column
    quarters and then each of Vᵀ's 64-row quarters holds its hi plane and
    then its lo plane (the parts the kernel streams)."""
    B, S, Hkv, D = k.shape
    Dc = width_class(D)
    kb, nb = _tf32_tile_blocks(Dc)
    split = Dc == 256
    nkt = -(-S // TF32_TILE)
    dev = k.device

    def tiles(x):  # (B, Hkv, nkt, 64, D), zero past S
        x = x.float().permute(0, 2, 1, 3)
        x = torch.nn.functional.pad(x, (0, 0, 0, nkt * TF32_TILE - S))
        return x.reshape(B, Hkv, nkt, TF32_TILE, D)

    def planes(vals, valid, plane):
        vals = torch.where(valid, vals, torch.zeros((), device=dev))
        hi = tf32_round(vals)
        return torch.where(plane == 0, hi, tf32_round(vals - hi))

    f = torch.arange(2 * kb * 2048, device=dev)
    if split:  # quarter, plane, 32-column block of the quarter
        plane, g = (f & 8191) // 4096, f & 4095
        cb = (f >> 13) * 2 + (g >> 11)
    else:
        plane, g = f // (kb * 2048), f % (kb * 2048)
        cb = g >> 11
    r, w = (g >> 5) & 63, g & 31
    c = cb * 32 + (((w >> 2) ^ r) & 7) * 4 + (w & 3)
    k_img = planes(tiles(k)[..., r, c.clamp(max=D - 1)], c < D, plane)

    f = torch.arange(2 * nb * 4096, device=dev)
    if split:  # quarter (64-row block), plane
        plane, g = (f & 8191) // 4096, f & 4095
        vb = f >> 13
    else:
        plane, g = f // (nb * 4096), f % (nb * 4096)
        vb = g >> 12
    rr, w = (g >> 5) & 63, g & 31
    pk = ((g >> 11) & 1) * 32 + (((w >> 2) ^ rr) & 7) * 4 + (w & 3)
    d = vb * 64 + rr
    v_img = planes(tiles(v)[..., vt_key_at(pk), d.clamp(max=D - 1)], d < D, plane)
    return torch.cat([k_img, v_img], dim=-1).reshape(-1)
