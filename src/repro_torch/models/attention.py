"""Grouped-query attention with RoPE / M-RoPE and KV caches (port of
``repro.models.attention``).

Train and prefill attention (``cache is None``) is the plain ``_sdpa``
with f32 logits, as the reference leaves it to XLA; with
``cfg.attn_q_chunk`` it is ``_sdpa_q_chunked``, and with
``use_kernel=True`` and T >= 128 the flash-attention kernel
(``kernels.flash_attention``: the CUDA kernel on a CUDA tensor, its plain
version on the CPU).  The single-token decode path routes through the
decode-attention CUDA kernel (``decode_attn="cuda"``) or its plain PyTorch
version (``"plain"``); ``decode_attn="off"`` keeps the ``_sdpa`` math on
the dense cache.  With ``cfg.mrope_sections`` and ``mrope_positions``
given, q and k are rotated by M-RoPE before any branch (the flash kernel
reads them rotated), otherwise by RoPE of ``positions``, as in the
reference.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ref as da_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.cache import KVCache, PagedKVCache, paged_append, paged_view
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mrope, apply_rope, dense, dense_init
from repro_torch.sharding.rules import (
    current_mesh_context,
    maybe_shard,
    pin_grad,
    replicated_where_sharded,
    split_dim,
    splits_evenly,
)


def attn_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d, h * hd, **kw),
        "wk": dense_init(gen, d, hkv * hd, **kw),
        "wv": dense_init(gen, d, hkv * hd, **kw),
        "wo": dense_init(gen, h * hd, d, dtype=dtype, device=device),
    }


def _sdpa(q, k, v, mask, *, scale):
    """Softmax attention core; f32 logits and softmax whatever the input
    type (the reference's ``preferred_element_type=f32``).

    q: (B, T, H, D); k/v: (B, S, Hkv, D) with H = G·Hkv (GQA).
    mask: (B, T, S) or (T, S) boolean — True = attend.
    """
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if not splits_evenly(q, 2, Hkv) and replicated_where_sharded(k, q, 2):
        return _sdpa_repeat_kv(q, k, v, mask, scale=scale)
    qg = split_dim(q, 2, Hkv, H // Hkv)
    logits = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * scale
    m = mask if mask.dim() == 3 else mask[None]
    logits = torch.where(m[:, None, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def _sdpa_repeat_kv(q, k, v, mask, *, scale):
    """``_sdpa`` for a ``DTensor`` q whose head shards outnumber the KV
    heads (4 over a model axis of 16) and K/V are whole along those shards
    (train and prefill): K/V are repeated to q's H heads (head h reads KV
    head h // G) and sliced like q, and the attention, parallel over batch
    and heads, runs on each rank's block (``local_map`` with q's
    placements in and out) rather than gathering every head of q on every
    rank.  ``DTensor``'s own products would flatten two sharded batch
    dimensions into one, which it refuses before torch 2.13.  A decode
    cache sharded on its sequence keeps ``_sdpa``'s way: gathering q's one
    token is the cheaper move there."""
    from torch.distributed.tensor.experimental import local_map

    B, T, H, D = q.shape
    Hkv, G = k.shape[2], H // k.shape[2]

    def rep(x):
        return x[:, :, :, None].expand(B, x.shape[1], Hkv, G, D).reshape(B, -1, H, D)

    pl = list(q.placements)
    per_block = local_map(functools.partial(_sdpa, scale=scale), out_placements=pl,
                          in_placements=(pl, pl, pl, None), redistribute_inputs=True)
    return per_block(q, rep(k), rep(v), mask)


def _sdpa_q_chunked(q, k, v, *, scale, q_chunk: int, window: int = 0):
    """Causal attention over query chunks, one at a time — the plain path's
    analogue of flash attention's memory behaviour: only (B, H, q_chunk, S)
    logits are live at once.  q: (B, T, H, D); T must be a multiple of
    q_chunk."""
    T = q.shape[1]
    outs = []
    for i in range(T // q_chunk):
        mask = causal_mask(q_chunk, T, offset=i * q_chunk, window=window,
                           device=q.device)
        outs.append(_sdpa(q[:, i * q_chunk:(i + 1) * q_chunk], k, v, mask, scale=scale))
    return torch.cat(outs, dim=1)


def causal_mask(T: int, S: int, *, offset: int = 0, window: int = 0,
                device=None) -> torch.Tensor:
    """(T, S) mask; query i attends key j iff j <= i+offset (and within the
    sliding window when ``window > 0``)."""
    qpos = torch.arange(T, device=device)[:, None] + offset
    kpos = torch.arange(S, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m


def resolve_decode_attn(use_kernel, *, sliding_window: int = 0, device="cuda") -> str:
    """Map the public ``use_kernel`` knob (True / False / "auto") to the
    decode-attention implementation tag: "cuda" (the kernel — forced, or
    auto on a CUDA device) or "plain" (its plain PyTorch version — auto on
    the CPU, or the explicit opt-out ``use_kernel=False``).  The kernel has
    no CPU version, so ``True`` on the CPU raises; sliding-window attention
    has no kernel path and raises rather than changing semantics."""
    if sliding_window > 0:
        raise ValueError(
            "decode_attention has no sliding-window support — serve "
            "sliding-window models with decode_attn='off'"
        )
    on_cuda = torch.device(device).type == "cuda"
    if use_kernel == "auto":
        return "cuda" if on_cuda else "plain"
    if use_kernel:
        if not on_cuda:
            raise ValueError(
                f"use_kernel=True needs a CUDA device (got {device!r}): the "
                "decode-attention kernel has no CPU version")
        return "cuda"
    return "plain"


def decode_kernel_plan(cfg: ModelConfig, *, use_kernel="auto", device="cuda") -> dict:
    """Which implementation the single-token decode path takes, and why —
    so a run that claims kernel speed cannot silently be on the plain
    version."""
    if cfg.sliding_window > 0:
        return {
            "path": "off",
            "reason": f"sliding_window={cfg.sliding_window} (no kernel path)",
        }
    dev = torch.device(device)
    path = resolve_decode_attn(use_kernel, device=dev)
    if path == "cuda":
        reason = "forced by use_kernel=True" if use_kernel is True else f"device={dev}"
    elif use_kernel == "auto":
        reason = f"device={dev} — plain PyTorch version (the kernel needs CUDA)"
    else:
        reason = "use_kernel=False — plain PyTorch version (explicit opt-out)"
    return {"path": path, "reason": reason, "device": str(dev)}


def _decode_attend(q1, k_all, v_all, valid_len, *, impl: str):
    """One-token attention over a dense cache view via the decode kernel
    ("cuda") or its plain version ("plain").
    q1: (B, Hq, D); k/v: (B, S, Hkv, D); valid_len: (B,) or scalar."""
    if impl == "cuda":
        if q1.device.type != "cuda":
            raise ValueError(f"decode_attn='cuda' on a {q1.device} tensor")
        return da_ops.decode_attention(q1, k_all, v_all, valid_len)
    if impl == "plain":
        return da_ref.decode_attention_plain(q1, k_all, v_all, valid_len)
    raise ValueError(f"unknown decode_attn impl {impl!r}")


def attn_apply(
    p,
    cfg: ModelConfig,
    x: torch.Tensor,
    *,
    positions: torch.Tensor,
    cache: KVCache | PagedKVCache | None = None,
    mrope_positions: torch.Tensor | None = None,
    use_kernel: bool = False,
    pages: tuple | None = None,
    decode_attn: str = "off",
):
    """GQA attention.  Train/prefill when ``cache is None``; otherwise
    decode: write x's tokens into the cache at ``cache.index`` and attend
    over it.

    A ``PagedKVCache`` decodes through the block table instead:
    ``pages=(block, length)`` (slot → page ids, per-slot fill counts); the
    new token is written into the arena and attention runs on the gathered
    per-slot view through ``_decode_attend`` ("off" means "plain" there).
    Caches are updated in place and returned.
    """
    B, T, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cd = x.dtype

    q = split_dim(dense(p["wq"], x), -1, H, D)
    k = split_dim(dense(p["wk"], x), -1, Hkv, D)
    v = split_dim(dense(p["wv"], x), -1, Hkv, D)
    if cfg.mrope_sections and mrope_positions is not None:
        q = apply_mrope(q, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, mrope_positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    scale = D ** -0.5

    if cache is None:
        if use_kernel and T >= 128:
            out = fa_ops.flash_attention(
                q, k, v, causal=True, window=cfg.sliding_window)
        else:
            qc = 0 if cfg.unroll_time_scans else cfg.attn_q_chunk
            if qc and T > qc and T % qc == 0:
                out = _sdpa_q_chunked(
                    q, k, v, scale=scale, q_chunk=qc, window=cfg.sliding_window)
            else:
                mask = causal_mask(T, T, window=cfg.sliding_window, device=x.device)
                out = _sdpa(q, k, v, mask, scale=scale)
        new_cache = None
    elif isinstance(cache, PagedKVCache):
        if T != 1:
            raise ValueError("paged decode appends exactly one token")
        if cfg.sliding_window > 0:
            raise ValueError("paged decode needs full causal attention")
        block, length = pages
        new_cache = paged_append(cache, block, length, k[:, 0], v[:, 0])
        k_all, v_all = paged_view(new_cache, block)
        impl = decode_attn if decode_attn != "off" else "plain"
        out = _decode_attend(
            q[:, 0], k_all.to(cd), v_all.to(cd), length + 1, impl=impl,
        )[:, None]  # (B, 1, Hq, D)
    else:
        S = cache.k.shape[1]
        idx = cache.index
        start = max(0, min(idx, S - T))  # where dynamic_update_slice writes
        cache.k[:, start:start + T] = k.to(cache.k.dtype)
        cache.v[:, start:start + T] = v.to(cache.v.dtype)
        k_all, v_all = cache.k, cache.v
        ctx = current_mesh_context()
        if ctx is not None and "kvseq" in ctx.logical:
            # keep the cache sequence-sharded through the attention compute
            # (partial softmax per shard instead of all-gathering K/V)
            k_all = maybe_shard(k_all, "batch", "kvseq", None, None)
            v_all = maybe_shard(v_all, "batch", "kvseq", None, None)
        if decode_attn != "off" and T == 1 and cfg.sliding_window == 0:
            valid = torch.full((B,), idx + 1, dtype=torch.int32, device=x.device)
            out = _decode_attend(
                q[:, 0], k_all.to(cd), v_all.to(cd), valid, impl=decode_attn,
            )[:, None]
        else:
            # valid keys: j <= idx + i (T >= 1 appended tokens)
            mask = causal_mask(T, S, offset=idx, window=cfg.sliding_window,
                               device=x.device)
            out = _sdpa(q, k_all.to(cd), v_all.to(cd), mask, scale=scale)
        new_cache = KVCache(k=k_all, v=v_all, index=idx + T)

    # the gradient reaches the heads whole where they do not divide the
    # model axis: DTensor cannot view a head-sharded one back into heads
    y = dense(p["wo"], pin_grad(out.reshape(B, T, H * D)))
    return y, new_cache
