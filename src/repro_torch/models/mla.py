"""Multi-head Latent Attention (port of ``repro.models.mla``): DeepSeek-V2/V3,
MiniCPM3.

The cache stores only the compressed latent ``c_kv`` (kv_lora_rank) and one
shared roped key per position.  Two decode paths:

* ``absorb=False`` (paper-faithful): up-project the whole cached latent to
  per-head K/V every step;
* ``absorb=True`` (the published inference optimisation): fold ``W_uk``
  into the query and ``W_uv`` into the output, so attention runs in the
  latent space.  This path reads ``w_uk`` / ``w_uv`` in f32 from the
  parameter tree, so it needs them in the parameter type
  (``KEEP_LEAVES``: ``transformer.compute_params`` leaves them uncast).

The attention is plain products, as in the reference (its einsums run
outside any Pallas kernel): ``torch.einsum`` with f32 logits.  Where the
reference asks for ``preferred_element_type=f32`` from bf16 operands, the
operands are upcast first (a bf16 ``einsum`` would round its output), as
``attention._sdpa`` does.  Caches are written in place, at ``cache.index``
(a host int).
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.cache import MLACache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense, dense_init, rmsnorm, rmsnorm_init
from repro_torch.sharding.rules import per_block, pin_grad, same_blocks, split_dim, unshard_dim

#: subtrees ``transformer.compute_params`` leaves in the parameter type
KEEP_LEAVES = ("w_uk", "w_uv")


def mla_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    m, H = cfg.mla, cfg.num_heads
    kw = dict(dtype=dtype, device=device)
    return {
        "w_dq": dense_init(gen, cfg.d_model, m.q_lora_rank, **kw),
        "q_norm": rmsnorm_init(m.q_lora_rank, dtype, device),
        "w_uq": dense_init(gen, m.q_lora_rank,
                           H * (m.qk_nope_head_dim + m.qk_rope_head_dim), **kw),
        "w_dkv": dense_init(gen, cfg.d_model, m.kv_lora_rank, **kw),
        "kv_norm": rmsnorm_init(m.kv_lora_rank, dtype, device),
        "w_kr": dense_init(gen, cfg.d_model, m.qk_rope_head_dim, **kw),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim, **kw),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim, **kw),
        "w_o": dense_init(gen, H * m.v_head_dim, cfg.d_model, **kw),
    }


def _queries(p, cfg: ModelConfig, x, positions):
    m, H = cfg.mla, cfg.num_heads
    B, T, _ = x.shape
    cq = rmsnorm(p["q_norm"], dense(p["w_dq"], x), eps=cfg.rms_eps)
    q = split_dim(dense(p["w_uq"], cq), -1, H, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta)


def _attend(q_nope, q_rope, k_nope, k_rope, v, mask, *, scale):
    """The non-absorbed path's attention in f32: per-head q / k (B, ·, H,
    ·), the shared roped key (B, S, d_rope), v (B, S, H, d_v), a (T, S)
    mask.  ``DTensor`` K / V sharded on batch and heads only: each rank
    attends on its block (``sharding.rules.per_block``), the shared key
    whole along the heads."""
    pl = same_blocks((0, 2), k_nope, v)
    if pl is not None and all(isinstance(a, DTensor) for a in (q_nope, q_rope, k_rope)):
        pl_rope = [Replicate() if p == Shard(2) else p for p in pl]
        return per_block(functools.partial(_attend, scale=scale), pl,
                         q_nope, q_rope, k_nope, k_rope, v, mask,
                         in_placements=(pl, pl, pl, pl_rope, pl, None))
    logits_rope = torch.einsum("bthd,bsd->bhts", q_rope.float(), k_rope.float())
    logits_nope = torch.einsum("bthd,bshd->bhts", q_nope.float(), k_nope.float())
    logits = torch.where(mask, (logits_nope + logits_rope) * scale, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())


def mla_apply(p, cfg: ModelConfig, x: torch.Tensor, *, positions: torch.Tensor,
              cache: MLACache | None = None, absorb: bool = False, **_):
    """``(y, new_cache)``: train/prefill when ``cache is None``, else write
    x's T tokens into the cache at ``cache.index`` and attend over it."""
    m, H = cfg.mla, cfg.num_heads
    B, T, _ = x.shape
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5

    q_nope, q_rope = _queries(p, cfg, x, positions)
    c_kv_new = dense(p["w_dkv"], x)  # (B, T, r): the raw latent, cached
    k_rope_new = apply_rope(
        dense(p["w_kr"], x)[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]

    if cache is None:
        c_kv, k_rope = c_kv_new, k_rope_new
        S, idx = T, 0
        new_cache = None
    else:
        S, idx = cache.c_kv.shape[1], cache.index
        start = max(0, min(idx, S - T))  # where dynamic_update_slice writes
        cache.c_kv[:, start:start + T] = c_kv_new.to(cache.c_kv.dtype)
        cache.k_rope[:, start:start + T] = k_rope_new.to(cache.k_rope.dtype)
        c_kv, k_rope = cache.c_kv, cache.k_rope
        new_cache = MLACache(c_kv=c_kv, k_rope=k_rope, index=idx + T)
        # a latent cache sharded on its sequence (it has no head dimension
        # to shard) is gathered along it first: torch 2.11's DTensor cannot
        # flatten (batch, sequence) both sharded for the up-projections
        c_kv, k_rope = unshard_dim(c_kv, 1), unshard_dim(k_rope, 1)
    qpos = idx + torch.arange(T, device=x.device)[:, None]
    mask = torch.arange(S, device=x.device)[None, :] <= qpos

    ckv_n = rmsnorm(p["kv_norm"], c_kv.to(x.dtype), eps=cfg.rms_eps)  # (B, S, r)

    if not absorb:
        k_nope = split_dim(dense(p["w_uk"], ckv_n), -1, H, m.qk_nope_head_dim)
        v = split_dim(dense(p["w_uv"], ckv_n), -1, H, m.v_head_dim)
        out = _attend(q_nope, q_rope, k_nope, k_rope.to(x.dtype), v, mask, scale=scale)
    else:
        logits_rope = torch.einsum("bthd,bsd->bhts", q_rope.float(),
                                   k_rope.to(x.dtype).float())
        # q_lat = q_nope · W_uk: attend in the latent space, all in f32
        w_uk = split_dim(p["w_uk"]["kernel"], 1, H, m.qk_nope_head_dim)
        q_lat = torch.einsum("bthd,rhd->bthr", q_nope.float(), w_uk.float())
        ckv32 = ckv_n.float()
        logits_nope = torch.einsum("bthr,bsr->bhts", q_lat, ckv32)
        logits = torch.where(mask, (logits_nope + logits_rope) * scale, -1e30)
        probs = torch.softmax(logits, dim=-1)
        ctx_lat = torch.einsum("bhts,bsr->bthr", probs, ckv32)  # (B, T, H, r)
        w_uv = split_dim(p["w_uv"]["kernel"], 1, H, m.v_head_dim)
        out = torch.einsum("bthr,rhd->bthd", ctx_lat, w_uv.float())

    # the gradient reaches the heads whole where they do not divide the
    # model axis, as in ``attention.attn_apply``
    y = dense(p["w_o"], pin_grad(out.to(x.dtype).reshape(B, T, H * m.v_head_dim)))
    return y, new_cache
