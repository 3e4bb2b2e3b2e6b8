"""Core layers (port of ``repro.models.layers``): plain functions over dicts
of tensors, with the reference's parameter names (``kernel``, ``bias``,
``scale``, ``embedding``) so weights carry across leaf for leaf.

Each ``*_init`` draws from an explicit ``torch.Generator`` with the
reference's shapes and distributions (a truncated normal on ±2σ); the
numbers differ from ``jax.random``'s, so parity tests carry the reference's
weights across with ``repro_torch.convert.params_from_reference``.
The GELU is the tanh approximation, ``jax.nn.gelu``'s default (torch's
default is the erf form, about 1e-3 away).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.sharding.rules import unshard_dim


def truncated_normal(gen: torch.Generator, shape, dtype, stddev: float,
                     device=None) -> torch.Tensor:
    """``stddev`` × a standard normal truncated to [−2, 2]."""
    out = torch.empty(shape, dtype=torch.float32, device=device or gen.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return stddev * out.to(dtype)


# ----------------------------------------------------------------------------
# Dense
# ----------------------------------------------------------------------------

def dense_init(gen, d_in: int, d_out: int, *, bias: bool = False,
               dtype=torch.float32, device=None):
    stddev = (1.0 / d_in) ** 0.5
    p = {"kernel": truncated_normal(gen, (d_in, d_out), dtype, stddev, device)}
    if bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device or gen.device)
    return p


def dense(p, x):
    """Matmul in the activation's type: the weight is cast down to it, not
    the activation up (``layers.py:36`` of the reference).  A caller that
    holds weights already in that type (``transformer.compute_params``)
    makes the cast a no-op."""
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    return y


# ----------------------------------------------------------------------------
# Norms
# ----------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, *, eps: float = 1e-6):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, *, eps: float = 1e-5):
    """LayerNorm with f32 statistics, scale and bias read in f32."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mu) ** 2, dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


# ----------------------------------------------------------------------------
# Embedding
# ----------------------------------------------------------------------------

def embedding_init(gen, vocab: int, d: int, dtype=torch.float32, device=None):
    return {"embedding": truncated_normal(gen, (vocab, d), dtype, 0.02, device)}


def embed(p, ids, *, compute_dtype=None):
    # a vocabulary-sharded DTensor table is gathered whole first: the
    # masked partial sum DTensor's lookup makes cannot take a partial-sum
    # gradient back (torch 2.13)
    out = F.embedding(ids, unshard_dim(p["embedding"], 0))
    if compute_dtype is not None:
        out = out.to(compute_dtype)
    return out


def unembed(p, x):
    """Logits = x @ Eᵀ (tied), accumulated in f32: the reference's einsum
    promotes x to E's f32."""
    return x.float() @ p["embedding"].float().T


# ----------------------------------------------------------------------------
# SwiGLU MLP (llama-family FFN)
# ----------------------------------------------------------------------------

def swiglu_init(gen, d_model: int, d_ff: int, dtype=torch.float32, device=None):
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "w_up": dense_init(gen, d_model, d_ff, dtype=dtype, device=device),
        "w_down": dense_init(gen, d_ff, d_model, dtype=dtype, device=device),
    }


def swiglu(p, x):
    return dense(p["w_down"], F.silu(dense(p["w_gate"], x)) * dense(p["w_up"], x))


# ----------------------------------------------------------------------------
# GELU MLP (whisper FFN)
# ----------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def gelu_mlp_init(gen, d_model: int, d_ff: int, dtype=torch.float32, device=None):
    return {
        "w_in": dense_init(gen, d_model, d_ff, bias=True, dtype=dtype, device=device),
        "w_out": dense_init(gen, d_ff, d_model, bias=True, dtype=dtype, device=device),
    }


def gelu_mlp(p, x):
    return dense(p["w_out"], gelu(dense(p["w_in"], x)))


# ----------------------------------------------------------------------------
# Rotary position embeddings (standard and multimodal M-RoPE)
# ----------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies theta^(−2i/D)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate ``x`` (..., T, H, D) by per-token ``positions`` (..., T): the
    angles are positions · theta^(−2i/D) in f32 (half-split layout)."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, x.device)
    ang = positions[..., :, None, None].float() * inv  # (..., T, 1, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: tuple) -> torch.Tensor:
    """Multimodal RoPE (Qwen2-VL): ``positions3`` (3, ..., T) holds the
    temporal / height / width ids; ``sections`` splits the D/2 frequency
    bands among them (e.g. (16, 24, 24)), each band rotated by its stream's
    position."""
    d = x.shape[-1]
    if sum(sections) != d // 2:
        raise ValueError(f"mrope sections {sections} must cover head_dim/2 = {d // 2}")
    inv = rope_frequencies(d, theta, x.device)
    band = torch.cat([torch.full((n,), i, device=x.device) for i, n in enumerate(sections)])
    pos = torch.movedim(positions3[band], 0, -1)  # (..., T, D/2)
    ang = pos[..., :, None, :].float() * inv  # (..., T, 1, D/2)
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *, mask=None):
    """Mean token cross entropy; logits (..., V) f32, labels (...) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    # a vocabulary-sharded DTensor is gathered whole first, as in
    # ``transformer.chunked_ce``
    gold = torch.gather(unshard_dim(logits, -1), -1, labels[..., None].long())[..., 0]
    nll = lse - gold
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return torch.mean(nll)
