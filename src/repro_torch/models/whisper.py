"""Whisper-style encoder-decoder backbone (port of ``repro.models.whisper``;
arXiv:2212.04356).

The mel-spectrogram and conv front end is a stub, as in the reference: the
encoder takes precomputed frame embeddings (B, S_enc, d), the output the
two conv layers would give.  The backbone: a bidirectional encoder, a
causal decoder with cross-attention, learned positions (4,096 decoder
rows), pre-LN, GELU FFNs, a tied head whose padded vocabulary columns are
−1e30.  The key projection has no bias.  The decoder's self-attention
decodes through a stacked ``KVCache`` written in place.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.cache import KVCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    cross_entropy,
    dense,
    dense_init,
    embed,
    embedding_init,
    gelu_mlp,
    gelu_mlp_init,
    layernorm,
    layernorm_init,
    truncated_normal,
    unembed,
)
from repro_torch.sharding.rules import maybe_shard, per_block, pin_grad, same_blocks, split_dim
from repro_torch.utils.tree import tree_stack, tree_unstack

#: learned decoder positions (rows of ``dec_pos``)
DEC_POSITIONS = 4096


def _mha_init(gen, cfg: ModelConfig, dtype, device=None):
    d, hd = cfg.d_model, cfg.num_heads * cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    return {
        "wq": dense_init(gen, d, hd, bias=True, **kw),
        "wk": dense_init(gen, d, hd, **kw),
        "wv": dense_init(gen, d, hd, bias=True, **kw),
        "wo": dense_init(gen, hd, d, bias=True, **kw),
    }


def _attend(q, k, v, mask, out_dtype):
    """Softmax attention with f32 logits and accumulation: q (B, T, H, D),
    k / v (B, S, H, D), mask (T, S) boolean (True = attend) or None.
    ``DTensor``s sharded alike on batch and heads attend on each rank's
    block."""
    pl = same_blocks((0, 2), k, v)
    if pl is not None and isinstance(q, DTensor):
        return per_block(functools.partial(_attend, out_dtype=out_dtype), pl, q, k, v, mask)
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (q.shape[-1] ** -0.5)
    if mask is not None:
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(out_dtype)


def _mha(p, cfg, xq, xkv, mask):
    B, T, _ = xq.shape
    S = xkv.shape[1]
    H, D = cfg.num_heads, cfg.head_dim
    q = split_dim(dense(p["wq"], xq), -1, H, D)
    k = split_dim(dense(p["wk"], xkv), -1, H, D)
    v = split_dim(dense(p["wv"], xkv), -1, H, D)
    out = _attend(q, k, v, mask, xq.dtype)
    return dense(p["wo"], pin_grad(out.reshape(B, T, H * D)))


def _mha_cached(p, cfg, xq, cache: KVCache):
    """Causal self-attention over a KV cache (decode): x's T tokens are
    written at ``cache.index`` (in place) and attend to every key up to
    their own position."""
    B, T, _ = xq.shape
    H, D = cfg.num_heads, cfg.head_dim
    q = split_dim(dense(p["wq"], xq), -1, H, D)
    k = split_dim(dense(p["wk"], xq), -1, H, D)
    v = split_dim(dense(p["wv"], xq), -1, H, D)
    S = cache.k.shape[1]
    idx = cache.index
    start = max(0, min(idx, S - T))  # where dynamic_update_slice writes
    cache.k[:, start:start + T] = k.to(cache.k.dtype)
    cache.v[:, start:start + T] = v.to(cache.v.dtype)
    mask = (torch.arange(S, device=xq.device)[None, :]
            <= idx + torch.arange(T, device=xq.device)[:, None])
    out = _attend(q, cache.k.to(q.dtype), cache.v.to(q.dtype), mask, xq.dtype)
    y = dense(p["wo"], pin_grad(out.reshape(B, T, H * D)))
    return y, KVCache(k=cache.k, v=cache.v, index=idx + T)


def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None):
    """Parameters with the reference's tree and shapes (encoder and decoder
    layers stacked on a leading dimension), drawn from ``gen``."""
    dtype = getattr(torch, cfg.param_dtype)
    device = torch.device(device) if device is not None else gen.device
    d = cfg.d_model

    def enc_layer():
        return {"ln1": layernorm_init(d, dtype, device),
                "attn": _mha_init(gen, cfg, dtype, device),
                "ln2": layernorm_init(d, dtype, device),
                "mlp": gelu_mlp_init(gen, d, cfg.d_ff, dtype, device)}

    def dec_layer():
        return {"ln1": layernorm_init(d, dtype, device),
                "self_attn": _mha_init(gen, cfg, dtype, device),
                "ln2": layernorm_init(d, dtype, device),
                "cross_attn": _mha_init(gen, cfg, dtype, device),
                "ln3": layernorm_init(d, dtype, device),
                "mlp": gelu_mlp_init(gen, d, cfg.d_ff, dtype, device)}

    return {
        "enc_pos": truncated_normal(gen, (cfg.encoder_seq_len, d), dtype, 0.02, device),
        "dec_embed": embedding_init(gen, cfg.padded_vocab, d, dtype, device),
        "dec_pos": truncated_normal(gen, (DEC_POSITIONS, d), dtype, 0.02, device),
        "encoder": tree_stack([enc_layer() for _ in range(cfg.num_encoder_layers)]),
        "decoder": tree_stack([dec_layer() for _ in range(cfg.num_layers)]),
        "enc_ln": layernorm_init(d, dtype, device),
        "dec_ln": layernorm_init(d, dtype, device),
    }


def encode(params, cfg: ModelConfig, frame_embeds: torch.Tensor):
    """frame_embeds (B, S_enc, d), the stubbed conv front end's output →
    memory (B, S_enc, d), bidirectional."""
    cd = getattr(torch, cfg.compute_dtype)
    S = frame_embeds.shape[1]
    h = frame_embeds.to(cd) + params["enc_pos"][None, :S].to(cd)
    h = maybe_shard(h, "batch", "seq", None)
    for p in tree_unstack(params["encoder"]):
        x = layernorm(p["ln1"], h)
        h = h + _mha(p["attn"], cfg, x, x, None)
        h = h + gelu_mlp(p["mlp"], layernorm(p["ln2"], h))
        h = maybe_shard(h, "batch", "seq", None)
    return layernorm(params["enc_ln"], h)


def decode(params, cfg: ModelConfig, tokens: torch.Tensor, memory: torch.Tensor, *,
           cache=None, position_offset: int = 0):
    """Causal decoder over ``tokens`` (B, T) with cross-attention to
    ``memory`` → (f32 logits (B, T, padded vocab), new_cache).  ``cache``:
    the stacked self-attention ``KVCache`` (decode), updated in place."""
    cd = getattr(torch, cfg.compute_dtype)
    B, T = tokens.shape
    h = embed(params["dec_embed"], tokens, compute_dtype=cd)
    start = max(0, min(int(position_offset), params["dec_pos"].shape[0] - T))
    h = h + params["dec_pos"][None, start:start + T].to(cd)
    h = maybe_shard(h, "batch", "seq", None)
    mem = memory.to(cd)
    mask = torch.ones((T, T), dtype=torch.bool, device=tokens.device).tril()
    for r, p in enumerate(tree_unstack(params["decoder"])):
        x = layernorm(p["ln1"], h)
        if cache is None:
            h = h + _mha(p["self_attn"], cfg, x, x, mask)
        else:
            sa, _ = _mha_cached(p["self_attn"], cfg, x,
                                KVCache(k=cache.k[r], v=cache.v[r], index=cache.index))
            h = h + sa
        h = h + _mha(p["cross_attn"], cfg, layernorm(p["ln2"], h), mem, None)
        h = h + gelu_mlp(p["mlp"], layernorm(p["ln3"], h))
        if cache is None:  # the reference constrains the uncached body only
            h = maybe_shard(h, "batch", "seq", None)
    h = layernorm(params["dec_ln"], h)
    logits = unembed(params["dec_embed"], h)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    logits = maybe_shard(logits, "batch", "seq", "model")
    new_cache = None if cache is None else cache._replace(index=cache.index + T)
    return logits, new_cache


def init_decoder_cache(cfg: ModelConfig, batch: int, seq: int, dtype, *, index: int = 0,
                       device=None):
    """The decoder's self-attention cache, stacked (L, B, S, H, D)."""
    shape = (cfg.num_layers, batch, seq, cfg.num_heads, cfg.head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device), index=index)


def loss_fn(params, cfg: ModelConfig, batch):
    """batch: frame_embeds (B, S_enc, d), tokens (B, T), labels (B, T) and
    an optional loss_mask → (loss, {"ce": loss})."""
    memory = encode(params, cfg, batch["frame_embeds"])
    logits, _ = decode(params, cfg, batch["tokens"], memory)
    loss = cross_entropy(logits, batch["labels"], mask=batch.get("loss_mask"))
    return loss, {"ce": loss}


def decode_step(params, cfg: ModelConfig, tokens, memory, cache, *, position):
    return decode(params, cfg, tokens, memory, cache=cache, position_offset=position)
