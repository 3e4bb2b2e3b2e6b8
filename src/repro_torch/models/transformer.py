"""Decoder-only LM of the attention × dense-FFN family (port of
``repro.models.transformer``).

The reference factors the layer stack into **segments** (a repeating unit
of layer specs scanned over its repeats) and keeps every per-layer leaf
stacked on a leading dimension.  The port keeps that parameter tree, leaf
for leaf (``seg0.l0.mixer.wq.kernel`` of shape (L, d, H·D), …), and turns
each ``lax.scan`` into a Python loop over the stacked dimension, taking
views of the layer's leaves and cache slices (cache writes land in the
stacked arrays in place).

Ported: ``layer_specs``, ``segments``, ``init_layer``, ``apply_layer``,
``init_params``, ``init_cache``, ``forward``, ``_head_logits``,
``decode_step``, ``init_paged_cache``, ``paged_decode_step``,
``paged_insert_prompt``, and for training ``_remat_wrap``, ``chunked_ce``
and ``loss_fn``.  Other mixers, MoE FFNs and multi-token prediction raise
``NotImplementedError`` (``ROADMAP.md`` queue 1, item 11).

Training differentiates through the Python loop with autograd.  Each
stacked leaf is split once per forward with ``unbind(0)``, so its
gradient is stacked in one pass; indexing ``x[r]`` per layer would have
each layer's backward fill a zero tensor the size of the whole stack.
``cfg.remat_policy`` maps the reference's ``jax.checkpoint`` policies
onto ``torch.utils.checkpoint`` (non-reentrant) around each layer body.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import cache as cache_lib
from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    dense,
    dense_init,
    embed,
    embedding_init,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    unembed,
)
from repro_torch.utils.tree import tree_flatten, tree_stack, tree_unflatten

#: mixers whose caches accept T ≥ 1 appended tokens in ONE decode_step call
#: (keys causal-masked against idx + arange(T)); the recurrent mixers carry
#: single-step state and must be fed token by token.  Serving uses this to
#: pick batched or loop prefill.
MULTI_TOKEN_MIXERS = ("attn", "mla")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str  # attn | mla | mamba | mlstm | slstm
    ffn: str  # dense | moe | none


@dataclass(frozen=True)
class Segment:
    unit: tuple  # tuple[LayerSpec] — one repeat of the segment
    repeats: int


def layer_specs(cfg: ModelConfig) -> list[LayerSpec]:
    specs = []
    for i in range(cfg.num_layers):
        if cfg.hybrid_pattern:
            mixer = cfg.hybrid_pattern[i % len(cfg.hybrid_pattern)]
        elif cfg.xlstm is not None:
            mixer = "slstm" if i in cfg.xlstm.slstm_at else "mlstm"
        else:
            mixer = cfg.mixer
        if cfg.xlstm is not None:
            ffn = "none"  # xLSTM blocks embed their own FFN
        elif cfg.moe is None:
            ffn = "dense"
        else:
            mode = cfg.moe.layer_mode
            if mode == "all":
                ffn = "moe"
            elif mode == "every_other":
                ffn = "moe" if i % 2 == 1 else "dense"
            elif mode == "after_first_k":
                ffn = "dense" if i < cfg.moe.first_k_dense else "moe"
            else:
                raise ValueError(mode)
        specs.append(LayerSpec(mixer=mixer, ffn=ffn))
    return specs


def segments(cfg: ModelConfig) -> list[Segment]:
    """The stack as a repeating unit of layer specs, or maximal homogeneous
    runs (the reference's ``segment_repeats`` override is a cost-probe
    control and not read here)."""
    specs = layer_specs(cfg)
    L = len(specs)
    # smallest period p | L with specs[i] == specs[i % p]
    for p in range(1, L):
        if L % p == 0 and all(specs[i] == specs[i % p] for i in range(L)):
            return [Segment(unit=tuple(specs[:p]), repeats=L // p)]
    # fall back to maximal homogeneous runs
    segs = []
    i = 0
    while i < L:
        j = i
        while j < L and specs[j] == specs[i]:
            j += 1
        segs.append(Segment(unit=(specs[i],), repeats=j - i))
        i = j
    return segs


def _check_ported(spec: LayerSpec) -> None:
    if spec.mixer != "attn":
        raise NotImplementedError(
            f"mixer {spec.mixer!r} is not ported yet: ROADMAP.md queue 1, item 11")
    if spec.ffn != "dense":
        raise NotImplementedError(
            f"ffn {spec.ffn!r} is not ported yet: ROADMAP.md queue 1, item 11")


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ----------------------------------------------------------------------------
# Single layer
# ----------------------------------------------------------------------------

def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, dtype, device=None):
    _check_ported(spec)
    return {
        "mixer_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "mixer": attn_init(gen, cfg, dtype=dtype, device=device),
        "ffn_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "ffn": swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype, device=device),
    }


def apply_layer(p, cfg: ModelConfig, spec: LayerSpec, h, *, cache=None,
                positions=None, pages=None, decode_attn="off"):
    """Pre-norm residual block: ``(h, new_cache, aux)``; aux is 0.0 (no
    auxiliary loss in the dense family)."""
    _check_ported(spec)
    hn = rmsnorm(p["mixer_norm"], h, eps=cfg.rms_eps)
    mix, new_cache = attn_apply(
        p["mixer"], cfg, hn, positions=positions, cache=cache, pages=pages,
        decode_attn=decode_attn,
    )
    h = h + mix
    h = h + swiglu(p["ffn"], rmsnorm(p["ffn_norm"], h, eps=cfg.rms_eps))
    return h, new_cache, 0.0


# ----------------------------------------------------------------------------
# Full model
# ----------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None):
    """Parameters with the reference's tree, shapes and distributions,
    drawn from ``gen`` on ``device`` (default: the generator's device;
    ``"meta"`` gives the shapes without memory)."""
    dtype = _dtype(cfg.param_dtype)
    device = torch.device(device) if device is not None else gen.device
    if cfg.num_mtp_layers > 0:
        raise NotImplementedError(
            "multi-token prediction (deepseek-v3's MTP) is not ported yet: "
            "ROADMAP.md queue 1, item 11")
    params = {"embed": embedding_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device)}
    for si, seg in enumerate(segments(cfg)):
        params[f"seg{si}"] = tree_stack([
            {f"l{li}": init_layer(gen, cfg, spec, dtype, device)
             for li, spec in enumerate(seg.unit)}
            for _ in range(seg.repeats)
        ])
    params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            gen, cfg.d_model, cfg.padded_vocab, dtype=dtype, device=device)
    return params


def compute_params(params, cfg: ModelConfig):
    """The weights as the forward pass reads them: every dense ``kernel``
    and ``bias`` cast once to the compute type, the rest as they are.

    ``dense`` casts its weight to the activation's type at every call
    (``layers.py:36`` of the reference), so a copy made once gives the same
    numbers — and in bf16 saves a step re-reading the f32 weights and
    writing the cast (about 6.6 GB of traffic per decode step of
    tinyllama-1.1b).  Norm scales and the embedding table stay in the
    parameter type: ``rmsnorm`` and the tied head read them in f32, and the
    embedding is cast after the gather.  Where both types agree nothing is
    copied.
    """
    cd = _dtype(cfg.compute_dtype)

    def walk(tree):
        return {
            k: (v.to(cd) if k in ("kernel", "bias") else v)
            if isinstance(v, torch.Tensor) else walk(v)
            for k, v in tree.items()
        }

    return walk(params)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype, *, index: int = 0,
               device=None):
    """Stacked per-segment dense caches, filled up to ``index``."""
    caches = {}
    for si, seg in enumerate(segments(cfg)):
        unit = {}
        for li, spec in enumerate(seg.unit):
            _check_ported(spec)
            shape = (seg.repeats, batch, seq, cfg.num_kv_heads, cfg.head_dim)
            unit[f"l{li}"] = cache_lib.KVCache(
                k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
                index=index,
            )
        caches[f"seg{si}"] = unit
    return caches


def _layer_cache(c, r: int):
    """The ``r``-th layer's slice of a stacked cache (views: writes land in
    the stack)."""
    if isinstance(c, cache_lib.PagedKVCache):
        return cache_lib.PagedKVCache(k=c.k[r], v=c.v[r])
    return cache_lib.KVCache(k=c.k[r], v=c.v[r], index=c.index)


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of ``remat_policy="dots"``: keep the
    outputs of plain matmuls (``x @ W`` reaches ``aten.mm``) and recompute
    the rest, as ``dots_with_no_batch_dims_saveable`` keeps the dots with
    no batch dimension (the attention einsums are batched: ``bmm``)."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, cfg: ModelConfig):
    """``fn`` under the config's rematerialisation policy: ``"none"`` as it
    is, ``"full"`` recomputing everything in the backward, ``"dots"``
    keeping the matmul outputs."""
    if cfg.remat_policy == "none":
        return fn
    if cfg.remat_policy == "dots":
        ctx = partial(create_selective_checkpoint_contexts, _save_matmuls)
        return partial(checkpoint, fn, use_reentrant=False, context_fn=ctx)
    if cfg.remat_policy == "full":
        return partial(checkpoint, fn, use_reentrant=False)
    raise ValueError(cfg.remat_policy)


def forward(params, cfg: ModelConfig, tokens: torch.Tensor, *, positions=None,
            cache=None, pages: tuple | None = None, decode_attn: str = "off",
            return_hidden: bool = False, skip_logits: bool = False):
    """Returns (logits, aux_loss, new_cache[, hidden]).  Caches are updated
    in place; ``new_cache`` holds the same tensors with the dense fill
    index advanced.  ``skip_logits`` returns None for the logits (the loss
    takes them chunk by chunk from ``hidden``, the final-normed states)."""
    cd = _dtype(cfg.compute_dtype)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)

    h = embed(params["embed"], tokens, compute_dtype=cd)
    aux = 0.0
    new_caches = {} if cache is not None else None
    for si, seg in enumerate(segments(cfg)):
        seg_cache = cache[f"seg{si}"] if cache is not None else None

        def body(h, p_r, r, seg=seg, seg_cache=seg_cache):
            aux = 0.0
            for li, spec in enumerate(seg.unit):
                c_in = _layer_cache(seg_cache[f"l{li}"], r) if cache is not None else None
                h, _, a = apply_layer(
                    p_r[f"l{li}"], cfg, spec, h, cache=c_in, positions=positions,
                    pages=pages, decode_attn=decode_attn,
                )
                aux = aux + a
            return h, aux

        body = _remat_wrap(body, cfg) if cache is None else body
        leaves, spec = tree_flatten(params[f"seg{si}"])
        layers = [x.unbind(0) for x in leaves]
        for r in range(seg.repeats):
            h, a = body(h, tree_unflatten([x[r] for x in layers], spec), r)
            aux = aux + a
        if cache is not None:
            new_caches[f"seg{si}"] = {
                key: c._replace(index=c.index + T) if isinstance(c, cache_lib.KVCache) else c
                for key, c in seg_cache.items()
            }

    h = rmsnorm(params["final_norm"], h, eps=cfg.rms_eps)
    logits = None if skip_logits else _head_logits(params, cfg, h)
    out = (logits, aux, new_caches)
    return out + (h,) if return_hidden else out


def _head_logits(params, cfg: ModelConfig, h):
    """f32 logits; padded vocab columns are −1e30 (never predicted)."""
    if cfg.tie_embeddings:
        logits = unembed(params["embed"], h)
    else:
        logits = dense(params["lm_head"], h).float()
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=h.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


# ----------------------------------------------------------------------------
# Losses
# ----------------------------------------------------------------------------

def chunked_ce(params, cfg: ModelConfig, hidden, labels, *, mask=None, chunk=512):
    """Cross entropy from final-normed ``hidden`` (B, T, d) in sequence
    chunks, each under a checkpoint, so only (B, chunk, V) f32 logits are
    ever live: the backward recomputes a chunk's logits (the reference's
    ``jax.checkpoint`` inside its scan).  Sums over chunks in order, in
    f32, and divides by the mask's sum (at least 1)."""
    B, T, _ = hidden.shape
    if mask is None:
        mask = torch.ones((B, T), dtype=torch.float32, device=hidden.device)
    c = min(chunk, T)
    if T % c:
        c = T  # one chunk for odd lengths, as the reference does

    def piece(h_c, l_c, m_c):
        logits = _head_logits(params, cfg, h_c).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, l_c[..., None].long())[..., 0]
        return torch.sum((lse - gold) * m_c), torch.sum(m_c)

    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(T // c):
        sl = slice(i * c, (i + 1) * c)
        s, n = checkpoint(piece, hidden[:, sl], labels[:, sl], mask[:, sl],
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def loss_fn(params, cfg: ModelConfig, batch):
    """``(total, {"ce", "aux"})`` for ``batch`` = tokens (B, T), labels
    (B, T) and an optional ``loss_mask``."""
    if cfg.num_mtp_layers > 0:
        raise NotImplementedError(
            "the multi-token-prediction loss (deepseek-v3's MTP) is not ported "
            "yet: ROADMAP.md queue 1, item 11")
    if "mrope_positions" in batch or "vision_embeds" in batch:
        raise NotImplementedError(
            "the VLM front end (M-RoPE, vision embeddings) is not ported yet: "
            "ROADMAP.md queue 1, item 11")
    _, aux, _, hidden = forward(
        params, cfg, batch["tokens"], return_hidden=True, skip_logits=True)
    loss = chunked_ce(params, cfg, hidden, batch["labels"], mask=batch.get("loss_mask"))
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    return loss + aux, {"ce": loss, "aux": aux}


def decode_step(params, cfg: ModelConfig, tokens, cache, *, positions=None,
                decode_attn: str = "off"):
    """One serve step: tokens (B, T) + cache → (logits (B, T, V), new_cache).
    Without ``positions`` every token sits at the cache's fill index, as in
    the reference."""
    if positions is None:
        index = next(
            c.index for seg in cache.values() for c in seg.values()
            if isinstance(c, cache_lib.KVCache)
        )
        positions = torch.full(tokens.shape, index, dtype=torch.int64,
                               device=tokens.device)
    logits, _, new_cache = forward(
        params, cfg, tokens, positions=positions, cache=cache, decode_attn=decode_attn,
    )
    return logits, new_cache


# ----------------------------------------------------------------------------
# Paged decode plane (continuous-batching serving)
# ----------------------------------------------------------------------------

def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int, dtype, device=None):
    """Stacked per-segment ``PagedKVCache`` arenas, (L, n_pages, page_size,
    H_kv, D) per leaf.  Only pure-attention stacks have a paged path."""
    for spec in layer_specs(cfg):
        if spec.mixer != "attn":
            raise ValueError(
                f"paged decode supports attn-only stacks, got mixer {spec.mixer!r}")
    caches = {}
    for si, seg in enumerate(segments(cfg)):
        shape = (seg.repeats, n_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
        caches[f"seg{si}"] = {
            f"l{li}": cache_lib.PagedKVCache(
                k=torch.zeros(shape, dtype=dtype, device=device),
                v=torch.zeros(shape, dtype=dtype, device=device),
            )
            for li in range(len(seg.unit))
        }
    return caches


def paged_decode_step(params, cfg: ModelConfig, tokens, cache, block, length,
                      *, decode_attn: str = "plain"):
    """One continuous-batching step: advance every slot one token.

    tokens: (n_slots, 1); block: (n_slots, pages_per_slot) page ids;
    length: (n_slots,) tokens already cached per slot (device tensors).
    Returns (logits (n_slots, 1, V), cache).  Inactive slots (block row all
    NULL_PAGE, length 0) compute garbage harmlessly: rows are independent
    and their writes land in the null page.
    """
    positions = length[:, None].expand(tokens.shape)
    logits, _, new_cache = forward(
        params, cfg, tokens, positions=positions, cache=cache,
        pages=(block, length), decode_attn=decode_attn,
    )
    return logits, new_cache


def paged_insert_prompt(paged, dense_cache, block_row, n_valid):
    """Write a B=1 prefilled dense cache into one slot's pages (join), in
    place, all layers of a segment at once.  Rows ≥ ``n_valid`` go to the
    null page, so bucket padding never becomes visible."""
    for si, seg in paged.items():
        for li, pg in seg.items():
            dn = dense_cache[si][li]
            cache_lib.paged_write(pg, block_row, dn.k[:, 0], dn.v[:, 0], n_valid)
    return paged
