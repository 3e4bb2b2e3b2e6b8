"""Decoder-only LM of every mixer family: attention, MLA, mamba, mLSTM and
sLSTM × dense, MoE or no FFN, with DeepSeek-V3's multi-token prediction
and the VLM front end (port of ``repro.models.transformer``).

The reference factors the layer stack into **segments** (a repeating unit
of layer specs scanned over its repeats) and keeps every per-layer leaf
stacked on a leading dimension.  The port keeps that parameter tree, leaf
for leaf (``seg0.l0.mixer.wq.kernel`` of shape (L, d, H·D), …), and turns
each ``lax.scan`` into a Python loop over the stacked dimension, taking
views of the layer's leaves and cache slices.  Attention caches are
written in place; the recurrent mixers return new states, which
``forward`` copies into the stacked cache.

Ported: ``layer_specs``, ``segments``, ``segs_of``, ``init_layer``,
``apply_layer``, ``init_layer_cache``, ``init_params``, ``init_cache``,
``forward`` (with ``mrope_positions`` and ``vision_embeds``: the VLM's
patch embeddings replace the first Tv token embeddings), ``mtp_hidden``,
``_head_logits``, ``decode_step``, ``init_paged_cache``,
``paged_decode_step``, ``paged_insert_prompt``, and for training
``_remat_wrap``, ``chunked_ce`` and ``loss_fn`` (with the MTP loss).

Training differentiates through the Python loop with autograd.  Each
stacked leaf is split once per forward (``utils.tree.tree_unstack``), so
its gradient is stacked in one pass.
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

from repro_torch.models import attention, mamba, mla, moe, xlstm
from repro_torch.models import cache as cache_lib
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
from repro_torch.sharding.rules import maybe_shard, per_block, same_blocks, unshard_dim
from repro_torch.utils.tree import tree_stack, tree_unstack

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


def segs_of(cfg: ModelConfig) -> list[Segment]:
    """The reference's name for ``segments`` where caches are built."""
    return segments(cfg)


#: each mixer's module and the names of its init and apply, looked up at
#: every call: a function patched on its module is the one that runs
_MIXERS = {
    "attn": (attention, "attn_init", "attn_apply"),
    "mla": (mla, "mla_init", "mla_apply"),
    "mamba": (mamba, "mamba_init", "mamba_apply"),
    "mlstm": (xlstm, "mlstm_init", "mlstm_apply"),
    "slstm": (xlstm, "slstm_init", "slstm_apply"),
}


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


# ----------------------------------------------------------------------------
# Single layer
# ----------------------------------------------------------------------------

def init_layer(gen, cfg: ModelConfig, spec: LayerSpec, dtype, device=None):
    module, init, _ = _MIXERS[spec.mixer]
    p = {
        "mixer_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "mixer": getattr(module, init)(gen, cfg, dtype=dtype, device=device),
    }
    if spec.ffn == "dense":
        p["ffn_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["ffn"] = swiglu_init(gen, cfg.d_model, cfg.d_ff, dtype=dtype, device=device)
    elif spec.ffn == "moe":
        p["ffn_norm"] = rmsnorm_init(cfg.d_model, dtype, device)
        p["ffn"] = moe.moe_init(gen, cfg, dtype=dtype, device=device)
    return p


def apply_layer(p, cfg: ModelConfig, spec: LayerSpec, h, *, cache=None,
                positions=None, mrope_positions=None, mla_absorb=False, pages=None,
                decode_attn="off"):
    """Pre-norm residual block: ``(h, new_cache, aux)``; aux is the MoE
    load-balance loss, 0.0 for a dense FFN or none (xLSTM blocks carry their
    own)."""
    hn = rmsnorm(p["mixer_norm"], h, eps=cfg.rms_eps)
    kw = {}
    if spec.mixer in ("attn", "mla"):
        kw["positions"] = positions
    if spec.mixer == "attn":
        kw.update(mrope_positions=mrope_positions, pages=pages, decode_attn=decode_attn)
    if spec.mixer == "mla":
        kw["absorb"] = mla_absorb
    module, _, apply = _MIXERS[spec.mixer]
    mix, new_cache = getattr(module, apply)(p["mixer"], cfg, hn, cache=cache, **kw)
    h = maybe_shard(h + mix, "batch", "seq", None)
    if spec.ffn == "none":
        return h, new_cache, 0.0
    hn = rmsnorm(p["ffn_norm"], h, eps=cfg.rms_eps)
    if spec.ffn == "dense":
        return maybe_shard(h + swiglu(p["ffn"], hn), "batch", "seq", None), new_cache, 0.0
    y, aux = moe.moe_apply(p["ffn"], cfg, hn)
    return maybe_shard(h + y, "batch", "seq", None), new_cache, aux


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch: int, seq: int, dtype,
                     device=None):
    """One layer's dense decode cache, empty (a recurrent state for the
    recurrent mixers: its size does not depend on ``seq``)."""
    if spec.mixer == "attn":
        return cache_lib.kv_cache_init(batch, seq, cfg.num_kv_heads, cfg.head_dim, dtype,
                                       device)
    if spec.mixer == "mla":
        return cache_lib.mla_cache_init(
            batch, seq, cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim, dtype, device)
    if spec.mixer == "mamba":
        d_inner, _, d_state, d_conv = mamba._dims(cfg)
        return cache_lib.mamba_cache_init(batch, d_conv, d_inner, d_state, dtype, device)
    if spec.mixer == "mlstm":
        dh = xlstm._mlstm_inner(cfg) // cfg.num_heads
        return cache_lib.mlstm_cache_init(batch, cfg.num_heads, dh, dh, device)
    if spec.mixer == "slstm":
        return cache_lib.slstm_cache_init(batch, cfg.d_model, device)
    raise ValueError(spec.mixer)


# ----------------------------------------------------------------------------
# Full model
# ----------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: ModelConfig, *, device=None):
    """Parameters with the reference's tree, shapes and distributions,
    drawn from ``gen`` on ``device`` (default: the generator's device;
    ``"meta"`` gives the shapes without memory)."""
    dtype = _dtype(cfg.param_dtype)
    device = torch.device(device) if device is not None else gen.device
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
    if cfg.num_mtp_layers > 0:
        params["mtp"] = {
            "proj": dense_init(gen, 2 * cfg.d_model, cfg.d_model, dtype=dtype, device=device),
            "norm_h": rmsnorm_init(cfg.d_model, dtype, device),
            "norm_e": rmsnorm_init(cfg.d_model, dtype, device),
            "layer": init_layer(gen, cfg, _mtp_spec(cfg), dtype, device),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
        }
    return params


def _mtp_spec(cfg: ModelConfig) -> LayerSpec:
    return LayerSpec(mixer=cfg.mixer, ffn="dense" if cfg.moe is None else "moe")


def compute_params(params, cfg: ModelConfig):
    """The weights as the forward pass reads them: every dense ``kernel``
    and ``bias`` and the MoE expert stacks cast once to the compute type,
    the rest as they are.

    ``dense`` casts its weight to the activation's type at every call
    (``layers.py:36`` of the reference), and ``moe_apply`` its expert
    stacks (``moe.py:121-123``), so a copy made once gives the same
    numbers — and in bf16 saves a step re-reading the f32 weights and
    writing the cast (about 6.6 GB of traffic per decode step of
    tinyllama-1.1b, 38.7 GB of olmoe-1b-7b's experts).  Left in the
    parameter type: norm scales and the embedding table (``rmsnorm`` and
    the tied head read them in f32, the embedding is cast after the
    gather), and the subtrees each model file names in its
    ``KEEP_LEAVES``: the MoE ``router``, which the reference reads in f32,
    and MLA's ``w_uk`` / ``w_uv``, which the absorbed path reads in f32
    (its unabsorbed path casts them at each call, as ``dense`` does).  The
    subtrees in ``moe.CAST_WHOLE`` are cast leaf by leaf.  Where both types
    agree nothing is copied.
    """
    cd = _dtype(cfg.compute_dtype)
    keep = moe.KEEP_LEAVES + mla.KEEP_LEAVES

    def walk(tree, cast_all=False):
        out = {}
        for k, v in tree.items():
            if not isinstance(v, torch.Tensor):
                out[k] = v if k in keep else walk(v, cast_all=k in moe.CAST_WHOLE)
            elif cast_all or k in ("kernel", "bias"):
                out[k] = v.to(cd)
            else:
                out[k] = v
        return out

    return walk(params)


def init_cache(cfg: ModelConfig, batch: int, seq: int, dtype, *, index: int = 0,
               device=None):
    """Stacked per-segment decode caches (a leading layer dimension on every
    tensor): ``KVCache`` / ``MLACache`` filled up to ``index``, the
    recurrent states at their initial values."""
    caches = {}
    for si, seg in enumerate(segments(cfg)):
        unit = {}
        for li, spec in enumerate(seg.unit):
            one = init_layer_cache(cfg, spec, batch, seq, dtype, device=device)
            stacked = one._replace(**{
                f: t.expand(seg.repeats, *t.shape).contiguous()
                for f, t in one._asdict().items() if isinstance(t, torch.Tensor)})
            unit[f"l{li}"] = stacked._replace(index=index) if _dense_cache(one) else stacked
        caches[f"seg{si}"] = unit
    return caches


def _layer_cache(c, r: int):
    """The ``r``-th layer's slice of a stacked cache (views: writes land in
    the stack)."""
    return c._replace(**{f: t[r] for f, t in c._asdict().items()
                         if isinstance(t, torch.Tensor)})


def _write_back(dst, src) -> None:
    """Copy a layer's returned cache into its slice of the stack, where the
    mixer made new tensors (the recurrent states; attention writes in
    place and returns its own)."""
    for d, s in zip(dst, src):
        if isinstance(d, torch.Tensor) and s is not d:
            d.copy_(s)


def _dense_cache(c) -> bool:
    return isinstance(c, (cache_lib.KVCache, cache_lib.MLACache))


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
            mrope_positions=None, vision_embeds=None, cache=None,
            mla_absorb: bool = False, pages: tuple | None = None,
            decode_attn: str = "off", return_hidden: bool = False,
            skip_logits: bool = False):
    """Returns (logits, aux_loss, new_cache[, hidden]).  Caches are updated
    in place; ``new_cache`` holds the same tensors with the dense fill
    index advanced.  ``aux_loss`` sums the layers' MoE losses in layer
    order (0.0 without MoE).  ``skip_logits`` returns None for the logits
    (the loss takes them chunk by chunk from ``hidden``, the final-normed
    states).  ``vision_embeds`` (B, Tv, d), the VLM's precomputed patch
    embeddings, replace the first Tv token embeddings; ``mrope_positions``
    (3, B, T) drive M-RoPE in the attention layers."""
    cd = _dtype(cfg.compute_dtype)
    B, T = tokens.shape
    if positions is None:
        positions = torch.arange(T, device=tokens.device).expand(B, T)

    h = embed(params["embed"], tokens, compute_dtype=cd)
    if vision_embeds is not None:
        h = torch.cat([vision_embeds.to(cd), h[:, vision_embeds.shape[1]:]], dim=1)
    h = maybe_shard(h, "batch", "seq", None)
    aux = 0.0
    new_caches = {} if cache is not None else None
    for si, seg in enumerate(segments(cfg)):
        seg_cache = cache[f"seg{si}"] if cache is not None else None

        def body(h, aux, p_r, r, seg=seg, seg_cache=seg_cache):
            # aux is carried through the layers, as the reference's scan carry
            for li, spec in enumerate(seg.unit):
                c_in = _layer_cache(seg_cache[f"l{li}"], r) if cache is not None else None
                h, c_out, a = apply_layer(
                    p_r[f"l{li}"], cfg, spec, h, cache=c_in, positions=positions,
                    mrope_positions=mrope_positions, mla_absorb=mla_absorb, pages=pages,
                    decode_attn=decode_attn,
                )
                if c_in is not None:
                    _write_back(c_in, c_out)
                aux = aux + a
            return h, aux

        body = _remat_wrap(body, cfg) if cache is None else body
        for r, p_r in enumerate(tree_unstack(params[f"seg{si}"])):
            h, aux = body(h, aux, p_r, r)
        if cache is not None:
            new_caches[f"seg{si}"] = {
                key: c._replace(index=c.index + T) if _dense_cache(c) else c
                for key, c in seg_cache.items()
            }

    h = rmsnorm(params["final_norm"], h, eps=cfg.rms_eps)
    logits = None
    if not skip_logits:
        logits = maybe_shard(_head_logits(params, cfg, h), "batch", "seq", "model")
    out = (logits, aux, new_caches)
    return out + (h,) if return_hidden else out


def mtp_hidden(params, cfg: ModelConfig, hidden, tokens, positions):
    """Depth-1 MTP trunk: h'_t = Layer(W [norm(h_t); norm(E(tok_{t+1}))]),
    final-normed, and its MoE aux; the caller applies the shared head
    (chunked) to predict token t+2.  ``tokens`` come pre-shifted."""
    p = params["mtp"]
    e_next = embed(params["embed"], tokens, compute_dtype=_dtype(cfg.compute_dtype))
    x = torch.cat([rmsnorm(p["norm_h"], hidden, eps=cfg.rms_eps),
                   rmsnorm(p["norm_e"], e_next, eps=cfg.rms_eps)], dim=-1)
    x = dense(p["proj"], maybe_shard(x, "batch", "seq", None))
    x, _, aux = apply_layer(p["layer"], cfg, _mtp_spec(cfg), x, positions=positions)
    return rmsnorm(p["final_norm"], x, eps=cfg.rms_eps), aux


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
        # a vocabulary-sharded DTensor is gathered whole first: DTensor's
        # masked gather on the sharded dimension fails (torch 2.13)
        gold = torch.gather(unshard_dim(logits, -1), -1, l_c[..., None].long())[..., 0]
        return torch.sum((lse - gold) * m_c), torch.sum(m_c)

    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for i in range(T // c):
        sl = slice(i * c, (i + 1) * c)
        s, n = checkpoint(piece, hidden[:, sl], labels[:, sl], mask[:, sl],
                          use_reentrant=False)
        tot, cnt = tot + s, cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


def _shift_left(x):
    """``torch.roll(x, -1, 1)``; a ``DTensor`` sharded on its batch only
    rolls each rank's rows (torch 2.11 has no sharding rule for ``roll``)."""
    roll = partial(torch.roll, shifts=-1, dims=1)
    pl = same_blocks((0,), x)
    return per_block(roll, pl, x) if pl is not None else roll(x)


def loss_fn(params, cfg: ModelConfig, batch):
    """``(total, {"ce", "aux"[, "mtp"]})`` for ``batch`` = tokens (B, T),
    labels (B, T) and optionally ``loss_mask``, ``mrope_positions`` and
    ``vision_embeds`` (the VLM front end).  With MTP the trunk reads the
    tokens shifted by one and predicts the labels shifted by one (token
    t+2), its last two positions masked out (they wrap around), and adds
    ``mtp_loss_coef`` × its loss and its own MoE aux."""
    _, aux, _, hidden = forward(
        params, cfg, batch["tokens"], mrope_positions=batch.get("mrope_positions"),
        vision_embeds=batch.get("vision_embeds"), return_hidden=True, skip_logits=True)
    loss = chunked_ce(params, cfg, hidden, batch["labels"], mask=batch.get("loss_mask"))
    aux = torch.as_tensor(aux, dtype=torch.float32, device=loss.device)
    total = loss + aux
    metrics = {"ce": loss, "aux": aux}
    if cfg.num_mtp_layers > 0:
        tokens = batch["tokens"]
        B, T = tokens.shape
        positions = torch.arange(T, device=tokens.device).expand(B, T)
        h_mtp, aux_mtp = mtp_hidden(params, cfg, hidden, _shift_left(tokens), positions)
        mask = torch.ones((B, T), dtype=torch.float32, device=tokens.device)
        mask[:, -2:] = 0.0
        mtp_loss = chunked_ce(params, cfg, h_mtp, _shift_left(batch["labels"]),
                              mask=mask)
        total = total + cfg.mtp_loss_coef * mtp_loss + aux_mtp
        metrics["mtp"] = mtp_loss
    return total, metrics


def decode_step(params, cfg: ModelConfig, tokens, cache, *, positions=None,
                mla_absorb: bool = False, decode_attn: str = "off"):
    """One serve step: tokens (B, T) + cache → (logits (B, T, V), new_cache).
    Without ``positions`` every token sits at the cache's fill index, as in
    the reference; a purely recurrent cache has none (its state is
    position-free) and the tokens sit at 0."""
    if positions is None:
        index = next((c.index for seg in cache.values() for c in seg.values()
                      if _dense_cache(c)), 0)
        positions = torch.full(tokens.shape, index, dtype=torch.int64,
                               device=tokens.device)
    logits, _, new_cache = forward(
        params, cfg, tokens, positions=positions, cache=cache, mla_absorb=mla_absorb,
        decode_attn=decode_attn,
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
