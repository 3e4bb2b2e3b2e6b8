"""Input specs, sharding specs and step builders for the launcher and the
dry run (port of ``repro.launch.specs``).

``input_specs`` returns tensors on the ``meta`` device: the shape and type
of every model input with no storage — the shapes the production mesh is
proven against.  ``decode`` shapes build ``serve_step`` (one new token
against a ``seq_len`` cache); train/prefill build
``train_step``/``prefill_step``.  Specs are ``sharding.rules.P`` trees;
on a ``DeviceMesh`` they become ``DTensor`` placements, and the step that
``build_jitted`` returns places its arguments by them before it runs.
"""

from __future__ import annotations

import torch
import torch.utils._pytree as pytree
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import SHAPES, get_config
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    SoloMesh,
    axis_names,
    axis_sizes,
    batch_axes,
    data_axis_size,
)
from repro_torch.models import transformer as tf, whisper
from repro_torch.models.cache import KVCache, MambaCache, MLACache, MLSTMCache, SLSTMCache
from repro_torch.models.config import ModelConfig
from repro_torch.optim import adam, apply_updates, clip_by_global_norm, warmup_cosine
from repro_torch.sharding.rules import (
    MeshContext,
    P,
    partition_params,
    place,
    unshard_dim,
)

VISION_PREFIX = 256  # stubbed patch-embedding prefix length (qwen2-vl)
DECODER_CTX = 448  # whisper decoder context for train/prefill shapes


# ----------------------------------------------------------------------------
# Config adaptation per input shape
# ----------------------------------------------------------------------------

def shape_adapted_config(arch: str, shape_name: str) -> ModelConfig:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    # big models: bf16 params + bf16 Adam moments (the memory budget)
    if _approx_param_count(cfg) > 2e10:
        cfg = cfg.replace(param_dtype="bfloat16")
    if shape.kind == "decode" and shape_name == "long_500k":
        if cfg.family in ("dense", "moe", "vlm"):
            # sub-quadratic variant: sliding-window attention
            cfg = cfg.replace(sliding_window=8192)
    if shape.kind != "train":
        cfg = cfg.replace(remat_policy="none", num_mtp_layers=0)
    else:
        # training at 4k×256 always wants activation checkpointing; "full"
        # is the memory-safe baseline ("dots" is a lever where it fits)
        cfg = cfg.replace(remat_policy="full")
    if shape.kind in ("train", "prefill") and not cfg.is_encoder_decoder:
        # query-chunked attention bounds the live softmax matrix
        cfg = cfg.replace(attn_q_chunk=512)
    return cfg


def _approx_param_count(cfg: ModelConfig) -> float:
    d, L, f, V = cfg.d_model, cfg.num_layers, cfg.d_ff, cfg.vocab_size
    base = V * d * (1 if cfg.tie_embeddings else 2)
    attn = 4 * d * cfg.num_heads * cfg.head_dim
    per_layer = attn + 3 * d * f
    if cfg.moe is not None:
        per_layer = attn + 3 * d * cfg.moe.d_ff_expert * cfg.moe.num_experts
    return base + L * per_layer


def count_params(params) -> int:
    return sum(int(x.numel()) for x in pytree.tree_leaves(params))


def _path_str(path) -> str:
    return "/".join(
        str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path)


def count_active_params(cfg: ModelConfig, params) -> float:
    """Active parameters (MoE experts scaled by top_k/num_experts)."""
    total = 0.0
    scale = 1.0
    if cfg.moe is not None:
        scale = cfg.moe.top_k / cfg.moe.num_experts
    for path, leaf in pytree.tree_flatten_with_path(params)[0]:
        total += leaf.numel() * (scale if "experts/" in _path_str(path) else 1.0)
    return total


# ----------------------------------------------------------------------------
# Input specs (tensors on the meta device)
# ----------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(arch: str, shape_name: str) -> dict:
    cfg = shape_adapted_config(arch, shape_name)
    shape = SHAPES[shape_name]
    return input_specs_for(cfg, shape.kind, shape.global_batch, shape.seq_len)


def input_specs_for(cfg: ModelConfig, kind: str, B: int, S: int) -> dict:
    i32 = torch.int32
    cd = getattr(torch, cfg.compute_dtype)

    if kind in ("train", "prefill"):
        if cfg.is_encoder_decoder:
            T = min(S, DECODER_CTX)
            specs = {
                "frame_embeds": _meta((B, cfg.encoder_seq_len, cfg.d_model), cd),
                "tokens": _meta((B, T), i32),
            }
            if kind == "train":
                specs["labels"] = _meta((B, T), i32)
            return specs
        specs = {"tokens": _meta((B, S), i32)}
        if kind == "train":
            specs["labels"] = _meta((B, S), i32)
        if cfg.family == "vlm":
            specs["vision_embeds"] = _meta((B, VISION_PREFIX, cfg.d_model), cd)
            specs["mrope_positions"] = _meta((3, B, S), i32)
        return specs

    # decode: one new token against a seq_len cache
    specs = {"tokens": _meta((B, 1), i32)}
    cache_dtype = torch.bfloat16
    if cfg.is_encoder_decoder:
        specs["memory"] = _meta((B, cfg.encoder_seq_len, cfg.d_model), cd)
        cache = whisper.init_decoder_cache(cfg, B, S, cache_dtype, index=S - 1,
                                           device="meta")
    else:
        cache = tf.init_cache(cfg, B, S, cache_dtype, index=S - 1, device="meta")
    specs["cache"] = cache
    return specs


def concrete_inputs(arch: str, shape_name: str, seed: int = 0, *, device="cuda") -> dict:
    """Concrete seeded inputs matching ``input_specs``, on ``device`` (the
    card unless the caller asks for the CPU) — for smoke tests, NOT for the
    dry run.  Integer inputs are drawn in [0, vocab − 1), float inputs
    standard normal, each leaf in turn from one ``torch.Generator`` on
    ``device`` seeded with ``seed``; a cache's fill index stays the spec's."""
    dev = resolve_device(device)
    cfg = shape_adapted_config(arch, shape_name)
    specs = input_specs(arch, shape_name)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def realize(s):
        if not isinstance(s, torch.Tensor):
            return s
        if s.dtype == torch.int32:
            return torch.randint(0, max(2, cfg.vocab_size - 1), s.shape, generator=gen,
                                 dtype=torch.int32, device=dev)
        return torch.randn(s.shape, generator=gen, device=dev).to(s.dtype)

    return pytree.tree_map(realize, specs)


# ----------------------------------------------------------------------------
# Sharding specs
# ----------------------------------------------------------------------------

def make_mesh_context(mesh, cfg: ModelConfig, shape_name: str) -> MeshContext:
    return make_mesh_context_for(mesh, cfg, SHAPES[shape_name].global_batch)


def make_mesh_context_for(
    mesh, cfg: ModelConfig, B: int, *, strategy: str = "tp"
) -> MeshContext:
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    if strategy in ("dp", "dp_fsdp"):
        baxes = axis_names(mesh)  # batch over EVERY axis, no TP
    dsize = 1
    for a in baxes:
        dsize *= sizes[a]
    logical = {} if strategy in ("dp", "dp_fsdp") else {"model": "model"}
    if strategy == "kvseq":
        # decode variant: pin the KV cache's sequence dim to the model axis
        # inside attention (partial-softmax locality)
        logical["kvseq"] = "model"
    if B % dsize == 0 and B >= dsize:
        logical["batch"] = baxes if len(baxes) > 1 else baxes[0]
    # (seq stays unsharded for activations; cache seq sharding is separate)
    fsdp = _approx_param_count(cfg) > FSDP_THRESHOLD or strategy == "dp_fsdp"
    return MeshContext(mesh=mesh, logical=logical, fsdp=fsdp)


FSDP_THRESHOLD = 5e9  # params above this shard over the data axes too


def param_specs(cfg: ModelConfig, params, mesh, *, strategy: str = "tp"):
    if strategy == "serve":
        # decode/prefill: no optimizer state exists, so FSDP only buys
        # per-step parameter all-gathers — keep params TP-sharded instead
        return partition_params(params, model_axis="model", fsdp_axis=None)
    if strategy == "ep2d":
        # 2-D expert parallelism: experts sharded over (model × data) so
        # expert weights are never FSDP-gathered; non-expert params keep
        # TP + FSDP
        baxes = batch_axes(mesh)
        fsdp_axis = baxes if len(baxes) > 1 else baxes[0]
        return partition_params(
            params, model_axis="model", fsdp_axis=fsdp_axis,
            expert_axes=("model",) + tuple(
                a for a in axis_names(mesh) if a in ("data",)
            ),
        )
    if strategy == "dp":
        # pure data parallelism: params replicated on every axis
        return partition_params(params, model_axis=None, fsdp_axis=None)
    if strategy == "dp_fsdp":
        # ZeRO-3: no tensor parallelism, params sharded over all axes
        return partition_params(params, model_axis=None, fsdp_axis=axis_names(mesh))
    ctx_fsdp = _approx_param_count(cfg) > FSDP_THRESHOLD
    baxes = batch_axes(mesh)
    fsdp_axis = (baxes if len(baxes) > 1 else baxes[0]) if ctx_fsdp else None
    return partition_params(params, model_axis="model", fsdp_axis=fsdp_axis)


def _cache_entry_axes(mesh, B: int, n_heads: int):
    """Decide (batch, seq, heads) physical axes for cache tensors."""
    baxes = batch_axes(mesh)
    dsize = data_axis_size(mesh)
    msize = axis_sizes(mesh)["model"]
    batch_ax = (baxes if len(baxes) > 1 else baxes[0]) if B % dsize == 0 and B >= dsize else None
    heads_ax = "model" if n_heads % msize == 0 else None
    if batch_ax is None and heads_ax is None:
        seq_ax = tuple(list(baxes) + ["model"])
    elif batch_ax is None:
        seq_ax = baxes if len(baxes) > 1 else baxes[0]
    elif heads_ax is None:
        seq_ax = "model"
    else:
        seq_ax = None
    return batch_ax, seq_ax, heads_ax


def layer_cache_specs(cfg: ModelConfig, spec_mixer: str, mesh, B: int):
    msize = axis_sizes(mesh)["model"]
    if spec_mixer in ("attn", "whisper"):
        n_kv = cfg.num_kv_heads if spec_mixer == "attn" else cfg.num_heads
        b, s, h = _cache_entry_axes(mesh, B, n_kv)
        kv = P(b, s, h, None)
        return KVCache(k=kv, v=kv, index=P())
    if spec_mixer == "mla":
        b, s, _ = _cache_entry_axes(mesh, B, 1)  # latent has no head dim
        return MLACache(c_kv=P(b, s, None), k_rope=P(b, s, None), index=P())
    if spec_mixer == "mamba":
        b, _, _ = _cache_entry_axes(mesh, B, 1)
        return MambaCache(conv=P(b, None, "model"), ssm=P(b, "model", None))
    if spec_mixer == "mlstm":
        b, _, _ = _cache_entry_axes(mesh, B, 1)
        h_ax = "model" if cfg.num_heads % msize == 0 else None
        return MLSTMCache(C=P(b, h_ax, None, None), n=P(b, h_ax, None), m=P(b, h_ax))
    if spec_mixer == "slstm":
        b, _, _ = _cache_entry_axes(mesh, B, 1)
        d_ax = "model" if cfg.d_model % msize == 0 else None
        return SLSTMCache(c=P(b, d_ax), n=P(b, d_ax), h=P(b, d_ax), m=P(b, d_ax))
    raise ValueError(spec_mixer)


def _prepend_none(spec: P) -> P:
    return P(*((None,) + tuple(spec)))


def _map_specs(fn, tree):
    return pytree.tree_map(fn, tree, is_leaf=lambda x: isinstance(x, P))


def cache_specs(cfg: ModelConfig, mesh, B: int):
    """``P`` tree mirroring ``tf.init_cache`` (stacked segments)."""
    if cfg.is_encoder_decoder:
        return _map_specs(_prepend_none, layer_cache_specs(cfg, "whisper", mesh, B))
    out = {}
    for si, seg in enumerate(tf.segments(cfg)):
        unit_spec = {
            f"l{li}": layer_cache_specs(cfg, spec.mixer, mesh, B)
            for li, spec in enumerate(seg.unit)
        }
        out[f"seg{si}"] = _map_specs(_prepend_none, unit_spec)
    return out


def batch_specs(specs: dict, mesh, B: int, *, strategy: str = "tp") -> dict:
    """Specs for the input batch dict (tokens/labels/embeds/...)."""
    sizes = axis_sizes(mesh)
    baxes = batch_axes(mesh)
    if strategy in ("dp", "dp_fsdp"):
        baxes = axis_names(mesh)
    dsize = 1
    for a in baxes:
        dsize *= sizes[a]
    bax = (baxes if len(baxes) > 1 else baxes[0]) if B % dsize == 0 and B >= dsize else None
    out = {}
    for k, v in specs.items():
        if k == "cache":
            continue
        if k == "mrope_positions":
            out[k] = P(None, bax, None)
        elif hasattr(v, "ndim") and v.ndim >= 2:
            out[k] = P(*((bax,) + (None,) * (v.ndim - 1)))
        else:
            out[k] = P(bax)
    return out


# ----------------------------------------------------------------------------
# Step builders
# ----------------------------------------------------------------------------

def make_optimizer(cfg: ModelConfig, *, peak_lr=3e-4, warmup=100, total=10_000):
    moment_dtype = "bfloat16" if _approx_param_count(cfg) > 2e10 else None
    return clip_by_global_norm(
        adam(warmup_cosine(peak_lr, warmup, total), moment_dtype=moment_dtype), 1.0
    )


def _value_and_grad(loss, params, cfg, batch):
    """``((loss, metrics), grads)`` of ``loss(params, cfg, batch)`` with
    respect to every leaf of ``params``."""
    leaves, spec = pytree.tree_flatten(params)
    xs = [x.detach().requires_grad_() for x in leaves]
    with torch.enable_grad():
        total, metrics = loss(pytree.tree_unflatten(xs, spec), cfg, batch)
        grads = torch.autograd.grad(total, xs, materialize_grads=True)
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return (total.detach(), metrics), pytree.tree_unflatten(list(grads), spec)


def make_train_step(cfg: ModelConfig, optimizer, *, microbatches: int = 1):
    """Data-parallel train step, optionally with gradient accumulation.

    Microbatching IS the paper's §5 round-robin schedule applied within a
    step: the global update is the sequential composition of per-shard
    first-order updates, which the paper proves equivalent to mini-batch GD
    — here made literal by summing the per-microbatch gradients before one
    optimizer application.  It is also the standard memory lever: the live
    activation working set scales with B/microbatches.  As in the
    reference, the accumulated gradients are f32, each microbatch's divided
    by the count and added in microbatch order, and the step's metrics are
    then only the mean loss.
    """
    loss = whisper.loss_fn if cfg.is_encoder_decoder else tf.loss_fn

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (l, metrics), grads = _value_and_grad(loss, params, cfg, batch)
        else:

            def split(k, v):
                ax = 1 if k == "mrope_positions" else 0
                if v.shape[ax] % microbatches:
                    raise ValueError(
                        f"batch[{k!r}] axis {ax} ({v.shape[ax]}) does not split into "
                        f"{microbatches} microbatches")
                if isinstance(v, DTensor):
                    # contiguous rows, each microbatch laid out as the batch
                    # was (XLA's reshape of a sharded batch: an all-to-all)
                    whole = unshard_dim(v, ax)
                    return [c.redistribute(v.device_mesh, v.placements)
                            for c in whole.chunk(microbatches, dim=ax)]
                return v.chunk(microbatches, dim=ax)

            parts = {k: split(k, v) for k, v in batch.items()}
            g_acc = pytree.tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            l = None
            for i in range(microbatches):
                mbatch = {k: v[i] for k, v in parts.items()}
                (li, _), g = _value_and_grad(loss, params, cfg, mbatch)
                g_acc = pytree.tree_map(
                    lambda a, gi: a + gi.float() / microbatches, g_acc, g)
                l = li / microbatches if l is None else l + li / microbatches
                del g
            grads = g_acc
            metrics = {}
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = apply_updates(params, updates)
        metrics = dict(metrics, loss=l)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    if cfg.is_encoder_decoder:

        def prefill_step(params, batch):
            memory = whisper.encode(params, cfg, batch["frame_embeds"])
            logits, _ = whisper.decode(params, cfg, batch["tokens"], memory)
            return logits

    else:

        def prefill_step(params, batch):
            logits, _, _ = tf.forward(
                params,
                cfg,
                batch["tokens"],
                mrope_positions=batch.get("mrope_positions"),
                vision_embeds=batch.get("vision_embeds"),
            )
            return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig, *, mla_absorb: bool = False,
                    decode_attn: str = "off"):
    """One decode step against the batch's cache.  ``decode_attn`` is
    ``decode_step``'s own knob: "off" (the default, the reference's plain
    attention), "plain" or "cuda" (the decode-attention kernel pair)."""
    if cfg.is_encoder_decoder:

        def serve_step(params, batch):
            cache = batch["cache"]
            logits, new_cache = whisper.decode_step(
                params, cfg, batch["tokens"], batch["memory"], cache, position=cache.index
            )
            return logits, new_cache

    else:

        def serve_step(params, batch):
            logits, new_cache = tf.decode_step(
                params, cfg, batch["tokens"], batch["cache"], mla_absorb=mla_absorb,
                decode_attn=decode_attn,
            )
            return logits, new_cache

    return serve_step


# ----------------------------------------------------------------------------
# One-stop builder (used by the dry run and the cost probe)
# ----------------------------------------------------------------------------

def opt_state_specs(opt_state_shape, params_shape, pspec_tree):
    """Optimizer-state specs: subtrees mirroring the param tree reuse the
    param specs (FSDP'd moments); everything else is replicated."""
    params_structure = pytree.tree_structure(params_shape)

    def assign(sub):
        if pytree.tree_structure(sub) == params_structure:
            return pspec_tree
        return pytree.tree_map(lambda _: P(), sub)

    if isinstance(opt_state_shape, dict):
        return {k: assign(v) for k, v in opt_state_shape.items()}
    return pytree.tree_map(lambda _: P(), opt_state_shape)


def _placing(fn, mesh, spec_trees):
    """``fn`` with each positional argument first put on ``mesh`` by its
    spec tree (``sharding.rules.place``: ``DTensor``s on a device mesh,
    the arguments as they are on a ``SoloMesh``), run on a device mesh
    with plain tensors taken as replicated."""

    def step(*args):
        args = tuple(place(mesh, a, s) for a, s in zip(args, spec_trees))
        if isinstance(mesh, SoloMesh):
            return fn(*args)
        # tensors the step makes itself (positions, masks, the optimizer's
        # count) are the same on every rank: replicated, as JAX's are
        with implicit_replication():
            return fn(*args)

    step.specs = spec_trees
    return step


def build_jitted(cfg: ModelConfig, kind: str, mesh, B: int, S: int, *,
                 mla_absorb: bool = False, microbatches: int = 1,
                 strategy: str = "tp", seed: int = 0, decode_attn: str = "off"):
    """Build the step and its abstract arguments for (cfg, kind, B, S) on
    ``mesh``.  The name is the reference's; nothing is compiled — the step
    runs eagerly.

    Returns ``(step, args, params_shape)``: ``args`` hold ``meta`` tensors
    (shapes and types, no storage), ``params_shape`` the parameter tree on
    the meta device.  ``step(*concrete_args)`` puts each argument on
    ``mesh`` by its specs (``step.specs``) and runs.  The caller sets the
    mesh context (``make_mesh_context_for``) around the call, which the
    models' ``maybe_shard`` constraints read.
    """
    init = whisper.init_params if cfg.is_encoder_decoder else tf.init_params
    params_shape = init(torch.Generator().manual_seed(seed), cfg, device="meta")
    pspecs = param_specs(cfg, params_shape, mesh, strategy=strategy)
    in_specs = input_specs_for(cfg, kind, B, S)
    bspecs = batch_specs(in_specs, mesh, B, strategy=strategy)

    if kind == "train":
        optimizer = make_optimizer(cfg)
        opt_shape = optimizer.init(params_shape)
        ospecs = opt_state_specs(opt_shape, params_shape, pspecs)
        step = make_train_step(cfg, optimizer, microbatches=microbatches)
        placed = _placing(step, mesh, (pspecs, ospecs, bspecs))
        args = (params_shape, opt_shape, in_specs)
    elif kind == "prefill":
        step = make_prefill_step(cfg)
        placed = _placing(step, mesh, (pspecs, bspecs))
        args = (params_shape, in_specs)
    else:  # decode
        step = make_serve_step(cfg, mla_absorb=mla_absorb, decode_attn=decode_attn)
        bspecs_all = dict(bspecs)
        bspecs_all["cache"] = cache_specs(cfg, mesh, B)
        placed = _placing(step, mesh, (pspecs, bspecs_all))
        args = (params_shape, in_specs)
    return placed, args, params_shape
