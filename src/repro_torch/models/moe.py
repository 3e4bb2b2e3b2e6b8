"""Mixture-of-Experts FFN with top-k routing, shared experts and the aux
load-balance loss (port of ``repro.models.moe``).

Capacity-based scatter dispatch, grouped per batch row as in the reference:
each row ranks its T·k dispatch entries within their expert by a stable
sort (``_positions_in_expert``), keeps the first ``C = max(1, int(cf·T·k /
E))`` of each expert and sends the rest to a trash row ``E·C`` (dropped:
their gate contribution is zero).  The expert SwiGLU runs on the (B, E, C,
d) buffer as batched products (``torch.einsum``), as the reference's
einsums do outside any Pallas kernel.  The buffer and the experts'
output pass through ``maybe_shard`` at the reference's places (the
identity without a mesh context).

Determinism on the card, where the reference's scatters are ordered:

* the dispatch writes every entry into the buffer, but only the trash row
  takes more than one (kept entries have distinct (expert, rank) slots),
  and that row is cut off before the products;
* the combine adds a token's k slots in slot order, slot 0 first, as
  ``.at[tok].add`` does, by k plain adds, not an atomic ``index_add_``;
* ``jax.lax.top_k`` puts the lower expert first among equal
  probabilities; a stable descending sort does the same (``torch.topk``
  promises no order among ties).

Aux loss (Switch / DeepSeek form): ``coef · E · Σ_e f_e · P_e`` with
``f_e`` the dispatch fraction and ``P_e`` the mean router probability,
over the whole batch.  The router is read in f32 from the parameter tree
(``KEEP_LEAVES``: ``transformer.compute_params`` leaves it uncast): a bf16
router would change which experts a token picks.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, swiglu, swiglu_init, truncated_normal
from repro_torch.sharding.rules import maybe_shard, per_block, same_blocks, unshard_dim

#: subtrees ``transformer.compute_params`` leaves in the parameter type
KEEP_LEAVES = ("router",)
#: subtrees it casts whole to the compute type: ``moe_apply`` casts the
#: expert stacks at every call (the reference's ``moe.py:121-123``)
CAST_WHOLE = ("experts",)


def moe_init(gen, cfg: ModelConfig, dtype=torch.float32, device=None):
    m = cfg.moe
    d, f, E = cfg.d_model, m.d_ff_expert, m.num_experts
    std_in, std_out = (1.0 / d) ** 0.5, (1.0 / f) ** 0.5
    p = {
        "router": dense_init(gen, d, E, dtype=torch.float32, device=device),  # kept f32
        "experts": {
            "w_gate": truncated_normal(gen, (E, d, f), dtype, std_in, device),
            "w_up": truncated_normal(gen, (E, d, f), dtype, std_in, device),
            "w_down": truncated_normal(gen, (E, f, d), dtype, std_out, device),
        },
    }
    if m.num_shared_experts > 0:
        p["shared"] = swiglu_init(gen, d, m.d_ff_shared * m.num_shared_experts,
                                  dtype=dtype, device=device)
    return p


def _positions_in_expert(ids_f: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Rank of each dispatch entry within its expert, along the last axis,
    by a stable sort: O(M) memory instead of the (M, E) cumsum.  The
    reference's ``associative_scan`` of max over the run starts is a
    ``cummax``."""
    M = ids_f.shape[-1]
    order = torch.argsort(ids_f, dim=-1, stable=True)
    sorted_ids = torch.gather(ids_f, -1, order)
    idx = torch.arange(M, device=ids_f.device).expand_as(ids_f)
    is_start = torch.ones_like(ids_f, dtype=torch.bool)
    is_start[..., 1:] = sorted_ids[..., 1:] != sorted_ids[..., :-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    rank = torch.zeros_like(order).scatter_(-1, order, idx - run_start)
    return rank.to(torch.int32)


def route(p, cfg: ModelConfig, x: torch.Tensor):
    """The router in f32: ``(probs (B, T, E), gates (B, T, k), expert ids
    (B, T, k))``, gates renormalised over the k chosen, ids in descending
    probability with the lower id first among ties."""
    logits = x.float() @ p["router"]["kernel"].float()
    probs = torch.softmax(logits, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, ids = vals[..., : cfg.moe.top_k], ids[..., : cfg.moe.top_k]
    gates = gates / torch.clamp_min(gates.sum(dim=-1, keepdim=True), 1e-9)
    return probs, gates, ids


def dispatch(ids: torch.Tensor, C: int, num_experts: int):
    """``(dest, keep)`` for (B, T, k) expert ids: each entry's row of the
    flattened (E·C) buffer, or ``E·C`` (the trash row) past capacity."""
    B = ids.shape[0]
    ids_f = ids.reshape(B, -1)
    pos = _positions_in_expert(ids_f, num_experts)
    keep = pos < C
    dest = torch.where(keep, ids_f.long() * C + pos, num_experts * C)
    return dest, keep


def _route_rows(kernel, x, *, cfg: ModelConfig, C: int, cd):
    """Everything of the MoE FFN that is per batch row, before the experts:
    ``(probs, gates, counts, xe, dest, keep)`` with the dispatch counts
    (E,) and the (B, E, C, d) buffer of x's tokens by (expert, rank)."""
    m = cfg.moe
    B, T, d = x.shape
    E, k = m.num_experts, m.top_k
    probs, gates, ids = route({"router": {"kernel": kernel}}, cfg, x)
    # the dispatch counts, exact in f32 (the reference sums a one-hot); a
    # scatter of ones, so nothing waits on the device.  Buffers are made
    # like x (new_zeros): where x is a DTensor they are DTensors written in
    # place
    flat = ids.reshape(-1)
    counts = x.new_zeros(E, dtype=torch.float32).scatter_add_(
        0, flat, torch.ones(flat.shape, device=x.device))
    dest, keep = dispatch(ids, C, E)  # (B, T·k)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = x.new_zeros((B, E * C + 1, d), dtype=cd)
    # entry j of a row is token j // k (the reference's repeat(arange(T), k))
    buf[rows, dest] = x.to(cd)[:, :, None].expand(B, T, k, d).reshape(B, T * k, d)
    return probs, gates, counts, buf[:, : E * C].reshape(B, E, C, d), dest, keep


def _combine_rows(h, dest, keep, gates, *, cd):
    """y (B, T, d): each token's k expert outputs (B, E, C, d) weighted by
    its gates and added in slot order, slot 0 first, as ``.at[tok].add``."""
    B, E, C, d = h.shape
    T, k = gates.shape[1:]
    rows = torch.arange(B, device=h.device)[:, None]
    ent = h.reshape(B, E * C, d)[rows, dest.clamp(max=E * C - 1)]
    ent = torch.where(keep[..., None], ent, 0.0) * gates.reshape(B, -1, 1).to(cd)
    ent = ent.reshape(B, T, k, d)
    y = torch.zeros((B, T, d), dtype=cd, device=h.device)
    for j in range(k):
        y = y + ent[:, :, j]
    return y


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, *, compute_dtype=None):
    """``(y, aux_loss)`` for x (B, T, d).  Under a mesh, with x sharded on
    its batch only, the routing, dispatch and combine run on each rank's
    rows (``sharding.rules.per_block``; the counts leave as a partial
    sum), and only the expert products are ``DTensor`` operations."""
    m = cfg.moe
    B, T, d = x.shape
    E, k = m.num_experts, m.top_k
    cd = compute_dtype or x.dtype
    C = max(1, int(m.capacity_factor * T * k / E))

    kernel = p["router"]["kernel"]
    route_rows = functools.partial(_route_rows, cfg=cfg, C=C, cd=cd)
    combine_rows = functools.partial(_combine_rows, cd=cd)
    pl = same_blocks((0,), x)
    if pl is not None and isinstance(kernel, DTensor):
        whole = [Replicate()] * len(pl)
        summed = [Partial() if q.is_shard() else q for q in pl]
        probs, gates, counts, xe, dest, keep = per_block(
            route_rows, pl, kernel, x, in_placements=(whole, pl),
            out_placements=(pl, pl, summed, pl, pl, pl))
        combine = functools.partial(per_block, combine_rows, pl)
    else:
        probs, gates, counts, xe, dest, keep = route_rows(kernel, x)
        combine = combine_rows
    f_e = counts / (B * T) / k
    aux = m.aux_loss_coef * E * torch.sum(f_e * probs.mean(dim=(0, 1)))
    # (B, E, C, d) resharded to (data, model, ·, ·) is the all-to-all
    xe = maybe_shard(xe, "batch", "model", None, None)

    # the experts' d dimension is whole before use, as FSDP gathers it:
    # DTensor's local einsum fails on experts over "model" with d over
    # "data" (a view across two subspaces); no mesh, no change
    w = p["experts"]
    w_gate, w_up = (unshard_dim(w[n], 1).to(cd) for n in ("w_gate", "w_up"))
    w_down = unshard_dim(w["w_down"], 2).to(cd)
    g = torch.einsum("becd,edf->becf", xe, w_gate)
    u = torch.einsum("becd,edf->becf", xe, w_up)
    h = torch.einsum("becf,efd->becd", F.silu(g) * u, w_down)
    h = maybe_shard(h, "batch", "model", None, None)

    y = combine(h, dest, keep, gates)
    if "shared" in p:
        y = y + swiglu(p["shared"], x.to(cd))
    return y.to(x.dtype), aux
