"""Mixture-of-Experts FFN with top-k routing, shared experts and the aux
load-balance loss (port of ``repro.models.moe``).

Capacity-based scatter dispatch, grouped per batch row as in the reference:
each row ranks its T·k dispatch entries within their expert by a stable
sort (``_positions_in_expert``), keeps the first ``C = max(1, int(cf·T·k /
E))`` of each expert and sends the rest to a trash row ``E·C`` (dropped:
their gate contribution is zero).  The expert SwiGLU runs on the (B, E, C,
d) buffer as batched products (``torch.einsum``), as the reference's
einsums do outside any Pallas kernel.  The reference's ``maybe_shard``
calls are the identity without a mesh and have no counterpart here.

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

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, swiglu, swiglu_init, truncated_normal

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
    rank = torch.zeros_like(idx).scatter_(-1, order, idx - run_start)
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


def moe_apply(p, cfg: ModelConfig, x: torch.Tensor, *, compute_dtype=None):
    """``(y, aux_loss)`` for x (B, T, d)."""
    m = cfg.moe
    B, T, d = x.shape
    E, k = m.num_experts, m.top_k
    cd = compute_dtype or x.dtype
    C = max(1, int(m.capacity_factor * T * k / E))

    probs, gates, ids = route(p, cfg, x)
    # the dispatch counts, exact in f32 (the reference sums a one-hot); a
    # scatter of ones, so nothing waits on the device
    flat = ids.reshape(-1)
    counts = torch.zeros(E, device=x.device).scatter_add_(
        0, flat, torch.ones(flat.shape, device=x.device))
    f_e = counts / (B * T) / k
    aux = m.aux_loss_coef * E * torch.sum(f_e * probs.mean(dim=(0, 1)))

    dest, keep = dispatch(ids, C, E)  # (B, T·k)
    rows = torch.arange(B, device=x.device)[:, None]
    buf = torch.zeros((B, E * C + 1, d), dtype=cd, device=x.device)
    # entry j of a row is token j // k (the reference's repeat(arange(T), k))
    buf[rows, dest] = x.to(cd)[:, :, None].expand(B, T, k, d).reshape(B, T * k, d)
    xe = buf[:, : E * C].reshape(B, E, C, d)

    w = p["experts"]
    g = torch.einsum("becd,edf->becf", xe, w["w_gate"].to(cd))
    u = torch.einsum("becd,edf->becf", xe, w["w_up"].to(cd))
    h = torch.einsum("becf,efd->becd", F.silu(g) * u, w["w_down"].to(cd))

    hf = h.reshape(B, E * C, d)
    ent = hf[rows, dest.clamp(max=E * C - 1)]
    ent = torch.where(keep[..., None], ent, 0.0) * gates.reshape(B, -1, 1).to(cd)
    ent = ent.reshape(B, T, k, d)
    y = torch.zeros((B, T, d), dtype=cd, device=x.device)
    for j in range(k):  # slot order, as .at[tok].add
        y = y + ent[:, :, j]

    if "shared" in p:
        y = y + swiglu(p["shared"], x.to(cd))
    return y.to(x.dtype), aux
