"""The numbers that decide ``correct``: each compares what the program
produced with what a reference produced from the same inputs.

A norm is compared as the training rule asks: the gap between the
program's norm of a leaf and the reference's, over the reference's norm of
that leaf or of the median leaf, whichever is larger, worst leaf first.
Leaves whose reference message is nought to rounding (under a thousandth
of the median leaf's) move by round-off alone and are left out.
"""

from __future__ import annotations

import torch

#: a leaf whose reference message is under this share of the median leaf's
#: is left out of the residual comparison
NOUGHT = 1e-3


def norm_gap(p: torch.Tensor, r: torch.Tensor, keep: torch.Tensor | None = None) -> float:
    """Worst |‖p_i‖ − ‖r_i‖| / max(‖r_i‖, median ‖r‖) over the leaves i;
    ``p`` and ``r`` hold the norms."""
    p, r = p.double().reshape(-1), r.double().reshape(-1)
    if keep is not None:
        p, r = p[keep.reshape(-1)], r[keep.reshape(-1)]
    if r.numel() == 0:
        return 0.0
    floor = torch.clamp_min(r, r.median())
    return float(((p - r).abs() / floor).max())


def _half_ulp(theta: torch.Tensor) -> torch.Tensor:
    """Half the float32 spacing at each entry of ``theta`` (held as float32
    values): what a float32 θ cannot resolve of a move."""
    t = theta.float().abs()
    return ((torch.nextafter(t, torch.full_like(t, float("inf"))) - t) / 2).double()


def fit(prog: dict, ref: dict, at, lrs) -> dict:
    """The fit cells' numbers, all of them blind to which of two entries that
    tie to float32 rounding the top-k keeps (see PERF.md).  A round's move,
    (θ_{t−1} − θ_t)/lr + Σ_k r_{k,t} − Σ_k r_{k,t−1}, is the sum of the
    nodes' messages at θ_{t−1} whatever the top-k kept:

    * ``loss_gap``: each reported loss against the reference's loss at the
      program's own parameters;
    * ``grad_norm_gap``: the moves of the first block (the set-up's rounds
      from θ = 0) against the reference's sum of the dense messages at the
      program's own θ_{t−1}, by the gap of their norms, a scenario a leaf,
      worst round first;
    * ``window_grad_gap``: the same for the block continued from the
      window's end state, by the norm of the difference, less on each entry
      what float32 θ_t cannot resolve, over the norm of the terms'
      magnitudes (the scale at which float32 sums of them round), so that
      it reads the same however far the window trained;
    * ``residual_norm_gap``: the wire's residual after the first round, a
      node's row a leaf, near-tie rows and rows nought to rounding left out;
    * ``uplink_bytes_gap``: the ledger's bytes a round against the count.

    ``prog`` holds ``blocks`` of rounds, each from its own start
    (``theta0``, ``rsum0`` (S, D); ``thetas``, ``rsums`` (S, T, D) after each
    round), ``loss_thetas`` (S, L, D) with the ``losses`` (S, L) reported at
    them, ``residual1`` and ``uplink_bytes_per_round``; ``at`` maps
    parameters (n, D) to the reference's losses (n,), summed messages and
    summed magnitudes (n, D); ``lrs`` are the scenarios' learning rates.  A
    reference put in the program's place has one block and no
    ``window_grad_gap``."""
    S, D = prog["blocks"][0]["theta0"].shape
    lr = torch.tensor(lrs, dtype=torch.float64, device=prog["losses"].device)[:, None, None]
    starts, moves, slack, block_of = [], [], [], []
    for i, b in enumerate(prog["blocks"]):
        before = torch.cat([b["theta0"][:, None], b["thetas"][:, :-1]], dim=1).double()
        rs_before = torch.cat([b["rsum0"][:, None], b["rsums"][:, :-1]], dim=1).double()
        starts.append(before)
        moves.append((before - b["thetas"].double()) / lr + b["rsums"].double() - rs_before)
        slack.append(_half_ulp(b["thetas"]) / lr)
        block_of += [i] * b["thetas"].shape[1]
    starts, moves, slack = (torch.cat(x, dim=1) for x in (starts, moves, slack))
    T, L = starts.shape[1], prog["loss_thetas"].shape[1]
    losses, grads, mags = at(torch.cat([starts, prog["loss_thetas"].double()], dim=1)
                             .reshape(-1, D))
    losses = losses.view(S, T + L)[:, T:]
    grads, mags = grads.view(S, T + L, D)[:, :T], mags.view(S, T + L, D)[:, :T]
    keep = ((ref["message1"] >= NOUGHT * ref["message1"].median())
            & ~ref["near_tie1"])
    out = {
        "loss_gap": float(((prog["losses"].double() - losses).abs() / losses.abs()).max()),
        "grad_norm_gap": max(norm_gap(moves[:, t].norm(dim=1), grads[:, t].norm(dim=1))
                             for t in range(T) if block_of[t] == 0),
        "residual_norm_gap": norm_gap(prog["residual1"], ref["residual1"], keep),
        "uplink_bytes_gap": float(abs(prog["uplink_bytes_per_round"]
                                      - ref["uplink_bytes_per_round"])),
    }
    later = [t for t in range(T) if block_of[t] > 0]
    if later:
        over = torch.clamp_min((moves - grads).abs() - slack, 0.0)
        out["window_grad_gap"] = max(float((over[:, t].norm(dim=1)
                                            / mags[:, t].norm(dim=1)).max()) for t in later)
    return out


def kmeans(prog: dict, ref: dict) -> dict:
    """The k-means cell's numbers: the share of points assigned elsewhere
    than by the reference, the inertia's relative gap, and the worst
    centroid's distance from the reference's over max(its norm, the median
    centroid's norm)."""
    C, Cr = prog["centroids"].double(), ref["centroids"]
    cn = Cr.norm(dim=1)
    return {
        "assign_mismatch": float((prog["assignments"].long() != ref["assignments"])
                                 .double().mean()),
        "inertia_gap": abs(prog["inertia"] - ref["inertia"]) / ref["inertia"],
        "centroid_gap": float(((C - Cr).norm(dim=1) / torch.clamp_min(cn, cn.median())).max()),
    }
