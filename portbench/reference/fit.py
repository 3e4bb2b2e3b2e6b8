"""Plain reference of the fit cells: full-batch distributed gradient descent
on the mean logistic loss, every node's gradient weighted 1/K, summed
after a top-k wire with error feedback, for the first rounds from θ = 0.

Per round t and scenario s (learning rate lr_s), on node k's rows:

    m_i   = y_i · (x_i · θ)
    g_k   = mean_i( −y_i · σ(−m_i) · x_i ) / K          (the message)
    c_k   = g_k + r_k                                    (error feedback)
    o_k   = c_k where |c_k| ≥ the k-th largest |c_k| of the row, else 0
    r_k   = c_k − o_k
    θ     = θ − lr_s · Σ_k o_k

and after each round the loss mean_i logaddexp(0, −m_i) over every row at
the new θ.  Every push costs k × (4 + 4) bytes (index and f32 value).

``fault`` plants the faults that the benchmark's check has to catch, in
the reference put in the program's place: ``unchanged`` (θ never moves),
``frozen`` (θ stops after round 1), ``ef_dropped`` (from round 2 on the
residual is not added to the message), ``half_batch`` (each node's mean
over the first half of its rows), ``exchange`` (the sum leaves the last
node out), ``answer`` (node 0's largest kept entry of round 1 sent
negated).
"""

from __future__ import annotations

import torch

from portbench.reference.tf32 import dtype as _dtype
from portbench.reference.tf32 import operand

#: rows of X converted at a time
BLOCK_ROWS = 1 << 15
FAULTS = ("unchanged", "frozen", "ef_dropped", "half_batch", "exchange", "answer")
#: a row whose k-th and (k+1)-th largest magnitudes lie closer than this
#: share is a near tie: float32 rounding may order them either way, or make
#: them equal so that a program that keeps ties keeps both
NEAR_TIE = 1e-5


def _pass(X, y, thetas, precision, half_batch=False, grad=True, node_sum=False):
    """One pass over X at the S parameters ``thetas`` (S, D): the mean loss
    over all rows (S,) and, with ``grad``, the nodes' gradients (S, K, D),
    each node's mean over its rows (its first half under ``half_batch``),
    or with ``node_sum`` their sum over the nodes (S, D) and the sum of
    the terms' magnitudes (S, D), the scale at which a float32 sum of the
    terms rounds."""
    K, Nk, D = X.shape
    S = thetas.shape[0]
    dt = _dtype(precision)
    th = operand(thetas, precision)
    loss = torch.zeros((S,), dtype=torch.float64, device=X.device)
    G = Gabs = None
    if grad:
        G = torch.zeros((S, D) if node_sum else (S, K, D), dtype=dt, device=X.device)
    if node_sum:
        Gabs = torch.zeros((S, D), dtype=dt, device=X.device)
    nb = max(1, BLOCK_ROWS // Nk)
    used = Nk // 2 if half_batch else Nk
    for a in range(0, K, nb):
        Xb = operand(X[a:a + nb], precision)  # (B, Nk, D)
        yb = y[a:a + nb].to(dt)
        m = yb[None] * torch.einsum("bnd,sd->sbn", Xb, th)
        loss += torch.logaddexp(torch.zeros((), dtype=dt, device=X.device), -m).sum(
            dim=(1, 2), dtype=torch.float64)
        if not grad:
            continue
        coef = (-yb[None] * torch.sigmoid(-m))[:, :, :used]
        if precision == "tf32":
            coef = operand(coef, precision)
        if node_sum:
            G += torch.einsum("bnd,sbn->sd", Xb[:, :used], coef) / used
            Gabs += torch.einsum("bnd,sbn->sd", Xb[:, :used].abs(), coef.abs()) / used
        else:
            G[:, a:a + nb] = torch.einsum("bnd,sbn->sbd", Xb[:, :used], coef) / used
    if node_sum:
        return loss / (K * Nk), G, Gabs
    return loss / (K * Nk), G


def _topk_ef(c, k):
    """Per row of ``c`` (R, D): kept entries (|c| at or above the row's
    k-th largest magnitude) and the residual."""
    t = torch.topk(c.abs(), k, dim=1).values[:, -1:]
    o = torch.where(c.abs() >= t, c, torch.zeros((), dtype=c.dtype, device=c.device))
    return o, c - o


def at(X, y, thetas, group: int = 16):
    """At each of ``thetas`` (n, D), in float64, ``group`` parameters a
    pass: the mean loss over every row (n,), the sum over the nodes of the
    nodes' messages, each node's mean gradient over K (n, D), and the same
    sum of the terms' magnitudes (n, D).  The judge of a program's reported
    losses and of its rounds, at its own parameters."""
    K = X.shape[0]
    out = [], [], []
    for a in range(0, thetas.shape[0], group):
        for acc, v in zip(out, _pass(X, y, thetas[a:a + group].double(), "float64",
                                     node_sum=True)):
            acc.append(v if v.dim() == 1 else v / K)
    return tuple(torch.cat(acc) for acc in out)


def run(X, y, lrs, *, fraction: float, rounds: int = 3, precision: str = "float64",
        fault: str | None = None) -> dict:
    """The first ``rounds`` rounds from θ = 0 for each learning rate in
    ``lrs``.  Returns, as float64 tensors, what a program's run gives (see
    ``portbench/entries/fit.py``): one block of rounds from θ = 0 and r = 0
    with θ and Σ_k r_k after each round (S, rounds, D), the losses
    (S, rounds) at those θ, ``residual1`` (S, K) the row norms of the
    residual after round 1 and ``uplink_bytes_per_round``; and what only
    the reference gives: ``message1`` (S, K) the row norms of round 1's
    messages, and ``near_tie1`` (S, K) the rows whose k-th and (k+1)-th
    magnitudes lie within ``NEAR_TIE`` of each other in round 1."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    K, Nk, D = X.shape
    S = len(lrs)
    dt = _dtype(precision)
    lr = torch.tensor(lrs, dtype=dt, device=X.device)[:, None]
    k = max(1, min(D, int(round(fraction * D))))
    theta = torch.zeros((S, D), dtype=dt, device=X.device)
    r = torch.zeros((S * K, D), dtype=dt, device=X.device)
    losses, thetas, rsums = [], [], []
    out = {}
    for t in range(rounds):
        loss, G = _pass(X, y, theta.float() if precision == "tf32" else theta, precision,
                        half_batch=fault == "half_batch")
        if t:
            losses.append(loss)
        msg = (G / K).reshape(S * K, D)
        c = msg if (t and fault == "ef_dropped") else msg + r
        if t == 0:
            mags = torch.topk(c.abs(), min(k + 1, D), dim=1).values
            gap = (mags[:, k - 1] - mags[:, -1]) / mags[:, k - 1]
            out["near_tie1"] = ((gap < NEAR_TIE) if k < D else torch.zeros_like(gap).bool()
                                ).view(S, K)
        o, r = _topk_ef(c, k)
        o = o.view(S, K, D)
        if t == 0 and fault == "answer":
            j = int(o[0, 0].abs().argmax())
            o[0, 0, j] = -o[0, 0, j]
        agg = o[:, :-1].sum(dim=1) if fault == "exchange" else o.sum(dim=1)
        if t == 0:
            out["residual1"] = r.view(S, K, D).double().norm(dim=2)
            out["message1"] = msg.view(S, K, D).double().norm(dim=2)
        if not (fault == "unchanged" or (t and fault == "frozen")):
            theta = theta - lr * agg
        thetas.append(theta.double())
        rsums.append(r.view(S, K, D).double().sum(dim=1))
        del G, msg, o, c
    loss, _ = _pass(X, y, theta.float() if precision == "tf32" else theta, precision,
                    grad=False)
    losses.append(loss)
    zeros = torch.zeros((S, D), dtype=torch.float64, device=X.device)
    out["blocks"] = [{"theta0": zeros, "rsum0": zeros, "thetas": torch.stack(thetas, dim=1),
                      "rsums": torch.stack(rsums, dim=1)}]
    out["loss_thetas"] = out["blocks"][0]["thetas"]
    out["losses"] = torch.stack(losses, dim=1)
    out["uplink_bytes_per_round"] = k * (4 + 4) * K * S
    return out
