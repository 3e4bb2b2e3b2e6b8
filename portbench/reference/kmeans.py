"""Plain reference of the k-means cell: Lloyd's k-means under squared l2 on
the union of the sites' points, ``iters`` EM iterations from C0 and a
final assignment.

    E-step: a_i = argmin_j ‖x_i − c_j‖²   (first index on ties)
    M-step: c_j = mean of the points with a_i = j; a cluster left empty
            keeps its centroid

The sites' sufficient statistics (Σx, count) summed over the sites are the
union's, so the reference needs no sites.  Returns the centroids, the
final assignments and the inertia Σ_i min_j ‖x_i − c_j‖².

``float64`` takes the argmin of ‖c_j‖² − 2 x_i·c_j in float64 and the
inertia from the direct ‖x_i − c_{a_i}‖².  ``tf32`` takes x_i·c_j from
operands rounded to TF32 and everything else in float32.

``fault`` plants, in the reference put in the program's place:
``unchanged`` (the M-step returns C unchanged), ``half_batch`` (each
site's M-step over the first half of its points), ``exchange`` (the sum
leaves the last site out), ``answer`` (point 0's final assignment moved to
the next cluster).
"""

from __future__ import annotations

import torch

from portbench.reference.tf32 import dtype as _dtype
from portbench.reference.tf32 import operand

#: points of an E-step block
BLOCK_ROWS = 1 << 18
FAULTS = ("unchanged", "half_batch", "exchange", "answer")


def estep(X: torch.Tensor, C: torch.Tensor, precision: str):
    """``(assignments (N,) int64, squared distance (N,) float64)``."""
    dt = _dtype(precision)
    Cp = operand(C, precision)
    cc = (C.to(dt) ** 2).sum(dim=1)
    idx = torch.empty((X.shape[0],), dtype=torch.int64, device=X.device)
    dist = torch.empty((X.shape[0],), dtype=torch.float64, device=X.device)
    for a in range(0, X.shape[0], BLOCK_ROWS):
        Xb = X[a:a + BLOCK_ROWS]
        part = torch.addmm(cc[None], operand(Xb, precision), Cp.T, alpha=-2.0)
        i = part.argmin(dim=1)
        idx[a:a + BLOCK_ROWS] = i
        if precision == "float64":
            dist[a:a + BLOCK_ROWS] = ((Xb.double() - C.double()[i]) ** 2).sum(dim=1)
        else:
            xx = (Xb.to(dt) ** 2).sum(dim=1)
            dist[a:a + BLOCK_ROWS] = torch.clamp_min(
                xx + part.gather(1, i[:, None])[:, 0], 0.0).double()
        del part
    return idx, dist


def mstep(X: torch.Tensor, assign: torch.Tensor, C: torch.Tensor, precision: str):
    """The centroids' new values; an empty cluster keeps its centroid."""
    K = C.shape[0]
    dt = _dtype(precision)
    sums = torch.zeros((K, X.shape[1]), dtype=dt, device=X.device)
    sums.index_add_(0, assign, operand(X, precision).to(dt))
    counts = torch.bincount(assign, minlength=K).to(dt)
    return torch.where(counts[:, None] > 0, sums / torch.clamp_min(counts, 1.0)[:, None], C)


def run(Xs: torch.Tensor, C0: torch.Tensor, *, iters: int, precision: str = "float64",
        fault: str | None = None) -> dict:
    """``iters`` EM iterations on the sites' points ``Xs`` (sites, n, d)
    from ``C0`` (K, d).  Returns ``centroids`` (K, d) float64,
    ``assignments`` (N,) int64 and ``inertia`` (a float)."""
    if fault is not None and fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}")
    sites, n, d = Xs.shape
    X = Xs.reshape(-1, d)
    C = C0.to(_dtype(precision))
    for _ in range(iters):
        a, _ = estep(X, C, precision)
        if fault == "unchanged":
            continue
        if fault == "half_batch":
            keep = (torch.arange(X.shape[0], device=X.device) % n) < n // 2
            C = mstep(X[keep], a[keep], C, precision)
        elif fault == "exchange":
            C = mstep(X[:-n], a[:-n], C, precision)
        else:
            C = mstep(X, a, C, precision)
        del a
    a, dist = estep(X, C, precision)
    if fault == "answer":
        a[0] = (a[0] + 1) % C.shape[0]
    return {"centroids": C.double(), "assignments": a, "inertia": float(dist.sum())}
