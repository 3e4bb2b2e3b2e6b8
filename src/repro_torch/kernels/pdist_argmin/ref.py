"""Plain PyTorch nearest-centroid assignment (port of
``repro.kernels.pdist_argmin.ref``): the CPU path, and what
``chip_smoke.py`` holds the CUDA kernel to on the card.

It materialises the (N, K, d) differences, so on the card it is run on a
chunk of points, never on a whole data set.
"""

from __future__ import annotations

import torch

from repro_torch.kernels._tf32 import tf32_round

METRICS = ("l2", "l1", "linf")


def pdist_argmin_ref(X: torch.Tensor, C: torch.Tensor, metric: str = "l2"):
    """``(idx int32 (N,), dist f32 (N,))``: per point of X (N, d), the first
    index of its nearest row of C (K, d) and that distance, in f32.  l2 is
    squared, in the direct form Σ(x − c)²."""
    diff = X[:, None, :].float() - C[None, :, :].float()
    if metric == "l2":
        d = torch.sum(diff * diff, dim=-1)  # squared — same argmin
    elif metric == "l1":
        d = torch.sum(torch.abs(diff), dim=-1)
    elif metric == "linf":
        d = torch.amax(torch.abs(diff), dim=-1)
    else:
        raise ValueError(metric)
    # torch.argmin, like jnp.argmin, returns the first index of a tie
    return torch.argmin(d, dim=1).to(torch.int32), torch.amin(d, dim=1)


# ----------------------------------------------------------------------------
# The tensor-core l2 route's arithmetic (csrc/pdist_argmin_tc.cu), emulated.
# Only tests use it: it shows on the CPU that the guarded expanded form
# gives the direct form's answer, and that without the guard it would not.
# ----------------------------------------------------------------------------

#: the guard's bound, tol = (A·dp + B)·2⁻²³·(‖x‖² + max‖c‖²), by type
GUARD_COEFFS = {torch.float32: (8, 16), torch.bfloat16: (4, 8)}


def padded_depth(d: int, dtype) -> int:
    """d rounded up to the product's depth: 8 columns (TF32), 16 (bf16)."""
    step = 16 if dtype == torch.bfloat16 else 8
    return -(-d // step) * step


def guard_tol(x2: torch.Tensor, cmax2: torch.Tensor, d: int, dtype) -> torch.Tensor:
    """The largest top-2 gap of the expanded form that the guard re-checks."""
    a, b = GUARD_COEFFS[dtype]
    return (a * padded_depth(d, dtype) + b) * 2.0**-23 * (x2 + cmax2)


def pdist_argmin_tc_emulated(X: torch.Tensor, C: torch.Tensor, *, guard: bool = True):
    """The l2 tensor-core route on X (N, d), C (K, d) of one type:
    ``(idx int32 (N,), dist f32 (N,), flagged bool (N,))``.

    The search runs in the expanded form e_k = ‖c_k‖² − 2x·c_k.  For f32
    both x and m = −2c are split into hi = tf32(v) and lo = tf32(v − hi),
    and x·m is lo·hi + hi·lo + hi·hi, each product of TF32 values exact in
    f32; bf16 takes one product of the exact values.  The winner is the
    first index of the least e_k, its distance is recomputed in the direct
    form, and a row whose gap to the second-least e_k is at most
    ``guard_tol`` is flagged and, with ``guard``, re-run in the direct form
    over all K (``pdist_argmin_ref``)."""
    if X.dtype != C.dtype or X.dtype not in GUARD_COEFFS:
        raise ValueError(f"expected X and C of one type, f32 or bf16: {X.dtype}, {C.dtype}")
    Xf, Cf = X.float(), C.float()
    m = -2.0 * Cf  # exact
    if X.dtype == torch.bfloat16:
        cross = Xf @ m.T
    else:
        xh, mh = tf32_round(Xf), tf32_round(m)
        xl, ml = tf32_round(Xf - xh), tf32_round(m - mh)
        cross = xl @ mh.T + xh @ ml.T + xh @ mh.T
    c2 = torch.sum(Cf * Cf, dim=1)
    e = cross + c2[None, :]
    idx = torch.argmin(e, dim=1)  # the first index of a tie, as the kernel's strict '<'
    rows = torch.arange(X.shape[0])
    b1 = e[rows, idx]
    b2 = e.clone()
    b2[rows, idx] = float("inf")
    b2 = b2.min(dim=1).values  # +inf when K = 1
    diff = Xf - Cf[idx]
    dist = torch.sum(diff * diff, dim=1)
    flagged = ~((b2 - b1) > guard_tol(torch.sum(Xf * Xf, dim=1), c2.max(), X.shape[1], X.dtype))
    idx = idx.to(torch.int32)
    if guard and bool(flagged.any()):
        idx[flagged], dist[flagged] = pdist_argmin_ref(X[flagged], C, "l2")
    return idx, dist, flagged
