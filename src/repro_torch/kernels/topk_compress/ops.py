"""Top-k sparsification: the exact-threshold wire encode and the
approximate, sort-free ``topk_sparsify``.

``topk_encode`` is the counterpart of
``repro.kernels.topk_compress.ops.topk_encode``.  The
threshold stays outside the kernel, as in the JAX package (there XLA's
``lax.top_k``, here ``torch.topk``: both give the exact k-th magnitude);
the pass that masks, takes the EF residual and counts survivors is the
CUDA kernel on a CUDA tensor and its plain version on a CPU tensor.

Rows: where the JAX wire scans nodes one at a time, these functions take
the (K, …) stack of one leaf and threshold each node's row on its own,
so a round of K nodes is one launch per leaf.

``topk_sparsify`` is the counterpart of ``ops.topk_sparsify``: three
rounds of 128 candidate thresholds, each checked by one ``count_ge``
launch, then one ``apply_threshold`` launch.  The rounds run as tensor
operations on x's device, with no host round trip between them.
``count_ge`` and ``apply_threshold`` take the CUDA kernels for CUDA
tensors and their plain versions for CPU ones.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.topk_compress import kernel, ref
from repro_torch.kernels.topk_compress.ref import NCAND


def encode_threshold(c: torch.Tensor, t: torch.Tensor, *, with_residual: bool):
    """``(o, res | None, count)`` for rows ``c`` (K, n), thresholds ``t``
    (K,): the kernel for CUDA tensors, the plain version for CPU ones."""
    if c.device.type == "cuda":
        return kernel.encode_threshold(c, t, with_residual=with_residual)
    if c.device.type == "cpu":
        return ref.encode_threshold_ref(c, t, with_residual=with_residual)
    raise ValueError(f"topk encode: no kernel for device {c.device}")


@torch.library.custom_op("repro_torch::topk_encode", mutates_args=())
def _topk_encode_op(c: torch.Tensor, k: int,
                    with_residual: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The wire encode of rows ``c`` (R, …): each row's exact k-th
    magnitude, then one launch of the encode (or select) kernel over all R
    rows.  Without a residual the second output is empty."""
    rows = c.reshape(c.shape[0], -1).contiguous()
    t = torch.topk(rows.abs(), k, dim=1).values[:, -1].contiguous()
    o, res, count = encode_threshold(rows, t, with_residual=with_residual)
    res = res.view(c.shape) if with_residual else c.new_empty((0,))
    return o.view(c.shape), res, count


@_topk_encode_op.register_fake
def _(c, k, with_residual):
    res = torch.empty_like(c) if with_residual else c.new_empty((0,))
    return torch.empty_like(c), res, c.new_empty((c.shape[0],), dtype=torch.int32)


def _topk_encode_vmap(info, in_dims, c, k, with_residual):
    # (S, R, …) scenarios fold into S·R rows: each row keeps its own
    # threshold, so no bit of a row changes, and the kernel launches once
    c = c.movedim(in_dims[0], 0)
    S, R = c.shape[0], c.shape[1]
    o, res, count = _topk_encode_op(c.reshape((S * R,) + tuple(c.shape[2:])), k,
                                    with_residual)
    res = res.view(c.shape) if with_residual else res.new_empty((S, 0))
    return (o.view(c.shape), res, count.view(S, R)), (0, 0, 0)


torch.library.register_vmap("repro_torch::topk_encode", _topk_encode_vmap)


def topk_encode(u: torch.Tensor, r: torch.Tensor | None = None, *, k: int):
    """Fused wire encode of the stacked messages ``u`` (K, …) of one leaf,
    plus EF residuals ``r`` (same shape) when given.

    Per node row ``c = u + r``: keeps the ``k`` largest magnitudes
    (ties keep more), returning ``(o, res | None, count)`` with ``o`` and
    ``res = c - o`` shaped like ``u`` and ``count`` the (K,) int32
    survivors.  ``r=None`` runs the residual-free select kernel.  For one
    unstacked leaf ``x`` call ``topk_encode(x[None], k=k)``.

    A custom op (``repro_torch::topk_encode``): under ``torch.func.vmap``
    the S scenarios' (K, …) stacks run as one launch on S·K rows."""
    c = u if r is None else u + r
    k = max(1, min(int(k), c[0].numel()))
    o, res, count = _topk_encode_op(c, k, r is not None)
    return o, (res if r is not None else None), count


def count_ge(x: torch.Tensor, thresholds: torch.Tensor) -> torch.Tensor:
    """(128,) int64 counts of |x| >= t_j for the 128 ``thresholds`` (any
    order), x compared in f32.  Unlike the JAX function's f32 counts these
    are exact at any size, and x's own elements are all that is counted
    (the JAX kernel also counts its zero padding where a threshold is
    <= 0)."""
    t = thresholds.reshape(-1).to(device=x.device, dtype=torch.float32).contiguous()
    if x.device.type == "cuda":
        return kernel.count_ge(x.contiguous(), t)
    if x.device.type == "cpu":
        return ref.count_ge_ref(x, t)
    raise ValueError(f"topk count: no kernel for device {x.device}")


def apply_threshold(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """``where(|x| >= t, x, +0.0)`` in x's type and shape, |x| compared in
    f32 with the scalar ``thresh`` (a tensor; it stays on the device)."""
    t = torch.as_tensor(thresh).reshape(1).to(device=x.device, dtype=torch.float32)
    if x.device.type == "cuda":
        return kernel.apply_threshold(x.contiguous(), t.contiguous())
    if x.device.type == "cpu":
        return ref.apply_threshold_ref(x, t)
    raise ValueError(f"topk mask: no kernel for device {x.device}")


def topk_sparsify(x: torch.Tensor, k: int, *, rounds: int = 3) -> torch.Tensor:
    """Keep about the ``k`` largest magnitudes of x (ties and the bracket's
    resolution keep at least k), dropping the rest to +0.0.

    Each round places 128 candidates evenly in (lo, hi], counts the
    survivors of each, and narrows the bracket to the largest candidate
    that keeps at least k and its successor; the mask then applies lo.
    Line for line ``repro.kernels.topk_compress.ops.topk_sparsify``."""
    k = max(1, min(int(k), x.numel()))
    # max |x| in one pass with no |x| temporary (bitwise x.abs().max())
    hi = torch.linalg.vector_norm(x, float("inf")).float() * (1.0 + 1e-6) + 1e-30
    lo = torch.zeros((), dtype=torch.float32, device=x.device) + 1e-30
    frac = torch.arange(1, NCAND + 1, device=x.device).float() / NCAND
    for _ in range(rounds):
        cand = lo + (hi - lo) * frac
        counts = count_ge(x, cand)  # decreasing in cand
        # largest candidate with count >= k -> new lo; its successor -> new hi
        ok = counts >= k
        j = torch.clamp_min(ok.sum(dtype=torch.int32) - 1, 0).long().reshape(1)
        # index_select, not cand[j]: indexing by a tensor may read it on the host
        new_lo = torch.where(ok[0], cand.index_select(0, j)[0], lo)
        nxt = cand.index_select(0, torch.clamp_max(j + 1, NCAND - 1))[0]
        new_hi = torch.where(j[0] + 1 < NCAND, nxt, hi)
        new_hi = torch.where(ok[0], new_hi, cand[0])
        lo, hi = new_lo, new_hi
    return apply_threshold(x, lo)
