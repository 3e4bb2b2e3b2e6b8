"""Top-k wire encode: exact threshold + one fused pass per leaf.

Counterpart of ``repro.kernels.topk_compress.ops.topk_encode``.  The
threshold stays outside the kernel, as in the JAX package (there XLA's
``lax.top_k``, here ``torch.topk``: both give the exact k-th magnitude);
the pass that masks, takes the EF residual and counts survivors is the
CUDA kernel on a CUDA tensor and its plain version on a CPU tensor.

Rows: where the JAX wire scans nodes one at a time, these functions take
the (K, …) stack of one leaf and threshold each node's row on its own,
so a round of K nodes is one launch per leaf.  ``topk_sparsify`` (the
bisection count/mask kernels) is not ported yet — see ``ROADMAP.md``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.topk_compress import kernel, ref


def encode_threshold(c: torch.Tensor, t: torch.Tensor, *, with_residual: bool):
    """``(o, res | None, count)`` for rows ``c`` (K, n), thresholds ``t``
    (K,): the kernel for CUDA tensors, the plain version for CPU ones."""
    if c.device.type == "cuda":
        return kernel.encode_threshold(c, t, with_residual=with_residual)
    if c.device.type == "cpu":
        return ref.encode_threshold_ref(c, t, with_residual=with_residual)
    raise ValueError(f"topk encode: no kernel for device {c.device}")


def topk_encode(u: torch.Tensor, r: torch.Tensor | None = None, *, k: int):
    """Fused wire encode of the stacked messages ``u`` (K, …) of one leaf,
    plus EF residuals ``r`` (same shape) when given.

    Per node row ``c = u + r``: keeps the ``k`` largest magnitudes
    (ties keep more), returning ``(o, res | None, count)`` with ``o`` and
    ``res = c - o`` shaped like ``u`` and ``count`` the (K,) int32
    survivors.  ``r=None`` runs the residual-free select kernel.  For one
    unstacked leaf ``x`` call ``topk_encode(x[None], k=k)``.
    """
    c = u if r is None else u + r
    rows = c.reshape(c.shape[0], -1).contiguous()
    k = max(1, min(int(k), rows.shape[1]))
    t = torch.topk(rows.abs(), k, dim=1).values[:, -1].contiguous()
    o, res, count = encode_threshold(rows, t, with_residual=r is not None)
    return o.view(c.shape), (None if res is None else res.view(c.shape)), count
