"""Wire layer — WHAT crosses the network and what it costs (port of
``repro.api.wire``).

A ``Wire`` decides how a push is encoded (dense, top-k, magnitude
threshold, int8, each optionally with error feedback) and reports the byte
cost of every message, from which the engine materializes the
``CommLedger``.  Two encode entry points, one per transport family:

* ``encode_push`` — server transports (§5 protocol): the node pushes the
  delta it computed on top of the handed-off parameter.
* ``encode_updates`` — update transports (allreduce / delay line): the
  stacked (K, …) per-node messages are encoded before aggregation, error
  feedback residuals carried per node; with ``stacked=False`` one
  single-stream message (``OptimizerStrategy``), residuals shaped like θ.

The top-k and int8 wires encode each eligible leaf (f32, ≥ 256 elements
per node) with the port's CUDA kernels: one launch per leaf per round for
all K nodes at once (the reference scans the nodes one at a time); a
single-stream leaf is encoded as one row, a (1, n) view of it.
``use_kernel`` is tri-state: ``"auto"`` means "the tensors are on CUDA",
``True``/``False`` force it — ``False`` on CUDA runs the reference
formulas, which is how ``chip_smoke.py`` shows the kernels change no bit
of a fit.  Server transports encode through ``CompressedWire.encode_push``
with the reference codecs, as in the JAX package.

Not ported yet: ``dp:``, ``secagg`` and ``>``-chains (``ROADMAP.md``
queue 1, item 5).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import torch

from repro_torch.core.compression import (
    Compressed,
    _kernel_eligible,
    int8_compress,
    int8_rows,
    kernel_plan,
    threshold_compress,
    topk_compress,
    topk_rows,
)
from repro_torch.utils.tree import (
    tree_add,
    tree_bytes,
    tree_flatten,
    tree_leaves,
    tree_map,
    tree_stack,
    tree_sub,
    tree_unflatten,
)

PyTree = Any


class Wire:
    """Base wire: dense — push exactly what the strategy produced::

        res = api.fit(strategy, data, transport="allreduce", steps=100,
                      wire="topk:0.1+ef", device="cuda")
        res.ledger.uplink_bytes    # metered through the wire
    """

    name = "dense"
    #: True when encode is the identity (no information loss)
    lossless = True

    def init_state(self, theta: PyTree, num_nodes: int, *, stacked: bool = True):
        """Per-run wire state (e.g. error-feedback residuals); () if none."""
        return ()

    def measure(self, tree: PyTree) -> int:
        """Dense byte size of ``tree``."""
        return tree_bytes(tree)

    def push_bytes(self, theta: PyTree) -> int | None:
        """Static per-push byte cost for θ-shaped messages, or None when the
        cost is value-dependent."""
        return self.measure(theta)

    def encode_push(self, wstate, k: int, theta_start: PyTree, theta_new: PyTree):
        """Encode one §5 contact push.  Returns (wstate, θ_push, up_bytes)."""
        return wstate, theta_new, torch.tensor(float(self.measure(theta_new)))

    def encode_updates(self, wstate, msgs: PyTree, *, stacked: bool = True):
        """Encode the stacked (K, …) update messages (one θ-shaped message
        with ``stacked=False``).  Returns (wstate, msgs_hat, up_bytes) with
        ``up_bytes`` summed over the nodes."""
        return wstate, msgs, torch.tensor(float(tree_bytes(msgs)))


class DenseWire(Wire):
    pass


def _set_row(buf: torch.Tensor, k: int, row: torch.Tensor) -> torch.Tensor:
    out = buf.clone()
    out[k] = row
    return out


class CompressedWire(Wire):
    """Compression codec from ``core.compression`` + optional error
    feedback: the residual of whatever the codec dropped is carried per
    node and added to the next push (EF-SGD)::

        wire = api.make_wire("topk:0.05+ef")   # or int8[+ef], thresh:<τ>[+ef]
        wire = api.CompressedWire(my_codec, error_feedback=True, name="mine")
    """

    lossless = False

    def __init__(
        self,
        compressor: Callable[[PyTree], Compressed],
        *,
        error_feedback: bool = False,
        name: str = "compressed",
    ):
        self.compressor = compressor
        self.error_feedback = error_feedback
        self.name = name
        self._pb_cache: dict = {}

    def init_state(self, theta: PyTree, num_nodes: int, *, stacked: bool = True):
        if not self.error_feedback:
            return ()
        if not stacked:
            return tree_map(torch.zeros_like, theta)
        return tree_map(
            lambda p: torch.zeros((num_nodes,) + tuple(p.shape), dtype=p.dtype,
                                  device=p.device),
            theta,
        )

    def push_bytes(self, theta: PyTree) -> int | None:
        # the built-in codecs price a push from shapes alone: one
        # evaluation on zeros gives the exact static cost (memoized)
        key = tuple((str(x.dtype), tuple(x.shape)) for x in tree_leaves(theta))
        if key not in self._pb_cache:
            zeros = tree_map(torch.zeros_like, theta)
            self._pb_cache[key] = int(float(self.compressor(zeros).wire_bytes))
        return self._pb_cache[key]

    def encode_push(self, wstate, k, theta_start, theta_new):
        delta = tree_sub(theta_new, theta_start)
        if self.error_feedback:
            corrected = tree_add(delta, tree_map(lambda b: b[k], wstate))
            comp = self.compressor(corrected)
            wstate = tree_map(
                lambda b, c, d: _set_row(b, k, c - d), wstate, corrected, comp.tree
            )
        else:
            comp = self.compressor(delta)
        return wstate, tree_add(theta_start, comp.tree), comp.wire_bytes

    def encode_updates(self, wstate, msgs, *, stacked: bool = True):
        if not stacked:
            if self.error_feedback:
                corrected = tree_add(msgs, wstate)
                comp = self.compressor(corrected)
                return tree_sub(corrected, comp.tree), comp.tree, comp.wire_bytes
            comp = self.compressor(msgs)
            return wstate, comp.tree, comp.wire_bytes
        # the reference vmaps the codec over nodes; a codec maps one node's
        # whole tree, so here it runs once per node row
        K = tree_leaves(msgs)[0].shape[0]
        hats, residuals, nbs = [], [], []
        for i in range(K):
            m = tree_map(lambda x: x[i], msgs)
            if self.error_feedback:
                m = tree_add(m, tree_map(lambda r: r[i], wstate))
            comp = self.compressor(m)
            hats.append(comp.tree)
            nbs.append(comp.wire_bytes)
            if self.error_feedback:
                residuals.append(tree_sub(m, comp.tree))
        new_state = tree_stack(residuals) if self.error_feedback else wstate
        return new_state, tree_stack(hats), torch.stack(nbs).sum()


class ThresholdWire(CompressedWire):
    """Magnitude-threshold sparsifier: keep entries with ``|x| ≥ tau``.
    The kept COUNT is value-dependent, so the ledger takes the per-round
    counted bytes instead of a static price."""

    def __init__(self, tau: float, *, error_feedback: bool = False):
        super().__init__(
            self._compress,
            error_feedback=error_feedback,
            name=f"thresh:{tau}" + ("+ef" if error_feedback else ""),
        )
        self.tau = tau

    def _compress(self, tree):
        return threshold_compress(tree, self.tau)

    def push_bytes(self, theta: PyTree) -> int | None:
        return None  # value-dependent — no static per-push cost


class _FusedWire(CompressedWire):
    """Compressed wire whose update encode runs the port's CUDA kernels.

    ``use_kernel``: ``"auto"`` is on exactly when the messages are CUDA
    tensors; ``True``/``False`` force it (``True`` on CPU runs the kernels'
    plain versions, ``False`` the reference codec).  Both paths compute the
    same formulas, so the knob never changes a bit of a fit.
    ``kernel_report(theta)`` says which leaves take which path; the engine
    reports it as ``FitResult.metrics["wire_kernel_hits"]``.
    """

    def __init__(self, compressor, *, error_feedback, name, use_kernel="auto"):
        super().__init__(compressor, error_feedback=error_feedback, name=name)
        self.use_kernel = use_kernel

    def _kernel_active(self, tree: PyTree) -> bool:
        if self.use_kernel == "auto":
            leaves = tree_leaves(tree)
            return bool(leaves) and leaves[0].device.type == "cuda"
        return bool(self.use_kernel)

    def kernel_report(self, theta: PyTree) -> dict:
        plan = kernel_plan(theta)
        plan["active"] = self._kernel_active(theta)
        plan["wire"] = self.name
        return plan

    def _encode_rows(self, m: torch.Tensor, r: torch.Tensor | None):
        """One leaf for all K nodes, ``m`` (K, …) → (encoded, new residual
        | None)."""
        raise NotImplementedError

    def _per_push_bytes(self, tree: PyTree) -> float:
        """Static byte cost of one node's push (mirrors the codec)."""
        raise NotImplementedError

    def push_bytes(self, theta: PyTree) -> int | None:
        # the codec's own count, from the shapes: the same number as the
        # codec run on zeros, without a θ-sized tree of zeros to run it on
        return int(self._per_push_bytes(theta))

    def encode_updates(self, wstate, msgs, *, stacked: bool = True):
        if not self._kernel_active(msgs):
            return super().encode_updates(wstate, msgs, stacked=stacked)
        leaves_m, spec = tree_flatten(msgs)
        leaves_r = tree_leaves(wstate) if self.error_feedback else [None] * len(leaves_m)
        if stacked:
            outs = [self._encode_rows(m, r) for m, r in zip(leaves_m, leaves_r)]
            K = leaves_m[0].shape[0]
            per = self._per_push_bytes(tree_map(lambda x: x[0], msgs))
            up = torch.full((K,), per).sum()
        else:
            # one push: each leaf as one row, a (1, n) view of it
            outs = [
                tuple(None if x is None else x[0]
                      for x in self._encode_rows(m[None], None if r is None else r[None]))
                for m, r in zip(leaves_m, leaves_r)
            ]
            up = torch.tensor(self._per_push_bytes(msgs))
        hat = tree_unflatten([o[0] for o in outs], spec)
        if self.error_feedback:
            return tree_unflatten([o[1] for o in outs], spec), hat, up
        return wstate, hat, up


class TopKWire(_FusedWire):
    """Top-k wire whose encode (mask + EF residual + survivor count) runs as
    ONE fused CUDA pass per eligible leaf, after an exact per-row
    ``torch.topk`` threshold."""

    def __init__(self, fraction: float, *, error_feedback: bool = False,
                 use_kernel="auto"):
        super().__init__(
            partial(topk_compress, fraction=fraction),
            error_feedback=error_feedback,
            name=f"topk:{fraction}" + ("+ef" if error_feedback else ""),
            use_kernel=use_kernel,
        )
        self.fraction = fraction

    def _encode_rows(self, m, r):
        k = max(1, int(round(self.fraction * m[0].numel())))
        if _kernel_eligible(m[0]):
            from repro_torch.kernels.topk_compress import ops as tk_ops

            out, res, _count = tk_ops.topk_encode(m, r, k=k)
            return out, res
        # reference fallback — identical formulas, so mixed kernel /
        # fallback leaves stay bit-equal to the all-reference path
        c = m if r is None else m + r
        o = topk_rows(c.reshape(c.shape[0], -1), k).view(c.shape)
        return o, (None if r is None else c - o)

    def _per_push_bytes(self, tree):
        return float(sum(
            max(1, int(round(self.fraction * x.numel()))) * (4 + x.element_size())
            for x in tree_leaves(tree)
        ))


class Int8Wire(_FusedWire):
    """Int8 wire: absmax + quantize→dequantize CUDA kernels per eligible
    leaf, one scale per node."""

    def __init__(self, *, error_feedback: bool = False, use_kernel="auto"):
        super().__init__(
            int8_compress,
            error_feedback=error_feedback,
            name="int8" + ("+ef" if error_feedback else ""),
            use_kernel=use_kernel,
        )

    def _encode_rows(self, m, r):
        c = m if r is None else m + r
        if _kernel_eligible(c[0]):
            from repro_torch.kernels.int8_quant import ops as q8_ops

            out = q8_ops.int8_roundtrip(c)[0]
        else:
            out = int8_rows(c.reshape(c.shape[0], -1)).view(c.shape)
        return out, (None if r is None else c - out)

    def _per_push_bytes(self, tree):
        return float(sum(x.numel() * 1 + 4 for x in tree_leaves(tree)))


_NOT_PORTED = "ROADMAP.md queue 1, item 5 (ChainWire, SecAggWire, DPWire)"


def make_wire(spec: str | Wire | None) -> Wire:
    """Resolve a wire spec: a ``Wire``, ``None``/``"dense"``, or
    ``"<codec>[+ef]"`` with codecs ``topk:<fraction>``, ``thresh:<tau>``
    and ``int8`` — e.g. ``"topk:0.05+ef"``."""
    if spec is None:
        return DenseWire()
    if isinstance(spec, Wire):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"wire spec must be a Wire or str, got {type(spec)!r}")
    if ">" in spec or spec.startswith(("dp:", "secagg")):
        raise NotImplementedError(
            f"wire {spec!r} is not ported to repro_torch yet — {_NOT_PORTED}"
        )
    if spec == "dense":
        return DenseWire()
    ef = spec.endswith("+ef")
    base = spec[:-3] if ef else spec
    if base.startswith("thresh:"):
        return ThresholdWire(float(base.split(":", 1)[1]), error_feedback=ef)
    if base.startswith("topk:"):
        return TopKWire(float(base.split(":", 1)[1]), error_feedback=ef)
    if base == "int8":
        return Int8Wire(error_feedback=ef)
    raise ValueError(
        f"unknown wire spec {spec!r} — expected 'dense', 'topk:<f>[+ef]', "
        "'thresh:<tau>[+ef]' or 'int8[+ef]'"
    )
