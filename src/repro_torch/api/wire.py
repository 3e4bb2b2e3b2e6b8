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
of a fit.  Off the kernels the stacked messages take the same formulas
row by row (``topk_rows`` / ``int8_rows``), one call a leaf for all K
nodes, as the reference vmaps its codec: no host loop over the nodes.
Server transports encode through ``CompressedWire.encode_push`` with the
reference codecs, as in the JAX package.

The security wires: ``dp:<clip>,<sigma>`` clips each node's message to an
L2 norm and adds Gaussian noise; ``secagg`` simulates pairwise-masked
secure aggregation (the aggregate is the unmasked sum by construction,
``uplink_payloads`` shows what each uplink carries); ``"a>b"`` chains
stages left to right (``"dp:1.0,0.5>topk:0.1+ef"``), so a chained top-k or
int8 stage still runs its kernels.  Their noise and masks are drawn from a
``torch.Generator`` on the message's device seeded by ``_stream_seed`` of
(seed, round counter, global node index, leaf index): the same invariants
as the reference's ``fold_in`` chain (one fixed function of those four, so
placement- and occupancy-invariant), not its bits.  The per-node round
counters are int32 tensors on the host, so seeding a draw never waits for
the card.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import numpy as np
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
    #: True when this wire re-encodes a payload without changing its size
    #: (secure aggregation masks): a ``ChainWire`` then keeps the previous
    #: stage's byte count
    preserves_bytes = False

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

    def _encode_rows(self, m: torch.Tensor, r: torch.Tensor | None, kernel: bool):
        """One leaf for all K nodes, ``m`` (K, …) → (encoded, new residual
        | None): through the kernel where ``kernel`` and the leaf is
        eligible, else the reference formulas on each row."""
        raise NotImplementedError

    def _per_push_bytes(self, tree: PyTree) -> float:
        """Static byte cost of one node's push (mirrors the codec)."""
        raise NotImplementedError

    def push_bytes(self, theta: PyTree) -> int | None:
        # the codec's own count, from the shapes: the same number as the
        # codec run on zeros, without a θ-sized tree of zeros to run it on
        return int(self._per_push_bytes(theta))

    def encode_updates(self, wstate, msgs, *, stacked: bool = True):
        kernel = self._kernel_active(msgs)
        if not (kernel or stacked):
            return super().encode_updates(wstate, msgs, stacked=False)
        leaves_m, spec = tree_flatten(msgs)
        leaves_r = tree_leaves(wstate) if self.error_feedback else [None] * len(leaves_m)
        if stacked:
            outs = [self._encode_rows(m, r, kernel) for m, r in zip(leaves_m, leaves_r)]
            K = leaves_m[0].shape[0]
            per = self._per_push_bytes(tree_map(lambda x: x[0], msgs))
            up = torch.full((K,), per).sum()
        else:
            # one push: each leaf as one row, a (1, n) view of it
            outs = [
                tuple(None if x is None else x[0]
                      for x in self._encode_rows(m[None], None if r is None else r[None],
                                                 kernel))
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

    def _encode_rows(self, m, r, kernel):
        k = max(1, int(round(self.fraction * m[0].numel())))
        if kernel and _kernel_eligible(m[0]):
            from repro_torch.kernels.topk_compress import ops as tk_ops

            out, res, _count = tk_ops.topk_encode(m, r, k=k)
            return out, res
        # reference fallback — identical formulas, so mixed kernel /
        # fallback leaves stay bit-equal to the all-reference path; c
        # contiguous as the kernel's operand, so that the outputs sum over
        # the nodes in the same order
        c = (m if r is None else m + r).contiguous()
        o = topk_rows(c.reshape(c.shape[0], -1), k).view(c.shape)
        return o, (None if r is None else c - o)

    def _per_push_bytes(self, tree):
        return float(sum(
            max(1, int(round(self.fraction * x.numel()))) * (4 + x.element_size())
            for x in tree_leaves(tree)
        ))


class Int8Wire(_FusedWire):
    """Int8 wire: the whole encode of an eligible leaf (EF add, scale,
    quantize→dequantize, residual) in one CUDA launch where a row fits on
    chip, one scale per node."""

    def __init__(self, *, error_feedback: bool = False, use_kernel="auto"):
        super().__init__(
            int8_compress,
            error_feedback=error_feedback,
            name="int8" + ("+ef" if error_feedback else ""),
            use_kernel=use_kernel,
        )

    def _encode_rows(self, m, r, kernel):
        if kernel and _kernel_eligible(m[0]):
            from repro_torch.kernels.int8_quant import ops as q8_ops

            out, res, _scale = q8_ops.int8_encode(m, r)
            return out, res
        c = (m if r is None else m + r).contiguous()
        out = int8_rows(c.reshape(c.shape[0], -1)).view(c.shape)
        return out, (None if r is None else c - out)

    def _per_push_bytes(self, tree):
        return float(sum(x.numel() * 1 + 4 for x in tree_leaves(tree)))


_MASK64 = (1 << 64) - 1


def _splitmix64(h: int) -> int:
    h = (h + 0x9E3779B97F4A7C15) & _MASK64
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & _MASK64
    return h ^ (h >> 31)


def _stream_seed(*words: int) -> int:
    """The 64-bit seed of one noise or mask draw: SplitMix64 folded over
    the words (h ← splitmix64(h ⊕ w), from h = 0), e.g. (wire seed, round
    counter, global node index, leaf index).  A fixed function of the
    words alone, so a node's stream does not depend on where it runs or
    on which other nodes are alive."""
    h = 0
    for w in words:
        h = _splitmix64(h ^ (int(w) & _MASK64))
    return h


def _normal(shape, device, *words: int) -> torch.Tensor:
    """Standard normal f32 draws of ``shape`` on ``device`` from the stream
    ``_stream_seed(*words)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream_seed(*words))
    return torch.randn(shape, generator=gen, device=device, dtype=torch.float32)


def _counters(num_nodes: int, stacked: bool) -> torch.Tensor:
    # host-side int32 round counters: reading one to seed a draw needs no
    # device sync
    if stacked:
        return torch.zeros((num_nodes,), dtype=torch.int32)
    return torch.zeros((), dtype=torch.int32)


class DPWire(Wire):
    """Differentially-private uplink: per-node L2 clip + Gaussian noise.

    Each node's whole-tree message is scaled to L2 norm ≤ ``dp_clip`` and
    perturbed with N(0, (dp_sigma · dp_clip)²) noise per coordinate before
    it leaves the node.  The draw for node k at round t is one fixed
    function of (seed, t, global k, leaf): placement-invariant, and a dead
    row under a ``FaultPlan`` shifts no other node's stream.  The payload
    is dense, so the ledger meters dense bytes; chain a sparsifier to trade
    bytes too::

        api.fit(strategy, data, transport="allreduce", steps=20,
                wire="dp:1.0,0.01>topk:0.1+ef", device="cuda")
    """

    lossless = False

    def __init__(self, clip: float, sigma: float, *, seed: int = 0):
        if float(clip) <= 0.0:
            raise ValueError(f"dp clip must be > 0, got {clip}")
        if float(sigma) < 0.0:
            raise ValueError(f"dp sigma must be >= 0, got {sigma}")
        self.dp_clip = float(clip)
        self.dp_sigma = float(sigma)
        self.seed = int(seed)
        self.name = f"dp:{self.dp_clip},{self.dp_sigma}"

    def init_state(self, theta, num_nodes, *, stacked: bool = True):
        # per-node round counters: where each node is in its noise stream
        return _counters(num_nodes, stacked)

    def _privatize(self, leaves: list, cnts, gidx: list, level=None) -> list:
        """Clip + noise the rows of ``leaves`` (each (R, …), row r one
        node's leaf), row r with counter ``cnts[r]`` and global index
        ``gidx[r]``.  Under a sweep whose scenarios' counters parted
        (a swept ``dropout_p``), ``cnts`` is (S, R) and ``level`` the
        sweep's vmap level: each scenario's noise is drawn outside the
        batch and handed in as its slice."""
        R = leaves[0].shape[0]
        sq = sum(torch.sum(torch.square(x.float()).reshape(R, -1), dim=1) for x in leaves)
        nrm = torch.sqrt(sq)
        if isinstance(self.dp_clip, torch.Tensor) or isinstance(self.dp_sigma, torch.Tensor):
            # swept: the scenario's clip and σ·clip as f32 tensors
            clip = torch.as_tensor(self.dp_clip, dtype=torch.float32, device=nrm.device)
            sigma = torch.as_tensor(self.dp_sigma, dtype=torch.float32, device=nrm.device)
            noise_scale = sigma * clip
            scale = torch.clamp(clip / torch.clamp_min(nrm, 1e-12), max=1.0)
        else:
            # clip and σ·clip as the reference's f32 scalars, passed as
            # kernel arguments: a tensor made from them would be a
            # host-to-device copy, which waits for the card every round
            clip = float(np.float32(self.dp_clip))
            noise_scale = float(np.float32(self.dp_sigma) * np.float32(self.dp_clip))
            # a true divide (``scalar / tensor`` is a reciprocal and a multiply)
            scale = torch.clamp(torch.full_like(nrm, clip) / torch.clamp_min(nrm, 1e-12),
                                max=1.0)
        out = []
        for i, x in enumerate(leaves):
            shape = tuple(x.shape[1:])
            if level is None:
                noise = torch.stack([
                    _normal(shape, x.device, self.seed, cnts[r], gidx[r], i)
                    for r in range(R)
                ])
            else:
                noise = _scenario_join(torch.stack([
                    torch.stack([_normal(shape, x.device, self.seed, c[r], gidx[r], i)
                                 for r in range(R)])
                    for c in cnts
                ]), level)
            s = scale.reshape((R,) + (1,) * len(shape))
            y = x.float() * s + noise_scale * noise
            out.append(y.to(x.dtype))
        return out

    def encode_push(self, wstate, k, theta_start, theta_new):
        delta = tree_sub(theta_new, theta_start)
        leaves, spec = tree_flatten(delta)
        kg = int(node_global_index_fn(k))
        priv = self._privatize([x[None] for x in leaves], [int(wstate[k])], [kg])
        theta_push = tree_add(theta_start, tree_unflatten([p[0] for p in priv], spec))
        wstate = wstate.clone()
        wstate[k] += 1
        return wstate, theta_push, torch.tensor(float(self.measure(theta_new)))

    def encode_updates(self, wstate, msgs, *, stacked: bool = True):
        nb = torch.tensor(float(tree_bytes(msgs)))
        leaves, spec = tree_flatten(msgs)
        if not stacked:
            cnt, level = _scenario_split(wstate)
            if level is not None and bool((cnt == cnt[0]).all()):
                cnt, level = cnt[0], None
            cnts = [[c] for c in cnt.tolist()] if level is not None else [int(cnt)]
            priv = self._privatize([x[None] for x in leaves], cnts,
                                   [int(node_global_index_fn(0))], level)
            return wstate + 1, tree_unflatten([p[0] for p in priv], spec), nb
        K = leaves[0].shape[0]
        gidx = [int(node_global_index_fn(k)) for k in range(K)]
        # under a sweep the counters are batched: read them outside the
        # batch; alike in every scenario, one draw serves all of them
        cnts, level = _scenario_split(wstate)
        if level is not None and bool((cnts == cnts[0]).all()):
            cnts, level = cnts[0], None
        priv = self._privatize(leaves, cnts.tolist(), gidx, level)
        return wstate + 1, tree_unflatten(priv, spec), nb


class SecAggWire(Wire):
    """Secure-aggregation simulation: pairwise antisymmetric uplink masks.

    Nodes g < j share a seeded pairwise mask m_gj (stream (seed, g's round
    counter, g, j, leaf)); node g uploads x_g + Σ_{j>g} m_gj − Σ_{j<g} m_jg,
    and the masks cancel in the sum.  Floating-point sums cannot cancel
    exactly, so ``encode_updates`` hands the aggregate the unmasked
    messages (bitwise equal to the dense wire by construction, as the
    real protocol's modular arithmetic is exact) and meters the dense
    payload; ``uplink_payloads`` builds what each uplink carries.  Under a
    ``FaultPlan`` a dropped node's counter freezes, and masks between
    nodes whose counters diverged no longer cancel — secure aggregation's
    dropout problem, shown rather than hidden::

        api.fit(strategy, data, transport="allreduce", steps=20,
                wire="topk:0.1+ef>secagg", device="cuda")
    """

    lossless = True
    preserves_bytes = True

    def __init__(self, *, seed: int = 0):
        self.seed = int(seed)
        self.name = "secagg"

    def init_state(self, theta, num_nodes, *, stacked: bool = True):
        return _counters(num_nodes, stacked)

    def _masked(self, leaves: list, cnts: list, gidx: list, num_global: int) -> list:
        """Rows r of ``leaves`` plus node ``gidx[r]``'s pairwise masks, each
        mask drawn once per (counter, pair, leaf)."""
        R = leaves[0].shape[0]
        out = []
        for i, x in enumerate(leaves):
            shape = tuple(x.shape[1:])
            draws: dict = {}
            rows = []
            for r in range(R):
                g = gidx[r]
                total = torch.zeros(shape, dtype=torch.float32, device=x.device)
                for j in range(num_global):
                    if j == g:
                        continue
                    key = (cnts[r], min(g, j), max(g, j))
                    if key not in draws:
                        draws[key] = _normal(shape, x.device, self.seed, *key, i)
                    total = total + draws[key] if g < j else total - draws[key]
                rows.append((x[r].float() + total).to(x.dtype))
            out.append(torch.stack(rows))
        return out

    def uplink_payloads(self, wstate, msgs, *, stacked: bool = True):
        """What each uplink carries at the current round counter: message +
        pairwise masks, as large as the message."""
        leaves, spec = tree_flatten(msgs)
        if not stacked:
            pay = self._masked([x[None] for x in leaves], [int(wstate)], [0], 1)
            return tree_unflatten([p[0] for p in pay], spec)
        K = leaves[0].shape[0]
        num_global = K * num_node_shards_fn()
        gidx = [int(node_global_index_fn(k)) for k in range(K)]
        return tree_unflatten(self._masked(leaves, wstate.tolist(), gidx, num_global), spec)

    def encode_push(self, wstate, k, theta_start, theta_new):
        raise NotImplementedError(
            "secagg masks only cancel inside an aggregate — use an update "
            "transport (allreduce/delay line); a §5 server contact has "
            "nothing to cancel against"
        )

    def encode_updates(self, wstate, msgs, *, stacked: bool = True):
        # the aggregate sees the unmasked messages (exact cancellation);
        # the wire carries the masked payload, dense-sized, metered here
        return wstate + 1, msgs, torch.tensor(float(tree_bytes(msgs)))


class ChainWire(Wire):
    """Wire stages applied left to right (``"a>b"``): ``"dp:1.0,0.5>topk:0.1+ef"``
    privatizes, then sparsifies the private message (EF recycles only
    noised residue); ``"topk:0.1+ef>secagg"`` sparsifies, then masks the
    compressed payload.  Each stage re-prices the payload except
    ``preserves_bytes`` stages (secagg), which keep the previous count::

        wire = api.make_wire("dp:1.0,0.5>topk:0.1+ef")
        wire.stages          # (DPWire, TopKWire)
    """

    def __init__(self, stages):
        stages = tuple(stages)
        if len(stages) < 2:
            raise ValueError("a wire chain needs at least two stages")
        for s in stages:
            if isinstance(s, ChainWire):
                raise ValueError("wire chains do not nest")
        self.stages = stages
        self.name = ">".join(s.name for s in stages)
        self.lossless = all(s.lossless for s in stages)
        self.preserves_bytes = all(s.preserves_bytes for s in stages)

    def init_state(self, theta, num_nodes, *, stacked: bool = True):
        return tuple(s.init_state(theta, num_nodes, stacked=stacked) for s in self.stages)

    def push_bytes(self, theta):
        pb: int | None = self.measure(theta)
        for s in self.stages:
            if not s.preserves_bytes:
                pb = s.push_bytes(theta)  # None propagates: value-dependent
        return pb

    def encode_push(self, wstate, k, theta_start, theta_new):
        new_states = []
        theta, nb = theta_new, torch.tensor(float(self.measure(theta_new)))
        for s, st in zip(self.stages, wstate):
            st, theta, b = s.encode_push(st, k, theta_start, theta)
            new_states.append(st)
            if not s.preserves_bytes:
                nb = b
        return tuple(new_states), theta, nb

    def encode_updates(self, wstate, msgs, *, stacked: bool = True):
        new_states = []
        nb = torch.tensor(float(tree_bytes(msgs)))
        for s, st in zip(self.stages, wstate):
            st, msgs, b = s.encode_updates(st, msgs, stacked=stacked)
            new_states.append(st)
            if not s.preserves_bytes:
                nb = b
        return tuple(new_states), msgs, nb


def node_global_index_fn(k_local):
    # late-bound: the executor module imports nothing from here, but the
    # edge stays one-way at import time
    from repro_torch.api.executor import node_global_index

    return node_global_index(k_local)


def num_node_shards_fn() -> int:
    from repro_torch.api.executor import num_node_shards

    return num_node_shards()


def _scenario_split(x):
    from repro_torch.api.executor import scenario_split

    return scenario_split(x)


def _scenario_join(x, level):
    from repro_torch.api.executor import scenario_join

    return scenario_join(x, level)


def make_wire(spec: str | Wire | None) -> Wire:
    """Resolve a wire spec: a ``Wire``, ``None``/``"dense"``, or
    ``"<codec>[+ef]"`` with codecs ``topk:<fraction>``, ``thresh:<tau>``,
    ``int8``, ``dp:<clip>,<sigma>`` and ``secagg`` — e.g.
    ``"topk:0.05+ef"``; stages compose left to right with ``>``:
    ``"dp:1.0,0.5>topk:0.1+ef"``."""
    if spec is None:
        return DenseWire()
    if isinstance(spec, Wire):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"wire spec must be a Wire or str, got {type(spec)!r}")
    if ">" in spec:
        return ChainWire([make_wire(part) for part in spec.split(">")])
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
    if base.startswith("dp:"):
        if ef:
            raise ValueError(
                "dp takes no +ef (noise is not a compression residual); "
                "chain it with a sparsifier instead: 'dp:<c>,<s>>topk:<f>+ef'"
            )
        parts = base.split(":", 1)[1].split(",")
        if len(parts) != 2:
            raise ValueError(f"dp wire spec must be 'dp:<clip>,<sigma>', got {spec!r}")
        return DPWire(float(parts[0]), float(parts[1]))
    if base == "secagg":
        if ef:
            raise ValueError("secagg takes no +ef (masking is lossless)")
        return SecAggWire()
    raise ValueError(
        f"unknown wire spec {spec!r} — expected 'dense', 'topk:<f>[+ef]', "
        "'thresh:<tau>[+ef]', 'int8[+ef]', 'dp:<clip>,<sigma>', 'secagg', "
        "or a '>'-chain of those"
    )
