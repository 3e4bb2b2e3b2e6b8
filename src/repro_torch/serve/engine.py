"""``ServeEngine`` — the inference half of the train → serve executor swap
(port of ``repro.serve.engine``).

A fit produces ``FitResult.theta``; the strategy that trained it answers
requests with it (``Strategy.predict``).  The engine owns

* **placement** — θ on one device (its own, or ``device=``); requests are
  moved there.  With ``mesh=`` θ is sharded by the name rules
  (``sharding.rules.place_params``: ``DTensor``s on a device mesh, θ as it
  is on a ``SoloMesh``) and each request batch is padded to a multiple of
  the batch axes' size and split over them; the answer comes back whole;
* **execution** — predicts run eagerly under ``torch.inference_mode()``.
  The reference compiles a jittable predict once per request shape and
  donates the request buffer; PyTorch has no compile step here and donates
  nothing (``ROADMAP.md`` queue 3, item 19);
* **hot-swap** — ``swap(theta)`` replaces the served parameters under a
  lock, which the registry's publish → activate path calls into;
* **accounting** — every answered batch is metered through
  ``ServeMetrics`` / ``CommLedger`` as a priced ``inference`` message
  (request features up, predictions down; padded rows excluded).

Host requests are canonicalized as ``jnp.asarray`` canonicalizes them with
64-bit types off: numpy float64 becomes float32 and int64 int32, so a
request costs the same bytes in both packages.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.device import resolve_device
from repro_torch.launch.mesh import SoloMesh, batch_axes, data_axis_size, mesh_device
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.sharding.rules import NamedSharding, P, place_params
from repro_torch.telemetry import trace as _trace
from repro_torch.utils.tree import tree_leaves, tree_map

PyTree = Any

#: host dtypes a request is narrowed to (64-bit types off, as in the reference)
_CANONICAL = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
              np.dtype(np.uint64): np.uint32}


def _tensor_leaves(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _to_request(X, device: torch.device) -> torch.Tensor:
    if isinstance(X, torch.Tensor):
        return X.to(device)
    arr = np.asarray(X)
    arr = arr.astype(_CANONICAL.get(arr.dtype, arr.dtype), copy=False)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


class ServeEngine:
    """Serve a finalized model through its strategy's ``predict``.

    Args:
      strategy: the Strategy that produced (or can interpret) ``theta``.
      theta: finalized parameters — ``FitResult.theta`` or a registry load
        (tensors or numpy arrays).
      mesh / model_axis / fsdp_axis: θ's placement (see above); the device
        is then the mesh's.
      donate: the reference's donation knob, kept in the signature;
        nothing is donated.
      metrics: a shared ``ServeMetrics`` (one per deployment); fresh by
        default.
      tag: ledger event tag for this engine's inference traffic.
      tracer: a ``repro_torch.telemetry.trace.Tracer`` recording
        ``serve/predict`` and ``serve/swap`` spans and the
        ``serve/requests`` / ``serve/padded_slots`` counters; defaults to
        the ambient tracer at construction (so ``fit(..., executor="serve",
        tracer=...)`` traces its engine).  None: no tracing.
      device: where θ is served; default the device of θ's tensors, or
        ``"cuda"`` (raising without a GPU) when θ holds none.
    """

    def __init__(self, strategy, theta: PyTree, *, mesh=None, model_axis: str = "model",
                 fsdp_axis: str | None = None, donate: bool = True,
                 metrics: ServeMetrics | None = None, tag: str = "serve", tracer=None,
                 device=None):
        self.strategy = strategy
        self.mesh = mesh
        self.model_axis = model_axis
        self.fsdp_axis = fsdp_axis
        self._batch_axes = batch_axes(mesh) if mesh is not None else ()
        self._batch_mul = data_axis_size(mesh) if mesh is not None else 1
        self.tag = tag
        self.metrics = metrics if metrics is not None else ServeMetrics()
        self.tracer = tracer if tracer is not None else _trace.current_tracer()
        if mesh is not None and not isinstance(mesh, SoloMesh):
            self.device = mesh_device(mesh)
        elif device is None:
            leaves = _tensor_leaves(theta)
            self.device = leaves[0].device if leaves else resolve_device("cuda")
        else:
            self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._fn = strategy.predict
        self.theta = None
        self.swap(theta)

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_fit(cls, result, strategy, **kw) -> "ServeEngine":
        """Stand a finished ``api.fit`` up for inference (its ``theta`` is
        already finalized)."""
        return cls(strategy, result.theta, **kw)

    @classmethod
    def from_registry(cls, registry, name: str, strategy, *, version: int | None = None,
                      like: PyTree = None, **kw) -> "ServeEngine":
        """Serve a published model; ``like`` restores non-dict pytrees
        (NamedTuple thetas) into their structure.  Without ``like`` the
        leaves load onto ``device=`` (default ``"cuda"``)."""
        theta = registry.load(name, version, like=like, device=kw.get("device") or "cuda")
        return cls(strategy, theta, **kw)

    # -- serving -------------------------------------------------------------

    def _place(self, theta: PyTree) -> PyTree:
        def move(x):
            if isinstance(x, (np.ndarray, np.generic)):
                return _to_request(x, self.device)
            return x.to(self.device) if isinstance(x, torch.Tensor) else x

        theta = tree_map(move, theta)
        if self.mesh is None:
            return theta
        return place_params(self.mesh, theta, model_axis=self.model_axis,
                            fsdp_axis=self.fsdp_axis)

    def _place_request(self, X: torch.Tensor) -> torch.Tensor:
        if self.mesh is None or isinstance(self.mesh, SoloMesh) or not self._batch_axes:
            return X
        axes = self._batch_axes if len(self._batch_axes) > 1 else self._batch_axes[0]
        return NamedSharding(self.mesh, P(axes)).put(X)

    def _run(self, theta, X):
        if isinstance(X, DTensor):
            # constants the predict makes are the same on every rank
            with implicit_replication():
                Y = self._fn(theta, X)
            return tree_map(lambda y: y.full_tensor() if isinstance(y, DTensor) else y, Y)
        return self._fn(theta, X)

    def swap(self, theta: PyTree) -> None:
        """Replace the served parameters under the engine's lock (registry
        hot-swap).  The pytree structure must stay the same."""
        from torch.utils import _pytree as pytree

        if self.theta is not None:
            old = pytree.tree_structure(self.theta)
            new = pytree.tree_structure(theta)
            if old != new:
                raise ValueError(f"swap() needs the served pytree structure {old}, got {new}")
        tr = self.tracer
        with tr.span("serve/swap") if tr is not None else nullcontext():
            placed = self._place(theta)
            with self._lock:
                self.theta = placed

    def _fence(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, X, *, valid: int | None = None):
        """Answer one request batch.

        ``X`` rows are independent requests; ``valid`` marks how many
        leading rows are real (the batcher's bucket padding) — only those
        are returned and metered."""
        X = _to_request(X, self.device)
        n = X.shape[0] if valid is None else valid
        req = X[:n]
        pad = (-X.shape[0]) % self._batch_mul
        if pad:  # a device multiple under a mesh; the padding never leaves
            X = torch.cat([X, X[-1:].expand(pad, *X.shape[1:])])
        Xp = self._place_request(X)
        with self._lock:
            theta = self.theta
        tr = self.tracer
        t0 = time.perf_counter()
        with (tr.span("serve/predict", batch=int(X.shape[0]), valid=int(n))
              if tr is not None else nullcontext()):
            with torch.inference_mode():
                Y = self._run(theta, Xp)
            self._fence()
        dt = time.perf_counter() - t0
        if tr is not None:
            tr.count("serve/requests", n)
            tr.count("serve/padded_slots", int(X.shape[0]) - int(n))
        Y = tree_map(lambda y: y[:n], Y)
        self.metrics.record_batch(n, X.shape[0], dt, req, Y, tag=self.tag)
        return Y

    @property
    def ledger(self):
        return self.metrics.ledger

    def stats(self) -> dict:
        return self.metrics.summary()
