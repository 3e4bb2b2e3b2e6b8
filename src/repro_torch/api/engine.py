"""``repro_torch.api.fit`` — one entry point for the distributed trainers
(port of ``repro.api.engine``).

    fit(strategy, data, transport=..., wire=..., executor=..., schedule=...,
        device="cuda")

runs a (strategy × transport × wire × executor) combination and returns a
``FitResult``:

* ``theta``       — the final parameter;
* ``trajectory``  — per-round trace: the handed-back θ for server
  transports, the strategy's ``round_metric`` for update transports;
* ``ledger``      — byte-exact ``CommLedger`` under the paper's
  client-server cost model (decomposed by tier under ``multipod``); a list
  of one per scenario under a sweep, where ``theta``, ``trajectory`` and
  the carry gain a leading S axis;
* ``metrics``     — the strategy's summary, plus ``uplink_bytes_per_round``
  / ``downlink_bytes_per_round`` (numpy), ``wire_kernel_hits`` for the
  kernel wires and ``wire_kernel_launches`` (the wire kernels' launches
  during the fit, from ``repro_torch.kernels.LAUNCHES``), ``carry`` — a
  resume token for ``fit(..., carry=...)``
  (``repro_torch.convert.carry_from_reference`` makes one from a JAX fit)
  — and, under ``executor="serve"``, the live ``serve_engine``.

A ``tracer=`` (``repro_torch.telemetry.Tracer``) is installed as the
ambient tracer for the whole run: the ``fit/loop``, ``fit/ledger`` and
``fit/metrics`` spans, the executors' ``dispatch/<label>`` spans and the
serving engine's spans land on one timeline.  Every span is on the host
and changes nothing the card computes, so a traced fit returns the
untraced fit's bits.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch
from torch.func import vmap

from repro_torch import kernels
from repro_torch.api.executor import make_executor
from repro_torch.api.faults import FaultPlan, make_fault_plan
from repro_torch.api.strategy import Strategy
from repro_torch.api.transport import make_transport
from repro_torch.api.wire import make_wire
from repro_torch.core.allreduce import CommLedger
from repro_torch.device import resolve_device, to_device
from repro_torch.telemetry import trace as _trace

PyTree = Any

#: the kernels a wire's encode launches (``metrics["wire_kernel_launches"]``)
_WIRE_KERNELS = ("topk_encode", "topk_select", "int8_absmax", "int8_quant", "int8_encode")


def _jsonable(v, _size_cap: int = 100_000):
    """Best-effort JSON conversion: primitives pass, arrays and tensors
    become lists (or a shape/dtype placeholder past ``_size_cap``
    elements), anything else becomes ``"<TypeName>"``."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, (np.ndarray, np.generic)):
        arr = np.asarray(v)
        if arr.ndim == 0:
            return arr.item()
        if arr.size > _size_cap:
            return f"<ndarray shape={arr.shape} dtype={str(arr.dtype)}>"
        return arr.tolist()
    return f"<{type(v).__name__}>"


class FitResult(NamedTuple):
    theta: PyTree
    trajectory: PyTree
    ledger: CommLedger
    metrics: dict

    def metrics_json(self) -> dict:
        """``metrics`` as a JSON-serializable dict (the ``"carry"`` resume
        token dropped, arrays as lists)."""
        return {k: _jsonable(v) for k, v in self.metrics.items() if k != "carry"}


def _total(a: np.ndarray) -> int:
    """Exact byte total: int64 accumulation for integer counts, f64 for
    the (small) value-dependent f32 counts."""
    if np.issubdtype(a.dtype, np.integer):
        return int(a.sum(dtype=np.int64))
    return int(round(float(a.sum(dtype=np.float64))))


def fit(
    strategy: Strategy,
    data: PyTree = None,
    *,
    transport="sequential_server",
    wire="dense",
    executor="local",
    schedule=None,
    steps: int | None = None,
    stream: PyTree = None,
    theta0: PyTree = None,
    carry=None,
    faults: FaultPlan | None = None,
    tag: str = "fit",
    device="cuda",
    sweep: dict | None = None,
    tracer=None,
    trace: str | None = None,
    **transport_options,
) -> FitResult:
    """Train ``strategy`` on ``data`` under a transport and a wire.

    Args:
      strategy: the per-node learner F^(k) (``repro_torch.api.strategy``).
      data: sharded data with a leading node axis (tensors or numpy arrays;
        moved to ``device``), or None for closure-based strategies.
      transport: ``sequential_server`` / ``stale_server`` / ``delay_line``
        / ``allreduce`` / ``admm_consensus``, or a ``Transport`` instance.
      wire: ``"dense"``, ``"topk:<f>[+ef]"``, ``"thresh:<τ>[+ef]"``,
        ``"int8[+ef]"``, ``"dp:<clip>,<sigma>"``, ``"secagg"``, a
        ``>``-chain of those, or a ``Wire``.
      executor: ``"local"``, ``"mesh"``, ``"multipod"``, ``"sweep"``,
        ``"mesh+sweep"``, ``"multipod+sweep"`` or an ``Executor``.
      schedule: contact schedule (server transports), any int sequence.
      steps: number of rounds (update transports).
      stream: optional pytree with a leading time axis, one element per
        round handed to ``local_updates``.
      theta0: initial parameter; defaults to ``strategy.init_theta(data)``.
      carry: resume token from a previous ``FitResult.metrics["carry"]``.
      faults: optional ``FaultPlan`` — seeded dropout / straggler / quorum.
      device: ``"cuda"`` (default; raises without a GPU) or ``"cpu"``.
      sweep: the scenario values of a sweep executor spec, e.g.
        ``executor="sweep", sweep={"lr": [0.05, 0.1]}``.
      tracer: optional ``repro_torch.telemetry.Tracer``, installed as the
        ambient tracer for the whole run.  ``fit/loop`` is fenced with
        ``torch.cuda.synchronize()`` when a tracer is given, so it covers
        device completion.
      trace: ``"phases"`` (needs ``tracer``) also records per-phase device
        times — local step, wire encode, per-hop collective, statistics
        completion — by replaying standalone fenced probes at the run's
        shapes AFTER the fit (``repro_torch.telemetry.phases``); the fit
        itself is untouched.
      transport_options: ``staleness=...`` for delay_line; ``rho=``,
        ``g=``, ``g_lam=`` for admm_consensus.
    """
    if trace not in (None, "phases"):
        raise ValueError(f"trace must be None or 'phases', got {trace!r}")
    if trace == "phases" and tracer is None:
        raise ValueError("trace='phases' requires a tracer=Tracer()")
    with _trace.activated(tracer):
        return _fit_traced(
            strategy, data, wire=wire, transport=transport, executor=executor,
            sweep=sweep, schedule=schedule, steps=steps, stream=stream, theta0=theta0,
            carry=carry, faults=faults, tag=tag, device=device, tracer=tracer,
            trace=trace, transport_options=transport_options,
        )


def _fit_traced(strategy, data, *, wire, transport, executor, sweep, schedule, steps,
                stream, theta0, carry, faults, tag, device, tracer, trace,
                transport_options) -> FitResult:
    dev = resolve_device(device)
    w = make_wire(wire)
    tr = make_transport(transport, **transport_options)
    ex = make_executor(executor, sweep_params=sweep)
    plan = make_fault_plan(faults)
    data, stream, theta0, carry = to_device((data, stream, theta0, carry), dev)
    if ex.num_scenarios is not None:
        ex.params = to_device(ex.params, dev)
    launched = {n: kernels.LAUNCHES[n] for n in _WIRE_KERNELS}
    with _trace.span("fit/loop", transport=tr.name, wire=w.name, executor=ex.name, tag=tag):
        raw = tr.run(
            strategy, data,
            wire=w, schedule=schedule, steps=steps, stream=stream,
            theta0=theta0, carry=carry, executor=ex, faults=plan,
        )
        if tracer is not None and dev.type == "cuda":
            # fence so the loop span covers device completion, not just the
            # queueing — a pure wait, results unchanged
            torch.cuda.synchronize(dev)
    launched = {n: kernels.LAUNCHES[n] - launched[n] for n in _WIRE_KERNELS}

    if trace == "phases":
        from repro_torch.telemetry import phases as _phases

        _phases.profile_phases(
            tracer, strategy, data, wire=w, transport=tr, executor=ex,
            schedule=schedule, steps=steps, stream=stream, theta0=theta0,
        )

    ups = np.asarray(raw.uplink)
    downs = np.asarray(raw.downlink)
    # topology-aware executors decompose the flat totals by reduction tier
    hop_split = ex.ledger_hops(strategy, data)

    def materialize(u: np.ndarray, d: np.ndarray, suffix: str = "") -> CommLedger:
        led = CommLedger()
        if strategy.init_rounds and carry is None:
            # rounds the strategy charges before its loop (LBFGS: the
            # initial gradient Allreduce)
            K = strategy.num_nodes(data)
            theta_like = ex.scenario_template(raw.theta) if theta0 is None else theta0
            for _ in range(strategy.init_rounds):
                led.record_allreduce(theta_like, K, tag=f"{tag}/init")
        T = int(u.shape[0])
        up_tot, down_tot = _total(u), _total(d)
        led.uplink_bytes += up_tot
        led.downlink_bytes += down_tot
        led.rounds += raw.rounds_per_step * T
        led.events.append((raw.event_kind, f"{tag}{suffix}[0:{T}]", up_tot + down_tot))
        if hop_split:
            led.attribute_hops(hop_split)
        return led

    S = ex.num_scenarios
    with _trace.span("fit/ledger", scenarios=S):
        if S is None:
            ledger = materialize(ups, downs)
        else:
            ledger = [materialize(ups[s], downs[s], f"/s{s}") for s in range(S)]
    with _trace.span("fit/metrics"):
        if S is None:
            metrics = dict(strategy.summary(raw.theta, data))
        else:
            try:
                batched = vmap(lambda th: strategy.summary(th, data))(raw.theta)
                metrics = {k: v.cpu().numpy() for k, v in batched.items()}
            except Exception:  # summaries need not be vmappable — skip
                metrics = {}
    metrics.update(raw.extras)
    metrics["uplink_bytes_per_round"] = ups
    metrics["downlink_bytes_per_round"] = downs
    metrics["transport"] = tr.name
    metrics["wire"] = w.name
    metrics["executor"] = ex.name
    metrics["carry"] = raw.carry
    if hasattr(w, "kernel_report"):
        # which leaves the wire's kernels covered vs the <256/non-f32
        # reference fallback
        metrics["wire_kernel_hits"] = w.kernel_report(ex.scenario_template(raw.theta))
        metrics["wire_kernel_launches"] = {n: c for n, c in launched.items() if c}
    metrics.update(ex.extra_metrics())  # e.g. the serving executor's live engine
    return FitResult(
        theta=raw.theta, trajectory=raw.trajectory, ledger=ledger, metrics=metrics
    )
