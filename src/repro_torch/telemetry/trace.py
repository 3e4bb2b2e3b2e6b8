"""Structured run tracing — spans, counters, gauges and Perfetto export
(port of ``repro.telemetry.trace``).

A ``Tracer`` collects named, tagged **spans** (wall-time intervals on the
host clock) plus monotonic **counters** and last-value **gauges**, and
exports them as Chrome trace-event JSON that Perfetto
(https://ui.perfetto.dev) or ``chrome://tracing`` loads::

    from repro_torch.telemetry.trace import Tracer

    tracer = Tracer()
    with tracer.span("round", round=3, nodes=8):
        ...                              # any host-side work
    tracer.count("program_cache/uncached")
    tracer.export_chrome("run.trace.json")

**Nothing when off.**  The instrumented call sites (``api.fit``, the
executors' ``dispatch``, ``repro_torch.serve``) guard every span behind one
``is None`` check on the ambient ``current_tracer()``, which is None by
default.  Every span is host-side and no span changes what the card
computes, so a traced fit returns the untraced fit's bits.

The spans the port records:

* ``fit/loop``, ``fit/ledger``, ``fit/metrics`` — ``api.fit``'s three
  stages; ``dispatch/<label>`` — an executor's whole loop of rounds;
* ``fit/round/update``, ``fit/round/wire``, ``fit/round/aggregate``,
  ``fit/round/metric`` — the four phases of every round of an update
  transport (``allreduce``, ``delay_line``): the strategy's local updates,
  the wire's encode with the participation mask and the uplink count, the
  aggregate through to the applied update and the downlink count, the
  round's metric.  Each opens once a round on every executor (once per
  scenario a round only where a sweep steps its scenarios in turn);
* ``kmeans/estep``, ``kmeans/mstep``, ``kmeans/assign`` — an EM iteration
  of ``ml.clustering.distributed_kmeans`` and its final assignment;
* ``phase/*``, ``hop/*`` — ``fit(trace="phases")``'s probes;
  ``serve/*``, ``batcher/serve`` — the serving engines and the batcher.

Device time: a host span around queued CUDA work measures submission, not
execution.  Call sites that want device-complete spans fence with
``torch.cuda.synchronize()`` before closing the span (``fit`` does it for
``fit/loop`` when a tracer is given; ``telemetry.phases`` for each probe),
and ``device_trace(logdir)`` wraps ``torch.profiler`` so the kernels'
device timeline lands in ``logdir`` under a span of the same run.  While
``torch.profiler`` records, every span also opens a
``torch.profiler.record_function`` range of its name around the same
block, so the profiler's own trace carries the spans on its clock and
each kernel can be put in the span that launched it (a user annotation:
the profiler's device operations and operator tables leave it out).

This module imports the standard library only; torch is looked up in
``sys.modules`` for the profiler check and imported inside
``device_trace``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager, nullcontext

__all__ = [
    "Tracer",
    "activated",
    "current_tracer",
    "span",
]


def _now_us() -> float:
    """Monotonic clock in microseconds (the trace-event time unit)."""
    return time.perf_counter_ns() / 1e3


class Tracer:
    """Collects spans, counters and gauges for one run.

    Thread-safe: serving spans arrive from batcher client threads, and each
    thread's spans carry its own small ``tid`` so Perfetto draws one track
    per thread.  ``enabled=False`` makes a tracer that is always off: every
    ``span`` returns a null context and counters are dropped.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = bool(enabled)
        self.spans: list = []  # dicts: name, ts (us), dur (us), tid, tags
        self.counters: dict = {}
        self.gauges: dict = {}
        self._lock = threading.Lock()
        self._tids: dict = {}  # thread ident -> small stable int
        self.t0_us = _now_us()

    # -- recording -----------------------------------------------------------

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            with self._lock:
                tid = self._tids.setdefault(ident, len(self._tids))
        return tid

    def span_begin(self, name: str, **tags) -> dict:
        """Open a span record (low level: use ``with tracer.span(...)``)."""
        rec = {"name": name, "ts": _now_us(), "dur": None, "tid": self._tid(), "tags": tags}
        with self._lock:
            self.spans.append(rec)
        return rec

    def span_end(self, rec: dict) -> None:
        rec["dur"] = _now_us() - rec["ts"]

    @contextmanager
    def _span(self, name: str, tags: dict):
        rec = self.span_begin(name, **tags)
        try:
            torch = sys.modules.get("torch")
            if torch is not None and torch.autograd._profiler_enabled():
                with torch.autograd.profiler.record_function(name):
                    yield rec
            else:
                yield rec
        finally:
            self.span_end(rec)

    def span(self, name: str, **tags):
        """Context manager timing the enclosed block::

            with tracer.span("aggregate", hop="inter_pod") as rec:
                ...
                rec["tags"]["bytes"] = nbytes   # tags may be added inside

        A disabled tracer returns a null context."""
        if not self.enabled:
            return nullcontext()
        return self._span(name, tags)

    def spanned(self, name: str, fn):
        """``fn`` with each call inside a span ``name``: a call site looks
        its tracer up once and wraps its phases only when there is one, so
        an untraced loop runs its own statements and nothing else::

            t = current_tracer()
            if t is not None:
                estep = t.spanned("kmeans/estep", estep)
        """

        def run(*args, **kwargs):
            with self.span(name):
                return fn(*args, **kwargs)

        return run

    def count(self, name: str, n: float = 1) -> None:
        """Monotonic counter (dispatches, padded slots, …)."""
        if not self.enabled:
            return
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def gauge(self, name: str, value) -> None:
        """Last-value-wins gauge (slot occupancy, a skipped probe's reason, …)."""
        if not self.enabled:
            return
        with self._lock:
            self.gauges[name] = value

    @contextmanager
    def device_trace(self, logdir: str):
        """Profile the enclosed block with ``torch.profiler`` (CPU and, when
        a card is present, CUDA activities) under a ``device_trace`` span,
        and write its Chrome trace to ``<logdir>/device_trace.json``::

            with tracer.device_trace("traces/") as prof:
                api.fit(..., tracer=tracer)
            prof.key_averages()            # per-kernel device time

        Yields the ``torch.profiler.profile``."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(str(logdir), exist_ok=True)
        with self.span("device_trace", logdir=str(logdir)):
            with profile(activities=activities) as prof:
                yield prof
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(str(logdir), "device_trace.json"))

    # -- reading -------------------------------------------------------------

    def wall_s(self, name: str) -> float:
        """Total wall seconds across all closed spans named ``name``."""
        return sum(
            s["dur"] for s in self.spans if s["name"] == name and s["dur"] is not None
        ) / 1e6

    def summary(self) -> dict:
        """Per-span-name aggregate: count, total / mean / max wall seconds."""
        agg: dict = {}
        for s in self.spans:
            if s["dur"] is None:
                continue
            e = agg.setdefault(s["name"], {"count": 0, "total_s": 0.0, "max_s": 0.0})
            e["count"] += 1
            e["total_s"] += s["dur"] / 1e6
            e["max_s"] = max(e["max_s"], s["dur"] / 1e6)
        for e in agg.values():
            e["mean_s"] = e["total_s"] / e["count"]
        return agg

    # -- export --------------------------------------------------------------

    def chrome_events(self) -> list:
        """The run as Chrome trace-event dicts: one complete (``"X"``) event
        per closed span, one counter (``"C"``) sample per counter and gauge.
        Every event carries ``ph`` / ``ts`` / ``pid`` / ``tid`` / ``name``."""
        pid = os.getpid()
        events = [{"ph": "M", "ts": 0, "pid": pid, "tid": 0, "name": "process_name",
                   "args": {"name": "repro_torch"}}]
        for s in self.spans:
            if s["dur"] is None:
                continue  # still open: not exportable
            events.append({
                "ph": "X", "ts": s["ts"], "dur": s["dur"], "pid": pid, "tid": s["tid"],
                "name": s["name"], "cat": s["name"].split("/")[0],
                "args": {k: _arg(v) for k, v in s["tags"].items()},
            })
        t_end = _now_us()
        for name, value in {**self.counters, **self.gauges}.items():
            events.append({"ph": "C", "ts": t_end, "pid": pid, "tid": 0, "name": name,
                           "args": {"value": _arg(value)}})
        return events

    def export_chrome(self, path: str) -> str:
        """Write the trace-event JSON; returns ``path``.  Load it in
        Perfetto or summarize it with ``python tools/traceview.py <path>``."""
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(), "displayTimeUnit": "ms"}, f)
        return path


def _arg(v):
    """Trace-event args must be JSON: primitives pass, 0-d tensors and numpy
    scalars become numbers, the rest strings."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    try:
        return v.item()
    except Exception:
        return str(v)


# ----------------------------------------------------------------------------
# Ambient tracer — how instrumented layers find the active run's tracer
# ----------------------------------------------------------------------------

_active = threading.local()


def current_tracer() -> Tracer | None:
    """The tracer installed for the current thread, or None (the default;
    instrumented call sites guard on this)."""
    t = getattr(_active, "value", None)
    if t is not None and not t.enabled:
        return None
    return t


@contextmanager
def activated(tracer: Tracer | None):
    """Install ``tracer`` as the ambient tracer for the enclosed block
    (``api.fit(..., tracer=...)`` wraps the whole run in this, so the
    executors' dispatch spans land on the same timeline).  ``None``
    leaves the block untraced, so call sites stay unconditional."""
    prev = getattr(_active, "value", None)
    _active.value = tracer
    try:
        yield tracer
    finally:
        _active.value = prev


def span(name: str, **tags):
    """Span on the AMBIENT tracer — a null context when none is installed::

        from repro_torch.telemetry import trace

        with trace.span("fit/ledger", scenarios=S):
            ...
    """
    t = current_tracer()
    if t is None:
        return nullcontext()
    return t._span(name, tags)
