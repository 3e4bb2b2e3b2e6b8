"""Request microbatcher: ragged client traffic → a few static shapes (port
of ``repro.serve.batcher``).

Requests arrive one at a time.  The batcher

* **groups** pending requests by exact per-request shape and dtype,
* **buckets** every flush to the smallest configured batch size that fits,
  padding the tail by repeating the last request (rows are independent —
  ``Strategy.predict`` — so padding cannot change a real answer; padded
  rows are dropped before tickets resolve and are never metered),
* **flushes** a group when it reaches the largest bucket, when ``poll``
  finds its oldest request older than ``timeout_s``, or when a caller
  blocks on a ``Ticket``.

So the set of batch shapes is |shape groups| × |buckets|, however ragged
the traffic.  The reference keeps that set small to bound its compiles;
the port runs eagerly and keeps it for the same padding contract and the
same batches.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Callable

import numpy as np

from repro_torch.telemetry import trace as _trace
from repro_torch.utils.tree import tree_map


class Ticket:
    """Handle for one submitted request; ``result()`` forces service if the
    request is still queued and waits if its batch is in flight on another
    thread.  A failure resolves every ticket of the batch with the error,
    which ``result()`` re-raises — a request is never silently lost.

    The owner passed at construction needs a ``flush(key=...)`` method
    that serves the keyed request: the ``MicroBatcher`` here, or
    ``ContinuousLMEngine`` (which also fails tickets on eviction through
    ``_fail``)."""

    __slots__ = ("_batcher", "_key", "_value", "_error", "_done")

    def __init__(self, batcher, key):
        self._batcher = batcher
        self._key = key
        self._value = None
        self._error = None
        self._done = threading.Event()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    def _resolve(self, value) -> None:
        self._value = value
        self._done.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._done.set()

    def result(self, timeout: float | None = None):
        if not self.done:
            # serve the group if it is still queued; if another thread is
            # already serving it, this is a no-op and we wait for it
            self._batcher.flush(key=self._key)
            if not self._done.wait(timeout):
                raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._value


def _default_buckets(max_batch: int) -> tuple:
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return tuple(out)


class MicroBatcher:
    """Bucketed-padding microbatcher in front of a predict function.

    Args:
      predict: a ``ServeEngine`` (preferred: padded slots are left out of
        its byte metering) or any row-independent callable ``X -> Y``
        (``X`` a numpy batch).
      max_batch: largest (and forced-flush) batch bucket.
      buckets: ascending batch buckets; default powers of two up to
        ``max_batch``.
      timeout_s: max age of a queued request before ``poll`` flushes its
        group — the latency bound batching is traded against.
      clock: injectable monotonic clock (tests).
      tracer: a ``Tracer`` recording a ``batcher/serve`` span per flush
        (tagged with bucket, valid count and the group's max queue wait)
        and the ``batcher/requests`` / ``batcher/padded_slots`` /
        ``batcher/queue_wait_s`` counters; defaults to the ambient tracer at
        construction.  None: no tracing.
    """

    def __init__(self, predict, *, max_batch: int = 8, buckets: tuple | None = None,
                 timeout_s: float = 0.01, clock: Callable[[], float] = time.monotonic,
                 tracer=None):
        from repro_torch.serve.engine import ServeEngine

        if isinstance(predict, ServeEngine):
            self._call = lambda X, n: predict.predict(X, valid=n)
        else:
            self._call = lambda X, n: tree_map(lambda y: y[:n], predict(X))
        self.buckets = tuple(sorted(buckets or _default_buckets(max_batch)))
        if buckets is not None and self.buckets[-1] != max_batch:
            raise ValueError(
                f"max_batch={max_batch} must be the largest bucket "
                f"(got buckets={self.buckets}) — pass a matching max_batch")
        self.max_batch = self.buckets[-1]
        self.timeout_s = timeout_s
        self._clock = clock
        self.tracer = tracer if tracer is not None else _trace.current_tracer()
        # the lock guards only the queues — predict runs OUTSIDE it, so a
        # slow decode never blocks submits or polls of other shape groups
        self._lock = threading.Lock()
        self._pending: dict = {}  # key -> list[(np.ndarray, Ticket, t_enq)]
        self.flushes = 0

    def submit(self, x) -> Ticket:
        """Queue one request (a SINGLE example, no batch axis)."""
        x = np.asarray(x)
        key = (x.shape, str(x.dtype))
        with self._lock:
            ticket = Ticket(self, key)
            self._pending.setdefault(key, []).append((x, ticket, self._clock()))
            # pop a full group while still holding the lock, so no group ever
            # exceeds max_batch (racing submits would overshoot the buckets)
            grp = self._pending.pop(key) if len(self._pending[key]) >= self.max_batch else None
        if grp:
            self._serve(grp)
        return ticket

    def pending(self) -> int:
        with self._lock:
            return sum(len(v) for v in self._pending.values())

    def poll(self) -> int:
        """Flush every group whose oldest request has waited ≥ timeout_s.
        Returns the number of requests served.  A failing predict resolves
        that group's tickets with the error and polling goes on."""
        now = self._clock()
        with self._lock:
            due = [key for key, grp in self._pending.items()
                   if grp and now - grp[0][2] >= self.timeout_s]
        served = 0
        for key in due:
            try:
                served += self._flush_group(key)
            except Exception:
                pass  # delivered to the group's tickets by _serve
        return served

    def flush(self, key=None) -> int:
        """Serve everything queued (or one shape group).  Returns the count."""
        with self._lock:
            keys = [key] if key is not None else list(self._pending)
        return sum(self._flush_group(k) for k in keys)

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.max_batch

    def _flush_group(self, key) -> int:
        with self._lock:
            grp = self._pending.pop(key, [])
        return self._serve(grp) if grp else 0

    def _serve(self, grp) -> int:
        n = len(grp)
        bucket = self.bucket_for(n)
        tr = self.tracer
        wait_ms = 0.0
        if tr is not None:
            now = self._clock()
            wait_ms = 1e3 * max(now - t_enq for _, _, t_enq in grp)
            tr.count("batcher/requests", n)
            tr.count("batcher/padded_slots", bucket - n)
            tr.count("batcher/queue_wait_s", sum(now - t_enq for _, _, t_enq in grp))
        X = np.stack([x for x, _, _ in grp])
        if bucket > n:
            X = np.concatenate([X, np.repeat(X[-1:], bucket - n, axis=0)])
        try:
            with (tr.span("batcher/serve", bucket=bucket, valid=n,
                          queue_wait_ms=round(wait_ms, 3))
                  if tr is not None else nullcontext()):
                Y = self._call(X, n)
        except BaseException as e:
            # BaseException: an interrupt mid-predict must still resolve the
            # batch's tickets, or waiters hang to their timeout
            for _, ticket, _ in grp:
                ticket._fail(e)
            raise
        with self._lock:
            self.flushes += 1
        for i, (_, ticket, _) in enumerate(grp):
            ticket._resolve(tree_map(lambda y: y[i], Y))
        return n
