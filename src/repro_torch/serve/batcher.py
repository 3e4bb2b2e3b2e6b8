"""Request handles (port of ``repro.serve.batcher``'s ``Ticket``).

``MicroBatcher`` waits for the request/response serving slice
(``ROADMAP.md`` queue 1, item 10); the continuous-batching engine needs
only the handle.
"""

from __future__ import annotations

import threading


class Ticket:
    """Handle for one submitted request; ``result()`` forces service if the
    request is still queued and waits if it is in flight on another thread.
    A failure resolves the ticket with the error, which ``result()``
    re-raises — a request is never silently lost.

    The owner passed at construction needs a ``flush(key=...)`` method that
    serves the keyed request (``ContinuousLMEngine``, which also fails
    tickets on eviction through ``_fail``)."""

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
            # serve the request if it is still queued; if another thread is
            # already serving it, this is a no-op and we wait for it
            self._batcher.flush(key=self._key)
            if not self._done.wait(timeout):
                raise TimeoutError("request still in flight")
        if self._error is not None:
            raise self._error
        return self._value
