"""Serving metrics (port of ``repro.serve.metrics``): per-request latency,
decode throughput and inference bytes on a ``CommLedger``.

Every retired request is one ``inference`` event priced as
``CommLedger.record_inference`` prices it (prompt ids up, generated ids
down), coalesced into one running event per tag.  Besides the reference's
counters the port records each request's time to first token
(``p50_ttft_ms`` / ``p95_ttft_ms``).  ``record_batch`` comes with the
``MicroBatcher`` (``ROADMAP.md`` queue 1, item 10), and with it the
batch and padding counters.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.allreduce import CommLedger
from repro_torch.utils.tree import tree_bytes

PyTree = Any

#: latency percentile window — counters and bytes stay exact forever, but a
#: long-lived server must not grow a list per request
LATENCY_WINDOW = 4096


def _percentile(sorted_vals: list, q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def _window() -> deque:
    return deque(maxlen=LATENCY_WINDOW)


@dataclass
class ServeMetrics:
    """Latency/throughput counters + a ``CommLedger`` for inference bytes.

    Percentiles come from a bounded window of the most recent requests or
    steps; everything else is an exact running total.
    """

    ledger: CommLedger = field(default_factory=CommLedger)
    requests: int = 0
    busy_s: float = 0.0
    tokens: int = 0
    decode_steps: int = 0
    slot_active_acc: int = 0
    slot_cap_acc: int = 0
    evictions: int = 0
    started_at: float = field(default_factory=time.perf_counter)
    latencies_s: deque = field(default_factory=_window)
    token_latencies_s: deque = field(default_factory=_window)
    ttft_s: deque = field(default_factory=_window)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    # ledger events coalesce per tag: one running event, not one per request
    _event_idx: dict = field(default_factory=dict, repr=False)

    def record_decode_step(self, n_active: int, n_slots: int, latency_s: float) -> None:
        """One continuous-batching decode step: ``n_active`` of ``n_slots``
        slots each advanced one token in ``latency_s`` (the per-token
        latency of every active slot)."""
        with self._lock:
            self.tokens += n_active
            self.decode_steps += 1
            self.busy_s += latency_s
            self.slot_active_acc += n_active
            self.slot_cap_acc += n_slots
            if n_active:
                self.token_latencies_s.append(latency_s)

    def record_first_token(self, latency_s: float) -> None:
        """A request's first token is out ``latency_s`` after its submit."""
        with self._lock:
            self.ttft_s.append(latency_s)

    def record_request_stream(self, n_tokens: int, e2e_latency_s: float,
                              request: PyTree = None, response: PyTree = None,
                              tag: str = "serve") -> None:
        """One retired generation request: its end-to-end latency enters
        the window and its prompt / generated-ids bytes are metered."""
        with self._lock:
            self.requests += 1
            self.latencies_s.append(e2e_latency_s)
            up = tree_bytes(request) if request is not None else 0
            down = tree_bytes(response) if response is not None else 0
            self.ledger.uplink_bytes += up
            self.ledger.downlink_bytes += down
            if up or down:
                # updated in place, not append-then-pop, so the log stays
                # consistent when other writers share this ledger
                idx = self._event_idx.get(tag)
                if idx is None:
                    self.ledger.events.append(("inference", tag, up + down))
                    self._event_idx[tag] = len(self.ledger.events) - 1
                else:
                    kind, t, prev = self.ledger.events[idx]
                    self.ledger.events[idx] = (kind, t, prev + up + down)

    def record_eviction(self, n: int = 1) -> None:
        with self._lock:
            self.evictions += n

    def summary(self) -> dict:
        with self._lock:
            lat = sorted(self.latencies_s)
            tok_lat = sorted(self.token_latencies_s)
            ttft = sorted(self.ttft_s)
            requests, busy = self.requests, self.busy_s
            tokens, steps = self.tokens, self.decode_steps
            slot_act, slot_cap = self.slot_active_acc, self.slot_cap_acc
            evictions = self.evictions
            up, down = self.ledger.uplink_bytes, self.ledger.downlink_bytes
        return {
            "requests": requests,
            "busy_s": busy,
            "wall_s": time.perf_counter() - self.started_at,
            "requests_per_s": requests / max(busy, 1e-9),
            "mean_latency_ms": 1e3 * (sum(lat) / len(lat)) if lat else 0.0,
            "p50_latency_ms": 1e3 * _percentile(lat, 0.50),
            "p95_latency_ms": 1e3 * _percentile(lat, 0.95),
            "p99_latency_ms": 1e3 * _percentile(lat, 0.99),
            "request_bytes": up,
            "response_bytes": down,
            "tokens": tokens,
            "tokens_per_s": tokens / max(busy, 1e-9) if tokens else 0.0,
            "decode_steps": steps,
            "slot_utilization": (slot_act / slot_cap) if slot_cap else 0.0,
            "evictions": evictions,
            "p50_token_ms": 1e3 * _percentile(tok_lat, 0.50),
            "p95_token_ms": 1e3 * _percentile(tok_lat, 0.95),
            "p99_token_ms": 1e3 * _percentile(tok_lat, 0.99),
            "p50_ttft_ms": 1e3 * _percentile(ttft, 0.50),
            "p95_ttft_ms": 1e3 * _percentile(ttft, 0.95),
        }
