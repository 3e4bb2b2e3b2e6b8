"""``RunReport`` — one artifact answering "what did this run do?" (port of
``repro.telemetry.report``).

``CommLedger`` knows the bytes (per reduction hop), the ``Tracer`` the wall
time (per span), ``program_cache_stats()`` the executors' dispatches (the
port runs eagerly, so every dispatch is ``uncached``),
``metrics["wire_kernel_hits"]`` the wire kernels' coverage, joined with
their launches during the fit (``metrics["wire_kernel_launches"]``, from
``repro_torch.kernels.LAUNCHES``), and
``ServeMetrics`` the latency percentiles.  ``RunReport`` joins them::

    tracer = Tracer()
    res = api.fit(strategy, data, wire="topk:0.1+ef", steps=100,
                  tracer=tracer, trace="phases", device="cuda")
    rep = RunReport.from_fit(res, tracer=tracer)
    rep.as_dict()              # one JSON-serializable dict
    print(rep.to_markdown())   # rendered tables

``from_serve(engine)`` builds the serving side from a ``ServeEngine`` or a
``ContinuousLMEngine``.
"""

from __future__ import annotations

import json

__all__ = ["RunReport"]


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _fmt_s(s: float) -> str:
    return f"{1e3 * s:.2f} ms" if s < 1.0 else f"{s:.3f} s"


class RunReport:
    """One dict + markdown rendering of a run's time, bytes and dispatches.

    Construct through :meth:`from_fit` or :meth:`from_serve`; the joined
    data lives in ``.data`` (JSON-serializable: what :meth:`as_dict`
    returns)."""

    def __init__(self, data: dict):
        self.data = data

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_fit(cls, result, tracer=None) -> "RunReport":
        """Join a ``FitResult`` with the run's tracer (if any): config,
        per-hop ledger bytes, span wall times, dispatch counts and wire
        kernel hits.  ``tracer`` is the instance passed to ``fit(...,
        tracer=...)``; None reports bytes and dispatches only."""
        from repro_torch.api.executor import program_cache_stats

        m = result.metrics
        ledger = result.ledger
        if isinstance(ledger, list):  # sweep: S per-scenario ledgers
            comm = {
                "scenarios": len(ledger),
                "per_scenario": ledger[0].summary() if ledger else {},
                "total_bytes": sum(led.total_bytes for led in ledger),
            }
        else:
            comm = ledger.summary()
        data = {
            "kind": "fit",
            "config": {
                "transport": m.get("transport"),
                "wire": m.get("wire"),
                "executor": m.get("executor"),
            },
            "comm": comm,
            "program_cache": program_cache_stats(),
        }
        if "faults" in m:
            data["faults"] = dict(m["faults"])
        if "wire_kernel_hits" in m:
            data["wire_kernel_hits"] = {**m["wire_kernel_hits"],
                                        "launches": dict(m.get("wire_kernel_launches", {}))}
        cls._join_tracer(data, tracer)
        return cls(data)

    @classmethod
    def from_serve(cls, engine, tracer=None) -> "RunReport":
        """Join a serving engine's ``ServeMetrics`` summary (latency
        percentiles, pad fraction, inference bytes) with its tracer (by
        default the one the engine records into).  A ``ContinuousLMEngine``
        also gives its decode-attention plan and per-implementation token
        hits."""
        data = {
            "kind": "serve",
            "serve": engine.stats(),
            "comm": engine.ledger.summary(),
        }
        hits = getattr(engine, "kernel_hits", None)
        if hits is not None:
            data["decode_kernel_hits"] = dict(hits)
            data["decode_kernel_plan"] = dict(getattr(engine, "kernel_plan", {}) or {})
        cls._join_tracer(data, tracer if tracer is not None else engine.tracer)
        return cls(data)

    @staticmethod
    def _join_tracer(data: dict, tracer) -> None:
        if tracer is None:
            return
        data["spans"] = tracer.summary()
        if tracer.counters:
            data["counters"] = dict(tracer.counters)
        if tracer.gauges:
            data["gauges"] = dict(tracer.gauges)

    # -- rendering -----------------------------------------------------------

    def as_dict(self) -> dict:
        return self.data

    def to_json(self) -> str:
        return json.dumps(self.data, indent=2, default=str)

    def to_markdown(self) -> str:
        d = self.data
        lines = [f"## RunReport ({d['kind']})", ""]
        cfg = d.get("config")
        if cfg:
            lines.append("- config: " + " × ".join(f"`{v}`" for v in cfg.values() if v))
        faults = d.get("faults")
        if faults:
            lines.append("- faults: " + ", ".join(
                f"{k}={v}" for k, v in faults.items() if v not in (None, 0, 0.0)))
        comm = d.get("comm", {})
        if "total_bytes" in comm:
            lines.append(f"- comm total: {_fmt_bytes(comm['total_bytes'])}"
                         + (f" over {comm['rounds']} rounds" if comm.get("rounds") else ""))
        if comm.get("scenarios"):
            lines.append(f"- scenarios: {comm['scenarios']} (per-scenario shown below)")
            comm = comm.get("per_scenario", {})
        by_hop = comm.get("by_hop")
        if by_hop:
            lines += ["", "| hop | uplink | downlink | price/byte |", "|---|---|---|---|"]
            for name, h in by_hop.items():
                lines.append(
                    f"| {name} | {_fmt_bytes(h['uplink_bytes'])} "
                    f"| {_fmt_bytes(h['downlink_bytes'])} | {h['price_per_byte']:g} |")
        spans = d.get("spans")
        if spans:
            lines += ["", "| span | count | total | mean |", "|---|---|---|---|"]
            for name in sorted(spans):
                e = spans[name]
                lines.append(f"| {name} | {e['count']} | {_fmt_s(e['total_s'])} "
                             f"| {_fmt_s(e['mean_s'])} |")
        cache = d.get("program_cache")
        if cache:
            lines.append(
                f"\n- program cache: {cache['hits']} hits / {cache['misses']} misses "
                f"({cache['size']} cached), {cache['uncached']} uncached dispatches "
                "(eager PyTorch)")
        hits = d.get("wire_kernel_hits")
        if hits:
            lines.append(f"- wire kernel hits: `{hits}`")
        dhits = d.get("decode_kernel_hits")
        if dhits:
            plan = d.get("decode_kernel_plan", {})
            via = f" via `{plan['path']}` ({plan['reason']})" if plan else ""
            lines.append(f"- decode kernel hits: `{dhits}`{via}")
        counters = d.get("counters")
        if counters:
            lines.append("- counters: " + ", ".join(
                f"{k}={v:g}" if isinstance(v, float) else f"{k}={v}"
                for k, v in sorted(counters.items())))
        serve = d.get("serve")
        if serve:
            lines += [
                "",
                "| requests | req/s | p50 | p95 | p99 | pad |",
                "|---|---|---|---|---|---|",
                (f"| {serve['requests']} | {serve['requests_per_s']:.0f} "
                 f"| {serve['p50_latency_ms']:.2f} ms | {serve['p95_latency_ms']:.2f} ms "
                 f"| {serve['p99_latency_ms']:.2f} ms | {100 * serve['pad_fraction']:.1f}% |"),
            ]
            if serve.get("tokens"):
                lines += [
                    "",
                    "| tokens | tok/s | slot util | p50 token | p99 token |",
                    "|---|---|---|---|---|",
                    (f"| {serve['tokens']} | {serve['tokens_per_s']:.0f} "
                     f"| {100 * serve['slot_utilization']:.1f}% "
                     f"| {serve['p50_token_ms']:.2f} ms | {serve['p99_token_ms']:.2f} ms |"),
                ]
        return "\n".join(lines) + "\n"
