"""The program's own spans in a traced window: every device operation and
every idle gap put in the innermost program span that holds it, on the
profiler's clock.

While ``torch.profiler`` records, each span of the port's ``Tracer`` is
also a ``record_function`` range of its name (a user annotation, which the
window's device operations and host labels leave out).  ``attribute``
reduces the profiler's events (``profiler_events``):

* a device operation goes to the host operation that launched it (its
  ``linked_correlation_id`` is that operation's ``id``), and from there to
  the innermost program range on the launching operation's thread that
  holds the operation's start; where that thread opens no range at all
  (a backward runs in the autograd engine's device thread) or no
  operation launched it (a kernel library called through ``ctypes``), it
  goes by the launch's time to the innermost range of any thread that
  holds it;
* an idle gap goes to the innermost program range that holds its
  midpoint;
* a program range is a user annotation other than the window's own mark.

What no range holds is counted apart, so the device seconds of all spans
plus ``unspanned_device_s`` are the window's device seconds.  The
benchmark's ``traced_window`` does not call this yet; the readers of the
span metrics (``metrics/*_span_ms.*``, ``round_idle_ms.fit``,
``between_fits_share.fit``) read its result under ``record["program"]``.
Until then one cell's traced window with this reduction runs as

    python3 portbench/spans.py --workload <cell> --seed <n> [--out <jsonl>]

which prints one JSON line: the window, the reduction, those readers'
values and the spans' share of the device time.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent.parent
MARK = "portbench/window"

#: the readers of the program's spans, by the cells' entries
READERS = {
    "fit": ("update_span_ms.fit", "metric_span_ms.fit", "wire_span_ms.fit",
            "aggregate_span_ms.fit", "round_idle_ms.fit", "between_fits_share.fit"),
    "kmeans": ("estep_span_ms.kmeans", "mstep_span_ms.kmeans"),
}


def profiler_events(prof) -> list:
    """The profiler's raw events as ``attribute`` reads them: name, ``id``
    (the correlation id), thread, device type, user annotation,
    ``linked_correlation_id`` and ``time_range`` (µs), on the clock of
    ``prof.events()``.  Read from the raw results because ``FunctionEvent``
    carries the link from a device operation to the operation that
    launched it only in newer torch versions (2.11's has no such field)."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    out = []
    for k in res.events():
        if getattr(k, "is_hidden_event", lambda: False)():
            continue
        out.append(SimpleNamespace(
            name=k.name(), id=k.correlation_id(), thread=k.start_thread_id(),
            device_type=k.device_type(), is_user_annotation=k.is_user_annotation(),
            linked_correlation_id=k.linked_correlation_id(),
            time_range=SimpleNamespace(start=(k.start_ns() - t0) / 1e3,
                                       end=(k.end_ns() - t0) / 1e3)))
    return out


def _innermost(ranges, points) -> list:
    """For each point t, the index of the innermost of ``ranges`` ((start,
    end) pairs that nest, as one thread's ranges do) with start <= t <
    end, or None: a stack over the ranges in order of start (the outer
    first at a tie) swept with the points in order."""
    order = sorted(range(len(ranges)), key=lambda i: (ranges[i][0], -ranges[i][1]))
    out = [None] * len(points)
    stack, k = [], 0
    for j in sorted(range(len(points)), key=points.__getitem__):
        t = points[j]
        while k < len(order) and ranges[order[k]][0] <= t:
            i = order[k]
            while stack and ranges[stack[-1]][1] <= ranges[i][0]:
                stack.pop()
            stack.append(i)
            k += 1
        while stack and ranges[stack[-1]][1] <= t:
            stack.pop()
        out[j] = stack[-1] if stack else None
    return out


def idle_gaps(events, w0: float, w1: float, mark: str = MARK) -> list:
    """The window's idle gaps, (start, end) in the profiler's µs, as the
    window's reduction finds them: the complement in [w0, w1] of the union
    of the device operations' intervals."""
    from portbench.devtrace import _merge

    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1))
                   for e in _device_ops(events, mark)
                   if e.time_range.end > w0 and e.time_range.start < w1])
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    return [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]


def _device_ops(events, mark):
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type == DeviceType.CUDA and e.name != mark
            and not getattr(e, "is_user_annotation", False)]


def _latest_innermost(threads: dict, points) -> list:
    """For each point, the latest started of the threads' innermost ranges
    that hold it, or None."""
    best = [None] * len(points)
    for rs in threads.values():
        found = _innermost([(r.time_range.start, r.time_range.end) for r in rs], points)
        for j, i in enumerate(found):
            if i is not None and (best[j] is None
                                  or rs[i].time_range.start > best[j].time_range.start):
                best[j] = rs[i]
    return best


def attribute(events, gaps, mark: str = MARK) -> dict:
    """Device seconds, launches, idle seconds, host seconds and count of
    each program span name in the profiler's ``events``; ``gaps`` are the
    window's idle gaps ((start, end) µs).  Returns ``{"spans": {name:
    {"device_s", "launches", "idle_s", "host_s", "count"}},
    "unspanned_device_s", "unspanned_idle_s", "unspanned_top"}``, the last
    the five device operations by name that took most unspanned time.

    Two kinds of launch have no operation on a thread that opens ranges
    to go by: a backward on CUDA runs in the autograd engine's device
    thread while the calling thread waits inside its range, and a kernel
    launched straight from a range (``ctypes``) links to no operation under
    torch 2.11 (it may link to the range itself elsewhere).  Such a launch
    goes by its time (the operation's start, else its runtime call's): the
    latest started of the threads' innermost ranges that hold it."""
    from torch.autograd import DeviceType

    ranges, ops, calls = [], {}, {}
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        if e.name.startswith("cu"):
            calls.setdefault(e.id, e)  # a runtime call: its id is its device operation's
            continue
        if e.linked_correlation_id:
            continue
        ops.setdefault(e.id, e)
        if e.is_user_annotation and e.name != mark and e.time_range.end > e.time_range.start:
            ranges.append(e)
    spans: dict = {}
    for r in ranges:
        s = spans.setdefault(r.name, {"device_s": 0.0, "launches": 0, "idle_s": 0.0,
                                      "host_s": 0.0, "count": 0})
        s["host_s"] += (r.time_range.end - r.time_range.start) / 1e6
        s["count"] += 1
    threads: dict = {}
    for r in ranges:
        threads.setdefault(r.thread, []).append(r)

    # each device operation: its launching operation, then the innermost
    # range on that operation's thread that holds the operation's start
    device = _device_ops(events, mark)
    owner = [None] * len(device)
    queries: dict = {}
    loose = []  # (device operation, launch time) placed by time alone
    for n, d in enumerate(device):
        op = ops.get(d.linked_correlation_id)
        if op is not None and op.name != mark:
            if op.is_user_annotation:
                owner[n] = op.name
            else:
                queries.setdefault(op.thread, []).append((n, op.time_range.start))
        elif d.id in calls:
            loose.append((n, calls[d.id].time_range.start))
    for thread, qs in queries.items():
        if thread not in threads:  # a worker thread: it opens no range
            loose += qs
            continue
        rs = threads[thread]
        found = _innermost([(r.time_range.start, r.time_range.end) for r in rs],
                           [t for _, t in qs])
        for (n, _), i in zip(qs, found):
            owner[n] = None if i is None else rs[i].name
    for (n, _), r in zip(loose, _latest_innermost(threads, [t for _, t in loose])):
        owner[n] = None if r is None else r.name
    unspanned_device, unspanned_ops = 0.0, {}
    for n, d in enumerate(device):
        s = (d.time_range.end - d.time_range.start) / 1e6
        if owner[n] is None:
            unspanned_device += s
            unspanned_ops[d.name] = unspanned_ops.get(d.name, 0.0) + s
        else:
            spans[owner[n]]["device_s"] += s
            spans[owner[n]]["launches"] += 1

    # each idle gap: the innermost range holding its midpoint, the latest
    # started of the threads' innermost ones
    unspanned_idle = 0.0
    best = _latest_innermost(threads, [0.5 * (s + e) for s, e in gaps])
    for (s, e), r in zip(gaps, best):
        if r is None:
            unspanned_idle += (e - s) / 1e6
        else:
            spans[r.name]["idle_s"] += (e - s) / 1e6
    top = sorted(unspanned_ops.items(), key=lambda kv: -kv[1])[:5]
    return {"spans": spans, "unspanned_device_s": unspanned_device,
            "unspanned_idle_s": unspanned_idle, "unspanned_top": [list(kv) for kv in top]}


def span_sum(record, key: str, match) -> float | None:
    """``key`` summed over the program's spans whose names ``match``, or
    None where the window ran nothing on the card or no span matches (a
    program without those spans)."""
    program = record.get("program")
    if not program or not record["device_ops"] or not record["units"]:
        return None
    hits = [s[key] for name, s in program["spans"].items() if match(name)]
    return sum(hits) if hits else None


def per_unit_ms(record, key: str, match) -> float | None:
    """``span_sum`` in ms a unit of work (a round, an EM iteration)."""
    s = span_sum(record, key, match)
    return None if s is None else s * 1e3 / record["units"]


def window(run_chunk, chunks: int, tracer, sync) -> tuple:
    """``chunks`` chunks under the profiler with ``tracer`` ambient, as the
    benchmark's traced window runs them; returns the profiler's events,
    the window's bounds (µs on the profiler's clock), its wall seconds and
    the work units done."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch.telemetry import trace

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    units = 0
    with profile(activities=activities) as prof:
        with record_function(MARK):
            t0 = time.perf_counter()
            for _ in range(chunks):
                with tracer.span("portbench/chunk"), trace.activated(tracer):
                    units += run_chunk(tracer)
            sync()
            window_s = time.perf_counter() - t0
    events = profiler_events(prof)
    w0 = next(e.time_range.start for e in events
              if e.name == MARK and e.device_type == torch.autograd.DeviceType.CPU)
    return events, w0, w0 + window_s * 1e6, window_s, units


def measure(root, workload: str, seed: int, device: str = "cuda") -> dict:
    """One cell's traced window with the program's spans reduced: the
    window, ``attribute``'s result, the span readers' values and the share
    of the device seconds that the spans hold."""
    import torch

    from portbench import harness
    from repro_torch.telemetry.trace import Tracer

    plan = harness.cell_plan(root, workload)
    entry_name = plan.cfg["entry"]
    entry = harness.load_module(Path(root) / "portbench" / "entries" / f"{entry_name}.py",
                                f"portbench_entry_{entry_name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    state = entry.setup(plan.cfg, plan.traffic, seed, device)
    sync()
    events, w0, w1, window_s, units = window(lambda tr: entry.chunk(state, tr),
                                             plan.traffic["trace_chunks"], Tracer(), sync)
    entry.free(state)
    from portbench.devtrace import layer_of

    device_ops = _device_ops(events, MARK)
    gaps = idle_gaps(events, w0, w1)
    program = attribute(events, gaps)
    layers: dict = {}  # the name map's layers of the same window, beside the spans
    for e in device_ops:
        layer = layer_of(e.name, plan.name_map["layers"], plan.name_map["default"])
        layers[layer] = layers.get(layer, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    record = {"units": units, "chunks": plan.traffic["trace_chunks"], "window_s": window_s,
              "device_ops": len(device_ops),
              "device_s": sum((e.time_range.end - e.time_range.start) / 1e6
                              for e in device_ops),
              "idle_s": sum(e - s for s, e in gaps) / 1e6, "layers": layers,
              "program": program}
    metrics = {}
    for name in READERS[entry_name]:
        reader = harness.load_module(Path(root) / "portbench" / "metrics" / f"{name}.py",
                                     "portbench_span_metric_" + name.replace(".", "_"))
        metrics[name] = reader.read(record)
    spans = program["spans"]

    def device_s(prefix):
        return sum(s["device_s"] for n, s in spans.items() if n.startswith(prefix))

    if entry_name == "fit":
        inside = device_s("fit/round/") + device_s("dispatch/")
        share = {"round_spans_of_dispatch": device_s("fit/round/") / inside if inside else None}
    else:
        share = {"kmeans_spans_of_window": device_s("kmeans/") / record["device_s"]
                 if record["device_s"] else None}
    return {"workload": workload, "seed": seed,
            "device": torch.cuda.get_device_name() if cuda else "cpu",
            "card": harness.card_line() if cuda else None,
            "record": record, "metrics": metrics, "share": share}


def main(argv) -> int:
    p = argparse.ArgumentParser(description="One cell's traced window, by the program's spans.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", default=None, help="a JSON-lines file the line is appended to")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench/spans.py: no CUDA device", file=sys.stderr)
        return 2
    line = json.dumps(measure(ROOT, a.workload, a.seed))
    print(line, flush=True)
    if a.out:
        with open(a.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).parent]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main(sys.argv[1:]))
