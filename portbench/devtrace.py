"""The traced window: ``torch.profiler`` over a fixed number of chunks, and
its reduction to what the per-layer readers read.

Device time is the union of the intervals in which a kernel, a copy or a
fill ran on the card; busy over the window's wall gives the idle share.
Each device operation is put in a layer by the first pattern of the
configuration's name map (``portbench/layers/<config>.json``) that its
name matches.  Each idle gap between device operations is labelled by
what the host was doing in it: the innermost span of the program's
``Tracer`` open at the time, and the innermost operation the profiler
recorded on the host.
"""

from __future__ import annotations

import bisect
import re
import time

MARK = "portbench/window"
#: a name longer than this is cut in the breakdown
NAME_CHARS = 96


def _innermost(starts, items, t):
    """The item with the latest start that contains ``t``; ``starts`` is
    sorted and ``items`` are (start, end, label) in that order."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - 400), -1):
        s, e, label = items[j]
        if s <= t < e:
            return label
    return None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def layer_of(name: str, name_map: list, default: str) -> str:
    for pattern, layer in name_map:
        if re.search(pattern, name):
            return layer
    return default


def traced_window(run_chunk, chunks: int, tracer, sync, name_map: list, default: str) -> dict:
    """Run ``run_chunk(tracer)`` ``chunks`` times under the profiler and
    reduce the trace.  Returns the window's wall and busy seconds, the
    device operations by name (seconds, count, layer), seconds by layer,
    the idle gaps' seconds by host activity, and the work units done."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    units = 0
    with profile(activities=activities) as prof:
        with record_function(MARK):
            mark_us = time.perf_counter_ns() / 1e3
            for _ in range(chunks):
                with tracer.span("portbench/chunk"):
                    units += run_chunk(tracer)
            sync()
            window_s = time.perf_counter_ns() / 1e3 - mark_us
    window_s /= 1e6
    events = list(prof.events())
    marks = [e for e in events if e.name == MARK and e.device_type == DeviceType.CPU]
    w0 = marks[0].time_range.start
    w1 = w0 + window_s * 1e6
    offset = mark_us - w0  # Tracer µs minus profiler µs
    device, host = [], []
    for e in events:
        if e.name == MARK or getattr(e, "is_user_annotation", False):
            continue
        if e.device_type == DeviceType.CUDA:
            device.append(e)
        elif e.device_type == DeviceType.CPU and e.time_range.end > e.time_range.start:
            host.append((e.time_range.start, e.time_range.end, e.name))
    ops: dict = {}
    for e in device:
        op = ops.setdefault(e.name, {"name": e.name, "seconds": 0.0, "count": 0,
                                     "layer": layer_of(e.name, name_map, default)})
        op["seconds"] += (e.time_range.end - e.time_range.start) / 1e6
        op["count"] += 1
    layers: dict = {}
    for op in ops.values():
        layers[op["layer"]] = layers.get(op["layer"], 0.0) + op["seconds"]
    busy = _merge([(max(e.time_range.start, w0), min(e.time_range.end, w1)) for e in device
                   if e.time_range.end > w0 and e.time_range.start < w1])
    busy_s = sum(e - s for s, e in busy) / 1e6
    host.sort()
    spans = sorted((s["ts"] - offset, s["ts"] - offset + s["dur"], s["name"])
                   for s in tracer.spans if s["dur"] is not None)
    hs, ss = [h[0] for h in host], [s[0] for s in spans]
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        label = (f"{_innermost(ss, spans, mid) or 'outside any span'} > "
                 f"{_innermost(hs, host, mid) or 'python'}")
        gaps[label] = gaps.get(label, 0.0) + (e - s) / 1e6
    return {"units": units, "chunks": chunks, "window_s": window_s, "busy_s": busy_s,
            "ops": sorted(ops.values(), key=lambda o: -o["seconds"]), "layers": layers,
            "device_ops": sum(o["count"] for o in ops.values()),
            "idle_gaps": sorted(gaps.items(), key=lambda g: -g[1])}


def breakdown(record: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that took
    most time, named by layer, and the ten host activities under which the
    card sat idle longest (seconds summed over the window's gaps)."""
    return {
        "device_ops": [[f"{o['layer']}: {o['name'][:NAME_CHARS]}", o["seconds"]]
                       for o in record["ops"][:10]],
        "idle_gaps": [[label[:NAME_CHARS * 2], s] for label, s in record["idle_gaps"][:10]],
    }
