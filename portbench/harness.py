"""Run one cell of ``BENCHMARK.json`` and print its result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

    portbench/configs/<config>.json     sizes, source, the entry that runs it
    portbench/traffic/<traffic>.json    the mix's parameters
    portbench/limits/<workload>.json    the cell's limits and their readings
    portbench/layers/<config>.json      device-kernel names -> layers
    portbench/entries/<entry>.py        the driver of an entry
    portbench/metrics/<metric>.py       one reader of a per-layer metric

A run: set-up (data from the seed on the card, the program's first checked
steps, one warm chunk), the window (chunks until ``--seconds`` have passed;
a traced run profiles the traffic's ``trace_chunks`` chunks instead), what
the program hands to the check, the peak memory, then the reference on the
same inputs and the comparison.
"""

from __future__ import annotations

import importlib.util
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

#: top-level modules that must not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def bench_dir(root: Path) -> Path:
    return Path(root) / "portbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_plan(root: Path, workload: str) -> SimpleNamespace:
    """What ``BENCHMARK.json`` and the cell's files say about ``workload``."""
    root = Path(root)
    manifest = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    bd = bench_dir(root)
    cfg = load_json(bd / "configs" / f"{cell['config']}.json")
    traffic = load_json(bd / "traffic" / f"{cell['traffic']}.json")
    limits_path = bd / "limits" / f"{workload}.json"
    limits = load_json(limits_path)["limits"] if limits_path.exists() else {}
    e2e = [m for m in manifest["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    name_map = load_json(bd / "layers" / f"{cell['config']}.json")
    return SimpleNamespace(cell=cell, cfg=cfg, traffic=traffic, limits=limits, e2e=e2e,
                           per_layer=per_layer, name_map=name_map, root=root)


def judge(readings: dict, limits: dict) -> tuple[bool, dict, dict]:
    """Each compared reading beside its limit: correct when the cell has a
    limit, each limit has a finite reading and every reading lies at or
    under its limit.  A reading that the cell gives no limit is returned
    apart, shown and not judged (PERF.md names each and why)."""
    checks = {}
    for name, spec in limits.items():
        checks[name] = {"value": readings.get(name, math.nan), "limit": spec["limit"]}
    ok = bool(checks) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                              for c in checks.values())
    shown = {name: v for name, v in readings.items() if name not in limits}
    return ok, checks, shown


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t0: float | None = None, err=sys.stderr) -> dict:
    """One run of ``workload``; returns the result line as a dict."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    plan = cell_plan(root, workload)
    bd = bench_dir(plan.root)
    entry = load_module(bd / "entries" / f"{plan.cfg['entry']}.py",
                        f"portbench_entry_{plan.cfg['entry']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.init()
    print(f"set-up: imports and CUDA {time.perf_counter() - t0:.3f} s", file=err, flush=True)
    state = entry.setup(plan.cfg, plan.traffic, seed, device)
    sync()
    setup_s = time.perf_counter() - t0
    print(f"set-up {setup_s:.3f} s", file=err, flush=True)
    record = None
    if trace:
        from repro_torch.telemetry.trace import Tracer

        from portbench.devtrace import traced_window

        record = traced_window(lambda tr: entry.chunk(state, tr), plan.traffic["trace_chunks"],
                               Tracer(), sync, plan.name_map["layers"], plan.name_map["default"])
        units, chunks, window_s = record["units"], record["chunks"], record["window_s"]
    else:
        units = chunks = 0
        w0 = time.perf_counter()
        while True:
            units += entry.chunk(state, None)
            chunks += 1
            sync()
            window_s = time.perf_counter() - w0
            if window_s >= seconds:
                break
    counters = entry.counters(state)
    prog = entry.program_output(state)
    sync()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    print(f"window {window_s:.6f} s, {chunks} chunks, {units} {entry.UNIT}; memory peak "
          f"{peak} B", file=err, flush=True)
    entry.free(state)
    if cuda:
        torch.cuda.empty_cache()
    r0 = time.perf_counter()
    ref = entry.reference(state, "float64", None)
    readings = entry.readings(state, prog, ref)
    print(f"reference {time.perf_counter() - r0:.3f} s", file=err, flush=True)
    correct, checks, shown = judge(readings, plan.limits)
    for name, value in shown.items():
        print(f"shown, not compared: {name} {value!r}", file=err, flush=True)
    if trace:
        metrics = {}
        record.update(counts=entry.counts(plan.cfg, plan.traffic), counters=counters)
        for m in plan.per_layer:
            reader = load_module(bd / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + re.sub(r"\W", "_", m["name"]))
            value = reader.read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = entry.end_to_end(units, window_s)
        values["setup_s"] = setup_s
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in plan.e2e}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": plan.cell["chips"], "memory_peak_bytes": peak}
    if cuda:
        print(f"card: {card_line()}", file=err, flush=True)
    result = {"correct": correct, "attempted": chunks, "failed": 0 if correct else 1,
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=record["busy_s"], window_s=record["window_s"])
        from portbench.devtrace import breakdown

        result["breakdown"] = breakdown(record)
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=err, flush=True)
    return result


def main(argv, t0: float, root: Path) -> int:
    import argparse

    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cell_plan(root, args.workload).cell
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    loaded = forbidden_modules()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0
