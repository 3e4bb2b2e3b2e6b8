"""Markdown table of the port's dry-run matrix: one row per result file
that ``python -m repro_torch.launch.dryrun`` wrote (default directory
``experiments/dryrun``), the production meshes' rows in (mesh, arch,
shape) order.

    PYTHONPATH=src python -m tools.dryrun_table [DIR]

Columns: status, per-device FLOPs, bytes and collective bytes (one
counting pass), argument bytes, the ``MemTracker`` peak, whether the
attention runs whole on every model rank (the query heads do not divide
the model axis of 16, so ``sharding.rules.split_dim`` gathers them), the
host seconds of the pass, and the torch version that counted (a result
without one was written by this interpreter's torch).
"""

from __future__ import annotations

import glob
import json
import os
import sys

import torch

from repro_torch.configs import ARCHS, SHAPES, get_config

MODEL_AXIS = 16
MESHES = ("16x16", "2x16x16")


def heads_whole(arch: str) -> str:
    h = get_config(arch).num_heads
    return f"yes ({h} heads)" if h % MODEL_AXIS else "no"


def _g(x) -> str:
    return "" if x is None else f"{x:.4e}"


def rows(directory: str) -> list:
    found = {}
    for path in glob.glob(os.path.join(directory, "*.json")):
        with open(path) as f:
            res = json.load(f)
        if res.get("tag"):
            continue
        found[(res["mesh"], res["arch"], res["shape"])] = res
    out = []
    for mesh in MESHES:
        for arch in ARCHS:
            for shape in SHAPES:
                res = found.get((mesh, arch, shape))
                if res is None:
                    out.append(f"| {arch} | {shape} | {mesh} | not run | | | | | | | | |")
                    continue
                status = res["status"]
                if status == "skipped":
                    out.append(f"| {arch} | {shape} | {mesh} | skipped: {res['reason']} "
                               "| | | | | | | | |")
                    continue
                if status != "ok":
                    out.append(f"| {arch} | {shape} | {mesh} | error: {res['error'][:80]} "
                               "| | | | | | | | |")
                    continue
                pc, mem = res["cost_corrected"], res["memory"]
                out.append(
                    f"| {arch} | {shape} | {mesh} | ok | {_g(pc['flops'])} | {_g(pc['bytes'])} "
                    f"| {_g(pc['coll'])} | {mem['argument_size_in_bytes']:,} "
                    f"| {mem['memtracker_peak_bytes']:,} | {heads_whole(arch)} "
                    f"| {res['probe_s'] + res['lower_s']:.1f} "
                    f"| {res.get('torch', torch.__version__)} |")
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    directory = argv[0] if argv else "experiments/dryrun"
    print("| arch | shape | mesh | status | FLOPs / dev | bytes / dev | coll. bytes / dev "
          "| arg. bytes / dev | MemTracker peak / dev | heads whole on the model ranks "
          "| host s | torch |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for row in rows(directory):
        print(row)


if __name__ == "__main__":
    main()
