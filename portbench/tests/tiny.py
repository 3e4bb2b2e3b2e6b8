"""A copy of the benchmark's files cut to a size the CPU runs in a second:
the same names and limits; only sizes change."""

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

#: sizes of the CPU copy, by file under portbench/
TINY = {
    "configs/logreg-epsilon.json": {"records": 1600, "features": 300},
    "configs/kmeans-kdd99.json": {"rows": 16 * 256, "dims": 6, "clusters": 20},
    "traffic/16sites-topk.json": {"rounds_per_fit": 5},
    "traffic/100kclients-topk.json": {"nodes": 400, "rounds_per_fit": 5},
    "traffic/16sites-iters20.json": {"iters_per_call": 4},
}


def edit_json(path: Path, **changes) -> None:
    d = json.loads(path.read_text())
    d.update(changes)
    path.write_text(json.dumps(d, indent=2) + "\n")


def copy_tree(dst: Path) -> Path:
    """``BENCHMARK.json`` and ``portbench/`` copied under ``dst``."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def make_tiny(dst: Path) -> Path:
    root = copy_tree(dst)
    for rel, changes in TINY.items():
        edit_json(root / "portbench" / rel, **changes)
    return root


def workloads() -> list:
    return [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
