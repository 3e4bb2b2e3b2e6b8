"""A configuration, a traffic mix, a cell and a per-layer metric added as new
files (and entries of ``BENCHMARK.json``) run without an edit to any file
the benchmark already has."""

import hashlib
import json
import shutil

from portbench import harness


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "portbench").rglob("*") if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_config_cell_and_metric_added_as_files(tiny_root):
    bd = tiny_root / "portbench"
    before = _digests(tiny_root)
    cfg = json.loads((bd / "configs" / "logreg-epsilon.json").read_text())
    cfg.update(name="logreg-throwaway", features=120)
    (bd / "configs" / "logreg-throwaway.json").write_text(json.dumps(cfg))
    shutil.copy(bd / "layers" / "logreg-epsilon.json", bd / "layers" / "logreg-throwaway.json")
    traffic = json.loads((bd / "traffic" / "16sites-topk.json").read_text())
    traffic.update(nodes=8, rounds_per_fit=3)
    (bd / "traffic" / "8sites-throwaway.json").write_text(json.dumps(traffic))
    shutil.copy(bd / "limits" / "fit-epsilon-16sites-topk.json",
                bd / "limits" / "fit-throwaway.json")
    (bd / "metrics" / "rounds_traced.fit.py").write_text(
        "def read(record):\n    return float(record['units'])\n")
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "logreg-throwaway", "source": "https://example.org/x",
                         "file": "portbench/configs/logreg-throwaway.json", "reduced": [],
                         "why": "a test"})
    m["workloads"].append({"name": "fit-throwaway", "config": "logreg-throwaway",
                           "traffic": "8sites-throwaway", "chips": 1, "why": "a test"})
    for e in m["end_to_end"]:
        if e["name"] == "rounds_per_s":
            e["workloads"].append("fit-throwaway")
    m["per_layer"].append({"name": "rounds_traced.fit", "unit": "rounds", "better": "higher",
                           "source": "device_trace", "layer": "fit round",
                           "moves": "rounds_per_s", "workloads": ["fit-throwaway"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    after = _digests(tiny_root)
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    out = harness.run_cell(tiny_root, "fit-throwaway", 3, 0.0, False, device="cpu")
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"rounds_per_s", "setup_s"}
    traced = harness.run_cell(tiny_root, "fit-throwaway", 3, 0.0, True, device="cpu")
    assert traced["metrics"]["rounds_traced.fit"]["value"] == 3 * traffic["trace_chunks"]
    assert "uplink_bytes_per_round.fit" not in traced["metrics"]
