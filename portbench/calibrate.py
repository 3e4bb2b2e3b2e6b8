"""The readings that the limits of ``correct`` are set from, at a cell's own
size on the card, in one process (the benchmark's runs do not run this):

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 7,8,9] [--out chiprun_out/calibrate.jsonl]

For every seed: set-up as a run makes it (the data, the program's checked
steps and its warm chunk), a window of chunks as long as a run's
(``run_seconds``), what the program hands to the check after it, then the
program's numbers against the reference (the lower readings).  For every control seed also:
the reference computed in TF32 put in the program's place (the control),
each fault of the entry's reference planted in its place, and each fault of
``portbench/faults.py`` planted in the program (set-up, its warm chunk and
the check, with no window).  One JSON line a seed and kind, on standard
output and appended to ``--out``.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    import torch

    from portbench import faults, harness

    plan = harness.cell_plan(ROOT, a.workload)
    entry = harness.load_module(ROOT / "portbench" / "entries" / f"{plan.cfg['entry']}.py",
                                "portbench_entry")
    ref_mod = harness.load_module(
        ROOT / "portbench" / "reference" / f"{plan.cfg['entry']}.py", "portbench_reference")
    torch.backends.cuda.matmul.allow_tf32 = False
    window_s = harness.load_json(ROOT / "BENCHMARK.json")["run_seconds"]
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    out = open(a.out, "a") if a.out else None
    try:
        for seed in seeds + [s for s in controls if s not in seeds]:
            t0 = time.perf_counter()

            def emit(kind, readings):
                line = json.dumps({"workload": a.workload, "seed": seed, "kind": kind,
                                   "readings": readings, "s": time.perf_counter() - t0})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()

            st = entry.setup(plan.cfg, plan.traffic, seed, "cuda")
            w0 = time.perf_counter()
            while time.perf_counter() - w0 < window_s:
                entry.chunk(st, None)
                torch.cuda.synchronize()
            prog = entry.program_output(st)
            entry.free(st)
            ref = entry.reference(st, "float64", None)
            emit("program", entry.readings(st, prog, ref))
            del prog
            if seed in controls:
                emit("control_tf32", entry.readings(st, entry.reference(st, "tf32", None), ref))
                for fault in ref_mod.FAULTS:
                    emit(f"fault_{fault}", entry.readings(
                        st, entry.reference(st, "float64", fault), ref))
                for fault in faults.FAULTS + (faults.FIT_FAULTS if plan.cfg["entry"] == "fit"
                                              else ()):
                    with faults.planted(plan.cfg["entry"], fault):
                        broken = entry.setup(plan.cfg, plan.traffic, seed, "cuda")
                        out_broken = entry.program_output(broken)
                    entry.free(broken)
                    emit(f"planted_{fault}", entry.readings(broken, out_broken, ref))
                    del broken, out_broken
            del st, ref
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).parent]
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    sys.exit(main(sys.argv[1:]))
