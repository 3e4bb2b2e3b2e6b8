"""Time two builds of one attention kernel source in turns, in one process.

A: the library built from this package's ``csrc/<name>.cu``; B: the one
built from ``<alt-csrc>/<name>.cu``, a version of the same source with the
same C interface (say, the parent commit's or one with another dispatch).
Both go through the same wrapper (``kernel.flash_attention``), each shape
and type timed A, B, B, A for ``--rounds`` rounds with CUDA events around
``--inner`` calls; prints one JSON line a shape with the median, min and
max ms of a call for each side and B / A.  Needs a CUDA device and nvcc::

    PYTHONPATH=src python3 -m repro_torch.kernels.timing --alt-csrc DIR

The shapes (B, T, S, Hq, Hkv, D), causal: tinyllama-1.1b's heads at B 8 ×
T 2048 and qwen2-1.5b's at B 2 × T 4096, the two prefill shapes of the
port's kernel table.
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import kernel

SHAPES = {"tinyllama-1.1b": (8, 2048, 2048, 32, 4, 64),
          "qwen2-1.5b": (2, 4096, 4096, 12, 2, 128)}
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def load_alt(name: str, csrc: Path):
    """The ``build._LIBS`` entry of ``name`` built from ``csrc/<name>.cu``,
    left unregistered (built into the same ``_build/``, named by its hash)."""
    saved_csrc, saved = build.CSRC, build._LIBS.pop(name, None)
    build.CSRC = csrc
    try:
        build.library(name)
        return build._LIBS.pop(name)
    finally:
        build.CSRC = saved_csrc
        if saved is not None:
            build._LIBS[name] = saved


def time_in_turns(fn, libs: dict, names: tuple, *, inner: int, rounds: int) -> dict:
    """ms a call of ``fn`` with each side's libraries in place, A B B A."""
    runs = {side: [] for side in libs}
    order = list(libs) + list(reversed(list(libs)))
    for side in libs:  # warm each side once (first launch raises its smem limit)
        build._LIBS.update({n: libs[side][n] for n in names})
        fn()
    torch.cuda.synchronize()
    for _ in range(rounds):
        for side in order:
            build._LIBS.update({n: libs[side][n] for n in names})
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(inner):
                fn()
            e1.record()
            e1.synchronize()
            runs[side].append(e0.elapsed_time(e1) / inner)
    return {side: {"median": statistics.median(v), "min": min(v), "max": max(v),
                   "runs": len(v)} for side, v in runs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--alt-csrc", type=Path, required=True)
    ap.add_argument("--inner", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("timing: no CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for label, (B, T, S, Hq, Hkv, D) in SHAPES.items():
        for tname, dtype in DTYPES.items():
            name = kernel.ROUTES[dtype]
            names = ("flash_attention_tf32",) if dtype == torch.float32 else (name,)
            build.library(names[0])
            libs = {"A": {n: build._LIBS[n] for n in names},
                    "B": {n: load_alt(n, args.alt_csrc) for n in names}}
            q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
            outs = {}
            for side in libs:
                build._LIBS.update({n: libs[side][n] for n in names})
                outs[side] = kernel.flash_attention(q, k, v)
            same = bool(torch.equal(outs["A"], outs["B"]))
            t = time_in_turns(lambda: kernel.flash_attention(q, k, v), libs, names,
                              inner=args.inner, rounds=args.rounds)
            build._LIBS.update({n: libs["A"][n] for n in names})
            print(json.dumps({"shape": label, "dims": [B, T, S, Hq, Hkv, D], "type": tname,
                              "A": t["A"], "B": t["B"], "B_over_A": t["B"]["median"]
                              / t["A"]["median"], "outputs_equal": same}), flush=True)
            del q, k, v, outs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
