#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a) and prints the card, the versions and the build time.
2. Kernel phase: each of the four wire-encode kernels against its plain
   PyTorch version on the same CUDA tensors, bitwise (signed zeros and
   survivor counts included), at n ∈ {257, 8193, 2^20, 2^24} and a stacked
   (16, 2000), k ∈ {1, n/100, n}; then CUDA-event times (median of 20
   replays of a CUDA graph of the launches) beside the byte bound, the
   plain version and one PyTorch library call where one computes the same
   function.
3. Main path: ``repro_torch.api.fit`` with ``GradientDescent(logistic_loss)``
   on the local executor at the shape of the dense PASCAL "epsilon" set
   (400,000 × 2,000 f32, K = 16 nodes of 25,000 rows; synthetic, made on
   the card from a seeded generator), 20 rounds each of (a) allreduce ×
   topk:0.01+ef, (b) allreduce × int8+ef, (c) delay_line(2) × topk:0.01,
   (d) sequential_server × dense.  Checks that the loss falls, that each
   kernel was launched steps × eligible leaves times, the ledger bytes,
   and that (a) and (b) with ``use_kernel=False`` are bitwise the same fit.
4. Prints one JSON line of per-kernel numbers, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.  Exits non-zero, with no result line, when there
is no CUDA device or ``src/repro_torch`` is not beside it.  Any failed
check raises.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(REPO, "src")

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
K, N, D = 16, 25_000, 2_000  # epsilon: 400,000 × 2,000 over 16 nodes
STEPS = 20
TOPK_F = 0.01


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check(cond, what: str):
    if not cond:
        raise AssertionError(what)


def graph_ms(torch, fn, *, inner: int, reps: int = 20) -> float:
    """Device time of one ``fn()``: median over ``reps`` replays of a CUDA
    graph holding ``inner`` calls, timed with CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


def eager_ms(torch, fn, *, inner: int, reps: int = 20) -> float:
    """Stream time of one ``fn()`` for calls that cannot be captured in a
    CUDA graph (they synchronise): median over ``reps`` runs of ``inner``
    back-to-back calls between CUDA events — launch gaps included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(inner):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(torch):
    from repro_torch.kernels.int8_quant import kernel as q8k, ref as q8r
    from repro_torch.kernels.topk_compress import kernel as tkk, ref as tkr

    def same_bits(a, b):
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))

    gen = torch.Generator(device="cuda").manual_seed(0)
    err = {"topk_encode": 0.0, "topk_select": 0.0, "int8_absmax": 0.0, "int8_quant": 0.0}
    checked = 0
    for shape in [(1, 257), (1, 8193), (1, 1 << 20), (1, 1 << 24), (K, D)]:
        x = torch.randn(shape, generator=gen, device="cuda")
        n = shape[1]
        for k in sorted({1, max(1, n // 100), n}):
            t = torch.topk(x.abs(), k, dim=1).values[:, -1].contiguous()
            for name, with_res in (("topk_encode", True), ("topk_select", False)):
                o, res, cnt = tkk.encode_threshold(x, t, with_residual=with_res)
                o_r, res_r, cnt_r = tkr.encode_threshold_ref(x, t, with_residual=with_res)
                torch.cuda.synchronize()
                check(same_bits(o, o_r), f"{name} output differs at {shape}, k={k}")
                check(torch.equal(cnt, cnt_r), f"{name} count differs at {shape}, k={k}")
                check(bool((cnt >= k).all()), f"{name} kept fewer than k at {shape}")
                err[name] = max(err[name], float((o - o_r).abs().max()))
                if with_res:
                    check(same_bits(res, res_r), f"{name} residual differs at {shape}")
                    err[name] = max(err[name], float((res - res_r).abs().max()))
                checked += 1
        m, m_r = q8k.absmax(x), q8r.absmax_ref(x)
        s = torch.clamp_min(m_r, 1e-12) * (1.0 / 127.0)
        q, q_r = q8k.quant_dequant(x, s), q8r.quant_dequant_ref(x, s)
        torch.cuda.synchronize()
        check(same_bits(m, m_r), f"int8 absmax differs at {shape}")
        check(same_bits(q, q_r), f"int8 quant differs at {shape}")
        err["int8_absmax"] = max(err["int8_absmax"], float((m - m_r).abs().max()))
        err["int8_quant"] = max(err["int8_quant"], float((q - q_r).abs().max()))
        checked += 2
        print(f"kernel check {shape}: bitwise equal to the plain versions", flush=True)
    print(f"kernel phase: {checked} comparisons, all bitwise equal", flush=True)

    # times at the main path's shape (one θ leaf of D for K nodes) and at 2^24
    timings = {}
    for label, shape, inner in (("main", (K, D), 50), ("2^24", (1, 1 << 24), 10)):
        rows, n = shape
        x = torch.randn(shape, generator=gen, device="cuda")
        k = max(1, int(round(TOPK_F * n)))
        t = torch.topk(x.abs(), k, dim=1).values[:, -1].contiguous()
        s = torch.clamp_min(x.abs().amax(dim=1), 1e-12) * (1.0 / 127.0)
        zp = torch.zeros((rows,), dtype=torch.int32, device="cuda")
        el = rows * n
        rows_b = 4 * rows
        cases = {
            "topk_encode": (
                lambda: tkk.encode_threshold(x, t, with_residual=True),
                lambda: tkr.encode_threshold_ref(x, t, with_residual=True),
                None, 12 * el + 2 * rows_b, 4 * el),
            "topk_select": (
                lambda: tkk.encode_threshold(x, t, with_residual=False),
                lambda: tkr.encode_threshold_ref(x, t, with_residual=False),
                None, 8 * el + 2 * rows_b, 3 * el),
            "int8_absmax": (
                lambda: q8k.absmax(x), lambda: q8r.absmax_ref(x),
                lambda: torch.linalg.vector_norm(x, float("inf"), dim=1),
                4 * el + rows_b, 2 * el),
            # fake_quantize_per_channel_affine checks its zero points on the
            # host, so it cannot be captured: timed eagerly (eager_ms)
            "int8_quant": (
                lambda: q8k.quant_dequant(x, s), lambda: q8r.quant_dequant_ref(x, s),
                lambda: torch.fake_quantize_per_channel_affine(x, s, zp, 0, -127, 127),
                8 * el + rows_b, 6 * el),
        }
        for name, (kern, plain, lib, nbytes, ops) in cases.items():
            b_ms, b_by = bound_ms(nbytes, ops)
            lib_time = graph_ms if name != "int8_quant" else eager_ms
            timings[(name, label)] = {
                "ms": graph_ms(torch, kern, inner=inner),
                "plain_ms": graph_ms(torch, plain, inner=inner),
                "library_ms": None if lib is None else lib_time(torch, lib, inner=inner),
                "bound_ms": b_ms, "bound_by": b_by, "shape": list(shape),
            }
            print(f"time {name} {label} {shape}: {timings[(name, label)]}", flush=True)
    return err, timings


def make_epsilon_shaped(torch, seed: int):
    """Epsilon-shaped classification shards made on the card as
    ``make_feature_shards`` makes them: a planted w,
    y = sign(Xw + 0.05·noise) ∈ {−1, +1}."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((D,), generator=gen, device="cuda")
    Xs = torch.randn((K, N, D), generator=gen, device="cuda")
    ys = torch.sign(Xs @ w + 0.05 * torch.randn((K, N), generator=gen, device="cuda"))
    ys[ys == 0] = 1.0
    return Xs, ys


def main_path(torch):
    from repro_torch import api, kernels
    from repro_torch.core import schedules
    from repro_torch.ml.linear import logistic_loss

    data = make_epsilon_shaped(torch, 0)
    strategy = api.GradientDescent(logistic_loss, lr=1.0)
    loss0 = float(strategy.summary(strategy.init_theta(data), data)["loss"])
    print(f"data {tuple(data[0].shape)} f32 on the card "
          f"({data[0].numel() * 4 / 1e9:.2f} GB); loss at θ=0: {loss0:.6f}", flush=True)
    k = max(1, int(round(TOPK_F * D)))
    topk_push = k * (4 + 4)  # 4-byte index + f32 value per kept entry
    int8_push = D * 1 + 4  # one byte per entry + the f32 scale
    runs = {
        "a": dict(transport="allreduce", wire="topk:0.01+ef", steps=STEPS,
                  expect={"topk_encode": STEPS}, push=topk_push, pushes=STEPS * K),
        "b": dict(transport="allreduce", wire="int8+ef", steps=STEPS,
                  expect={"int8_absmax": STEPS, "int8_quant": STEPS},
                  push=int8_push, pushes=STEPS * K),
        "c": dict(transport="delay_line", staleness=2, wire="topk:0.01", steps=STEPS,
                  expect={"topk_select": STEPS}, push=topk_push, pushes=STEPS * K),
        "d": dict(transport="sequential_server", wire="dense",
                  schedule=schedules.round_robin(K, STEPS), expect={},
                  push=4 * D, pushes=STEPS * K),
    }
    # the first fit of a process pays one-off set-up (CUDA/cuBLAS handles,
    # lazy kernel loading, torch.func): time it apart from the runs
    t0 = time.perf_counter()
    api.fit(strategy, data, transport="allreduce", wire="topk:0.01+ef", steps=1,
            executor="local", device="cuda")
    torch.cuda.synchronize()
    print(f"warm-up fit (1 round, first in the process): "
          f"{time.perf_counter() - t0:.4f} s", flush=True)
    results = {}
    kernels.reset_launches()
    for tag, spec in runs.items():
        spec = dict(spec)
        expect, push, pushes = spec.pop("expect"), spec.pop("push"), spec.pop("pushes")
        before = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = api.fit(strategy, data, executor="local", device="cuda", **spec)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        delta = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.KERNEL_NAMES}
        want = {n: expect.get(n, 0) for n in kernels.KERNEL_NAMES}
        check(delta == want, f"run {tag}: launches {delta}, expected {want}")
        loss = float(res.metrics["loss"])
        check(math.isfinite(loss) and loss < loss0, f"run {tag}: loss {loss} did not fall")
        check(bool(torch.isfinite(res.theta).all()) and res.theta.shape == (D,),
              f"run {tag}: θ not finite of shape ({D},)")
        check(res.ledger.uplink_bytes == pushes * push,
              f"run {tag}: uplink {res.ledger.uplink_bytes} != {pushes} × {push}")
        if "wire_kernel_hits" in res.metrics:
            hits = res.metrics["wire_kernel_hits"]
            check(hits["kernel_leaves"] == 1 and hits["active"],
                  f"run {tag}: wire_kernel_hits {hits}")
        rounds = STEPS if tag != "d" else STEPS * K
        results[tag] = res
        print(f"run {tag} {spec.get('transport')} × {spec.get('wire')}: "
              f"loss {loss0:.6f} -> {loss:.6f}, {rounds} rounds in {wall:.4f} s "
              f"({rounds / wall:.2f} rounds/s), peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB, launches {delta}, "
              f"uplink {res.ledger.uplink_bytes} B, total {res.ledger.total_bytes} B",
              flush=True)

    # kernel on ≡ off: the same fits through the reference formulas
    for tag, wire in (("a", api.TopKWire(TOPK_F, error_feedback=True, use_kernel=False)),
                      ("b", api.Int8Wire(error_feedback=True, use_kernel=False))):
        before = sum(kernels.LAUNCHES.values())
        off = api.fit(strategy, data, transport="allreduce", wire=wire, steps=STEPS,
                      executor="local", device="cuda")
        on = results[tag]
        check(sum(kernels.LAUNCHES.values()) == before, f"run {tag} off launched kernels")
        check(torch.equal(on.theta.view(torch.int32), off.theta.view(torch.int32)),
              f"run {tag}: θ differs with use_kernel=False")
        check(torch.equal(on.trajectory.view(torch.int32), off.trajectory.view(torch.int32)),
              f"run {tag}: trajectory differs with use_kernel=False")
        check(on.ledger.summary() == off.ledger.summary(),
              f"run {tag}: ledger differs with use_kernel=False")
        print(f"run {tag}: use_kernel on ≡ off, bitwise (θ, trajectory, ledger)", flush=True)
    return dict(kernels.LAUNCHES)


REPLACES = {
    "topk_encode": "src/repro/kernels/topk_compress/kernel.py:73",
    "topk_select": "src/repro/kernels/topk_compress/kernel.py:106",
    "int8_absmax": "src/repro/kernels/int8_quant/kernel.py:34",
    "int8_quant": "src/repro/kernels/int8_quant/kernel.py:53",
}


def main() -> int:
    if not os.path.isfile(os.path.join(SRC, "repro_torch", "__init__.py")):
        print("chip_smoke.py: src/repro_torch is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    from repro_torch.kernels import build

    smi = smi_line()
    print(f"card: {smi}", flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    build.library()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info()['seconds']:.2f} s)", flush=True)
    print(build.build_info()["log"].strip(), flush=True)

    err, timings = kernel_phase(torch)
    launches = main_path(torch)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")

    print("times at 2^24:", json.dumps({n: timings[(n, "2^24")] for n in REPLACES}))
    rows = []
    for name in REPLACES:
        t = timings[(name, "main")]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/wire_kernels.cu",
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": err[name], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
