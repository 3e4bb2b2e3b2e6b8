#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

1. Builds the port's CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   per source, all started together, sm_90a) and prints the card, the
   versions and the build time.
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
4. Decode-attention kernel phase: the kernel against its plain version
   (``decode_attention_plain``) in f32 and bf16 at the JAX package's test
   shapes, the serving shape (B 16, S 1024, Hq 32, Hkv 4, D 64) and qwen2's
   heads (G 6, D 128), every row seeing valid lengths 0, 1, S and one that
   is no multiple of a tile; limits 2e-5 (f32) and 3e-2 (bf16), the JAX
   package's own.  Times at the serving shape beside the byte bound, the
   plain version and ``F.scaled_dot_product_attention(..., enable_gqa=True)``.
5. Serving: ``repro_torch.serve.ContinuousLMEngine`` as
   ``python -m repro_torch.launch.serve --continuous`` builds it, for
   tinyllama-1.1b at full width and depth (bf16 compute, f32 parameters
   from a seeded ``torch.Generator`` on the card), 16 slots, page size 16,
   max_seq 1024, 48 greedy requests with prompts of 32–512 and 16–128 new
   tokens (seeded numpy).  Checks every ticket, the kernel's launches
   (decode steps × 22) and hits, and the ledger bytes; holds one captured
   decode step's logits with the kernel against ``use_kernel=False``; prints
   tokens/s, step ms, time to first token, peak memory and set-up time, and
   where that step's time goes (host wall and enqueue, device time as a
   CUDA graph, aten operations dispatched, and the parts on the device).
   Then the CLI itself, briefly.
6. Prints one JSON line of per-kernel numbers, the card's name and power
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
    """The least time for ``nbytes`` of traffic and ``ops`` f32 operations
    (the kernels here compute in f32 outside the tensor cores)."""
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


# the decode kernel's shapes: (B, S, Hq, Hkv, D) of tests/test_kernels_decode.py,
# the serving shape of tinyllama-1.1b and qwen2-1.5b's heads (G 6, D 128)
DECODE_SHAPES = [
    (2, 256, 8, 2, 32), (1, 512, 4, 4, 64), (3, 128, 4, 1, 16), (2, 300, 8, 4, 32),
    (16, 1024, 32, 4, 64), (3, 200, 12, 2, 128),
]
DECODE_MAIN = (16, 1024, 32, 4, 64)
DECODE_TOL = {"float32": 2e-5, "bfloat16": 3e-2}  # tests/test_kernels_decode.py:27,80


def decode_kernel_phase(torch):
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dak, ref as dar

    gen = torch.Generator(device="cuda").manual_seed(1)
    err = 0.0
    checked = 0
    for shape in DECODE_SHAPES:
        B, S, Hq, Hkv, D = shape
        # every row sees 0, 1, S and a length that is no multiple of a tile
        lens = [0, 1, S, S - 1 - S // 3]
        check(lens[3] % 32 != 0, f"length {lens[3]} is a multiple of a tile")
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(dtype)
            k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
            v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").to(dtype)
            worst = 0.0
            for shift in range(4):
                vl = torch.tensor([lens[(b + shift) % 4] for b in range(B)],
                                  dtype=torch.int32, device="cuda")
                out = dak.decode_attention(q, k, v, vl)
                plain = dar.decode_attention_plain(q, k, v, vl)
                torch.cuda.synchronize()
                check(out.shape == q.shape and out.dtype == dtype, f"decode out at {shape}")
                check(bool(torch.isfinite(out).all()), f"decode non-finite at {shape} {dtype}")
                e = float((out.float() - plain.float()).abs().max())
                tol = DECODE_TOL[str(dtype).split(".")[1]]
                check(e <= tol, f"decode attention {shape} {dtype}: |kernel - plain| {e} > {tol}")
                zero = vl == 0
                check(bool((out[zero] == 0).all()), f"decode valid_len 0 not 0 at {shape}")
                worst = max(worst, e)
                checked += 1
            err = max(err, worst)
            print(f"decode check {shape} {dtype}: max |kernel - plain| {worst:.3g} "
                  f"(lengths {lens})", flush=True)
    print(f"decode phase: {checked} comparisons within 2e-5 (f32) / 3e-2 (bf16)", flush=True)

    # time at the serving shape, bf16, every row full
    B, S, Hq, Hkv, D = DECODE_MAIN
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=gen, device="cuda").bfloat16()
    vl = torch.full((B,), S, dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] < vl[:, None])[:, None, None, :]
    q4, kt, vt = q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2)
    nbytes = 2 * int(vl.sum()) * Hkv * D * 2 + 2 * q.numel() * 2 + vl.numel() * 4
    ops = 4 * Hq * int(vl.sum()) * D
    b_ms, b_by = bound_ms(nbytes, ops)
    t = {
        "ms": graph_ms(torch, lambda: dak.decode_attention(q, k, v, vl), inner=50),
        "plain_ms": graph_ms(torch, lambda: dar.decode_attention_plain(q, k, v, vl), inner=50),
        "library_ms": graph_ms(torch, lambda: F.scaled_dot_product_attention(
            q4, kt, vt, attn_mask=mask, enable_gqa=True), inner=50),
        "bound_ms": b_ms, "bound_by": b_by, "shape": list(DECODE_MAIN), "bytes": nbytes,
    }
    print(f"time decode_attention main {DECODE_MAIN} bf16: {t}", flush=True)
    return err, t


SERVE_ARCH = "tinyllama-1.1b"
SERVE_SLOTS, SERVE_PAGE, SERVE_MAX_SEQ = 16, 16, 1024
SERVE_REQUESTS = 48
#: |logits(kernel) − logits(plain)| allowed on one captured bf16 decode step:
#: the two attention outputs differ by rounding (f32 sums in another order,
#: then one bf16 rounding each), and 22 bf16 layers carry that into logits of
#: unit scale; the argmax must agree wherever the top-2 margin is larger
#: than the difference measured
LOGIT_TOL = 0.25


def step_breakdown(torch, engine, cfg, args):
    """Where one decode step of the 16 live slots goes: host wall, host
    enqueue, device time (the step replayed as a CUDA graph), aten
    operations dispatched, and its parts on the device, each beside its
    byte bound."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch import kernels
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.models import cache as cache_lib, layers, transformer as tf
    from repro_torch.utils.tree import tree_leaves, tree_map

    class CountOps(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    W, L = engine._weights, cfg.num_layers
    tokens, cache, block, length = args

    def step():
        return tf.paged_decode_step(W, cfg, tokens, cache, block, length, decode_attn="cuda")

    step()
    torch.cuda.synchronize()
    launched = kernels.LAUNCHES["decode_attention"]
    with CountOps() as ops:
        step()
    check(kernels.LAUNCHES["decode_attention"] - launched == L, "breakdown step launches")
    wall, enq = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enq.append((t1 - t0) * 1e3)
        wall.append((time.perf_counter() - t0) * 1e3)
    device = graph_ms(torch, step, inner=1, reps=10)
    # every matmul weight is read once a step; of the embedding only 16 rows
    emb = W["embed"]["embedding"]
    w_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(W)) - emb.numel() * 4
    lw = tree_map(lambda x: x[0], W["seg0"])["l0"]
    lc = cache_lib.PagedKVCache(k=cache["seg0"]["l0"].k[0], v=cache["seg0"]["l0"].v[0])
    x = torch.randn((16, 1, cfg.d_model), device="cuda").to(lc.k.dtype)
    q = torch.randn((16, cfg.num_heads, cfg.head_dim), device="cuda").to(lc.k.dtype)
    k_all, v_all = cache_lib.paged_view(lc, block)
    vl = (length + 1).to(torch.int32)
    a = lw["mixer"]
    parts = {
        "decode kernel": (lambda: da_ops.decode_attention(q, k_all, v_all, vl), L,
                          2 * int(vl.sum()) * cfg.num_kv_heads * cfg.head_dim * 2),
        "paged_view gather": (lambda: cache_lib.paged_view(lc, block), L,
                              2 * 2 * k_all.numel() * k_all.element_size()),
        "layer matmuls": (lambda: (layers.dense(a["wo"], layers.dense(a["wq"], x)),
                                   layers.dense(a["wk"], x), layers.dense(a["wv"], x),
                                   layers.swiglu(lw["ffn"], x)), L,
                          sum(t.numel() * t.element_size() for t in tree_leaves(
                              {"m": a, "f": lw["ffn"]}) if t.dim() == 2)),
        "LM head": (lambda: layers.dense(W["lm_head"], x), 1,
                    W["lm_head"]["kernel"].numel() * 2),
    }
    summary = {"wall_ms": statistics.median(wall), "enqueue_ms": statistics.median(enq),
               "device_ms": device, "aten_ops": ops.n, "kernel_launches": L,
               "weight_bytes": w_bytes, "weight_bound_ms": w_bytes / HBM_BYTES_PER_S * 1e3}
    for name, (fn, times, nbytes) in parts.items():
        ms = graph_ms(torch, fn, inner=times, reps=10) * times
        summary[name] = {"ms_a_step": ms, "bound_ms_a_step": nbytes * times / HBM_BYTES_PER_S * 1e3}
    print("decode step breakdown (16 live slots):", json.dumps(summary), flush=True)
    check(summary["device_ms"] < summary["wall_ms"], "device time above wall time")


def serve_phase(torch):
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tf
    from repro_torch.serve import ContinuousLMEngine, ServeMetrics

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 stays f32 (prefill's _sdpa)
    cfg = get_config(SERVE_ARCH)
    n_layers = cfg.num_layers
    torch.cuda.synchronize()
    t_setup = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(gen, cfg)
    engine = ContinuousLMEngine(
        cfg, params, n_slots=SERVE_SLOTS, page_size=SERVE_PAGE, max_seq=SERVE_MAX_SEQ,
        tag=f"serve/{cfg.name}", device="cuda",
    )
    engine.submit(np.arange(40, dtype=np.int32), max_new=4).result()  # first-call costs
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_setup
    check(engine.kernel_plan["path"] == "cuda", f"plan {engine.kernel_plan}")
    print(f"serving set-up (weights on the card, engine, one warm-up request): "
          f"{setup_s:.4f} s; plan {engine.kernel_plan}", flush=True)

    rng = np.random.default_rng(0)
    plens = rng.integers(32, 513, size=SERVE_REQUESTS)
    gens = rng.integers(16, 129, size=SERVE_REQUESTS)
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32) for n in plens]
    engine.metrics = ServeMetrics()
    engine.kernel_hits = {"cuda": 0, "plain": 0}
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    tickets = [engine.submit(p, max_new=int(g)) for p, g in zip(prompts, gens)]
    steps = engine.run_until_idle()
    outs = [t.result() for t in tickets]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stats = engine.stats()

    for o, g in zip(outs, gens):
        check(o.shape == (int(g),) and o.dtype == np.int32, f"ticket shape {o.shape} != ({g},)")
        check(bool(((o >= 0) & (o < cfg.vocab_size)).all()), "generated id out of range")
    check(launches["decode_attention"] == steps * n_layers,
          f"decode_attention launched {launches['decode_attention']} times, "
          f"expected {steps} steps × {n_layers}")
    check(all(n == 0 for name, n in launches.items() if name != "decode_attention"),
          f"serving launched wire kernels: {launches}")
    check(engine.kernel_hits == {"cuda": stats["tokens"], "plain": 0},
          f"kernel_hits {engine.kernel_hits} vs {stats['tokens']} decode tokens")
    check(stats["tokens"] == int(gens.sum()) - SERVE_REQUESTS,
          f"decode tokens {stats['tokens']} != Σ(max_new − 1)")
    check(stats["request_bytes"] == 4 * int(plens.sum())
          and stats["response_bytes"] == 4 * int(gens.sum()),
          f"ledger {stats['request_bytes']}/{stats['response_bytes']} B")
    check(engine.ledger.uplink_bytes == 4 * int(plens.sum()), "ledger uplink")
    peak = torch.cuda.max_memory_allocated()
    print(f"serving {SERVE_REQUESTS} requests ({int(plens.sum())} prompt tokens, "
          f"{int(gens.sum())} generated): {serve_s:.4f} s, {steps} decode steps", flush=True)
    print(f"serve metrics: decode {stats['tokens_per_s']:.2f} tokens/s, median step "
          f"{stats['p50_token_ms']:.4f} ms (p95 {stats['p95_token_ms']:.4f}), median "
          f"time to first token {stats['p50_ttft_ms']:.4f} ms (p95 "
          f"{stats['p95_ttft_ms']:.4f}), slot utilization {stats['slot_utilization']:.4f}, "
          f"peak memory {peak / 2**30:.3f} GiB; set-up {setup_s:.4f} s vs serving "
          f"{serve_s:.4f} s", flush=True)
    print("serve stats:", json.dumps(stats), flush=True)

    # one captured decode step, with the kernel and with use_kernel=False
    caught = [engine.submit(rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32),
                            max_new=8)
              for n in rng.integers(32, 513, size=SERVE_SLOTS)]
    engine.step()
    engine.step()
    active = [s for s, r in enumerate(engine.sched.slots) if r is not None]
    check(len(active) == SERVE_SLOTS, f"{len(active)} slots active for the capture")
    args = (
        torch.from_numpy(engine._last_tok[:, None].copy()).long().cuda(), engine._cache,
        torch.from_numpy(engine.sched.block.copy()).long().cuda(),
        torch.from_numpy(engine.sched.length.copy()).cuda(),
    )
    lg = {}
    for impl in ("cuda", "plain"):
        logits, _ = tf.paged_decode_step(engine._weights, cfg, args[0], args[1], args[2],
                                         args[3], decode_attn=impl)
        lg[impl] = logits[:, 0, : cfg.vocab_size].float()
    torch.cuda.synchronize()
    diff = float((lg["cuda"] - lg["plain"]).abs().max())
    top2 = lg["cuda"].topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    clear = margin > diff
    same = lg["cuda"].argmax(-1) == lg["plain"].argmax(-1)
    check(diff <= LOGIT_TOL, f"captured step: |logits kernel − plain| {diff} > {LOGIT_TOL}")
    check(bool(same[clear].all()), "captured step: argmax differs where the margin is clear")
    print(f"captured decode step (16 slots, lengths {engine.sched.length.tolist()}): "
          f"max |logits kernel − plain| {diff:.4g} (limit {LOGIT_TOL}); argmax equal on "
          f"{int(same.sum())}/16 rows, {int(clear.sum())} rows with top-2 margin > the "
          f"difference; logit scale {float(lg['cuda'].abs().max()):.3g}", flush=True)
    step_breakdown(torch, engine, cfg, args)
    engine.run_until_idle()
    check(all(len(t.result()) == 8 for t in caught), "captured-step requests did not finish")
    del engine, params
    torch.cuda.empty_cache()

    # the CLI itself, at full width, a few requests
    t0 = time.perf_counter()
    outs = launch_serve.main(["--arch", SERVE_ARCH, "--continuous", "--batch", "4",
                              "--requests", "6", "--prompt-len", "40", "--gen", "8"])
    check(outs.shape == (6, 8), f"CLI output {outs.shape}")
    print(f"CLI run: {time.perf_counter() - t0:.4f} s", flush=True)
    torch.cuda.empty_cache()
    return launches


REPLACES = {
    "topk_encode": "src/repro/kernels/topk_compress/kernel.py:73",
    "topk_select": "src/repro/kernels/topk_compress/kernel.py:106",
    "int8_absmax": "src/repro/kernels/int8_quant/kernel.py:34",
    "int8_quant": "src/repro/kernels/int8_quant/kernel.py:53",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:31",
}
SOURCES = {
    "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
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
    build.build_all()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s, all sources at once "
          f"(nvcc " + ", ".join(
              f"{n} {build.build_info(n)['seconds']:.2f} s" for n in build.SIGNATURES)
          + ")", flush=True)
    for name in build.SIGNATURES:
        print(build.build_info(name)["log"].strip(), flush=True)

    err, timings = kernel_phase(torch)
    err["decode_attention"], timings[("decode_attention", "main")] = decode_kernel_phase(torch)
    launches = main_path(torch)
    launches["decode_attention"] = serve_phase(torch)["decode_attention"]
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was never launched on the main path")

    print("times at 2^24:", json.dumps({n: timings[(n, "2^24")] for n in REPLACES
                                        if (n, "2^24") in timings}))
    rows = []
    for name in REPLACES:
        t = timings[(name, "main")]
        rows.append({
            "name": name, "route": "cuda",
            "source": SOURCES.get(name, "src/repro_torch/csrc/wire_kernels.cu"),
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
