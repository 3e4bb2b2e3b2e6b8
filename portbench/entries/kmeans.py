"""The ``kmeans`` entry: ``repro_torch.ml.clustering.distributed_kmeans``
under l2 on the sites' points, called again and again from the same C0,
one user's clustering job a call.

Set-up makes the points and C0 on the card from the seed and runs one warm
call.  A chunk is one call of the traffic's ``iters_per_call`` EM
iterations and its final assignment; the last call of the window is the
answer compared with the reference.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import torch

from portbench.counts import kmeans as km_counts
from portbench.reference import kmeans as km_ref
from portbench.reference import readings as _readings

UNIT = "iterations"
#: the port's kernel library that the cell runs
LIBRARY = "pdist_argmin_tc"


def make_data(cfg: dict, traffic: dict, seed: int, device: str):
    """A planted mixture at the configuration's shape, made on the card from
    one generator seeded by ``seed``: ``clusters`` means ~ N(0, 10²), each
    point a uniformly drawn mean plus N(0, 1) noise; C0 is ``clusters``
    distinct points.  Returns the (sites, n, d) points and C0."""
    sites = traffic["sites"]
    n, d, k = cfg["rows"] // sites, cfg["dims"], cfg["clusters"]
    gen = torch.Generator(device=device).manual_seed(seed)
    means = cfg["assumed"]["mean_scale"] * torch.randn((k, d), generator=gen, device=device)
    comp = torch.randint(0, k, (sites * n,), generator=gen, device=device)
    X = means[comp] + torch.randn((sites * n, d), generator=gen, device=device)
    C0 = X[torch.randperm(X.shape[0], generator=gen, device=device)[:k]].clone()
    return X.reshape(sites, n, d), C0


def setup(cfg: dict, traffic: dict, seed: int, device: str) -> SimpleNamespace:
    t0 = time.perf_counter()
    from repro_torch.kernels import build
    from repro_torch.ml import clustering

    t1 = time.perf_counter()
    if device == "cuda":
        build.library(LIBRARY)
        built = build.build_info(LIBRARY)["seconds"]
        print(f"set-up: kernel library {LIBRARY} {time.perf_counter() - t1:.3f} s, of it "
              f"nvcc {built:.3f} s", file=sys.stderr, flush=True)
    t2 = time.perf_counter()
    Xs, C0 = make_data(cfg, traffic, seed, device)
    st = SimpleNamespace(cfg=cfg, traffic=traffic, Xs=Xs, C0=C0, last=None)
    st.call = lambda: clustering.distributed_kmeans(
        Xs, C0, num_clusters=cfg["clusters"], iters=traffic["iters_per_call"])
    if device == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    chunk(st, None)  # the warm call
    print(f"set-up: imports {t1 - t0:.3f} s, data {t3 - t2:.3f} s, warm call "
          f"{time.perf_counter() - t3:.3f} s", file=sys.stderr, flush=True)
    return st


def chunk(st: SimpleNamespace, tracer) -> int:
    st.last = st.call()
    return st.traffic["iters_per_call"]


def counters(st) -> dict:
    return {}


def program_output(st) -> dict:
    r = st.last
    return {"centroids": r.centroids, "assignments": r.assignments,
            "inertia": float(r.inertia)}


def free(st) -> None:
    st.last = st.call = None


def reference(st, precision: str, fault):
    return km_ref.run(st.Xs, st.C0, iters=st.traffic["iters_per_call"], precision=precision,
                      fault=fault)


def readings(st, prog: dict, ref: dict) -> dict:
    return _readings.kmeans(prog, ref)


def end_to_end(units: int, window_s: float) -> dict:
    return {"em_iters_per_s": units / window_s}


def counts(cfg: dict, traffic: dict) -> dict:
    n, k, d, iters = cfg["rows"], cfg["clusters"], cfg["dims"], traffic["iters_per_call"]
    return {"estep_least_s": km_counts.estep_least_s(n, k, d),
            "call_least_s": km_counts.call_least_s(n, k, d, iters),
            "iters_per_call": iters}
