"""Rank programs for the port's mesh tests: each runs on every rank of a
gloo world started by ``repro_torch.launch.mesh.run_ranks`` and returns a
dict of numpy arrays and flags.

This module imports no JAX: each rank imports it, and the tests hold the
ranks' results to the JAX package's fits in the test process.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import api
from repro_torch.core import schedules
from repro_torch.ml.linear import lsq_loss

LRS = (0.02, 0.05, 0.1, 0.2)
SERVER_CASES = [(t, w) for t in ("sequential_server", "stale_server")
                for w in ("dense", "topk:0.5+ef")]
UPDATE_CASES = [("allreduce", {}), ("delay_line", {"staleness": 2})]


def problem(K=8, Nk=10, n=5, seed=0):
    """The reference tests' problem (``tests/test_executors.py``) in f32."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(K, Nk, n)).astype(np.float32)
    w = rng.normal(size=(n,)).astype(np.float32)
    y = np.einsum("kni,i->kn", X, w).astype(np.float32)
    return X, y


def svm_problem(K=8):
    rng = np.random.default_rng(3)
    Xs = rng.normal(size=(K, 6, 2)).astype(np.float32)
    ys = np.sign(rng.normal(size=(K, 6))).astype(np.float32)
    return Xs, ys


def kwindows_points():
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(loc=c, scale=0.3, size=(80, 2))
                          for c in [(0, 0), (3, 3), (-3, 2)]])
    rng.shuffle(pts)
    return pts.reshape(8, 30, 2).astype(np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _gd(lr=0.1):
    return api.GradientDescent(lsq_loss, lr=lr)


def _fit(strategy, data, **kw):
    return api.fit(strategy, data, device="cpu", **kw)


def _run(res) -> dict:
    return {"theta": _np(res.theta), "traj": _np(res.trajectory),
            "ledger": res.ledger.summary()}


def mesh_program(rank, world):
    """The mesh executor on a 1-D ``("data",)`` mesh over the world, each
    case beside the port's local fit of the same problem."""
    from repro_torch.ml.kwindows import KWindowsStrategy
    from repro_torch.ml.svm import CascadeStrategy

    X, y = problem()
    out = {"world": world}
    for transport, kw in UPDATE_CASES:
        out[f"mesh/{transport}"] = _run(
            _fit(_gd(), (X, y), transport=transport, steps=40, executor="mesh", **kw))
        out[f"local/{transport}"] = _run(
            _fit(_gd(), (X, y), transport=transport, steps=40, **kw))
    sched = schedules.round_robin(8, 5)
    for transport, wire in SERVER_CASES:
        for ex in ("mesh", "local"):
            out[f"{ex}/{transport}/{wire}"] = _run(_fit(
                _gd(), (X, y), transport=transport, schedule=sched, wire=wire,
                executor=ex))
    for ex in ("mesh", "local"):
        out[f"{ex}/lbfgs"] = _run(_fit(api.LBFGS(lsq_loss), (X, y),
                                       transport="allreduce", steps=15, executor=ex))
        out[f"{ex}/topk"] = _run(_fit(_gd(), (X, y), transport="allreduce",
                                      wire="topk:0.5+ef", steps=25, executor=ex))
        res = _fit(KWindowsStrategy(0, num_windows=3, r=1.0), kwindows_points(),
                   transport="sequential_server", schedule=schedules.round_robin(8, 1),
                   executor=ex)
        out[f"{ex}/kwindows"] = {
            "theta": {f: _np(getattr(res.theta, f)) for f in res.theta._fields},
            "ledger": res.ledger.summary()}
        res = _fit(CascadeStrategy(C=1.0, iters=60), svm_problem(),
                   transport="allreduce", steps=3, executor=ex)
        out[f"{ex}/cascade"] = {"sv_mask": _np(res.theta.sv_mask),
                                "alpha": _np(res.theta.alpha), "traj": _np(res.trajectory),
                                "ledger": res.ledger.summary()}
    # resume: a mesh run's carry resumes on the local executor
    first = _fit(_gd(), (X, y), transport="allreduce", wire="topk:0.5+ef", steps=15,
                 executor="mesh")
    second = _fit(_gd(), (X, y), transport="allreduce", wire="topk:0.5+ef", steps=15,
                  carry=first.metrics["carry"])
    full = _fit(_gd(), (X, y), transport="allreduce", wire="topk:0.5+ef", steps=30)
    out["resume"] = {"theta": _np(second.theta), "full": _np(full.theta)}
    # reduce-scatter staging and the overlapped outer hop: on ≡ off
    for knob, transport, kw in [("reduce_scatter", "allreduce", {}),
                                ("overlap", "delay_line", {"staleness": 2}),
                                ("overlap", "delay_line", {"staleness": 1})]:
        for on in (True, False):
            res = _fit(_gd(), (X, y), transport=transport, steps=30,
                       executor=api.MeshExecutor(**{knob: on}), **kw)
            out[f"{knob}{kw.get('staleness', '')}/{on}"] = _run(res)
    # an overlapped run's carry resumes a synchronous one
    a = _fit(_gd(), (X, y), transport="delay_line", staleness=2, steps=15,
             executor=api.MeshExecutor(overlap=True))
    b = _fit(_gd(), (X, y), transport="delay_line", staleness=2, steps=15,
             executor=api.MeshExecutor(overlap=False), carry=a.metrics["carry"])
    out["overlap_resume"] = _np(b.theta)
    try:
        Xu, yu = problem(K=world + 1)
        _fit(_gd(), (Xu, yu), transport="allreduce", steps=2, executor="mesh")
        out["uneven"] = ""
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def multipod_program(rank, world):
    """Multipod on a 2 × (world/2) ``("pod", "data")`` mesh against the
    flat mesh executor on the same mesh, and the composed sweeps."""
    from repro_torch.launch.mesh import make_multipod_mesh

    X, y = problem()
    mesh = make_multipod_mesh()
    out = {"mesh_shape": tuple(int(s) for s in mesh.shape)}
    for transport, kw in UPDATE_CASES:
        for wire in ("dense", "topk:0.5+ef"):
            for name, ex in (("flat", api.MeshExecutor(mesh)),
                             ("hier", api.MultiPodExecutor(mesh))):
                out[f"{name}/{transport}/{wire}"] = _run(_fit(
                    _gd(), (X, y), transport=transport, wire=wire, steps=40,
                    executor=ex, **kw))
    # the (2, 2, 2) ("pod", "data", "model") production shape: nodes on pod
    # × data, each node shard held by the two ranks of its model axis
    from torch.distributed.device_mesh import init_device_mesh

    mesh222 = init_device_mesh("cpu", (2, 2, 2), mesh_dim_names=("pod", "data", "model"))
    for name, ex in (("flat", api.MeshExecutor(mesh222)),
                     ("hier", api.MultiPodExecutor(mesh222))):
        out[f"{name}/222"] = _run(_fit(_gd(), (X, y), transport="allreduce", steps=40,
                                       executor=ex))
    res = _fit(_gd(), (X, y), transport="allreduce", steps=10,
               executor=api.MultiPodExecutor(mesh, calibrate=True))
    out["calibrated"] = _run(res)
    out["calibrated/ref"] = _run(_fit(_gd(), (X, y), transport="allreduce", steps=10,
                                      executor=api.MultiPodExecutor(mesh)))
    out["explicit_price"] = [
        h.price_per_byte for h in
        api.MultiPodExecutor(mesh, calibrate=True, inter_price=42.0).resolve().topology.hops]
    sched = schedules.round_robin(8, 5)
    out["multipod/server"] = _run(_fit(_gd(), (X, y), transport="sequential_server",
                                       schedule=sched, executor="multipod"))
    out["local/server"] = _run(_fit(_gd(), (X, y), transport="sequential_server",
                                    schedule=sched))
    res = _fit(_gd(), (X, y), transport="allreduce", steps=10,
               executor=api.MultiPodExecutor(intra_price=1.0, inter_price=5.0))
    out["priced"] = res.ledger.summary()
    # mesh+sweep: S scenarios against S mesh fits
    res = _fit(_gd(), (X, y), transport="allreduce", steps=40,
               executor="mesh+sweep", sweep={"lr": list(LRS)})
    out["mesh+sweep"] = {
        "executor": res.metrics["executor"], "theta": _np(res.theta),
        "traj": _np(res.trajectory), "ledgers": [led.summary() for led in res.ledger]}
    out["mesh/solo"] = [_run(_fit(_gd(lr), (X, y), transport="allreduce", steps=40,
                                  executor="mesh")) for lr in LRS]
    # multipod+sweep over the delay line: the per-hop split per scenario
    res = _fit(_gd(), (X, y), transport="delay_line", staleness=1, steps=30,
               executor="multipod+sweep", sweep={"lr": list(LRS)})
    out["multipod+sweep"] = {"executor": res.metrics["executor"],
                             "theta": _np(res.theta),
                             "ledgers": [led.summary() for led in res.ledger]}
    out["multipod/solo"] = [_run(_fit(_gd(lr), (X, y), transport="delay_line",
                                      staleness=1, steps=30, executor="multipod"))
                            for lr in LRS]
    # a staleness sweep and a dropout sweep on the mesh
    res = _fit(_gd(0.05), (X, y), transport="delay_line", steps=25, wire="topk:0.5+ef",
               executor="mesh+sweep", sweep={"staleness": [0, 1, 3]})
    out["stal+sweep"] = {"theta": _np(res.theta),
                         "totals": [led.total_bytes for led in res.ledger]}
    out["stal/solo"] = [_run(_fit(_gd(0.05), (X, y), transport="delay_line", staleness=D,
                                  steps=25, wire="topk:0.5+ef", executor="mesh"))
                        for D in (0, 1, 3)]
    plan = dict(seed=5, straggler=1, quorum=5)
    res = _fit(_gd(), (X, y), transport="delay_line", staleness=1, steps=20,
               wire="int8+ef", faults=api.FaultPlan(dropout_p=0.0, **plan),
               executor="mesh+sweep", sweep={"dropout_p": [0.0, 0.2, 0.5]})
    out["drop+sweep"] = {"theta": _np(res.theta),
                         "totals": [led.total_bytes for led in res.ledger]}
    out["drop/solo"] = [_run(_fit(_gd(), (X, y), transport="delay_line", staleness=1,
                                  steps=20, wire="int8+ef",
                                  faults=api.FaultPlan(dropout_p=p, **plan),
                                  executor="mesh"))
                        for p in (0.0, 0.2, 0.5)]
    return out


def collectives_program(rank, world):
    """Each rank's inputs come from a seed of its rank; returns every
    collective's result."""
    from repro_torch.core import allreduce as ar
    from repro_torch.launch.mesh import axis_group, make_multipod_mesh

    mesh = make_multipod_mesh()  # (2, 2)
    flat_group = axis_group(mesh, ("pod", "data"))
    hops = (axis_group(mesh, "data"), axis_group(mesh, "pod"))
    rng = np.random.default_rng(rank)
    x = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    b = torch.from_numpy(rng.random(5) < 0.3)
    out = {
        "inputs": x.numpy(), "bools": b.numpy(),
        "flat_hop": ar.hierarchical_allreduce(x, (flat_group,)).numpy(),
        "joint": ar.mesh_allreduce(x, flat_group).numpy(),
        "staged": ar.hierarchical_allreduce(x, hops).numpy(),
        "scatter": ar.hierarchical_allreduce(x, hops, reduce_scatter=True).numpy(),
        "mean": ar.hierarchical_allreduce(x, hops, op="mean").numpy(),
        "max": ar.hierarchical_allreduce(x, hops, op="max").numpy(),
        "any": ar.mesh_allreduce(b, flat_group, op="any").numpy(),
        "pmean": ar.pmean_allreduce(x, flat_group).numpy(),
    }
    part = ar.partial_allreduce(x, hops)
    out["halves"] = ar.complete_allreduce(part, hops).numpy()
    out["halves_async"] = ar.complete_allreduce(part, hops, async_op=True).wait().numpy()
    # the sum of a batch of 3 scenarios under vmap: one collective
    xs = torch.stack([x, 2 * x, -x])
    out["vmapped"] = torch.func.vmap(lambda v: ar.hierarchical_allreduce(v, hops))(xs).numpy()
    out["vmapped_scatter"] = torch.func.vmap(
        lambda v: ar.hierarchical_allreduce(v, hops, reduce_scatter=True))(xs).numpy()
    return out


#: the reduced archs whose 4 heads a model axis of 8 does not divide, and
#: the MoE archs whose expert block runs with its experts' d over "data"
UNEVEN_HEAD_ARCHS = ("minicpm3-4b", "whisper-base", "xlstm-125m")
EXPERT_ARCHS = ("olmoe-1b-7b", "deepseek-v3-671b")


def split_friendly(cfg):
    """``cfg`` with xlstm-125m's sLSTM FFN at 3/2 of d rather than 4/3: the
    reduced d of 256 gives a 682-wide leaf at 4/3, which a model axis of 8
    does not divide (in the reference either); other configs as they are."""
    import dataclasses

    if cfg.xlstm is None:
        return cfg
    return cfg.replace(xlstm=dataclasses.replace(cfg.xlstm, proj_factor_slstm=1.5))


def uneven_heads_program(rank, world):
    """The prefill forward of each of ``UNEVEN_HEAD_ARCHS``, reduced, on a
    (1, 8) ("data", "model") mesh, and the expert block of each of
    ``EXPERT_ARCHS`` on a (2, 4) mesh with the experts over "model" and
    their d over "data" (FSDP); each beside the same forward without a
    mesh, on the same seeded values.  xlstm-125m's parameters are f64 (its
    cells compute in f32 either way): in f32 its row-parallel products sum
    in another order than one product does, 1.7e-6 off at worst."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import moe, transformer as tf, whisper
    from repro_torch.sharding.rules import (
        MeshContext,
        P,
        partition_params,
        place,
        set_mesh_context,
    )

    rng = np.random.default_rng(0)
    out = {}
    mesh = _mesh((1, 8), ("data", "model"), "cpu")
    B, T = 2, 16
    for arch in UNEVEN_HEAD_ARCHS:
        cfg = split_friendly(get_config(arch).reduced())
        if cfg.xlstm is not None:
            cfg = cfg.replace(param_dtype="float64", compute_dtype="float64")
        init = whisper.init_params if cfg.is_encoder_decoder else tf.init_params
        params = init(torch.Generator().manual_seed(0), cfg)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, T)).astype(np.int32))}
        if cfg.is_encoder_decoder:
            batch["frame_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32))
        want = S.make_prefill_step(cfg)(params, batch)
        step, _, _ = S.build_jitted(cfg, "prefill", mesh, B, T)
        set_mesh_context(S.make_mesh_context_for(mesh, cfg, B))
        try:
            got = step(params, batch)
        finally:
            set_mesh_context(None)
        out[arch] = {"plain": _np(want), "mesh": _np(got.full_tensor()),
                     "dtensor": isinstance(got, DTensor)}

    mesh = _mesh((2, 4), ("data", "model"), "cpu")
    for arch in EXPERT_ARCHS:
        cfg = get_config(arch).reduced()
        p = moe.moe_init(torch.Generator().manual_seed(1), cfg)
        x = torch.from_numpy(rng.standard_normal((4, 8, cfg.d_model), dtype=np.float32))
        y, aux = moe.moe_apply(p, cfg, x)
        placed = place(mesh, p, partition_params(p, model_axis="model", fsdp_axis="data"))
        set_mesh_context(MeshContext(mesh=mesh, logical={"model": "model", "batch": "data"},
                                     fsdp=True))
        try:
            with implicit_replication():
                yd, auxd = moe.moe_apply(placed, cfg, place(mesh, x, P("data", None, None)))
        finally:
            set_mesh_context(None)
        out[arch] = {"plain": _np(y), "mesh": _np(yd.full_tensor()),
                     "aux": _np(aux), "aux_mesh": _np(auxd.full_tensor()),
                     "w_down": str(placed["experts"]["w_down"].placements),
                     "dtensor": isinstance(yd, DTensor)}
    return out
