"""Multi-pod dry run: prove every (arch × shape × mesh) places and runs on
the production mesh, on shapes alone (port of ``repro.launch.dryrun``).

For each combination this brings up a fake world of 256 ranks (512 with
``--multipod``) in this process — ``torch.distributed``'s ``"fake"``
backend, whose collectives move nothing — builds ``make_production_mesh``
over it, places parameters, optimizer state, batch and cache as
``DTensor``s by the production specs with storage-free local shards, and
runs the step (train / prefill / serve) once as rank 0, recording:

* ``memory`` — ``argument_size_in_bytes``, exact from the local shard
  shapes, and the step's peak as ``MemTracker`` sees it
  (``memtracker_peak_bytes``, by memory kind under
  ``memtracker_peak_by_kind``);
* ``cost_corrected`` — per-device FLOPs, bytes and collective bytes,
  counted in one pass (``telemetry.costprobe``; ``cost_raw`` is the same
  pass, the port having no undercounting compiler);
* ``collectives_raw`` — this rank's collectives by kind and tier
  (``telemetry.hlo``);
* ``roofline`` — the three terms on the H100's constants
  (``telemetry.roofline``).

A failing combination is recorded as ``status: "error"`` with its message
and the sweep goes on.  The fake world is torn down before ``run_one``
returns: ``dist.is_initialized()`` decides the mesh executors' placement,
so no world may outlive the call.  Results land in
``experiments/dryrun/<arch>__<shape>__<mesh>[__tag].json``::

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch.distributed as dist

from repro_torch.configs import SHAPES, applicable
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import specs as S
from repro_torch.telemetry import hlo as hlo_lib
from repro_torch.telemetry import roofline as rl
from repro_torch.telemetry.costprobe import local_bytes, run_abstract


def _fake_world(n: int) -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def run_one(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    mla_absorb: bool = False,
    remat_override: str | None = None,
    microbatches: int | None = None,
    strategy: str = "tp",
    extra_tag: str = "",
    seed: int = 0,
    mesh_shape: tuple | None = None,
    reduced: bool = False,
    batch: int | None = None,
    seq_len: int | None = None,
) -> dict:
    """Dry-run one combination.  ``mesh_shape`` replaces the production
    mesh by a smaller one over a fake world of its size (``(4, 2)`` is
    ``("data", "model")``, three entries add ``"pod"`` in front);
    ``reduced`` takes the config's ``reduced()`` variant and ``batch`` /
    ``seq_len`` override the shape's — the small cases the tests run.
    Costs are counted in the one pass that runs the step (the reference's
    ``probes`` switch has no counterpart)."""
    shape = SHAPES[shape_name]
    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh_tag = "x".join(map(str, mesh_shape))
    head = {"arch": arch, "shape": shape_name, "mesh": mesh_tag}
    ok, why = applicable(arch, shape_name)
    if not ok:
        return dict(head, status="skipped", reason=why)

    cfg = S.shape_adapted_config(arch, shape_name)
    if reduced:
        cfg = cfg.reduced().replace(
            remat_policy=cfg.remat_policy, attn_q_chunk=cfg.attn_q_chunk,
            sliding_window=cfg.sliding_window)
    if remat_override is not None:
        cfg = cfg.replace(remat_policy=remat_override)
    B = batch if batch is not None else shape.global_batch
    T = seq_len if seq_len is not None else shape.seq_len
    if microbatches is None:
        microbatches = 4 if shape.kind == "train" else 1

    chips = 1
    for n in mesh_shape:
        chips *= n
    own_world = not dist.is_initialized()
    t0 = time.time()
    try:
        if own_world:
            _fake_world(chips)
        if mesh_shape in ((16, 16), (2, 16, 16)):
            mesh = mesh_lib.make_production_mesh(multi_pod=len(mesh_shape) == 3)
        else:
            names = ("pod", "data", "model")[-len(mesh_shape):]
            mesh = mesh_lib._mesh(tuple(mesh_shape), names, "cpu")
        t_mesh = time.time() - t0
        out = run_abstract(cfg, shape.kind, mesh, B, T, mla_absorb=mla_absorb,
                           microbatches=microbatches, strategy=strategy, seed=seed,
                           memory=True)
        t_run = time.time() - t0 - t_mesh
        counter, params_shape = out["counter"], out["params_shape"]
        pc = dict(counter.costs(), n_probes=1)
        coll_raw = hlo_lib.collective_stats(
            counter.records, pod_of=hlo_lib.mesh_pod_map(mesh))

        active = S.count_active_params(cfg, params_shape)
        if shape.kind in ("train", "prefill"):
            tokens = B * (min(T, S.DECODER_CTX) if cfg.is_encoder_decoder else T)
            mf = (rl.model_flops_train if shape.kind == "train"
                  else rl.model_flops_decode)(active, tokens)
        else:
            mf = rl.model_flops_decode(active, B)
        roof = rl.roofline(
            flops_per_device=pc["flops"],
            bytes_per_device=pc["bytes"],
            collective_bytes_per_device=pc["coll"],
            chips=chips,
            model_flops=mf,
        )
        peak = out["peak"] or {}
        mem_d = {
            "argument_size_in_bytes": local_bytes(out["args"]),
            "memtracker_peak_bytes": sum(k.get("Total", 0) for k in peak.values()),
            "memtracker_peak_by_kind": peak,
        }
        result = {
            **head,
            "chips": chips,
            "status": "ok",
            "tag": extra_tag,
            "kind": shape.kind,
            "batch": B,
            "seq_len": T,
            "n_params": int(S.count_params(params_shape)),
            "active_params": float(active),
            # the reference's timing keys: bringing up the world and mesh,
            # no compile (the port compiles nothing), the counting pass
            "lower_s": round(t_mesh, 2),
            "compile_s": 0.0,
            "probe_s": round(t_run, 2),
            "memory": mem_d,
            "cost_raw": {"flops": pc["flops"], "bytes_accessed": pc["bytes"]},
            "cost_corrected": pc,
            "collectives_raw": coll_raw,
            "op_census": hlo_lib.op_census(counter.counts),
            "roofline": roof.to_dict(),
            "config": {
                "param_dtype": cfg.param_dtype,
                "remat": cfg.remat_policy,
                "sliding_window": cfg.sliding_window,
                "mla_absorb": mla_absorb,
                "microbatches": microbatches,
                "strategy": strategy,
                "reduced": reduced,
            },
        }
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result = {
            **head,
            "status": "error",
            "tag": extra_tag,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-2000:],
        }
    finally:
        if own_world and dist.is_initialized():
            dist.destroy_process_group()
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--strategy", default="tp",
                    choices=["tp", "dp", "dp_fsdp", "kvseq", "serve", "ep2d"])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    res = run_one(
        args.arch,
        args.shape,
        multi_pod=args.multipod,
        mla_absorb=args.mla_absorb,
        remat_override=args.remat,
        microbatches=args.microbatches,
        strategy=args.strategy,
        extra_tag=args.tag,
    )
    os.makedirs(args.out, exist_ok=True)
    suffix = f"__{args.tag}" if args.tag else ""
    path = os.path.join(args.out, f"{args.arch}__{args.shape}__{res['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(res, f, indent=2)
    print(json.dumps({k: v for k, v in res.items() if k != "traceback"}, indent=2))
    return res


if __name__ == "__main__":
    main()
