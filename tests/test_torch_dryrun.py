"""The port's dry run (``repro_torch.launch.dryrun``): fake worlds of 8
ranks for the reduced configs, the full tinyllama-1.1b × train_4k on the
production 16×16 mesh, the argument bytes against the specs' local
shards, the counted FLOPs against the products, and no process group
left behind."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.sharding.rules import local_shape  # noqa: E402
from repro_torch.telemetry.costprobe import probe_costs  # noqa: E402

#: the reference's result keys (``src/repro/launch/dryrun.py``)
REFERENCE_KEYS = {"arch", "shape", "mesh", "chips", "status", "tag", "kind", "n_params",
                  "active_params", "lower_s", "compile_s", "probe_s", "memory", "cost_raw",
                  "cost_corrected", "collectives_raw", "roofline", "config"}

MESH = (4, 2)  # ("data", "model") over a fake world of 8
CASES = {"train": ("train_4k", 16), "decode": ("decode_32k", 8)}


@pytest.fixture(autouse=True)
def _no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


class StandInMesh:
    """Axis names and sizes only: what the specs read of a mesh."""

    mesh_dim_names = ("data", "model")
    shape = MESH


def _local_arg_bytes(cfg, kind, B, T, microbatches):
    step, args, _ = S.build_jitted(cfg, kind, StandInMesh(), B, T, microbatches=microbatches)
    total = 0
    for tree, spec_tree in zip(args, step.specs):
        leaves, treedef = torch.utils._pytree.tree_flatten(tree)
        for x, spec in zip(leaves, treedef.flatten_up_to(spec_tree)):
            if isinstance(x, torch.Tensor):
                total += math.prod(local_shape(x.shape, spec, StandInMesh())) * x.element_size()
    return total


@pytest.mark.parametrize("kind", list(CASES))
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "olmoe-1b-7b"])
def test_run_one_on_8_fake_ranks(arch, kind):
    shape, B = CASES[kind]
    res = dryrun.run_one(arch, shape, mesh_shape=MESH, reduced=True, batch=B, seq_len=32)
    assert res["status"] == "ok", res.get("traceback")
    assert REFERENCE_KEYS <= set(res)
    assert res["chips"] == 8 and res["mesh"] == "4x2" and res["kind"] == S.SHAPES[shape].kind
    cfg = S.shape_adapted_config(arch, shape)
    cfg = cfg.reduced().replace(remat_policy=cfg.remat_policy, attn_q_chunk=cfg.attn_q_chunk,
                                sliding_window=cfg.sliding_window)
    mb = 4 if kind == "train" else 1
    assert res["memory"]["argument_size_in_bytes"] == _local_arg_bytes(
        cfg, S.SHAPES[shape].kind, B, 32, mb)
    assert res["memory"]["memtracker_peak_bytes"] >= res["memory"]["argument_size_in_bytes"]
    pc = res["cost_corrected"]
    assert pc["n_probes"] == 1 and pc["flops"] > 0 and pc["bytes"] > 0
    coll = res["collectives_raw"]
    assert pc["coll"] == coll["total_bytes"] > 0
    assert set(coll["by_tier"]) == {"intra_pod"}  # no pod axis
    assert res["roofline"]["chips"] == 8 and res["roofline"]["dominant"] in (
        "compute", "memory", "collective")
    assert res["config"]["microbatches"] == mb
    json.dumps(res)


def test_failing_combination_is_recorded():
    """A microbatch of 2 rows cannot split over a data axis of 4: the
    error is recorded, the sweep would go on, and the world is gone."""
    res = dryrun.run_one("tinyllama-1.1b", "train_4k", mesh_shape=MESH, reduced=True,
                         batch=8, seq_len=32)
    assert res["status"] == "error" and res["error"] and "traceback" in res


def test_skipped_combination():
    res = dryrun.run_one("whisper-base", "long_500k")
    assert res["status"] == "skipped" and "448-token" in res["reason"]


def test_forward_flops_are_the_products():
    """Reduced tinyllama-1.1b's forward at B 2 × T 16 counts exactly its
    products: Q, K, V and O, the three FFN products, the full T×T scores
    and values, and the head."""
    cfg = get_config("tinyllama-1.1b").reduced()
    B, T = 2, 16
    d, H, Hkv, D, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = (2 * B * T * d * H * D + 2 * 2 * B * T * d * Hkv * D + 2 * B * T * H * D * d
                 + 3 * 2 * B * T * d * f + 2 * 2 * B * H * T * T * D)
    want = cfg.num_layers * per_layer + 2 * B * T * d * cfg.padded_vocab
    got = probe_costs(cfg, "prefill", make_host_mesh(), B, T)
    assert got["flops"] == want
    assert got["coll"] == 0 and got["n_probes"] == 1


def test_sharded_forward_flops_are_the_products_over_the_ranks():
    """Reduced tinyllama-1.1b's forward at B 8 × T 64 on a fake world of 8
    ((2, 4) ("data", "model")) counts on each rank exactly an eighth of
    its products: nothing runs whole on every model rank, the attention
    of its one KV head against 4 query heads included."""
    from repro_torch.launch.mesh import _mesh

    cfg = get_config("tinyllama-1.1b").reduced()
    B, T = 8, 64
    d, H, Hkv, D, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = (2 * B * T * d * H * D + 2 * 2 * B * T * d * Hkv * D + 2 * B * T * H * D * d
                 + 3 * 2 * B * T * d * f + 2 * 2 * B * H * T * T * D)
    want = (cfg.num_layers * per_layer + 2 * B * T * d * cfg.padded_vocab) // 8
    dryrun._fake_world(8)
    try:
        got = probe_costs(cfg, "prefill", _mesh((2, 4), ("data", "model"), "cpu"), B, T)
    finally:
        dist.destroy_process_group()
    assert got["flops"] == want and got["coll"] > 0


def test_sharded_train_step_runs_nothing_whole():
    """Reduced tinyllama-1.1b's train step (B 8 × T 64, 4 microbatches,
    full remat) on a fake world of 8 counts at most an eighth of four
    forward passes of the layers (forward, recompute, two products a
    backward) and three of the head: the gradients ``maybe_shard`` lays
    out on the way back reach each product reduced, so no rank multiplies
    by a weight gathered whole over the model axis."""
    cfg = get_config("tinyllama-1.1b").reduced()
    B, T = 8, 64
    d, H, Hkv, D, f = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_ff
    per_layer = (2 * B * T * d * H * D + 2 * 2 * B * T * d * Hkv * D + 2 * B * T * H * D * d
                 + 3 * 2 * B * T * d * f + 2 * 2 * B * H * T * T * D)
    most = (4 * cfg.num_layers * per_layer + 3 * 2 * B * T * d * cfg.padded_vocab) // 8
    res = dryrun.run_one("tinyllama-1.1b", "train_4k", mesh_shape=(2, 4), reduced=True,
                         batch=B, seq_len=T)
    assert res["status"] == "ok", res.get("traceback")
    assert 0 < res["cost_corrected"]["flops"] <= most


def test_cli_tinyllama_train_4k_on_the_production_mesh(tmp_path, capsys):
    """``python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape
    train_4k``: full width and depth on a fake world of 256, status ok,
    the reference's fields written."""
    res = dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k",
                       "--out", str(tmp_path)])
    assert res["status"] == "ok", res.get("traceback")
    saved = json.loads((tmp_path / "tinyllama-1.1b__train_4k__16x16.json").read_text())
    assert REFERENCE_KEYS <= set(saved) and saved["chips"] == 256
    assert saved["config"]["microbatches"] == 4 and saved["config"]["remat"] == "full"
    printed = json.loads(capsys.readouterr().out)
    assert printed["cost_corrected"] == saved["cost_corrected"]


def test_attention_stays_sharded_on_heads():
    """1 KV head against 4 query heads sharded over a model axis of 4, on a
    fake world of 8 ((2, 4) ("data", "model")): the attention runs on this
    rank's block (B/2 rows × H/4 heads) with no collective, FLOPs those
    of the block, and the block's values those of the whole answer."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.mesh import _mesh
    from repro_torch.models import attention as A
    from repro_torch.telemetry.costprobe import CostCounter

    rng = np.random.default_rng(1)
    B, T, H, Hkv, D = 4, 8, 4, 1, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               for s in ((B, T, H, D), (B, T, Hkv, D), (B, T, Hkv, D)))
    mask = A.causal_mask(T, T)
    want = A._sdpa(q, k, v, mask, scale=D ** -0.5)
    dryrun._fake_world(8)
    try:
        mesh = _mesh((2, 4), ("data", "model"), "cpu")
        # rank 0's blocks: the first half of the rows, the first query head
        qd = DTensor.from_local(q[: B // 2, :, :1], mesh, (Shard(0), Shard(2)),
                                run_check=False, shape=q.shape, stride=q.stride())
        kd, vd = (DTensor.from_local(x[: B // 2], mesh, (Shard(0), Replicate()),
                                     run_check=False, shape=x.shape, stride=x.stride())
                  for x in (k, v))
        counter = CostCounter()
        with counter, implicit_replication():  # the mask, as the steps run
            out = A._sdpa(qd, kd, vd, mask.to(torch.bool), scale=D ** -0.5)
        assert out.placements == (Shard(0), Shard(2))
        assert counter.records == []
        assert counter.flops == 2 * 2 * (B // 2) * (H // 4) * T * T * D
        torch.testing.assert_close(out.to_local(), want[: B // 2, :, :1], rtol=1e-5, atol=1e-6)
    finally:
        dist.destroy_process_group()
