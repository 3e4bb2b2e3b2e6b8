"""The dry run's matrix on small worlds (``repro_torch.launch.dryrun``):
the head splits a model axis does not divide (MLA, whisper, mLSTM and
sLSTM), deepseek-v3-671b's expert products with the experts' d sharded
for FSDP, and, on 8 gloo ranks, the forwards under such meshes against
the same forwards without one.

Each ``run_one`` case raises on a port whose models reshape a sharded
projection into heads directly (``DTensor`` refuses to unflatten 4 heads
over a model axis of 8), or whose expert products run on FSDP-sharded
weights (a local view across two subspaces)."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

import torch_mesh_ranks as ranks  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import specs as S  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6  # f32, as ``test_torch_dryrun.py``'s sharded cases
RANK_TIMEOUT = 240  # seconds the launch of 8 ranks may take (~20 s measured)

#: (arch, shape, batch, seq_len) on a (1, 8) ("data", "model") world, one
#: microbatch: the reduced configs' 4 heads do not divide the model axis
#: of 8
UNEVEN_CASES = [
    ("minicpm3-4b", "train_4k", 2, 32),
    ("minicpm3-4b", "prefill_32k", 8, 64),
    ("minicpm3-4b", "decode_32k", 8, 64),
    ("whisper-base", "train_4k", 2, 16),
    ("whisper-base", "prefill_32k", 8, 64),
    ("whisper-base", "decode_32k", 8, 64),
    ("xlstm-125m", "train_4k", 2, 4),
    ("xlstm-125m", "prefill_32k", 8, 64),
    ("xlstm-125m", "decode_32k", 8, 64),
]


@pytest.fixture(autouse=True)
def _no_world_left():
    assert not dist.is_initialized()
    yield
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape,batch,seq_len", UNEVEN_CASES)
def test_uneven_head_split_ends_ok(arch, shape, batch, seq_len):
    """The attention (or mLSTM / sLSTM cell) runs whole on every model
    rank; the step ends ``ok`` on a fake world of 8."""
    cfg = ranks.split_friendly(S.shape_adapted_config(arch, shape))
    res = dryrun.run_one(arch, shape, mesh_shape=(1, 8), reduced=True, batch=batch,
                         seq_len=seq_len, microbatches=1, config=cfg)
    assert res["status"] == "ok", res.get("traceback")
    assert res["chips"] == 8 and res["mesh"] == "1x8" and res["config"]["reduced"]
    assert res["cost_corrected"]["flops"] > 0


def test_deepseek_v3_expert_products_with_fsdp():
    """deepseek-v3-671b at full width, one MoE layer, its train step on a
    (2, 4) fake world: the experts over "model", their d over "data"
    (the config is over the FSDP threshold), B 8 × T 2048 in one
    microbatch.  The experts' d is gathered before the three products."""
    cfg = S.shape_adapted_config("deepseek-v3-671b", "train_4k")
    cfg = cfg.replace(num_layers=1, num_mtp_layers=0,
                      moe=dataclasses.replace(cfg.moe, first_k_dense=0))
    res = dryrun.run_one("deepseek-v3-671b", "train_4k", mesh_shape=(2, 4), batch=8,
                         seq_len=2048, microbatches=1, config=cfg)
    assert res["status"] == "ok", res.get("traceback")
    assert res["config"]["microbatches"] == 1 and res["config"]["param_dtype"] == "bfloat16"
    coll = res["collectives_raw"]
    assert coll["total_bytes"] > 0 and res["cost_corrected"]["flops"] > 0


@pytest.fixture(scope="module")
def uneven_runs():
    return run_ranks(ranks.uneven_heads_program, 8, backend="gloo", timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("arch", ranks.UNEVEN_HEAD_ARCHS + ranks.EXPERT_ARCHS)
def test_sharded_forward_equals_the_plain_one(uneven_runs, arch):
    """On 8 gloo ranks every rank's forward under the mesh, gathered,
    equals the forward without a mesh on the same values."""
    for out in uneven_runs:
        case = out[arch]
        assert case["dtensor"]
        np.testing.assert_allclose(case["mesh"], case["plain"], rtol=RTOL, atol=ATOL)
        if "aux" in case:
            np.testing.assert_allclose(case["aux_mesh"], case["aux"], rtol=RTOL, atol=ATOL)
            assert "Shard(dim=2)" in case["w_down"]  # the experts' d over "data"
