"""The port's collective accounting and census against the JAX package's
HLO parser (``tests/test_telemetry.py``): the pod map, the per-kind and
per-tier sums on the reference's synthetic program, and a staged
hierarchical all-reduce recorded on 8 gloo ranks.  The reference parses
HLO text; the port records collectives as they are dispatched, so the
synthetic program enters as the records it stands for."""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_sharding_ranks as sr  # noqa: E402
from repro.telemetry import hlo as j_hlo  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.telemetry import hlo  # noqa: E402


class _RefMesh:
    def __init__(self, **axes):
        self.axis_names = tuple(axes)
        self.shape = dict(axes)


class _PortMesh:
    def __init__(self, **axes):
        self.mesh_dim_names = tuple(axes)
        self.shape = tuple(axes.values())


@pytest.mark.parametrize("axes", [{"pod": 2, "data": 4}, {"data": 4},
                                  {"pod": 2, "data": 2, "model": 2}])
def test_mesh_pod_map_matches_reference(axes):
    assert hlo.mesh_pod_map(_PortMesh(**axes)) == j_hlo.mesh_pod_map(_RefMesh(**axes))


SYNTHETIC = """
  %ar0 = f32[8]{0} all-reduce(f32[8]{0} %x), replica_groups={{0,1},{2,3}}, to_apply=%add
  %ar1 = f32[4]{0} all-reduce(f32[4]{0} %y), replica_groups={{0,2},{1,3}}, to_apply=%add
  %ag = bf16[2,16]{1,0} all-gather(bf16[1,16]{1,0} %z), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[3]{0} reduce-scatter(f32[12]{0} %w), replica_groups=[1,4]<=[4], dimensions={0}
  %cp = f32[5]{0} collective-permute(f32[5]{0} %v), source_target_pairs={{0,1}}
"""

#: the same program as recorded collectives: kind, result bytes, groups
RECORDS = [
    {"kind": "all-reduce", "bytes": 32, "groups": [[0, 1], [2, 3]]},
    {"kind": "all-reduce", "bytes": 16, "groups": [[0, 2], [1, 3]]},
    {"kind": "all-gather", "bytes": 64, "groups": [[0, 1, 2, 3]]},
    {"kind": "reduce-scatter", "bytes": 12, "groups": [[0, 1, 2, 3]]},
    {"kind": "collective-permute", "bytes": 20, "groups": None},
]


@pytest.mark.parametrize("with_pods", [False, True])
def test_collective_stats_matches_reference(with_pods):
    """The reference's synthetic per-device HLO
    (``test_collective_stats_pod_attribution`` and more kinds) against
    the same collectives as records: counts, bytes and tiers equal."""
    pod_of = {0: 0, 1: 0, 2: 1, 3: 1} if with_pods else None
    want = j_hlo.collective_stats(SYNTHETIC, pod_of=pod_of)
    got = hlo.collective_stats(RECORDS, pod_of=pod_of)
    assert got == want
    if with_pods:
        assert got["by_tier"]["intra_pod"] == {"count": 1, "bytes": 32}


def test_collective_records_are_the_reference_answer():
    """``CollectiveRecord``s give what the dict records give."""
    recs = [hlo.CollectiveRecord(r["kind"], r["bytes"],
                                 tuple(r["groups"][0]) if r["groups"] else None)
            for r in RECORDS[:2]]
    pod_of = {0: 0, 1: 0, 2: 1, 3: 1}
    assert hlo.collective_stats(recs, pod_of=pod_of) == j_hlo.collective_stats(
        "\n".join(SYNTHETIC.splitlines()[:3]), pod_of=pod_of)


def test_op_census_counts_products_and_custom_ops():
    from repro_torch.kernels.int8_quant import ops as q8
    from repro_torch.telemetry.costprobe import CostCounter

    x = torch.randn(4, 8)
    with CostCounter() as c:
        y = x @ torch.randn(8, 3)
        torch.bmm(torch.randn(2, 3, 4), torch.randn(2, 4, 5))
        q8.int8_roundtrip(x)
    assert c.flops == 2 * 4 * 8 * 3 + 2 * 2 * 3 * 4 * 5
    census = hlo.op_census(c.counts)
    assert census["mm"] == 1 and census["bmm"] == 1
    assert census["repro_torch.int8_roundtrip"] == 1
    assert y.shape == (4, 3)


def test_staged_hierarchical_allreduce_by_tier():
    """On 8 gloo ranks, a (2, 4) multipod mesh: the staged all-reduce
    records an intra-pod ("data") then an inter-pod ("pod") all-reduce,
    nothing unattributed, and the sum is every rank's."""
    outs = run_ranks(sr.staged_program, 8, backend="gloo", timeout=300.0)
    for out in outs:
        assert out["tiers"] == ["intra_pod", "inter_pod"]
        stats = out["stats"]
        assert "unattributed" not in stats["by_tier"]
        assert stats["all-reduce"] == {"count": 2, "bytes": 2 * 16 * 4}
        assert stats["by_tier"]["intra_pod"]["bytes"] == stats["by_tier"]["inter_pod"][
            "bytes"] == 64
        np.testing.assert_array_equal(out["sum"], np.full(16, float(sum(range(8)))))
    assert [len(r) for r in outs[0]["ranks"]] == [4, 2]
