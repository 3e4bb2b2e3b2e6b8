"""Port parity: ``repro_torch.core.topology`` against ``repro.core.topology``,
and the staged collectives of ``repro_torch.core.allreduce`` on a world of
4 gloo ranks (one launch of ``repro_torch.launch.mesh.run_ranks`` running
``tests/torch_mesh_ranks.py``'s ``collectives_program``).

The hop decomposition is plain integer arithmetic and matches the JAX
package exactly.  The collectives are held to numpy sums of the ranks'
inputs: a flat single hop ≡ ``mesh_allreduce`` bitwise (the reference's
claim), the staged (pod, data) sum and the reduce-scatter staging ≡ the
joint sum at f32 rounding, the partial + complete halves ≡ the staged
sum bitwise, ``mean`` ≡ sum / fan-in, ``max`` and ``any`` exactly.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_mesh_ranks as ranks  # noqa: E402
from repro.core import topology as j_topo  # noqa: E402
from repro_torch.core import topology as t_topo  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    SoloMesh,
    axis_group,
    batch_axes,
    data_axis_size,
    make_multipod_mesh,
    make_node_mesh,
    run_ranks,
)

RANK_TIMEOUT = 180  # seconds the 4-rank launch may take (~6 s measured)


@pytest.mark.parametrize("axes, sizes, K", [
    (("pod", "data"), {"pod": 2, "data": 4}, 8),
    (("pod", "data"), {"pod": 2, "data": 4}, 16),
    (("pod", "data", "model"), {"pod": 2, "data": 2, "model": 2}, 8),
    (("data",), {"data": 4}, 8),
    (("pod",), {"pod": 2}, 6),
])
def test_hop_messages_match_reference(axes, sizes, K):
    t = t_topo.Topology.from_mesh(axes).hop_messages(K, sizes)
    j = j_topo.Topology.from_mesh(axes).hop_messages(K, sizes)
    assert t == j
    assert sum(m for _, m, _ in t) == K


def test_hop_messages_telescope():
    topo = t_topo.Topology.from_mesh(("pod", "data"))
    msgs = topo.hop_messages(8, {"pod": 2, "data": 4})
    assert [(n, m) for n, m, _ in msgs] == [("intra_pod", 6), ("inter_pod", 2)]
    assert topo.tiers == ("intra_pod", "inter_pod") and topo.axes == ("data", "pod")


def test_flat_topology_single_tier():
    topo = t_topo.Topology.from_mesh(("data",))
    assert topo.tiers == ("flat",)
    assert topo.hop_messages(8, {"data": 4}) == [("flat", 8, 1.0)]
    assert t_topo.Topology.flat(("pod", "data")).hops[0].axes == ("pod", "data")


def test_duplicate_axis_rejected():
    with pytest.raises(ValueError, match="more than one hop"):
        t_topo.Topology((t_topo.Hop(("data",), "a"), t_topo.Hop(("data",), "b")))
    with pytest.raises(ValueError, match="at least one hop"):
        t_topo.Topology(())


def test_prices_and_groups_indivisible():
    topo = t_topo.Topology.from_mesh(("pod", "data"), intra_price=2.0, inter_price=7.0)
    assert [h.price_per_byte for h in topo.hops] == [2.0, 7.0]
    assert t_topo.DEFAULT_PRICES == j_topo.DEFAULT_PRICES
    with pytest.raises(ValueError, match="do not divide"):
        topo.hop_messages(9, {"pod": 2, "data": 2})


def test_world_of_one_meshes():
    """Without a process group the factories give a world of one: every
    axis of size 1, no group, the collectives the identity."""
    node, pod = make_node_mesh(), make_multipod_mesh()
    assert isinstance(node, SoloMesh) and node.mesh_dim_names == ("data",)
    assert pod.mesh_dim_names == ("pod", "data") and pod.shape == (1, 1)
    assert batch_axes(pod) == ("pod", "data") and data_axis_size(pod) == 1
    assert axis_group(pod, ("pod", "data")) is None
    with pytest.raises(ValueError, match="initialized process group"):
        make_node_mesh(4)
    prices = t_topo.calibrate_prices(pod, cache=False)
    assert prices["seconds"] == {"intra_pod": None, "inter_pod": None}
    assert prices["inter_pod"] == 1.0 and prices["calibrated"] is True
    topo = t_topo.Topology.calibrated(pod)
    assert topo.tiers == ("intra_pod", "inter_pod")


@pytest.fixture(scope="module")
def collectives():
    return run_ranks(ranks.collectives_program, 4, backend="gloo", timeout=RANK_TIMEOUT)


def test_flat_hop_is_mesh_allreduce(collectives):
    for r in collectives:
        np.testing.assert_array_equal(r["flat_hop"], r["joint"])


def test_staged_sums_match_numpy(collectives):
    xs = np.stack([r["inputs"] for r in collectives])
    total = xs.sum(axis=0, dtype=np.float64)
    for r in collectives:
        for key in ("joint", "staged", "scatter"):
            np.testing.assert_allclose(r[key], total, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(r["scatter"], r["staged"])
        np.testing.assert_array_equal(r["halves"], r["staged"])
        np.testing.assert_array_equal(r["halves_async"], r["staged"])
        np.testing.assert_array_equal(r["mean"], r["staged"] / 4.0)
        np.testing.assert_array_equal(r["pmean"], r["joint"] / 4.0)
        np.testing.assert_array_equal(r["max"], xs.max(axis=0))
        np.testing.assert_array_equal(
            r["any"], np.stack([q["bools"] for q in collectives]).any(axis=0))
    # every rank holds the same bits
    for r in collectives[1:]:
        np.testing.assert_array_equal(r["staged"], collectives[0]["staged"])


def test_vmapped_collective_matches_per_scenario(collectives):
    xs = np.stack([r["inputs"] for r in collectives])
    for r in collectives:
        for key in ("vmapped", "vmapped_scatter"):
            np.testing.assert_array_equal(r[key][0], r["staged"])
            np.testing.assert_allclose(r[key][1], 2 * xs.sum(axis=0), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(r[key][2], -xs.sum(axis=0), rtol=1e-6, atol=1e-6)
