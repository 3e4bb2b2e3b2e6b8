"""The port's sharding rules against the JAX package's
(``tests/test_sharding.py``): ``partition_params`` and the launch specs'
``param_specs`` leaf for leaf, ``maybe_shard`` and ``MeshContext``, and
on 8 gloo ranks the placement itself — each rank holds bitwise the block
JAX puts on the device of the same index — with mesh serving, a restore
onto shardings and an ambient multipod ``MeshContext`` driving the mesh
executors.

The gloo ranks run ``tests/torch_sharding_ranks.py`` (no JAX); the JAX
placements run on 8 fake devices in a subprocess (``fake_devices``)."""

from __future__ import annotations

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_sharding_ranks as sr  # noqa: E402
from repro import api as japi  # noqa: E402
from repro.configs import ARCHS  # noqa: E402
from repro.configs import get_config as j_get_config  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.launch.mesh import make_multipod_mesh as j_multipod_mesh  # noqa: E402
from repro.ml.linear import lsq_loss as j_lsq  # noqa: E402
from repro.models import transformer as j_tf  # noqa: E402
from repro.models import whisper as j_whisper  # noqa: E402
from repro.models.config import ModelConfig as JModelConfig  # noqa: E402
from repro.models.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402
from repro_torch.configs import get_config as t_get_config  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.launch.mesh import SoloMesh, make_host_mesh, run_ranks  # noqa: E402
from repro_torch.models import transformer as t_tf  # noqa: E402
from repro_torch.models import whisper as t_whisper  # noqa: E402
from repro_torch.models.config import ModelConfig as TModelConfig  # noqa: E402
from repro_torch.models.config import MoEConfig as TMoEConfig  # noqa: E402
from repro_torch.sharding import rules as t_rules  # noqa: E402

F_RTOL, F_ATOL = 1e-5, 1e-6  # fits trained apart (tests/test_torch_fit.py)
RANK_TIMEOUT = 300.0

STRATEGIES = ("tp", "dp", "dp_fsdp", "kvseq", "serve", "ep2d")


def _path(p) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in p)


def j_flat_specs(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    return {_path(p): tuple(s) for p, s in leaves}


def t_flat_specs(tree) -> dict:
    leaves = torch.utils._pytree.tree_flatten_with_path(
        tree, is_leaf=lambda s: isinstance(s, t_rules.P))[0]
    return {_path(p): tuple(s) for p, s in leaves}


def _moe_cfg(cls, moe_cls):
    return cls(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
               vocab_size=512, head_dim=16,
               moe=moe_cls(num_experts=4, top_k=2, d_ff_expert=64))


@functools.lru_cache(maxsize=None)
def shapes(arch: str | None):
    """(JAX shape tree, port meta tree) of ``arch``'s ``reduced()`` config,
    or of the reference test's dense+MoE config for None."""
    if arch is None:
        jc, tc = _moe_cfg(JModelConfig, JMoEConfig), _moe_cfg(TModelConfig, TMoEConfig)
    else:
        jc, tc = j_get_config(arch).reduced(), t_get_config(arch).reduced()
    j_init = j_whisper.init_params if jc.is_encoder_decoder else j_tf.init_params
    t_init = t_whisper.init_params if tc.is_encoder_decoder else t_tf.init_params
    jp = jax.eval_shape(lambda: j_init(jax.random.key(0), jc))
    tp = t_init(torch.Generator().manual_seed(0), tc, device="meta")
    return jc, tc, jp, tp


PARTITION_CASES = {
    "tp_only": dict(model_axis="model", fsdp_axis=None),
    "fsdp": dict(model_axis="model", fsdp_axis="data"),
    "fsdp_pod_data": dict(model_axis="model", fsdp_axis=("pod", "data")),
    "expert_axes": dict(model_axis="model", fsdp_axis="data", expert_axes=("model", "data")),
    "no_model_axis": dict(model_axis=None, fsdp_axis=("data", "model")),
}


@pytest.mark.parametrize("case", list(PARTITION_CASES))
def test_partition_params_matches_reference(case):
    """The reference test's dense+MoE tree: every leaf's spec equal."""
    _, _, jp, tp = shapes(None)
    kw = PARTITION_CASES[case]
    want = j_flat_specs(j_rules.partition_params(jp, **kw))
    got = t_flat_specs(t_rules.partition_params(tp, **kw))
    assert got == want


def test_param_specs_as_the_reference_test():
    """``tests/test_sharding.py``'s spot checks, on the port."""
    P = t_rules.P
    _, _, _, tp = shapes(None)
    s = t_rules.partition_params(tp, model_axis="model", fsdp_axis=None)
    assert s["embed"]["embedding"] == P("model", None)
    assert s["seg0"]["l0"]["mixer"]["wq"]["kernel"] == P(None, None, "model")
    assert s["seg0"]["l0"]["mixer"]["wo"]["kernel"] == P(None, "model", None)
    assert s["seg0"]["l0"]["ffn"]["experts"]["w_gate"] == P(None, "model", None, None)
    assert s["final_norm"]["scale"] == P()
    s = t_rules.partition_params(tp, model_axis="model", fsdp_axis="data")
    assert s["seg0"]["l0"]["mixer"]["wq"]["kernel"] == P(None, "data", "model")
    assert s["seg0"]["l0"]["ffn"]["experts"]["w_gate"] == P(None, "model", "data", None)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_every_reduced_arch(arch, strategy):
    """``param_specs`` (and through it ``partition_params``) on the host
    mesh: every leaf of every ``reduced()`` arch, each strategy."""
    _, tc, jp, tp = shapes(arch)
    jmesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    want = j_flat_specs(j_specs.param_specs(tc, jp, jmesh, strategy=strategy))
    got = t_flat_specs(t_specs.param_specs(tc, tp, make_host_mesh(), strategy=strategy))
    assert got == want


def test_maybe_shard_noop_without_context():
    t_rules.set_mesh_context(None)
    x = torch.ones((4, 4))
    assert t_rules.maybe_shard(x, "batch", None) is x
    # under a context a plain tensor is left as it is, as on a world of one
    t_rules.set_mesh_context(t_rules.MeshContext(mesh=make_host_mesh(),
                                                 logical={"batch": "data"}))
    try:
        assert t_rules.maybe_shard(x, "batch", None) is x
    finally:
        t_rules.set_mesh_context(None)


def test_mesh_context_pod_axis_resolution():
    """``tests/test_sharding.py::test_mesh_context_pod_axis_resolution`` on
    the port: node axes, the pod tier, and ``topology()``'s hops."""
    ctx = t_rules.MeshContext(mesh=SoloMesh(("pod", "data", "model")), logical={})
    jctx = j_rules.MeshContext(
        mesh=jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                               ("pod", "data", "model")), logical={})
    assert ctx.node_axes == jctx.node_axes == ("pod", "data")
    assert ctx.pod_axis == jctx.pod_axis == "pod"
    assert ctx.intra_pod_axes == jctx.intra_pod_axes == ("data",)
    topo, jtopo = ctx.topology(), jctx.topology()
    assert topo.tiers == jtopo.tiers == ("intra_pod", "inter_pod")
    assert [h.axes for h in topo.hops] == [h.axes for h in jtopo.hops] == [("data",), ("pod",)]
    flat = t_rules.MeshContext(mesh=make_host_mesh(), logical={})
    assert flat.pod_axis is None and flat.topology().tiers == ("flat",)


def test_spec_placements_and_uneven_dimensions():
    """Axes in mesh order shard in that order; two axes against it make a
    strided shard; a dimension the mesh does not divide raises, as
    ``jax.device_put`` does (DTensor would pad it)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard

    mesh = SoloMesh(("pod", "data", "model"))
    P = t_rules.P
    assert t_rules.spec_placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert t_rules.spec_placements(P(None, ("model", "data")), mesh) == (
        Replicate(), _StridedShard(1, split_factor=1), Shard(1))

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (4, 16)

    with pytest.raises(ValueError, match="not divisible by 16"):
        t_rules.check_divisible((51865, 512), P("model", None), Mesh())
    t_rules.check_divisible((51968, 512), P("model", "data"), Mesh())


# ----------------------------------------------------------------------------
# 8 gloo ranks against 8 fake JAX devices
# ----------------------------------------------------------------------------

JAX_PLACEMENT = r"""
import json, hashlib
import numpy as np
import jax
from jax.sharding import Mesh
import sys
sys.path.insert(0, %(tests)r)
import torch_sharding_ranks as sr
from repro.sharding.rules import make_shardings, partition_params, place_params

mesh = Mesh(np.array(jax.devices()).reshape(2, 2, 2), ("pod", "data", "model"))
order = {d.id: i for i, d in enumerate(mesh.devices.flat)}
params = sr.leaf_values()

def digests(placed):
    out = {}
    for k, arr in sr.flat(placed).items():
        d = [None] * mesh.size
        for s in arr.addressable_shards:
            d[order[s.device.id]] = sr.shard_digest(np.asarray(s.data))
        out[k] = d
    return out

res = {}
for case, (model, fsdp, experts) in sr.PLACEMENT_CASES.items():
    spec = partition_params(params, model_axis=model, fsdp_axis=fsdp, expert_axes=experts)
    res[case] = digests(jax.device_put(params, make_shardings(mesh, spec)))
res["place_params"] = digests(place_params(mesh, params, model_axis="model", fsdp_axis="data"))
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def jax_blocks(fake_devices):
    import os

    return fake_devices(JAX_PLACEMENT % {"tests": os.path.dirname(os.path.abspath(__file__))})


@pytest.fixture(scope="module")
def rank_outs(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("sharded_ckpt"))
    return run_ranks(sr.sharding_program, 8, backend="gloo", args=(workdir,),
                     timeout=RANK_TIMEOUT)


@pytest.mark.parametrize("case", list(sr.PLACEMENT_CASES) + ["place_params"])
def test_place_params_bitwise_jax_blocks(case, jax_blocks, rank_outs):
    """Rank r's local block of every leaf is bitwise the shard JAX puts on
    device r of the same mesh, the ``("pod", "data")`` dimension and the
    strided ``("model", "data")`` one included; the whole is the leaf."""
    key = "place_params" if case == "place_params" else f"place/{case}"
    for r, out in enumerate(rank_outs):
        got = {k: sr.shard_digest(v) for k, v in out[key].items()}
        want = {k: d[r] for k, d in jax_blocks[case].items()}
        assert got == want, (case, r)
        if case != "place_params":
            assert out[f"full/{case}"]


@pytest.mark.parametrize("how", ["restore", "registry"])
def test_restore_onto_shardings_on_8_ranks(how, jax_blocks, rank_outs):
    """``checkpoint.restore(shardings=)`` and ``ModelRegistry.load(like=,
    shardings=)``: each rank restores the block JAX places on its device
    under the same specs."""
    for r, out in enumerate(rank_outs):
        got = {k: sr.shard_digest(v) for k, v in out[how].items()}
        assert got == {k: d[r] for k, d in jax_blocks["fsdp_pod_data"].items()}


def test_registry_load_onto_shardings_as_reference(tmp_path):
    """A θ the JAX registry published loads onto shardings in the port
    (the host mesh) with the JAX registry's values."""
    from jax.sharding import PartitionSpec as JP

    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro.serve import ModelRegistry as JRegistry
    from repro_torch.serve import ModelRegistry

    theta = {"w": sr.leaf_values()["embed"]["embedding"][:8, :4],
             "b": sr.leaf_values()["final_norm"]["scale"][:4]}
    JRegistry(str(tmp_path)).publish("lin", {k: jnp.asarray(v) for k, v in theta.items()})
    jspec = {"w": JP("data", "model"), "b": JP()}
    want = JRegistry(str(tmp_path)).load(
        "lin", like={k: jnp.zeros(v.shape) for k, v in theta.items()},
        shardings=j_rules.make_shardings(j_host_mesh(), jspec))
    got = ModelRegistry(str(tmp_path)).load(
        "lin", like={k: torch.zeros(v.shape) for k, v in theta.items()},
        shardings=t_rules.make_shardings(make_host_mesh(), {"w": t_rules.P("data", "model"),
                                                            "b": t_rules.P()}))
    for k in theta:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_serve_engine_on_a_mesh_of_8_ranks(rank_outs):
    """``TestServeMeshEightDevices`` on the port: GD trained on the mesh
    executor and served with θ placed on a (4, 2) mesh through a
    ``MicroBatcher`` answers as the JAX package's local engine, with the
    reference's ledger bytes."""
    X, y = sr.linear_problem()
    js = japi.GradientDescent(j_lsq, lr=0.1)
    rj = japi.fit(js, (jnp.asarray(X), jnp.asarray(y)), transport="allreduce", steps=100)
    from repro.serve import ServeEngine as JEngine

    Xq = np.random.default_rng(5).normal(size=(6, 5)).astype(np.float32)
    want = np.asarray(JEngine(js, rj.theta).predict(jnp.asarray(Xq)))
    for out in rank_outs:
        s = out["serve"]
        np.testing.assert_allclose(s["theta"], np.asarray(rj.theta), rtol=F_RTOL, atol=F_ATOL)
        np.testing.assert_allclose(s["preds"], want, rtol=F_RTOL, atol=F_ATOL)
        assert s["uplink"] == 6 * 5 * 4 and s["downlink"] == 6 * 4
        assert s["events"] == ["inference"]
    assert all(np.array_equal(o["serve"]["preds"], rank_outs[0]["serve"]["preds"])
               for o in rank_outs)


def test_multipod_mesh_context_drives_mesh_executor(rank_outs):
    """An ambient multipod ``MeshContext`` supplies the pod mesh to both
    mesh executors on 8 ranks: θ bitwise equal between them, the ledger
    split by hop, and θ the reference test's (its fits under the same
    context on the host's devices)."""
    X, y = sr.linear_problem()
    j_rules.set_mesh_context(j_rules.MeshContext(mesh=j_multipod_mesh(), logical={}))
    try:
        want = japi.fit(japi.GradientDescent(j_lsq, lr=0.1), (jnp.asarray(X), jnp.asarray(y)),
                        transport="allreduce", steps=10, executor="mesh").theta
    finally:
        j_rules.set_mesh_context(None)
    for out in rank_outs:
        c = out["context"]
        np.testing.assert_array_equal(c["flat"], c["hier"])
        np.testing.assert_allclose(c["flat"], np.asarray(want), rtol=F_RTOL, atol=F_ATOL)
        assert c["by_hop"] != {}


def test_context_resolution_without_a_world():
    """Without a process group the ambient context's mesh (a ``SoloMesh``)
    is what the mesh executor resolves, and the fit is the local one."""
    from repro_torch import api as tapi
    from repro_torch.ml.linear import lsq_loss as t_lsq

    X, y = sr.linear_problem()
    ctx = t_rules.MeshContext(mesh=SoloMesh(("pod", "data")), logical={})
    t_rules.set_mesh_context(ctx)
    try:
        ex = tapi.MultiPodExecutor()
        assert ex.resolve().mesh is ctx.mesh
        meshed = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (X, y), transport="allreduce",
                          steps=10, executor=ex, device="cpu")
    finally:
        t_rules.set_mesh_context(None)
    local = tapi.fit(tapi.GradientDescent(t_lsq, lr=0.1), (X, y), transport="allreduce",
                     steps=10, device="cpu")
    assert torch.equal(meshed.theta, local.theta)
    assert json.dumps(meshed.ledger.summary()["by_hop"]) != "{}"
