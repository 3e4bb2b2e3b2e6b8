"""Port parity: ``repro_torch.checkpoint`` against ``repro.checkpoint`` on
disk, both ways and bitwise, and the structure of
``repro_torch.data.synthetic_lm_batches`` (the cases of
``tests/test_data_checkpoint.py``).

The format is the reference's: one ``step_XXXXXXXX.npz`` of ``/``-joined
keys beside a JSON manifest.  bf16 leaves cross as JAX writes them, raw
2-byte voids: the port reads JAX's back bit for bit and writes the same
bytes.  (The JAX package's own ``restore`` cannot read a bf16 leaf back:
numpy has no cast from the void type; ``ROADMAP.md`` queue 3.)
"""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as j_ckpt  # noqa: E402
from repro.core.staleness import DelayLine as JDelayLine  # noqa: E402
from repro_torch import checkpoint as t_ckpt  # noqa: E402
from repro_torch.core.staleness import DelayLine as TDelayLine  # noqa: E402
from repro_torch.data import synthetic_lm_batch, synthetic_lm_batches  # noqa: E402


def arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(size=(3, 5)).astype(np.float32),
        "b": rng.normal(size=(5,)).astype(np.float32),
        "count": np.asarray(7, np.int32),
        "ids": rng.integers(-9, 9, size=(4,)).astype(np.int32),
        "buf": rng.normal(size=(1, 5)).astype(np.float32),
        "step": np.asarray(3, np.int32),
    }


def j_tree(a):
    return {"params": {"w": jnp.asarray(a["w"]), "b": jnp.asarray(a["b"])},
            "opt": ({"count": jnp.asarray(a["count"]), "ids": jnp.asarray(a["ids"])},
                    jnp.asarray(a["w"][0, 0])),
            "delay": JDelayLine(buffer={"b": jnp.asarray(a["buf"])},
                                step=jnp.asarray(a["step"]))}


def t_tree(a):
    t = {k: torch.from_numpy(v.copy()) for k, v in a.items()}
    return {"params": {"w": t["w"], "b": t["b"]},
            "opt": ({"count": t["count"], "ids": t["ids"]}, t["w"][0, 0].clone()),
            "delay": TDelayLine(buffer={"b": t["buf"]}, step=t["step"])}


def same_bits(t_leaf: torch.Tensor, j_leaf) -> bool:
    a = np.asarray(j_leaf)
    return (tuple(t_leaf.shape) == a.shape and str(t_leaf.dtype).split(".")[-1] == str(a.dtype)
            and t_leaf.numpy().tobytes() == a.tobytes())


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    a = arrays(0)
    j_ckpt.save(str(tmp_path), 5, j_tree(a))
    assert t_ckpt.latest_step(str(tmp_path)) == 5
    like = t_tree(arrays(1))
    out = t_ckpt.restore(str(tmp_path), 5, like)
    assert isinstance(out["delay"], TDelayLine) and isinstance(out["opt"], tuple)
    assert len(jax.tree.leaves(j_tree(a))) == len(torch.utils._pytree.tree_leaves(out))
    assert same_bits(out["params"]["w"], a["w"])
    assert same_bits(out["opt"][0]["count"], a["count"]) and out["opt"][0]["count"].shape == ()
    assert same_bits(out["opt"][0]["ids"], a["ids"])
    assert same_bits(out["opt"][1], a["w"][0, 0])
    assert same_bits(out["delay"].buffer["b"], a["buf"])
    assert same_bits(out["delay"].step, a["step"])
    assert same_bits(out["params"]["b"], a["b"])


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    a = arrays(2)
    t_ckpt.save(str(tmp_path), 12, t_tree(a))
    assert j_ckpt.latest_step(str(tmp_path)) == 12
    out = j_ckpt.restore(str(tmp_path), 12, j_tree(arrays(3)))
    want = j_tree(a)
    for got, ref in zip(jax.tree.leaves(out), jax.tree.leaves(want)):
        assert np.asarray(got).dtype == np.asarray(ref).dtype
        assert np.asarray(got).tobytes() == np.asarray(ref).tobytes()
    with open(tmp_path / "step_00000012.json") as f:
        meta = json.load(f)
    assert meta == {"step": 12, "keys": sorted(
        ["params/w", "params/b", "opt/0/count", "opt/0/ids", "opt/1", "delay/buffer/b",
         "delay/step"])}


def test_bf16_leaves_cross_as_raw_16_bits(tmp_path):
    """A JAX bf16 leaf restores in the port bitwise (and without a
    template, as bf16); the port writes the same bytes JAX does."""
    vals = np.random.default_rng(4).normal(size=(6, 3)).astype(np.float32)
    j_bf = jnp.asarray(vals, jnp.bfloat16)
    j_ckpt.save(str(tmp_path / "j"), 1, {"m": j_bf, "x": jnp.asarray(vals)})
    like = {"m": torch.zeros((6, 3), dtype=torch.bfloat16), "x": torch.zeros((6, 3))}
    out = t_ckpt.restore(str(tmp_path / "j"), 1, like)
    assert out["m"].dtype == torch.bfloat16
    assert out["m"].view(torch.int16).numpy().tobytes() == np.asarray(j_bf).tobytes()
    assert torch.equal(out["x"], torch.from_numpy(vals))
    loose = t_ckpt.restore_dict(str(tmp_path / "j"), 1, device="cpu")
    assert loose["m"].dtype == torch.bfloat16 and torch.equal(loose["m"], out["m"])
    t_ckpt.save(str(tmp_path / "t"), 1, {"m": out["m"], "x": out["x"]})
    with np.load(tmp_path / "j" / "step_00000001.npz") as jz, \
            np.load(tmp_path / "t" / "step_00000001.npz") as tz:
        assert sorted(jz.files) == sorted(tz.files)
        for k in jz.files:
            assert jz[k].dtype == tz[k].dtype and jz[k].tobytes() == tz[k].tobytes()
    with pytest.raises(ValueError, match="cast"):
        j_ckpt.restore(str(tmp_path / "t"), 1, {"m": j_bf, "x": jnp.asarray(vals)})


def test_restore_dict_rebuilds_nested_dicts(tmp_path):
    a = arrays(5)
    t_ckpt.save(str(tmp_path), 3, {"p": {"w": torch.from_numpy(a["w"])},
                                   "c": torch.from_numpy(a["count"])})
    d = t_ckpt.restore_dict(str(tmp_path), 3, device="cpu")
    j = j_ckpt.restore_dict(str(tmp_path), 3)
    assert torch.equal(d["p"]["w"], torch.from_numpy(np.asarray(j["p"]["w"])))
    assert d["c"].shape == () and int(d["c"]) == 7
    t_ckpt.save(str(tmp_path), 4, torch.arange(5.0))
    assert torch.equal(t_ckpt.restore_dict(str(tmp_path), 4, device="cpu"), torch.arange(5.0))


def test_checkpoint_roundtrip_and_atomic_write(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)},
            "step": torch.tensor(7)}
    path = t_ckpt.save(str(tmp_path), 7, tree)
    assert os.path.basename(path) == "step_00000007.npz"
    assert sorted(os.listdir(tmp_path)) == ["step_00000007.json", "step_00000007.npz"]
    out = t_ckpt.restore(str(tmp_path), 7, tree)
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    assert torch.equal(out["step"], tree["step"])


def test_checkpoint_shape_mismatch_raises(tmp_path):
    t_ckpt.save(str(tmp_path), 1, {"w": torch.ones((2, 2))})
    with pytest.raises(ValueError, match="shape mismatch"):
        t_ckpt.restore(str(tmp_path), 1, {"w": torch.ones((3, 3))})


def test_latest_step_empty(tmp_path):
    assert t_ckpt.latest_step(str(tmp_path / "nope")) is None
    assert t_ckpt.latest_step(str(tmp_path)) is None


def test_restore_onto_shardings_raises_naming_roadmap(tmp_path):
    """``restore(shardings=)`` places each leaf by its ``NamedSharding``: on
    the host mesh (a ``SoloMesh``) the leaves come back as saved, and a
    checkpoint the JAX package wrote restores onto shardings to the JAX
    restore's values (``tests/test_torch_sharding.py`` restores onto 8
    gloo ranks)."""
    from repro.launch.mesh import make_host_mesh as j_host_mesh
    from repro.sharding.rules import make_shardings as j_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.rules import P, make_shardings

    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(4, 2)).astype(np.float32),
            "b": rng.normal(size=(2,)).astype(np.float32)}
    j_ckpt.save(str(tmp_path), 1, {k: jnp.asarray(v) for k, v in tree.items()})
    like = {k: torch.zeros(v.shape) for k, v in tree.items()}
    sh = make_shardings(make_host_mesh(), {"w": P("data", "model"), "b": P()})
    out = t_ckpt.restore(str(tmp_path), 1, like, shardings=sh)
    from jax.sharding import PartitionSpec as JP

    jsh = j_shardings(j_host_mesh(), {"w": JP("data", "model"), "b": JP()})
    ref = j_ckpt.restore(str(tmp_path), 1, {k: jnp.zeros(v.shape) for k, v in tree.items()},
                         shardings=jsh)
    for k in tree:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_array_equal(out[k].numpy(), tree[k])


# ----------------------------------------------------------------------------
# The LM token stream (tests/test_data_checkpoint.py's cases)
# ----------------------------------------------------------------------------


def test_lm_batch_deterministic():
    b1 = synthetic_lm_batch(torch.Generator().manual_seed(7), 4, 32, 100, device="cpu")
    b2 = synthetic_lm_batch(torch.Generator().manual_seed(7), 4, 32, 100, device="cpu")
    assert torch.equal(b1["tokens"], b2["tokens"])
    s1 = synthetic_lm_batches(3, 4, 16, 50, device="cpu")
    s2 = synthetic_lm_batches(3, 4, 16, 50, device="cpu")
    for _ in range(3):
        assert torch.equal(next(s1)["tokens"], next(s2)["tokens"])


def test_lm_batch_has_structure():
    """tok_{t+1} = (7·tok_t + 1) mod V for ~90% of steps — learnable."""
    toks = synthetic_lm_batch(torch.Generator().manual_seed(0), 8, 128, 97,
                              device="cpu")["tokens"].numpy()
    assert toks.dtype == np.int64 and toks.min() >= 0 and toks.max() < 97
    assert np.mean((7 * toks[:, :-1] + 1) % 97 == toks[:, 1:]) > 0.8


def test_lm_batch_is_the_reference_recurrence():
    """The unrolled construction equals the reference's scan, step by step,
    on the same draws."""
    B, T, V = 3, 70, 101
    gen = torch.Generator().manual_seed(11)
    first = torch.randint(0, V, (B, 1), generator=gen)
    noise = torch.randint(0, V, (B, T), generator=gen)
    keep = torch.rand((B, T), generator=gen) < 0.1
    tok, out = first[:, 0], []
    for t in range(T):
        tok = torch.where(keep[:, t], noise[:, t], (7 * tok + 1) % V)
        out.append(tok)
    got = synthetic_lm_batch(torch.Generator().manual_seed(11), B, T, V, device="cpu")
    assert torch.equal(got["tokens"], torch.stack(out, dim=1))


def test_labels_are_shifted_tokens():
    b = synthetic_lm_batch(torch.Generator().manual_seed(1), 2, 16, 50, device="cpu")
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert torch.equal(b["labels"][:, -1], b["tokens"][:, 0])


def test_stream_shards_disjoint():
    it0 = synthetic_lm_batches(0, 8, 16, 100, shard_index=0, num_shards=2, device="cpu")
    it1 = synthetic_lm_batches(0, 8, 16, 100, shard_index=1, num_shards=2, device="cpu")
    b0, b1 = next(it0), next(it1)
    assert b0["tokens"].shape == (4, 16)
    assert not torch.equal(b0["tokens"], b1["tokens"])
    assert not torch.equal(next(it0)["tokens"], b0["tokens"])
    with pytest.raises(ValueError):
        next(synthetic_lm_batches(0, 5, 16, 100, num_shards=2, device="cpu"))
