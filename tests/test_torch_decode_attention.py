"""Port parity: single-token decode attention of ``repro_torch`` against the
JAX package's ``kernels/decode_attention``.

On the CPU the port's ``ops.decode_attention`` takes the kernel's plain
version (``ref.decode_attention_plain``), the function ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold the CUDA kernel to on the card.  The
JAX side runs as its own tests run it on the CPU: the Pallas kernel in
interpret mode, ``decode_attention_xla`` and ``ref.decode_attention_ref``.
Inputs are made with numpy from a seed and handed to both packages.
Tolerances are the JAX package's own (``tests/test_kernels_decode.py``):
2e-5 in f32, 3e-2 in bf16.  The port is not held bitwise to
``decode_attention_xla``: the reference's own bitwise claim does not hold
under jax 0.9.0 (ROADMAP.md queue 3, item 1).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import ops as j_ops  # noqa: E402
from repro.kernels.decode_attention import ref as j_ref  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as t_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ops as t_ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref as t_ref  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 3e-2

# (B, S, Hq, Hkv, D, valid): the CASES of tests/test_kernels_decode.py
CASES = [
    (2, 256, 8, 2, 32, 100),
    (1, 512, 4, 4, 64, 512),
    (3, 128, 4, 1, 16, 1),
    (2, 300, 8, 4, 32, 257),
]


def _inputs(seed, B, S, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _max_diff(jax_out, torch_out) -> float:
    return float(np.max(np.abs(
        np.asarray(jax_out, dtype=np.float32) - torch_out.float().numpy())))


@pytest.mark.parametrize("case", CASES, ids=str)
def test_decode_matches_jax_kernel_and_ref(case):
    B, S, Hq, Hkv, D, vl = case
    q, k, v = _inputs(sum(case), B, S, Hq, Hkv, D)
    out = t_ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), vl)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    assert _max_diff(j_ops.decode_attention(jq, jk, jv, jnp.asarray(vl), bk=64), out) < F32_TOL
    assert _max_diff(j_ref.decode_attention_ref(jq, jk, jv, vl), out) < F32_TOL


@pytest.mark.parametrize("case", CASES, ids=str)
def test_decode_close_to_jax_xla_mirror(case):
    B, S, Hq, Hkv, D, vl = case
    q, k, v = _inputs(sum(case) + 1, B, S, Hq, Hkv, D)
    out = t_ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), vl)
    exp = j_ops.decode_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl))
    assert _max_diff(exp, out) < F32_TOL


def test_per_row_valid_lengths():
    B, S, Hq, Hkv, D = 3, 128, 4, 2, 32
    q, k, v = _inputs(0, B, S, Hq, Hkv, D)
    vl = np.asarray([5, 64, 128], np.int32)
    out = t_ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(vl))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    assert _max_diff(j_ops.decode_attention(jq, jk, jv, jnp.asarray(vl), bk=32), out) < F32_TOL
    assert _max_diff(j_ref.decode_attention_ref(jq, jk, jv, jnp.asarray(vl)), out) < F32_TOL


def test_bf16_cache():
    B, S, Hq, Hkv, D = 2, 256, 8, 2, 32
    q, k, v = _inputs(1, B, S, Hq, Hkv, D)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    out = t_ops.decode_attention(tq, tk, tv, 200)
    assert out.dtype == torch.bfloat16
    assert _max_diff(j_ops.decode_attention(jq, jk, jv, jnp.asarray(200), bk=64), out) < BF16_TOL
    assert _max_diff(j_ref.decode_attention_ref(jq, jk, jv, 200), out) < BF16_TOL


@pytest.mark.parametrize("case", CASES, ids=str)
def test_port_ref_matches_jax_ref(case):
    B, S, Hq, Hkv, D, vl = case
    q, k, v = _inputs(sum(case) + 2, B, S, Hq, Hkv, D)
    out = t_ref.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), vl)
    exp = j_ref.decode_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), vl)
    assert _max_diff(exp, out) < F32_TOL


def test_empty_row_gives_zero_like_the_kernel():
    """valid_len 0: the kernel's divide is guarded by l > 0, so the row is
    0 (the softmax oracle gives NaN there)."""
    q, k, v = _inputs(3, 2, 64, 4, 2, 16)
    vl = np.asarray([0, 64], np.int32)
    out = t_ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(vl))
    exp = j_ops.decode_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl))
    assert bool((out[0] == 0).all()) and np.all(np.asarray(exp)[0] == 0)
    assert _max_diff(exp, out) < F32_TOL


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros((1, 4, 8))
    k = torch.zeros((1, 16, 2, 8))
    with pytest.raises(ValueError, match="CUDA tensor"):
        t_kernel.decode_attention(q, k, k, torch.ones((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        t_ops.decode_attention(q.to("meta"), k.to("meta"), k.to("meta"), 1)


# (B, S, Hq, Hkv, D, chunk, lengths): splits of one key, of a tile and of
# all of S; a row of length 0, and rows whose later splits lie wholly past
# their length
SPLIT_CASES = [
    (2, 70, 4, 2, 16, 1, [0, 37]),
    (3, 256, 8, 2, 32, 64, [0, 100, 256]),
    (2, 300, 8, 4, 32, 64, [257, 5]),
    (3, 128, 4, 1, 16, 128, [1, 0, 128]),
    (2, 200, 12, 2, 128, 64, [63, 200]),
]


def _split_inputs(case, dtype):
    B, S, Hq, Hkv, D, _, lens = case
    q, k, v = _inputs(S + D, B, S, Hq, Hkv, D)
    vl = np.asarray(lens, np.int32)
    tt = [torch.from_numpy(a).to(dtype) for a in (q, k, v)]
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jj = [jnp.asarray(a).astype(jd) for a in (q, k, v)]
    return tt, jj, vl


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_and_merge_plain_matches_plain_and_jax_kernel(case, dtype):
    """The split kernel's arithmetic (partials per run of ``chunk`` keys,
    then the merge) against the single-pass plain version and the JAX
    kernel in interpret mode, at the JAX package's limits."""
    (tq, tk, tv), (jq, jk, jv), vl = _split_inputs(case, dtype)
    chunk = case[5]
    out = t_ref.decode_attention_split_plain(tq, tk, tv, torch.from_numpy(vl), chunk)
    assert out.dtype == dtype and out.shape == tq.shape
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    plain = t_ref.decode_attention_plain(tq, tk, tv, torch.from_numpy(vl))
    assert float((out.float() - plain.float()).abs().max()) < tol
    exp = j_ops.decode_attention(jq, jk, jv, jnp.asarray(vl), bk=64)
    assert _max_diff(jnp.asarray(exp).astype(jnp.float32), out) < tol
    assert bool((out[torch.from_numpy(vl) == 0] == 0).all())


@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_split_partials_past_valid_len_are_empty(case):
    """A split that starts at or past a row's length is the empty partial
    (m = −1e30, l = 0, acc = 0) the kernel writes; the others carry keys."""
    (tq, tk, tv), _, vl = _split_inputs(case, torch.float32)
    B, S, Hq, _, D, chunk, lens = case
    part_acc, part_ml = t_ref.decode_partials_plain(tq, tk, tv, torch.from_numpy(vl), chunk)
    n_split = -(-S // chunk)
    assert part_acc.shape == (B * Hq, n_split, D) and part_ml.shape == (B * Hq, n_split, 2)
    starts = torch.arange(n_split) * chunk
    empty = starts[None, :] >= torch.as_tensor(lens).repeat_interleave(Hq)[:, None]
    assert bool((part_ml[..., 0][empty] == t_ref.NEG_INF).all())
    assert bool((part_ml[..., 1][empty] == 0).all() and (part_acc[empty] == 0).all())
    assert bool((part_ml[..., 1][~empty] > 0).all())


def test_merge_plain_of_one_split_is_the_single_pass():
    """With one split the merge's weight is exp(0) = 1: the divide of the
    single-pass version, bitwise."""
    (tq, tk, tv), _, vl = _split_inputs(SPLIT_CASES[1], torch.float32)
    S = tk.shape[1]
    out = t_ref.decode_attention_split_plain(tq, tk, tv, torch.from_numpy(vl), S)
    assert torch.equal(out, t_ref.decode_attention_plain(tq, tk, tv, torch.from_numpy(vl)))


@pytest.mark.parametrize("B,Hkv,S,sms", [(16, 4, 1024, 132), (2, 2, 256, 132),
                                         (16, 4, 40, 132), (1, 1, 100000, 132),
                                         (8, 2, 4096, 114), (3, 2, 200, 132)])
def test_plan_splits(B, Hkv, S, sms):
    """The split width is the tile times a power of two, the splits cover S
    exactly once, and there are at least two blocks an SM wherever S has
    enough tiles for them."""
    chunk, n_split = t_kernel.plan_splits(B, Hkv, S, sms)
    tile = t_kernel.TILE
    assert chunk % tile == 0 and (chunk // tile) & (chunk // tile - 1) == 0
    assert (n_split - 1) * chunk < S <= n_split * chunk
    if B * Hkv * -(-S // tile) >= t_kernel.BLOCKS_PER_SM * sms:
        assert B * Hkv * n_split >= t_kernel.BLOCKS_PER_SM * sms
    if (B, Hkv, S, sms) == (16, 4, 1024, 132):  # the serving shape: 512 blocks
        assert (chunk, n_split) == (128, 8)
