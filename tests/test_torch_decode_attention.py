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
