"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device and ``nvcc`` (marked ``cuda``; skipped elsewhere).
Imports no JAX, so it runs on a machine with the card alone::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.decode_attention import kernel as da_kernel  # noqa: E402
from repro_torch.kernels.decode_attention import ref as da_ref  # noqa: E402
from repro_torch.kernels.int8_quant import kernel as q8_kernel  # noqa: E402
from repro_torch.kernels.int8_quant import ref as q8_ref  # noqa: E402
from repro_torch.kernels.topk_compress import kernel as tk_kernel  # noqa: E402
from repro_torch.kernels.topk_compress import ref as tk_ref  # noqa: E402

SHAPES = [(1, 257), (1, 8193), (16, 2000), (3, 1001), (2, 1 << 20)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def same_bits(a, b) -> bool:
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_bitwise_with_plain_versions(cuda, shape):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda)
    n = shape[1]
    for k in sorted({1, max(1, n // 100), n}):
        t = torch.topk(x.abs(), k, dim=1).values[:, -1].contiguous()
        for with_residual in (True, False):
            before = dict(kernels.LAUNCHES)
            o, res, cnt = tk_kernel.encode_threshold(x, t, with_residual=with_residual)
            o_r, res_r, cnt_r = tk_ref.encode_threshold_ref(
                x, t, with_residual=with_residual)
            name = "topk_encode" if with_residual else "topk_select"
            assert kernels.LAUNCHES[name] == before[name] + 1
            assert same_bits(o, o_r) and torch.equal(cnt, cnt_r)
            assert (res is None) == (not with_residual)
            if with_residual:
                assert same_bits(res, res_r)
    m = q8_kernel.absmax(x)
    assert same_bits(m, q8_ref.absmax_ref(x))
    s = torch.clamp_min(m, 1e-12) * (1.0 / 127.0)
    assert same_bits(q8_kernel.quant_dequant(x, s), q8_ref.quant_dequant_ref(x, s))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_wrappers_refuse_bad_operands(cuda):
    x = torch.zeros((2, 300), device=cuda)
    with pytest.raises(ValueError, match="float32"):
        q8_kernel.absmax(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        q8_kernel.absmax(x.t())
    with pytest.raises(ValueError, match="aligned"):
        q8_kernel.absmax(x.view(-1)[1:599].view(2, 299))
    with pytest.raises(ValueError, match="CUDA"):
        q8_kernel.absmax(x.cpu())
    with pytest.raises(ValueError, match="threshold"):
        tk_kernel.encode_threshold(x, torch.zeros(3, device=cuda), with_residual=True)


# (B, S, Hq, Hkv, D): the JAX package's decode test shapes, the serving
# shape of tinyllama-1.1b (G 8, D 64) and qwen2-1.5b's heads (G 6, D 128)
DECODE_SHAPES = [
    (2, 256, 8, 2, 32), (1, 512, 4, 4, 64), (3, 128, 4, 1, 16),
    (2, 300, 8, 4, 32), (4, 1024, 32, 4, 64), (3, 200, 12, 2, 128),
    (2, 70, 2, 2, 8),
]
#: |kernel - plain| limits: the JAX package's own decode-test tolerances
DECODE_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _decode_inputs(device, shape, dtype, seed):
    B, S, Hq, Hkv, D = shape
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g, device=device).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=g, device=device).to(dtype)
    # 0, 1, S and a length that is no multiple of any tile, per row
    lens = [0, 1, S, (S * 5) // 7 + 3][:B] + [S] * max(0, B - 4)
    vl = torch.tensor(lens, dtype=torch.int32, device=device).clamp(max=S)
    return q, k, v, vl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DECODE_SHAPES, ids=str)
def test_decode_attention_kernel_vs_plain(cuda, shape, dtype):
    q, k, v, vl = _decode_inputs(cuda, shape, dtype, sum(shape))
    before = kernels.LAUNCHES["decode_attention"]
    out = da_kernel.decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attention"] == before + 1
    plain = da_ref.decode_attention_plain(q, k, v, vl)
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - plain.float()).abs().max())
    assert err <= DECODE_TOL[dtype], err
    # a row with no valid key gives 0, as the plain version does
    if int(vl[0]) == 0:
        assert bool((out[0] == 0).all())


@pytest.mark.cuda
def test_decode_attention_refuses_bad_operands(cuda):
    q = torch.zeros((2, 8, 64), device=cuda)
    k = torch.zeros((2, 16, 2, 64), device=cuda)
    vl = torch.ones((2,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da_kernel.decode_attention(q.double(), k.double(), k.double(), vl)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        da_kernel.decode_attention(q, k.bfloat16(), k.bfloat16(), vl)
    with pytest.raises(ValueError, match="contiguous"):
        da_kernel.decode_attention(q.transpose(0, 1), k, k, vl)
    with pytest.raises(ValueError, match="no kernel for G=3"):
        da_kernel.decode_attention(q[:, :6].contiguous(), k, k, vl)
    with pytest.raises(ValueError, match="no kernel for G=4, D=48"):
        da_kernel.decode_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                                   k[..., :48].contiguous(), vl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        da_kernel.decode_attention(q, k.cpu(), k, vl)
    with pytest.raises(ValueError, match="valid_len"):
        da_kernel.decode_attention(q, k, k, vl.long())
