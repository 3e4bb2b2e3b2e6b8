"""The port's CUDA kernels against their plain versions on the card.

Needs a CUDA device and ``nvcc`` (marked ``cuda``; skipped elsewhere).
Imports no JAX, so it runs on a machine with the card alone::

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
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
