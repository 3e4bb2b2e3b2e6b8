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
    # past grid.y's 65,535 blocks the kernels loop over rows: 65,536 rows
    # are taken, 0 rows still refused
    many = torch.zeros((65536, 4), device=cuda)
    assert q8_kernel.absmax(many).shape == (65536,)
    with pytest.raises(ValueError, match="unsupported shape"):
        q8_kernel.absmax(many[:0])


# (B, S, Hq, Hkv, D): the JAX package's decode test shapes, the serving
# shape of tinyllama-1.1b (G 8, D 64), qwen2-1.5b's heads (G 6, D 128),
# olmoe-1b-7b's heads (MHA: G 1, D 128), S within one tile (a single split);
# then the public head layouts past the first kernel's list: Gemma-2B (8 / 1
# at D 256), Qwen2-7B (G 7), StarCoder2-3B (G 12), Falcon-7B (MQA, G 71),
# Phi-3-mini (D 96), G 128, and odd groups and widths (G 3, 5, 12; D 24, 40,
# 80; D 256 in f32 at G 7)
DECODE_SHAPES = [
    (2, 256, 8, 2, 32), (1, 512, 4, 4, 64), (3, 128, 4, 1, 16),
    (2, 300, 8, 4, 32), (4, 1024, 32, 4, 64), (3, 200, 12, 2, 128),
    (2, 70, 2, 2, 8), (3, 40, 4, 2, 16), (4, 512, 16, 16, 128),
    (3, 300, 8, 1, 256), (2, 200, 28, 4, 128), (2, 200, 24, 2, 128), (3, 300, 71, 1, 64),
    (2, 200, 32, 32, 96), (2, 130, 128, 1, 64), (3, 130, 3, 1, 24), (2, 100, 10, 2, 40),
    (3, 150, 12, 1, 80), (2, 100, 7, 1, 256),
]
#: (B, S, Hq, Hkv, D) whose D is no multiple of 8: ``ops`` pads the heads
DECODE_PADDED_SHAPES = [(2, 90, 6, 2, 36), (3, 70, 5, 1, 20), (2, 64, 2, 1, 100)]
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
    before = dict(kernels.LAUNCHES)
    out = da_kernel.decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    assert kernels.LAUNCHES["decode_attention_merge"] == before["decode_attention_merge"] + 1
    plain = da_ref.decode_attention_plain(q, k, v, vl)
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    err = float((out.float() - plain.float()).abs().max())
    assert err <= DECODE_TOL[dtype], err
    # a row with no valid key gives 0, as the plain version does
    if int(vl[0]) == 0:
        assert bool((out[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", DECODE_PADDED_SHAPES, ids=str)
def test_decode_attention_pads_odd_head_widths(cuda, shape, dtype):
    """A D that is no multiple of 8 is padded with zero columns by ``ops``
    (counted in ``kernels.PADS``), runs the kernel at the true width's
    scale and matches the plain version at the true width."""
    from repro_torch.kernels.decode_attention import ops as da_ops

    q, k, v, vl = _decode_inputs(cuda, shape, dtype, sum(shape))
    before, pads = dict(kernels.LAUNCHES), kernels.PADS["decode_attention"]
    out = da_ops.decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    assert kernels.PADS["decode_attention"] == pads + 1
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    plain = da_ref.decode_attention_plain(q, k, v, vl)
    assert float((out.float() - plain.float()).abs().max()) <= DECODE_TOL[dtype]


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
    # G 3 and D 48 were refused by the first kernel's list; both now run
    for qq, kk in ((q[:, :6].contiguous(), k), (q[..., :48].contiguous(),
                                                 k[..., :48].contiguous())):
        qq, kk = qq.normal_(), kk.normal_()
        got = da_kernel.decode_attention(qq, kk, kk, vl)
        want = da_ref.decode_attention_plain(qq, kk, kk, vl)
        assert float((got - want).abs().max()) <= DECODE_TOL[torch.float32]
    # past the widest head, with the domain in the message
    with pytest.raises(ValueError, match="no kernel for D=264.*up to 256"):
        da_kernel.decode_attention(q.new_zeros((2, 8, 264)), k.new_zeros((2, 16, 2, 264)),
                                   k.new_zeros((2, 16, 2, 264)), vl)
    with pytest.raises(ValueError, match="no kernel for D=36.*multiple of 8"):
        da_kernel.decode_attention(q.new_zeros((2, 8, 36)), k.new_zeros((2, 16, 2, 36)),
                                   k.new_zeros((2, 16, 2, 36)), vl)
    with pytest.raises(ValueError, match="CUDA tensor"):
        da_kernel.decode_attention(q, k.cpu(), k, vl)
    with pytest.raises(ValueError, match="valid_len"):
        da_kernel.decode_attention(q, k, k, vl.long())
    with pytest.raises(ValueError, match="no multiple of 64"):
        da_kernel.decode_partials(q, k, k, vl, 8)
    parts = (torch.zeros((16, 2, 64), device=cuda), torch.zeros((16, 2, 2), device=cuda))
    with pytest.raises(ValueError, match="float32"):
        da_kernel.decode_merge(parts[0].bfloat16(), parts[1], torch.float32)
    with pytest.raises(ValueError, match=r"\(16, 2, 2\)"):
        da_kernel.decode_merge(parts[0], parts[1][:, :, :1].contiguous(), torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        da_kernel.decode_merge(*parts, torch.float16)


#: (B, S, Hq, Hkv, D, chunk): a split of one tile, splits past every row's
#: length, and a ragged last split
SPLIT_CASES = [(2, 256, 8, 2, 32, 64), (3, 300, 12, 2, 128, 128), (4, 1024, 32, 4, 64, 192),
               (2, 130, 2, 2, 8, 64), (2, 300, 8, 1, 256, 128), (2, 200, 71, 1, 64, 64),
               (2, 200, 20, 4, 80, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=str)
def test_decode_split_and_merge_vs_plain(cuda, case, dtype):
    """The split kernel's partials against ``decode_partials_plain`` and the
    merge against ``decode_merge_plain`` on the same partials."""
    *shape, chunk = case
    q, k, v, vl = _decode_inputs(cuda, tuple(shape), dtype, sum(case))
    vl[-1] = min(int(vl[-1]), chunk - 1)  # the later splits of that row are empty
    before = dict(kernels.LAUNCHES)
    part_acc, part_ml = da_kernel.decode_partials(q, k, v, vl, chunk)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    want_acc, want_ml = da_ref.decode_partials_plain(q, k, v, vl, chunk)
    empty = want_ml[..., 1] == 0
    assert bool(empty.any()) and bool((~empty).any())
    assert bool((part_ml[..., 0][empty] == -1e30).all() and (part_ml[..., 1][empty] == 0).all())
    assert bool((part_acc[empty] == 0).all())
    full = ~empty
    assert float((part_ml[..., 0] - want_ml[..., 0])[full].abs().max()) <= 1e-4
    rel_l = (part_ml[..., 1] - want_ml[..., 1]) / want_ml[..., 1].clamp_min(1e-30)
    assert float(rel_l[full].abs().max()) <= 1e-4
    got = part_acc / part_ml[..., 1:].clamp_min(1e-30)
    want = want_acc / want_ml[..., 1:].clamp_min(1e-30)
    assert float((got - want)[full].abs().max()) <= DECODE_TOL[dtype]
    out = da_kernel.decode_merge(part_acc, part_ml, dtype)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attention_merge"] == before["decode_attention_merge"] + 1
    assert out.dtype == dtype and out.shape == (q.shape[0] * q.shape[1], q.shape[2])
    plain = da_ref.decode_merge_plain(part_acc, part_ml, dtype)
    assert float((out.float() - plain.float()).abs().max()) <= DECODE_TOL[dtype]
    full_plain = da_ref.decode_attention_plain(q, k, v, vl).reshape(out.shape)
    assert float((out.float() - full_plain.float()).abs().max()) <= DECODE_TOL[dtype]
    assert bool((out.view(q.shape)[vl == 0] == 0).all())


@pytest.mark.cuda
def test_decode_attention_replays_in_a_cuda_graph(cuda):
    """The split kernel and the merge captured in a CUDA graph replay to
    the eager result, bitwise, and read the valid lengths at each replay."""
    shape = (16, 1024, 32, 4, 64)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert da_kernel.plan_splits(16, 4, 1024, sms)[1] > 1
    q, k, v, _ = _decode_inputs(cuda, shape, torch.bfloat16, 5)
    vl = torch.full((16,), 1024, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        da_kernel.decode_attention(q, k, v, vl)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = dict(kernels.LAUNCHES)
    with torch.cuda.graph(graph):
        out = da_kernel.decode_attention(q, k, v, vl)
    assert kernels.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    assert kernels.LAUNCHES["decode_attention_merge"] == before["decode_attention_merge"] + 1
    for lens in ([1024] * 16, [0, 1, 63, 64, 65, 191, 192, 193, 500, 640, 700, 900, 1000,
                               1023, 1024, 2]):
        vl.copy_(torch.tensor(lens, dtype=torch.int32))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, da_kernel.decode_attention(q, k, v, vl))
        plain = da_ref.decode_attention_plain(q, k, v, vl)
        assert float((out.float() - plain.float()).abs().max()) <= DECODE_TOL[torch.bfloat16]


# (N, K, d): the JAX package's pdist test shapes, K = 1, the design limit
# K 1024 × d 512, a dimension past the CUDA-core kernel's register tile (d
# 130), a chunk of the KDD Cup 1999 shape, N off that kernel's 256-point
# pass at K 1,000 and at an odd K and d, and a k-means-sized input on which
# each of its blocks makes several passes
PDIST_SHAPES = [
    (500, 16, 8), (300, 7, 5), (260, 5, 3), (128, 32, 64), (1000, 3, 2), (65, 4, 4),
    (777, 1, 9), (600, 1024, 512), (333, 40, 130), (8192, 1000, 42), (3001, 1000, 42),
    (513, 33, 17), (200003, 32, 42),
]
#: |kernel − plain| ≤ atol + rtol·|plain|: the JAX pdist test's jnp.allclose
PDIST_ATOL = PDIST_RTOL = 1e-5


def _pdist_gap_ok(X, C, metric, tol):
    """Where the plain version's top-2 gap exceeds ``tol`` the indices must
    agree; returns that mask (computed in chunks on the card)."""
    from repro_torch.ml.clustering import pdist

    m = {"l2": "l2sq"}.get(metric, metric)
    ok = []
    for s in range(0, X.shape[0], 1024):
        D = pdist(X[s:s + 1024].float(), C.float(), m)
        top = torch.topk(D, min(2, D.shape[1]), dim=1, largest=False).values
        gap = top[:, 1] - top[:, 0] if D.shape[1] > 1 else torch.full_like(top[:, 0], 1e30)
        ok.append(gap > tol[s:s + 1024])
    return torch.cat(ok)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l2", "l1", "linf"])
@pytest.mark.parametrize("shape", PDIST_SHAPES, ids=str)
def test_pdist_argmin_kernel_vs_plain(cuda, shape, metric, dtype):
    from repro_torch.kernels.pdist_argmin import kernel as pd_kernel
    from repro_torch.kernels.pdist_argmin import ref as pd_ref

    N, K, d = shape
    g = torch.Generator(device=cuda).manual_seed(N + K + d)
    X = torch.randn((N, d), generator=g, device=cuda).to(dtype)
    C = torch.randn((K, d), generator=g, device=cuda).to(dtype)
    before = dict(kernels.LAUNCHES)
    idx, dist = pd_kernel.pdist_argmin(X, C, metric)
    torch.cuda.synchronize()
    name = pd_kernel.route(metric)
    assert kernels.LAUNCHES[name] == before[name] + 1
    assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    ref_idx, ref_dist = [], []
    for s in range(0, N, 1024):  # the plain version materialises (n, K, d)
        i, dd = pd_ref.pdist_argmin_ref(X[s:s + 1024], C, metric)
        ref_idx.append(i)
        ref_dist.append(dd)
    ref_idx, ref_dist = torch.cat(ref_idx), torch.cat(ref_dist)
    tol = PDIST_ATOL + PDIST_RTOL * ref_dist.abs()
    assert bool(((dist - ref_dist).abs() <= tol).all())
    clear = _pdist_gap_ok(X, C, metric, tol)
    assert bool((idx == ref_idx)[clear].all())
    if metric == "linf":
        # one rounding per term and an exact max: bitwise, ties included
        assert torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)
    elif dtype == torch.float32:
        assert float(clear.float().mean()) > 0.99


def _pdist_in_order(X, C, metric):
    """l1 or l∞ with each centroid's terms added (or maxed) over j in
    increasing order, one f32 operation a term, the first index of the
    least: the CUDA-core kernel's order of operations."""
    Xf, Cf = X.float(), C.float()
    acc = torch.zeros((X.shape[0], C.shape[0]), device=X.device)
    for j in range(X.shape[1]):
        term = (Xf[:, j, None] - Cf[None, :, j]).abs()
        acc = acc + term if metric == "l1" else torch.maximum(acc, term)
    return torch.argmin(acc, dim=1).to(torch.int32), torch.amin(acc, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l1", "linf"])
@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "unaligned"])
@pytest.mark.parametrize("shape", [(3001, 1000, 42), (513, 33, 17), (300, 70, 130),
                                   (1000, 5, 64), (257, 3, 1), (200003, 32, 42)], ids=str)
def test_pdist_cuda_cores_adds_in_increasing_j(cuda, shape, metric, dtype, aligned):
    """The l1/l∞ kernel's results are bitwise those of adding each
    centroid's terms in increasing j and taking the first least index, at
    shapes where C is staged whole, the point tile is ragged, d passes the
    register tile, and each block makes several 256-point passes (200,003
    points: about five a block on 132 SMs, the last one short); with X
    starting on 16 bytes (vector loads) and one element past it (scalar
    loads)."""
    from repro_torch.kernels.pdist_argmin import kernel as pd_kernel

    N, K, d = shape
    g = torch.Generator(device=cuda).manual_seed(N + K + d)
    flat = (3.0 * torch.randn((N * d + 1,), generator=g, device=cuda)).to(dtype)
    X = flat[:N * d].view(N, d) if aligned else flat[1:].view(N, d)
    assert (X.data_ptr() % 16 == 0) == aligned
    C = X[torch.randperm(N, generator=g, device=cuda)[:K]].clone() if K < N else X[:K]
    idx, dist = pd_kernel.pdist_argmin(X, C, metric)
    want_idx, want_dist = _pdist_in_order(X, C, metric)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx)
    assert torch.equal(dist.view(torch.int32), want_dist.view(torch.int32))


#: (N, K, d) past one staged centroid row (d > 58,108): the split kernel,
#: one centroid group and two (K 20), and the KDD-sized N with a ragged tile
PDIST_WIDE_SHAPES = [(600, 16, 58_109), (300, 16, 100_000), (257, 20, 70_001)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("metric", ["l1", "linf"])
@pytest.mark.parametrize("shape", PDIST_WIDE_SHAPES, ids=str)
def test_pdist_cuda_cores_wide_rows_vs_plain(cuda, shape, metric, dtype):
    """Rows wider than a staged centroid row run the split kernel and its
    merge (one count a call): each point sits near one centroid, so the
    indices are the plain version's, and the distances are within its
    atol + rtol (l∞ exactly: a max in any order is the same)."""
    from repro_torch.kernels.pdist_argmin import kernel as pd_kernel
    from repro_torch.kernels.pdist_argmin import ref as pd_ref

    N, K, d = shape
    g = torch.Generator(device=cuda).manual_seed(N + K + d)
    C = torch.randn((K, d), generator=g, device=cuda)
    near = torch.randint(0, K, (N,), generator=g, device=cuda)
    X = (C[near] + 0.1 * torch.randn((N, d), generator=g, device=cuda)).to(dtype)
    C = C.to(dtype)
    before = kernels.LAUNCHES["pdist_argmin"]
    idx, dist = pd_kernel.pdist_argmin(X, C, metric)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["pdist_argmin"] == before + 1
    ref_idx, ref_dist = [], []
    for s in range(0, N, 32):  # the plain version materialises (n, K, d)
        i, dd = pd_ref.pdist_argmin_ref(X[s:s + 32], C, metric)
        ref_idx.append(i)
        ref_dist.append(dd)
    ref_idx, ref_dist = torch.cat(ref_idx), torch.cat(ref_dist)
    assert torch.equal(idx, ref_idx) and torch.equal(idx, near.to(torch.int32))
    tol = PDIST_ATOL + PDIST_RTOL * ref_dist.abs()
    assert bool(((dist - ref_dist).abs() <= tol).all())
    if metric == "linf":
        assert torch.equal(dist, ref_dist)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "l1", "linf"])
def test_pdist_argmin_kernel_ties_take_the_first_index(cuda, metric):
    from repro_torch.kernels.pdist_argmin import kernel as pd_kernel

    g = torch.Generator(device=cuda).manual_seed(3)
    X = torch.randn((1000, 20), generator=g, device=cuda)
    C = torch.randn((40, 20), generator=g, device=cuda)
    idx, dist = pd_kernel.pdist_argmin(X, C, metric)
    # rows 40..79 repeat rows 0..39, and 80..119 once more, across tiles
    idx3, dist3 = pd_kernel.pdist_argmin(X, torch.cat([C, C, C]), metric)
    assert torch.equal(idx3, idx) and torch.equal(dist3, dist)


@pytest.mark.cuda
def test_pdist_argmin_refuses_bad_operands(cuda):
    from repro_torch.kernels.pdist_argmin import kernel as pd_kernel
    from repro_torch.kernels.pdist_argmin import ops as pd_ops

    X = torch.zeros((10, 4), device=cuda)
    C = torch.zeros((3, 4), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        pd_kernel.pdist_argmin(X.double(), C.double())
    with pytest.raises(ValueError, match="share a type"):
        pd_kernel.pdist_argmin(X, C.bfloat16())
    with pytest.raises(ValueError, match="CUDA tensor"):
        pd_kernel.pdist_argmin(X, C.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        pd_kernel.pdist_argmin(X.t(), C)
    with pytest.raises(ValueError, match="unsupported shapes"):
        pd_kernel.pdist_argmin(X, C[:, :3].contiguous())
    with pytest.raises(ValueError, match="cosine"):
        pd_kernel.pdist_argmin(X, C, "cosine")
    Xt = torch.zeros((4, 10), device=cuda).t()  # (10, 4), not contiguous
    idx, _ = pd_ops.pdist_argmin(Xt, C)  # the ops wrapper makes it contiguous
    assert idx.shape == (10,)


@pytest.mark.cuda
def test_distributed_kmeans_on_card_launches_once_an_iteration(cuda):
    """The §4.1 identity on the card and the kernel's launch count: one
    per EM iteration and one for the final assignment."""
    from repro_torch.ml import clustering

    g = torch.Generator(device=cuda).manual_seed(0)
    means = torch.randn((8, 6), generator=g, device=cuda) * 4.0
    X = means[torch.randint(0, 8, (4 * 500,), generator=g, device=cuda)]
    X = X + torch.randn(X.shape, generator=g, device=cuda)
    C0 = X[torch.randperm(X.shape[0], generator=g, device=cuda)[:8]]
    before = kernels.LAUNCHES["pdist_argmin_tc"]
    rd = clustering.distributed_kmeans(X.reshape(4, 500, 6), C0, num_clusters=8, iters=10)
    assert kernels.LAUNCHES["pdist_argmin_tc"] == before + 11
    rc = clustering.kmeans(X, C0, num_clusters=8, metric="l2sq", iters=10)
    assert torch.allclose(rd.centroids, rc.centroids, atol=1e-4)
    assert float((rd.assignments == rc.assignments).float().mean()) > 0.999
    assert float(rd.inertia) <= float(clustering.nearest(X, C0, "l2sq")[1].sum())


def _pdist_plain(X, C, metric):
    from repro_torch.kernels.pdist_argmin import ref as pd_ref

    out = [pd_ref.pdist_argmin_ref(X[s:s + 1024], C, metric) for s in range(0, X.shape[0], 1024)]
    return torch.cat([i for i, _ in out]), torch.cat([d for _, d in out])


def _adversarial(cuda, dtype, seed=7, N=4099, pairs=32, d=42):
    """Points with ‖x‖² ≈ 1e6 around centroids in pairs 1e-3 apart (in
    bf16 the pair's step rounds to one unit in the last place): the
    expanded form cancels, the direct form does not."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    base = torch.full((d,), 1000.0 / d**0.5, device=cuda)
    centers = base + torch.randn((pairs, d), generator=g, device=cuda)
    step = torch.randn((pairs, d), generator=g, device=cuda)
    step = 1e-3 * step / step.norm(dim=1, keepdim=True)
    C = torch.cat([centers, centers + step]).to(dtype)
    X = (base + torch.randn((N, d), generator=g, device=cuda)).to(dtype)
    return X, C


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pdist_argmin_tc_adversarial(cuda, dtype):
    """Where the expanded form cancels (‖x‖ ≫ ‖x − c‖), the guard re-runs
    the rows in the direct form: the l2 route agrees with the plain
    version, indices equal wherever the top-2 gap clears the tolerance."""
    from repro_torch.kernels.pdist_argmin import kernel as pd_kernel

    X, C = _adversarial(cuda, dtype)
    idx, dist, rechecked = pd_kernel.nearest_l2_tc(X, C)
    ref_idx, ref_dist = _pdist_plain(X, C, "l2")
    tol = PDIST_ATOL + PDIST_RTOL * ref_dist.abs()
    assert bool(((dist - ref_dist).abs() <= tol).all())
    clear = _pdist_gap_ok(X, C, "l2", tol)
    assert bool((idx == ref_idx)[clear].all())
    assert 0 < int(rechecked) <= X.shape[0]


@pytest.mark.cuda
def test_pdist_argmin_routes_by_metric(cuda):
    """l2 takes the tensor-core kernel, l1 and l∞ the CUDA-core one; each
    call moves its route's counter by one and no other."""
    from repro_torch.kernels.pdist_argmin import kernel as pd_kernel
    from repro_torch.kernels.pdist_argmin import ops as pd_ops

    g = torch.Generator(device=cuda).manual_seed(4)
    X = torch.randn((300, 9), generator=g, device=cuda)
    C = torch.randn((70, 9), generator=g, device=cuda)
    assert pd_kernel.ROUTES == {"l2": "pdist_argmin_tc", "l1": "pdist_argmin",
                                "linf": "pdist_argmin"}
    for metric, name in pd_kernel.ROUTES.items():
        before = dict(kernels.LAUNCHES)
        pd_ops.pdist_argmin(X, C, metric=metric)
        assert kernels.LAUNCHES[name] == before[name] + 1
        assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
    with pytest.raises(ValueError, match="l1 and linf"):
        pd_kernel.pdist_argmin_cuda_cores(X, C, "l2")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_pdist_argmin_tc_replays_in_a_cuda_graph(cuda, dtype):
    """The three launches of the l2 route need no host synchronisation: a
    CUDA graph of a call replays bitwise to the eager result, the
    re-checked rows' count included."""
    from repro_torch.kernels.pdist_argmin import kernel as pd_kernel

    X, C = _adversarial(cuda, dtype, N=2000)
    X = torch.cat([X, torch.randn((3000, X.shape[1]), device=cuda).to(dtype) * 300.0])
    idx, dist, rechecked = pd_kernel.nearest_l2_tc(X, C)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        pd_kernel.nearest_l2_tc(X, C)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = pd_kernel.nearest_l2_tc(X, C)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], idx) and torch.equal(out[1].view(torch.int32),
                                                     dist.view(torch.int32))
    assert torch.equal(out[2], rechecked) and int(rechecked) > 0


# (B, T, S, Hq, Hkv, D, causal, window, q_offset): the five shapes of
# tests/test_kernels_flash.py, a query offset with T < S, a window with
# fully masked rows, D 8, tinyllama-1.1b's heads (G 8, D 64) and
# qwen2-1.5b's (G 6, D 128) at a few tiles, a ragged T and S
FLASH_SHAPES = [
    (2, 64, 64, 4, 2, 32, True, 0, 0), (1, 128, 128, 8, 8, 64, True, 0, 0),
    (2, 96, 96, 4, 1, 16, True, 0, 0), (2, 64, 64, 8, 2, 32, True, 24, 0),
    (1, 48, 48, 4, 4, 64, False, 0, 0), (2, 40, 100, 4, 2, 32, True, 0, 60),
    (2, 64, 64, 4, 2, 32, True, 8, 40), (1, 70, 70, 2, 1, 8, True, 0, 0),
    (1, 512, 512, 32, 4, 64, True, 0, 0), (1, 300, 300, 12, 2, 128, True, 0, 0),
    (2, 200, 131, 6, 3, 16, False, 50, 0),
    # head widths past the first kernels' list, causal, windowed and offset:
    # D 24, 40, 80, 96, 192 and Gemma-2B's 8 / 1 heads at D 256
    (2, 130, 130, 4, 2, 24, True, 0, 0), (2, 100, 160, 6, 3, 40, True, 32, 60),
    (1, 200, 200, 4, 1, 80, True, 70, 0), (2, 150, 150, 4, 4, 96, False, 0, 0),
    (1, 140, 200, 4, 2, 192, True, 0, 60), (1, 300, 300, 8, 1, 256, True, 0, 0),
    (2, 100, 180, 2, 1, 256, True, 50, 80), (1, 70, 70, 2, 2, 256, False, 0, 0),
]
#: (B, T, S, Hq, Hkv, D, causal, window, q_offset) whose D is no multiple
#: of 8: ``ops`` pads the heads
FLASH_PADDED_SHAPES = [(2, 100, 100, 4, 2, 36, True, 0, 0), (1, 90, 120, 2, 1, 100, True, 40, 30)]
#: |kernel − plain| limits: the JAX package's flash-test tolerances
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}


def _flash_inputs(device, shape, dtype):
    B, T, S, Hq, Hkv, D = shape[:6]
    g = torch.Generator(device=device).manual_seed(sum(shape[:6]))
    q = torch.randn((B, T, Hq, D), generator=g, device=device).to(dtype)
    k = torch.randn((B, S, Hkv, D), generator=g, device=device).to(dtype)
    v = torch.randn((B, S, Hkv, D), generator=g, device=device).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=str)
def test_flash_attention_kernel_vs_plain(cuda, shape, dtype):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    causal, window, q_offset = shape[6:]
    q, k, v = _flash_inputs(cuda, shape, dtype)
    name = fa_kernel.route(dtype)
    before = dict(kernels.LAUNCHES)
    out = fa_kernel.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before[name] + 1
    # the f32 route launches its prep kernel too
    prep = int(dtype == torch.float32)
    assert kernels.LAUNCHES["flash_attention_tf32_prep"] == (
        before["flash_attention_tf32_prep"] + prep)
    assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1 + prep
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    plain = tr(fa_ref.attention_ref(tr(q), tr(k), tr(v), **kw))
    assert out.dtype == dtype and out.shape == q.shape
    assert bool(torch.isfinite(out).all())
    assert float((out.float() - plain.float()).abs().max()) <= FLASH_TOL[dtype]
    if dtype == torch.bfloat16:  # and the tensor-core kernel's own arithmetic
        own = tr(fa_ref.attention_bf16p(tr(q), tr(k), tr(v), **kw))
        assert float((out.float() - own.float()).abs().max()) <= FLASH_TOL[dtype]
    # rows that see no key give 0, as the plain version's do
    dead = (plain.float() == 0).all(dim=-1)
    assert bool((out[dead] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_PADDED_SHAPES, ids=str)
def test_flash_attention_pads_odd_head_widths(cuda, shape, dtype):
    """A D that is no multiple of 8 is padded with zero columns by ``ops``
    (counted in ``kernels.PADS``), runs the routed kernel at the true
    width's scale and matches the plain version at the true width."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    causal, window, q_offset = shape[6:]
    q, k, v = _flash_inputs(cuda, shape, dtype)
    name = fa_kernel.route(dtype)
    before, pads = kernels.LAUNCHES[name], kernels.PADS["flash_attention"]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out = fa_ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert kernels.PADS["flash_attention"] == pads + 1
    assert out.dtype == dtype and out.shape == q.shape and out.is_contiguous()
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    plain = tr(fa_ref.attention_ref(tr(q), tr(k), tr(v), **kw))
    assert float((out.float() - plain.float()).abs().max()) <= FLASH_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [8, 32, 128, 80, 256])
def test_flash_attention_reads_strided_layouts(cuda, dtype, D):
    """q, k, v as views of one fused projection (the model's layout before
    any copy) give the same result as contiguous copies, bitwise; so does a
    q whose base is one element off 16 bytes (the bf16 kernel stages it by
    plain loads); the ops wrapper's bq/bk change nothing."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ops as fa_ops

    B, T, Hq, Hkv = 2, 150, 8, 2
    g = torch.Generator(device=cuda).manual_seed(7)
    fused = torch.randn((B, T, (Hq + 2 * Hkv) * D), generator=g, device=cuda).to(dtype)
    q = fused[..., :Hq * D].view(B, T, Hq, D)
    k = fused[..., Hq * D:(Hq + Hkv) * D].view(B, T, Hkv, D)
    v = fused[..., (Hq + Hkv) * D:].view(B, T, Hkv, D)
    assert not q.is_contiguous()
    before = kernels.LAUNCHES[fa_kernel.route(dtype)]
    out = fa_ops.flash_attention(q, k, v)
    assert torch.equal(out, fa_ops.flash_attention(q.contiguous(), k.contiguous(),
                                                   v.contiguous()))
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, bq=32, bk=64))
    base = torch.randn((B * T * Hq * D + 1,), generator=g, device=cuda).to(dtype)
    q_off = base[1:].view(B, T, Hq, D)
    assert q_off.data_ptr() % 16
    assert torch.equal(fa_ops.flash_attention(q_off, k, v),
                       fa_ops.flash_attention(q_off.contiguous(), k, v))
    assert kernels.LAUNCHES[fa_kernel.route(dtype)] == before + 5


@pytest.mark.cuda
def test_flash_attention_counts_each_route(cuda):
    """f32 launches the prep kernel and the 3xTF32 kernel, bf16 the bf16
    tensor-core one, each counted under its own name; the two routes agree
    within the bf16 limit on the same values."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    assert fa_kernel.ROUTES == {torch.float32: "flash_attention_tf32",
                                torch.bfloat16: "flash_attention_tc"}
    q, k, v = _flash_inputs(cuda, (2, 256, 256, 8, 2, 64), torch.bfloat16)
    before = dict(kernels.LAUNCHES)
    tc = fa_kernel.flash_attention(q, k, v)
    assert kernels.LAUNCHES["flash_attention_tc"] == before["flash_attention_tc"] + 1
    assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1
    f32 = fa_kernel.flash_attention(q.float(), k.float(), v.float())
    assert kernels.LAUNCHES["flash_attention_tf32"] == before["flash_attention_tf32"] + 1
    assert kernels.LAUNCHES["flash_attention_tf32_prep"] == (
        before["flash_attention_tf32_prep"] + 1)
    assert kernels.LAUNCHES["flash_attention_tc"] == before["flash_attention_tc"] + 1
    torch.cuda.synchronize()
    assert float((tc.float() - f32).abs().max()) <= FLASH_TOL[torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 130, 3, 64), (1, 64, 2, 8), (1, 70, 1, 128),
                                   (2, 5, 2, 16), (3, 100, 2, 32), (2, 70, 2, 40),
                                   (1, 130, 2, 96), (2, 100, 1, 256), (1, 65, 2, 192)], ids=str)
def test_flash_tf32_prep_is_its_plain_version_bitwise(cuda, shape):
    """The f32 route's prep kernel writes exactly ``tf32_image_ref``'s image
    (hi/lo planes, swizzle, Vᵀ key order, zeros past S and D), from
    contiguous k/v and from views of one fused projection."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    B, S, Hkv, D = shape
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    fused = torch.randn((B, S, 3 * Hkv * D), generator=g, device=cuda)
    k = fused[..., Hkv * D:2 * Hkv * D].view(B, S, Hkv, D)
    v = fused[..., 2 * Hkv * D:].view(B, S, Hkv, D)
    for kk, vv in ((k, v), (k.contiguous(), v.contiguous())):
        before = kernels.LAUNCHES["flash_attention_tf32_prep"]
        img = fa_kernel.tf32_image(kk, vv)
        assert kernels.LAUNCHES["flash_attention_tf32_prep"] == before + 1
        want = fa_ref.tf32_image_ref(kk, vv)
        torch.cuda.synchronize()
        assert torch.equal(img.view(torch.int32), want.view(torch.int32))


def _attention_f64(q, k, v):
    """Causal GQA attention of (B, T, H, D) operands in float64: the exact
    answer that the f32 paths are all measured against."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    qd = q.double().transpose(1, 2).reshape(B, Hkv, Hq // Hkv, T, D)
    s = torch.einsum("bhgtd,bhsd->bhgts", qd, k.double().transpose(1, 2)) * D ** -0.5
    mask = torch.ones((T, k.shape[1]), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", p, v.double().transpose(1, 2))
    return out.reshape(B, Hq, T, D).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [2.0, 3.0])
def test_flash_tf32_holds_at_the_split_worst_case(cuda, scale):
    """Large q and k (logits of standard deviation scale²) whose every
    element sits at the 3xTF32 split's worst case (low 13 bits 0x1001) stay
    within the f32 limit of the exact (float64) attention, at
    tinyllama-1.1b's heads (over one and over 32 key tiles), at
    qwen2-1.5b's, and at Gemma-2B's 8 / 1 heads of D 256 (the streamed
    tiles of the wide kernel).  The exact answer is the yardstick because f32
    ``attention_ref`` itself leaves it by 1.6e-5–2.3e-5 at scale 3 on these
    inputs (NVIDIA H100 80GB HBM3, 700 W)."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    def worst(x):
        return ((x.view(torch.int32) & ~0x1FFF) | 0x1001).view(torch.float32)

    for shape in ((1, 512, 512, 32, 4, 64), (1, 2048, 2048, 8, 2, 64),
                  (1, 300, 300, 12, 2, 128), (1, 1024, 1024, 8, 1, 256)):
        q, k, v = _flash_inputs(cuda, shape, torch.float32)
        q, k = worst(q * scale), worst(k * scale)
        out = fa_kernel.flash_attention(q, k, v)
        exact = _attention_f64(q, k, v)
        torch.cuda.synchronize()
        assert float((out.double() - exact).abs().max()) <= FLASH_TOL[torch.float32]


@pytest.mark.cuda
def test_flash_tf32_replays_in_a_cuda_graph(cuda):
    """The f32 route's two launches need no host synchronisation: a CUDA
    graph of a call replays bitwise to the eager result."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel

    q, k, v = _flash_inputs(cuda, (2, 300, 300, 8, 2, 64), torch.float32)
    out = fa_kernel.flash_attention(q, k, v, window=100)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fa_kernel.flash_attention(q, k, v, window=100)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = fa_kernel.flash_attention(q, k, v, window=100)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), out.view(torch.int32))


@pytest.mark.cuda
def test_flash_attention_refuses_bad_operands(cuda):
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    q = torch.zeros((1, 16, 4, 32), device=cuda)
    k = torch.zeros((1, 16, 2, 32), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention(q.double(), k.double(), k.double())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention(q, k.bfloat16(), k.bfloat16())
    # D 48 (f32) and D 24 (bf16) were refused by the first kernels' list;
    # both now run, and D 264 is refused with the domain in the message
    for D, dt in ((48, torch.float32), (24, torch.bfloat16)):
        qq, kk = q.new_empty((1, 16, 4, D)).normal_(), k.new_empty((1, 16, 2, D)).normal_()
        qq, kk = qq.to(dt), kk.to(dt)
        got = fa_kernel.flash_attention(qq, kk, kk)
        want = fa_ref.attention_ref(qq.transpose(1, 2), kk.transpose(1, 2),
                                    kk.transpose(1, 2)).transpose(1, 2)
        assert float((got.float() - want.float()).abs().max()) <= FLASH_TOL[dt]
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="no kernel for D=264.*up to 256"):
            fa_kernel.flash_attention(q.new_zeros((1, 16, 4, 264)).to(dt),
                                      k.new_zeros((1, 16, 2, 264)).to(dt),
                                      k.new_zeros((1, 16, 2, 264)).to(dt))
    with pytest.raises(ValueError, match="does not match"):
        fa_kernel.flash_attention(q[:, :, :3], k, k)
    with pytest.raises(ValueError, match="last dimension is contiguous"):
        fa_kernel.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fa_kernel.flash_attention(q, k.cpu(), k)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention(q.half(), k.half(), k.half())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_kernel.flash_attention(q.bfloat16(), k, k.bfloat16())
    with pytest.raises(ValueError, match="no kernel for D=20.*multiple of 8"):
        fa_kernel.flash_attention(q.new_zeros((1, 16, 4, 20)).bfloat16(),
                                  k.new_zeros((1, 16, 2, 20)).bfloat16(),
                                  k.new_zeros((1, 16, 2, 20)).bfloat16())
    with pytest.raises(ValueError, match="window"):
        fa_kernel.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16(), window=-1)


@pytest.mark.cuda
def test_attn_apply_flash_branch_on_card(cuda):
    """``attn_apply(use_kernel=True)`` launches the kernel once and agrees
    with the plain ``_sdpa`` and the q-chunked path within the bf16 limit."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_map

    cfg = get_config("tinyllama-1.1b").reduced()
    p = tf.compute_params(tf.init_params(torch.Generator(device=cuda).manual_seed(0), cfg),
                          cfg.replace(compute_dtype="bfloat16"))
    lp = tree_map(lambda x: x[0], p["seg0"])["l0"]["mixer"]
    x = torch.randn((2, 256, cfg.d_model), generator=torch.Generator(device=cuda).manual_seed(1),
                    device=cuda).bfloat16()
    pos = torch.arange(256, device=cuda).expand(2, 256)
    before = kernels.LAUNCHES["flash_attention_tc"]
    y, _ = attn.attn_apply(lp, cfg, x, positions=pos, use_kernel=True)
    assert kernels.LAUNCHES["flash_attention_tc"] == before + 1
    y_plain, _ = attn.attn_apply(lp, cfg, x, positions=pos)
    y_chunk, _ = attn.attn_apply(lp, cfg.replace(attn_q_chunk=64), x, positions=pos)
    assert kernels.LAUNCHES["flash_attention_tc"] == before + 1
    assert float((y.float() - y_plain.float()).abs().max()) <= 3e-2
    assert float((y.float() - y_chunk.float()).abs().max()) <= 3e-2


TOPK_SIZES = [1, 4096, 128 * 300, 10000, 8191, 513, (1 << 20) + 3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", TOPK_SIZES)
def test_topk_count_and_mask_vs_plain(cuda, n, dtype):
    g = torch.Generator(device=cuda).manual_seed(n)
    x = torch.randn((n,), generator=g, device=cuda).to(dtype)
    x[::7] = -x[::7].abs()
    # unsorted thresholds, 0 among them, and exact element values
    t = torch.rand((tk_ref.NCAND,), generator=g, device=cuda) * 3.0
    t[5], t[77] = 0.0, x[0].abs().float()
    t = t[torch.randperm(tk_ref.NCAND, generator=g, device=cuda)].contiguous()
    before = dict(kernels.LAUNCHES)
    counts = tk_kernel.count_ge(x, t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk_count"] == before["topk_count"] + 1
    assert counts.dtype == torch.int64
    assert torch.equal(counts, tk_ref.count_ge_ref(x, t))
    for thr in (t[0:1], t[5:6], t[77:78]):
        o = tk_kernel.apply_threshold(x, thr.contiguous())
        o_r = tk_ref.apply_threshold_ref(x, thr)
        assert o.dtype == dtype and o.shape == x.shape
        bits = torch.int32 if dtype == torch.float32 else torch.int16
        assert torch.equal(o.view(bits), o_r.view(bits))  # +0.0 for dropped entries
    assert kernels.LAUNCHES["topk_mask"] == before["topk_mask"] + 3


@pytest.mark.cuda
def test_topk_sparsify_on_card(cuda):
    from repro_torch.kernels.topk_compress import ops as tk_ops

    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((300, 1001), generator=g, device=cuda)
    k = 3000
    before = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the rounds never wait on the host
    try:
        out = tk_ops.topk_sparsify(x, k)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk_count"] == before["topk_count"] + 3
    assert kernels.LAUNCHES["topk_mask"] == before["topk_mask"] + 1
    kept = out != 0
    assert int(kept.sum()) >= k
    assert float(x[kept].abs().min()) >= float(x[~kept].abs().max())
    assert torch.equal(out[kept], x[kept])
    cpu = tk_ops.topk_sparsify(x.cpu(), k)
    assert torch.equal(out.cpu().view(torch.int32), cpu.view(torch.int32))


@pytest.mark.cuda
def test_topk_count_and_mask_refuse_bad_operands(cuda):
    x = torch.zeros((300,), device=cuda)
    t = torch.zeros((tk_ref.NCAND,), device=cuda)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tk_kernel.count_ge(x.double(), t)
    with pytest.raises(ValueError, match="128 contiguous float32"):
        tk_kernel.count_ge(x, t[:64])
    with pytest.raises(ValueError, match="contiguous tensor"):
        tk_kernel.count_ge(x.view(2, 150).t(), t)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tk_kernel.apply_threshold(x.cpu(), t[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_topk_mask_of_a_view_at_an_offset(cuda, dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    base = torch.randn((4099,), generator=g, device=cuda).to(dtype)
    thr = torch.full((1,), 0.5, device=cuda)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for off in (1, 2, 3):
        x = base[off:]  # contiguous, not on 16 bytes
        o = tk_kernel.apply_threshold(x, thr)
        assert torch.equal(o.view(bits), tk_ref.apply_threshold_ref(x, thr).view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("n", TOPK_SIZES)
def test_topk_mask_matches_hardshrink(cuda, n):
    """On f32 the mask is F.hardshrink(x, nextafter(t, 0)) bit for bit:
    |x| > nextafter(t, 0) is |x| >= t, and both write +0.0 elsewhere; so on
    a view at an offset (the scalar path)."""
    import torch.nn.functional as F

    g = torch.Generator(device=cuda).manual_seed(n + 1)
    base = torch.randn((n + 3,), generator=g, device=cuda)
    for x in (base[:n], base[3:]):
        for t in (0.5, float(x.abs().max()), 1e-3):
            thr = torch.full((1,), t, device=cuda)
            lam = float(torch.nextafter(thr, torch.zeros_like(thr)))
            o = tk_kernel.apply_threshold(x, thr)
            assert torch.equal(o.view(torch.int32), F.hardshrink(x, lam).view(torch.int32))


def _nan(sign_bit: bool) -> float:
    """A quiet NaN; with its sign bit set, an order by raw bits would put
    it before every number."""
    bits = torch.tensor([0xFFC00000 if sign_bit else 0x7FC00000], dtype=torch.int64)
    return float(bits.to(torch.int32).view(torch.float32))


def _count_edge_inputs(cuda, n, dtype, offset, seed):
    """x (n elements of ``dtype``, ``offset`` elements past a 16-byte
    boundary) with NaN of either sign, ±inf, −0.0 and +0.0 among them, and
    128 unsorted thresholds with duplicates, NaN of either sign, values
    <= 0, −0.0, ±inf and exact element magnitudes among them."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    base = torch.randn((n + offset,), generator=g, device=cuda).to(dtype)
    x = base[offset:]
    special = [_nan(False), _nan(True), float("inf"), float("-inf"), -0.0, 0.0]
    for i, v in enumerate(special[:n]):
        x[(i * 7919) % n] = v
    t = torch.rand((tk_ref.NCAND,), generator=g, device=cuda) * 3.0
    t[10:30] = t[30:50].clone()
    t[50], t[51], t[52], t[53] = _nan(False), _nan(True), -1.0, 0.0
    t[54], t[55], t[56] = -0.0, float("inf"), float("-inf")
    t[57:61] = x[torch.randint(0, n, (4,), generator=g, device=cuda)].float().abs()
    return x, t[torch.randperm(tk_ref.NCAND, generator=g, device=cuda)].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [1, 7, 513, 4099, (1 << 20) + 3, 1 << 24])
def test_topk_count_edge_cases_vs_plain(cuda, n, dtype, offset):
    x, t = _count_edge_inputs(cuda, n, dtype, offset, n + offset)
    before = kernels.LAUNCHES["topk_count"]
    counts = tk_kernel.count_ge(x, t)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk_count"] == before + 1
    assert torch.equal(counts, tk_ref.count_ge_ref(x, t))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_topk_count_replays_in_a_cuda_graph(cuda, dtype):
    """A captured count reads x and the thresholds anew at each replay."""
    x, t = _count_edge_inputs(cuda, (1 << 20) + 5, dtype, 0, 9)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk_kernel.count_ge(x, t)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        counts = tk_kernel.count_ge(x, t)
    g = torch.Generator(device=cuda).manual_seed(10)
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=g, device=cuda).to(dtype))
        t.copy_(t[torch.randperm(tk_ref.NCAND, generator=g, device=cuda)] * 0.9)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(counts, tk_ref.count_ge_ref(x, t))


def _absmax_rows(cuda, shape, seed):
    """(K, n) normal rows; where K >= 5, row 0 holds a NaN, row 1 +inf and
    −inf, row 2 only −0.0, row 3 a sign-bit NaN and +inf, row 4 −0.0 among
    tiny values."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda)
    K, n = shape
    if K >= 5:
        x[0, n // 2] = _nan(False)
        x[1, 0], x[1, n - 1] = float("inf"), float("-inf")
        x[2] = -0.0
        x[3, n - 1], x[3, n // 3] = _nan(True), float("inf")
        x[4] *= 1e-30
        x[4, 0] = -0.0
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 8193), (16, 2000), (1, 1 << 24), (16, 1 << 20),
                                   (5, (1 << 22) + 1), (1, 3), (7, 1)])
def test_int8_absmax_bitwise_with_plain(cuda, shape):
    """Rows not on 16 bytes, grid-stride loops of several trips (2^24 in
    one row; 2^20 in each of 16), K = 16, and NaN, ±inf and −0.0 in a row:
    bitwise the plain version's maxima.  A NaN row's max is |NaN| with the
    sign bit cleared (0x7fc00000), as the plain version gives it on the
    CPU; on the card torch's abs writes NaN as 0x7fffffff, so rows with a
    NaN are held to the plain version on the CPU, the others to both."""
    x = _absmax_rows(cuda, shape, sum(shape))
    before = kernels.LAUNCHES["int8_absmax"]
    m = q8_kernel.absmax(x)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int8_absmax"] == before + 1
    assert same_bits(m.cpu(), q8_ref.absmax_ref(x.cpu()))
    finite = ~torch.isnan(m)
    assert same_bits(m[finite], q8_ref.absmax_ref(x)[finite])


#: the int8 encode's shapes: the fit's (16, 2000) and the sweep's (128,
#: 2000), rows of 16,384 (the longest of one launch, route A) and 16,385
#: (route B), rows off 16 bytes, rows shorter than a float4, and one row
#: of 2^24 + 3 (route B's grid-stride loops, a scalar tail)
INT8_ENCODE_SHAPES = [(16, 2000), (128, 2000), (1, 16384), (5, 16384), (1, 16385),
                      (5, 16385), (5, 8193), (1, 1), (1, 3), (7, 257), (1, (1 << 24) + 3)]


def _nan_where_same(a, b) -> bool:
    """Equal bits wherever ``b`` is a number, NaN where ``b`` is NaN."""
    nan = torch.isnan(b)
    return torch.equal(torch.isnan(a), nan) and same_bits(a[~nan], b[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", ["normal", "edge"])
@pytest.mark.parametrize("with_ef", [True, False], ids=["ef", "no-ef"])
@pytest.mark.parametrize("shape", INT8_ENCODE_SHAPES, ids=str)
def test_int8_encode_routes_bitwise_with_plain(cuda, shape, with_ef, rows):
    """Both routes of the int8 wire encode (one launch up to 16,384
    elements a row, absmax + quant-dequant above): out, res and scale
    bitwise ``int8_encode_ref`` on the card, one count under the route's
    names.  On rows with NaN, ±inf and −0.0 (in m, so in c = m + r too)
    also equal to the plain version on the CPU wherever it is a number,
    NaN in the same places (the card writes NaNs of its own)."""
    assert q8_kernel.one_launch_max() == 16384
    g = torch.Generator(device=cuda).manual_seed(sum(shape) + with_ef)
    m = (_absmax_rows(cuda, shape, sum(shape)) if rows == "edge"
         else torch.randn(shape, generator=g, device=cuda))
    r = 0.25 * torch.randn(shape, generator=g, device=cuda) if with_ef else None
    before = dict(kernels.LAUNCHES)
    out, res, scale = q8_kernel.int8_encode(m, r)
    torch.cuda.synchronize()
    delta = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.KERNEL_NAMES}
    names = ("int8_encode",) if shape[1] <= 16384 else ("int8_absmax", "int8_quant")
    assert delta == {n: int(n in names) for n in kernels.KERNEL_NAMES}
    want = q8_ref.int8_encode_ref(m, r)
    assert same_bits(out, want[0]) and same_bits(scale, want[2])
    assert (res is None) == (not with_ef)
    if with_ef:
        assert same_bits(res, want[1])
    cpu = q8_ref.int8_encode_ref(m.cpu(), None if r is None else r.cpu())
    for got, w in zip((out, res, scale), cpu):
        if w is not None:
            assert _nan_where_same(got.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(5, 8193), (16, 2000), (1, (1 << 24) + 3)], ids=str)
def test_int8_quant_on_edge_rows_is_the_plain_version(cuda, shape):
    """quant-dequant on rows with NaN and ±inf: a NaN quotient (±inf over
    an inf scale) goes through int8 as 0, as the plain version's clamp and
    cast give it, so the kernel is bitwise the plain version on the card."""
    x = _absmax_rows(cuda, shape, sum(shape) + 1)
    s = torch.clamp_min(q8_ref.absmax_ref(x), 1e-12) * (1.0 / 127.0)
    got = q8_kernel.quant_dequant(x, s)
    torch.cuda.synchronize()
    assert same_bits(got, q8_ref.quant_dequant_ref(x, s))
    assert _nan_where_same(got.cpu(), q8_ref.quant_dequant_ref(x.cpu(), s.cpu()))


@pytest.mark.cuda
def test_single_stream_int8_fit_takes_both_routes(cuda):
    """``OptimizerStrategy`` × ``delay_line(1)`` × ``int8+ef`` at the
    reduced tinyllama-1.1b, each leaf as one row: leaves of at most 16,384
    elements take the one-launch encode, longer ones absmax + quant, one
    launch (or pair) a leaf a step; bitwise the fit through the reference
    codec."""
    from repro_torch import api
    from repro_torch.core.compression import _kernel_eligible
    from repro_torch.utils.tree import tree_leaves

    steps = 3
    _, params, stream, strategy = _train_setup(cuda, steps)
    sizes = [x.numel() for x in tree_leaves(params) if _kernel_eligible(x)]
    short = sum(n <= 16384 for n in sizes)
    assert 0 < short < len(sizes)
    runs = {}
    for use in (True, False):
        before = dict(kernels.LAUNCHES)
        runs[use] = api.fit(strategy, None, transport="delay_line", staleness=1,
                            wire=api.Int8Wire(error_feedback=True, use_kernel=use),
                            stream=stream, theta0=params, device="cuda")
        torch.cuda.synchronize()
        delta = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.KERNEL_NAMES}
        want = dict.fromkeys(kernels.KERNEL_NAMES, 0)
        if use:
            want.update(int8_encode=steps * short, int8_absmax=steps * (len(sizes) - short),
                        int8_quant=steps * (len(sizes) - short))
        assert delta == want, (use, delta)
    on, off = runs[True], runs[False]
    for a, b in zip(tree_leaves(on.theta), tree_leaves(off.theta)):
        assert same_bits(a, b)
    for a, b in zip(tree_leaves(on.metrics["carry"][2]), tree_leaves(off.metrics["carry"][2])):
        assert same_bits(a, b)
    assert torch.equal(on.trajectory, off.trajectory)
    assert on.ledger.summary() == off.ledger.summary()
    assert bool(torch.isfinite(on.trajectory).all())


#: encode's and select's shapes: one element, a row shorter than a float4,
#: rows off 16 bytes (n odd), the fit's (16, 2000) (one block a row) and
#: a row whose grid-stride loop takes several trips, with a scalar tail
ENCODE_SHAPES = [(1, 1), (1, 3), (1, 257), (5, 8193), (16, 2000), (1, (1 << 24) + 3)]
ENCODE_CASES = ["k=1", "k=1%", "k=n", "t=+inf", "tied"]


def _encode_case(cuda, shape, case, seed):
    """Rows and thresholds: the k-th magnitude of each row at k = 1, 1 %
    or n (every element survives), t = +inf (none does), or half the
    elements tied at the threshold's magnitude."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=cuda)
    K, n = shape
    if case == "t=+inf":
        return x, torch.full((K,), float("inf"), device=cuda)
    if case == "tied":
        x[:, ::2] = torch.copysign(torch.full_like(x[:, ::2], 0.75), x[:, ::2])
        return x, torch.full((K,), 0.75, device=cuda)
    k = {"k=1": 1, "k=1%": max(1, n // 100), "k=n": n}[case]
    return x, torch.topk(x.abs(), k, dim=1).values[:, -1].contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [True, False], ids=["encode", "select"])
@pytest.mark.parametrize("case", ENCODE_CASES)
@pytest.mark.parametrize("shape", ENCODE_SHAPES, ids=str)
def test_topk_encode_bitwise_at_edges(cuda, shape, case, with_residual):
    x, t = _encode_case(cuda, shape, case, sum(shape))
    name = "topk_encode" if with_residual else "topk_select"
    before = kernels.LAUNCHES[name]
    o, res, cnt = tk_kernel.encode_threshold(x, t, with_residual=with_residual)
    o_r, res_r, cnt_r = tk_ref.encode_threshold_ref(x, t, with_residual=with_residual)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    assert same_bits(o, o_r) and torch.equal(cnt, cnt_r)
    assert res is None if not with_residual else same_bits(res, res_r)
    want = {"k=n": shape[1], "t=+inf": 0}.get(case)
    if want is not None:
        assert bool((cnt == want).all())


def _nan_rows(cuda, shape, seed):
    """``_absmax_rows``; with fewer than 5 rows, row 0 holds −inf, a
    sign-bit NaN and a NaN in its last element."""
    x = _absmax_rows(cuda, shape, seed)
    if shape[0] < 5:
        n = shape[1]
        x[0, n // 3], x[0, n // 2], x[0, n - 1] = float("-inf"), _nan(True), _nan(False)
    return x


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [True, False], ids=["encode", "select"])
@pytest.mark.parametrize("shape", [(5, 8193), (16, 2000), (1, (1 << 24) + 3)], ids=str)
def test_topk_encode_nan_rows_vs_plain_on_cpu(cuda, shape, with_residual):
    """|NaN| >= t is false: o = +0 and res = NaN.  o and the count are
    bitwise the plain version on the CPU; so is res wherever it is a
    number, and its NaNs lie where the CPU's do (a NaN's payload is the
    arithmetic's: the CPU passes the input's on, the card writes its own,
    as torch's arithmetic on the card does)."""
    x = _nan_rows(cuda, shape, sum(shape) + 1)
    for t in (torch.topk(x.abs(), max(1, shape[1] // 100), dim=1).values[:, -1].contiguous(),
              torch.zeros((shape[0],), device=cuda)):
        o, res, cnt = tk_kernel.encode_threshold(x, t, with_residual=with_residual)
        o_c, res_c, cnt_c = tk_ref.encode_threshold_ref(x.cpu(), t.cpu(),
                                                        with_residual=with_residual)
        torch.cuda.synchronize()
        assert same_bits(o.cpu(), o_c) and torch.equal(cnt.cpu(), cnt_c)
        if with_residual:
            nan = torch.isnan(res_c)
            assert torch.equal(torch.isnan(res.cpu()), nan)
            assert same_bits(res.cpu()[~nan], res_c[~nan])
            _, res_r, _ = tk_ref.encode_threshold_ref(x, t, with_residual=True)
            assert same_bits(res, res_r)


#: one block a row (the count written by it), and several (the count
#: zeroed by the launch, then one atomic a block)
COUNT_SHAPES = [(16, 2000), (5, 8193), (1, (1 << 20) + 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("with_residual", [True, False], ids=["encode", "select"])
@pytest.mark.parametrize("shape", COUNT_SHAPES, ids=str)
def test_topk_encode_count_is_written_anew_each_call(cuda, shape, with_residual):
    """Three calls back to back, then ten replays of a CUDA graph holding
    the call: the count is the same every time, so none carries over from
    a call before; after t becomes +inf a replay counts 0."""
    x, t = _encode_case(cuda, shape, "k=1%", sum(shape) + 2)
    _, _, want = tk_ref.encode_threshold_ref(x, t, with_residual=with_residual)
    for _ in range(3):
        cnt = tk_kernel.encode_threshold(x, t, with_residual=with_residual)[2]
        torch.cuda.synchronize()
        assert torch.equal(cnt, want)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        tk_kernel.encode_threshold(x, t, with_residual=with_residual)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        o, res, cnt = tk_kernel.encode_threshold(x, t, with_residual=with_residual)
    o_r, res_r, _ = tk_ref.encode_threshold_ref(x, t, with_residual=with_residual)
    for _ in range(10):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(cnt, want) and same_bits(o, o_r)
        assert res is None if not with_residual else same_bits(res, res_r)
    t.fill_(float("inf"))
    graph.replay()
    torch.cuda.synchronize()
    assert not bool(cnt.any()) and not bool(o.any())


@pytest.mark.cuda
def test_topk_encode_on_two_streams_at_once(cuda):
    """The launch keeps no state between calls, so two streams may encode
    at once: each stream's counts are its own rows'."""
    inputs = [_encode_case(cuda, shape, "k=1%", 40 + i) for i, shape in enumerate(COUNT_SHAPES)]
    wants = [tk_ref.encode_threshold_ref(x, t, with_residual=True) for x, t in inputs]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    got = {}
    for rep in range(4):
        for i, (x, t) in enumerate(inputs):
            with torch.cuda.stream(streams[(i + rep) % 2]):
                got[rep, i] = tk_kernel.encode_threshold(x, t, with_residual=True)
    for s in streams:
        torch.cuda.current_stream().wait_stream(s)
    torch.cuda.synchronize()
    for (rep, i), (o, res, cnt) in got.items():
        o_r, res_r, cnt_r = wants[i]
        assert same_bits(o, o_r) and same_bits(res, res_r) and torch.equal(cnt, cnt_r)



# ----------------------------------------------------------------------------
# The training slice: single-stream fits and real gradient leaves
# ----------------------------------------------------------------------------


def _train_setup(cuda, steps):
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_lm_batches
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tf

    cfg = get_config("tinyllama-1.1b").reduced().replace(
        compute_dtype="bfloat16", remat_policy="full", attn_q_chunk=32)
    params = tf.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    it = synthetic_lm_batches(0, 4, 128, cfg.vocab_size, device=cuda)
    stream = train_cli.stack_batches([next(it) for _ in range(steps)])
    strategy = train_cli.make_strategy(cfg, train_cli.make_optimizer(1e-3, steps))
    return cfg, params, stream, strategy


@pytest.mark.cuda
def test_single_stream_fit_kernel_on_off_bitwise(cuda):
    """``OptimizerStrategy`` × ``delay_line(1)`` × ``topk:0.01+ef`` at the
    reduced tinyllama-1.1b (bf16 compute, remat full, query chunks): the
    fit through the encode kernel — one launch per leaf per step, each
    leaf as one row — is bitwise the fit through the reference codec."""
    from repro_torch import api
    from repro_torch.core.compression import kernel_plan
    from repro_torch.utils.tree import tree_leaves

    steps = 3
    _, params, stream, strategy = _train_setup(cuda, steps)
    runs = {}
    for use in (True, False):
        before = dict(kernels.LAUNCHES)
        runs[use] = api.fit(strategy, None, transport="delay_line", staleness=1,
                            wire=api.TopKWire(0.01, error_feedback=True, use_kernel=use),
                            stream=stream, theta0=params, device="cuda")
        torch.cuda.synchronize()
        delta = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.KERNEL_NAMES}
        eligible = kernel_plan(params)["kernel_leaves"]
        want = {n: (steps * eligible if use and n == "topk_encode" else 0)
                for n in kernels.KERNEL_NAMES}
        assert delta == want, (use, delta)
    on, off = runs[True], runs[False]
    for a, b in zip(tree_leaves(on.theta), tree_leaves(off.theta)):
        assert same_bits(a, b)
    for a, b in zip(tree_leaves(on.metrics["carry"][2]), tree_leaves(off.metrics["carry"][2])):
        assert same_bits(a, b)
    assert torch.equal(on.trajectory, off.trajectory)
    assert on.ledger.summary() == off.ledger.summary()
    push = sum(max(1, round(0.01 * x.numel())) * 8 for x in tree_leaves(params))
    assert on.ledger.uplink_bytes == steps * push
    assert bool(torch.isfinite(on.trajectory).all())


@pytest.mark.cuda
def test_encode_of_real_gradient_leaves_is_the_plain_version(cuda):
    """The gradient of the reduced model's loss, each leaf plus a residual
    encoded as one row by the kernel: bitwise the plain version; and the
    gradient with ``forward``'s ``unbind(0)`` equals the gradient with the
    layer weights taken as ``x[r]``."""
    from repro_torch.kernels.topk_compress import ops as tk_ops
    from repro_torch.models import transformer as tf
    from repro_torch.utils.tree import tree_flatten, tree_map, tree_unflatten

    cfg, params, stream, strategy = _train_setup(cuda, 1)
    batch = {k: v[0] for k, v in stream.items()}
    grads, _ = strategy.local_updates(params, strategy.init_state(params, None), None, batch)
    g_leaves, spec = tree_flatten(grads)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for g in g_leaves:
        r = 1e-3 * torch.randn(g.shape, generator=gen, device=cuda)
        k = max(1, round(0.01 * g.numel()))
        o, res, cnt = tk_ops.topk_encode(g[None], r[None], k=k)
        c = (g + r).reshape(1, -1)
        t = torch.topk(c.abs(), k, dim=1).values[:, -1].contiguous()
        o_r, res_r, cnt_r = tk_ref.encode_threshold_ref(c, t, with_residual=True)
        assert same_bits(o.reshape(1, -1), o_r) and same_bits(res.reshape(1, -1), res_r)
        assert torch.equal(cnt, cnt_r) and int(cnt[0]) >= k

    # x[r] per layer: another backward for the stacked leaves, same numbers
    leaves = [x.detach().requires_grad_() for x in tree_flatten(params)[0]]
    p = tree_unflatten(leaves, spec)
    positions = torch.arange(batch["tokens"].shape[1], device=cuda).expand(batch["tokens"].shape)
    layer = tf.segments(cfg)[0].unit[0]
    h = tf.embed(p["embed"], batch["tokens"], compute_dtype=torch.bfloat16)
    for i in range(cfg.num_layers):
        h = tf._remat_wrap(lambda h, w: tf.apply_layer(w, cfg, layer, h, positions=positions)[0],
                           cfg)(h, tree_map(lambda x, i=i: x[i], p["seg0"]["l0"]))
    h = tf.rmsnorm(p["final_norm"], h, eps=cfg.rms_eps)
    by_select = torch.autograd.grad(tf.chunked_ce(p, cfg, h, batch["labels"]), leaves)
    for (path, a), b in zip(torch.utils._pytree.tree_flatten_with_path(grads)[0], by_select):
        if getattr(path[0], "key", None) == "seg0":
            assert torch.equal(a, b), path


def _fit_problem(cuda, K=8, N=200, D=2000, task="classification"):
    gen = torch.Generator(device=cuda).manual_seed(11)
    Xs = torch.randn((K, N, D), generator=gen, device=cuda) / D ** 0.5
    w = torch.randn((D,), generator=gen, device=cuda)
    ys = Xs @ w
    if task == "classification":
        ys = torch.where(ys >= 0, 1.0, -1.0)
    return Xs, ys


@pytest.mark.cuda
def test_dp_wire_statistics_on_the_card(cuda):
    """σ = 0: each row's norm is min(‖m‖, clip) to rtol 1e-4
    (tests/test_property.py:262); zero messages: the noise drawn on the
    card has std within 5 % of σ·clip and |mean| < 0.05
    (tests/test_faults.py ``test_noise_scale_statistical``); the same
    counters give the same draws, advanced ones new draws; the draw on the
    card is a function of the counters alone, as on the CPU."""
    from repro_torch import api
    from repro_torch.api import wire as W

    gen = torch.Generator(device=cuda).manual_seed(2)
    msgs = torch.randn((16, 2000), generator=gen, device=cuda)
    msgs = msgs * torch.logspace(-3, 0, 16, device=cuda)[:, None]
    wi = api.DPWire(1.0, 0.0)
    _, hat, _ = wi.encode_updates(wi.init_state(msgs[0], 16), msgs)
    want = torch.clamp(torch.linalg.norm(msgs, dim=1), max=1.0)
    torch.testing.assert_close(torch.linalg.norm(hat, dim=1), want, rtol=1e-4, atol=0)
    wi = api.DPWire(2.0, 0.5, seed=5)
    zeros = torch.zeros((16, 2000), device=cuda)
    st = wi.init_state(zeros[0], 16)
    st1, a, _ = wi.encode_updates(st, zeros)
    assert a.device.type == "cuda" and st.device.type == "cpu"
    assert abs(float(a.std()) - 1.0) <= 0.05 and abs(float(a.mean())) < 0.05
    _, a2, _ = wi.encode_updates(st, zeros)
    _, b, _ = wi.encode_updates(st1, zeros)
    assert torch.equal(a, a2) and not torch.equal(a, b)
    assert torch.equal(a[3], 0.5 * 2.0 * W._normal((2000,), a.device, 5, 0, 3, 0))


@pytest.mark.cuda
def test_secagg_payloads_on_the_card(cuda):
    """Every payload differs from its message; the sum recovers the
    aggregate to rtol = atol = 1e-3 (tests/test_property.py:241)."""
    from repro_torch import api

    raw = torch.randn((16, 2000), generator=torch.Generator(device=cuda).manual_seed(4),
                      device=cuda)
    sa = api.SecAggWire()
    pay = sa.uplink_payloads(sa.init_state(raw[0], 16), raw)
    assert pay.device.type == "cuda"
    for k in range(16):
        assert not torch.allclose(pay[k], raw[k], atol=1e-3)
    torch.testing.assert_close(pay.sum(0), raw.sum(0), rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("wire, base, expect", [
    ("topk:0.01>secagg", "topk:0.01", {"topk_select": 4}),
    ("topk:0.01+ef>secagg", "topk:0.01+ef", {"topk_encode": 4}),
    ("int8+ef>secagg", "int8+ef", {"int8_encode": 4}),
])
def test_secagg_chain_fit_bitwise_its_first_stage(cuda, wire, base, expect):
    """A chain ending in secagg launches its first stage's kernels once a
    round and is bitwise that stage's fit (θ, trajectory, ledger)."""
    from repro_torch import api
    from repro_torch.ml.linear import logistic_loss

    data = _fit_problem(cuda)
    runs = {}
    for spec in (wire, base):
        before = dict(kernels.LAUNCHES)
        runs[spec] = api.fit(api.GradientDescent(logistic_loss, lr=1.0), data,
                             transport="allreduce", wire=spec, steps=4, device="cuda")
        torch.cuda.synchronize()
        delta = {n: kernels.LAUNCHES[n] - before[n] for n in kernels.KERNEL_NAMES}
        assert delta == {n: expect.get(n, 0) for n in kernels.KERNEL_NAMES}
    a, b = runs[wire], runs[base]
    assert same_bits(a.theta, b.theta) and same_bits(a.trajectory, b.trajectory)
    assert a.ledger.summary() == b.ledger.summary()


@pytest.mark.cuda
def test_dp_chain_drives_the_encode_kernel(cuda):
    """``dp:c,0>topk:f+ef`` on the card: one encode launch a round, and the
    fit bitwise the same chain with the top-k stage on the reference codec
    (the kernel changes no bit after the privatization)."""
    from repro_torch import api
    from repro_torch.ml.linear import logistic_loss

    data = _fit_problem(cuda)
    runs = {}
    for use in (True, False):
        chain = api.ChainWire([api.DPWire(0.05, 0.0),
                               api.TopKWire(0.01, error_feedback=True, use_kernel=use)])
        before = kernels.LAUNCHES["topk_encode"]
        runs[use] = api.fit(api.GradientDescent(logistic_loss, lr=1.0), data,
                            transport="allreduce", wire=chain, steps=5, device="cuda")
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["topk_encode"] - before == (5 if use else 0)
    assert same_bits(runs[True].theta, runs[False].theta)
    assert same_bits(runs[True].trajectory, runs[False].trajectory)


@pytest.mark.cuda
def test_lbfgs_on_the_card_matches_the_cpu(cuda):
    """``LBFGS`` × allreduce on the card against the same fit on the CPU:
    the trajectory to rtol 1e-4 / atol 1e-5 (cuBLAS and the CPU sum in
    other orders, which L-BFGS's curvature pairs magnify: ROADMAP queue 3,
    item 15), the ledger exactly (steps + 1 rounds)."""
    from repro_torch import api
    from repro_torch.ml.linear import lsq_loss

    Xs, ys = _fit_problem(cuda, K=4, N=100, D=500, task="regression")
    on = api.fit(api.LBFGS(lsq_loss), (Xs, ys), transport="allreduce", steps=10,
                 device="cuda")
    off = api.fit(api.LBFGS(lsq_loss), (Xs.cpu(), ys.cpu()), transport="allreduce",
                  steps=10, device="cpu")
    torch.testing.assert_close(on.trajectory.cpu(), off.trajectory, rtol=1e-4, atol=1e-5)
    assert on.ledger.summary() == off.ledger.summary() and on.ledger.rounds == 11


@pytest.mark.cuda
def test_private_second_order_on_the_card(cuda):
    """θ within rtol 1e-4 (atol 1e-4 of its largest element) of a float64
    solve on the card; the ledger K·(n² + n) numbers up, n down."""
    from repro_torch.ml.linear import private_second_order

    Xs, ys = _fit_problem(cuda, K=16, N=3000, D=500, task="regression")
    theta, ledger = private_second_order(Xs, ys, device="cuda")
    W = torch.einsum("kni,knj->ij", Xs.double(), Xs.double())
    V = torch.einsum("kni,kn->i", Xs.double(), ys.double())
    th64 = torch.linalg.solve(W, V)
    torch.testing.assert_close(theta.double(), th64, rtol=1e-4,
                               atol=1e-4 * float(th64.abs().max()))
    assert ledger.uplink_bytes == 16 * (500 * 500 + 500) * 4 and ledger.downlink_bytes == 2000


@pytest.mark.cuda
def test_ml_families_run_on_the_card(cuda):
    """The cascade SVM, the GP experts and consensus MPLE on the card at a
    small size: the cascade's SVs inside its pushed union and its decision
    signs above chance; the GP expert means within 0.12 of the exact GP
    (tests/test_gp.py:82); the MPLE support F1 above 0.95
    (tests/test_sparse_gp_graphical.py:97)."""
    from repro_torch import api
    from repro_torch.ml import gp, graphical, svm

    Xs, ys = _fit_problem(cuda, K=4, N=100, D=50)
    res = api.fit(svm.CascadeStrategy(), (Xs, ys), transport="allreduce", steps=3,
                  device="cuda")
    _, pushed = res.metrics["carry"][1]
    assert not bool((res.theta.sv_mask & ~pushed).any())
    acc = (torch.sign(svm.decision_function(res.theta, Xs.reshape(-1, 50))) == ys.reshape(-1))
    assert float(acc.float().mean()) > 0.5

    gen = torch.Generator(device=cuda).manual_seed(1)
    X = torch.rand((256, 1), generator=gen, device=cuda) * 6 - 3
    y = torch.sin(X[:, 0]) + 0.05 * torch.randn((256,), generator=gen, device=cuda)
    Xq = torch.linspace(-2.5, 2.5, 12, device=cuda)[:, None]
    hyp = gp.fit_hypers_distributed(X.reshape(4, 64, 1), y.reshape(4, 64), steps=20,
                                    device="cuda")
    mu_full, _ = gp.gp_posterior(hyp, X, y, Xq)
    preds = gp.expert_predictions(hyp, X.reshape(4, 64, 1), y.reshape(4, 64), Xq)
    for mu, _ in (gp.poe(preds), gp.gpoe(preds), gp.bcm(preds, gp.prior_variance(hyp, Xq))):
        assert float(torch.sqrt(torch.mean((mu - mu_full) ** 2))) < 0.12

    Theta = torch.eye(6, device=cuda) * 1.5
    idx = torch.arange(5, device=cuda)
    Theta[idx, idx + 1] = Theta[idx + 1, idx] = 0.5
    Xm = graphical.sample_gmrf(torch.Generator(device=cuda).manual_seed(0), Theta, 2000)
    Th, _ = graphical.mple_consensus(Xm.reshape(4, 500, 6), iters=30, inner_iters=30,
                                     device="cuda")
    assert float(graphical.support_f1(Th, Theta)) > 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["topk-ef", "topk-select", "int8", "int8-ef"])
def test_custom_ops_under_vmap_launch_once(cuda, op):
    """An (S, K, n) call through ``torch.func.vmap`` folds into S·K rows:
    ONE launch, bitwise S launches on (K, n)."""
    from repro_torch.kernels.int8_quant import ops as q8_ops
    from repro_torch.kernels.topk_compress import ops as tk_ops

    g = torch.Generator(device=cuda).manual_seed(11)
    u = torch.randn((8, 16, 2000), generator=g, device=cuda)
    r = torch.randn((8, 16, 2000), generator=g, device=cuda)
    if op == "topk-ef":
        fn, args, names = (lambda a, b: tk_ops.topk_encode(a, b, k=20)), (u, r), ("topk_encode",)
    elif op == "topk-select":
        fn, args, names = (lambda a: tk_ops.topk_encode(a, k=20)[::2]), (u,), ("topk_select",)
    elif op == "int8":
        fn, args, names = q8_ops.int8_roundtrip, (u,), ("int8_encode",)
    else:
        fn, args, names = q8_ops.int8_encode, (u, r), ("int8_encode",)
    kernels.reset_launches()
    got = torch.func.vmap(fn)(*args)
    torch.cuda.synchronize()
    for name in names:
        assert kernels.LAUNCHES[name] == 1, kernels.LAUNCHES
    for s in range(8):
        want = fn(*(a[s] for a in args))
        for x, w in zip(got, want):
            assert x[s].dtype == w.dtype and torch.equal(
                x[s].reshape(-1).view(torch.uint8), w.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
def test_sweep_fit_launches_the_encode_once_a_round(cuda):
    from repro_torch import api
    from repro_torch.ml.linear import lsq_loss

    g = torch.Generator(device=cuda).manual_seed(2)
    X = torch.randn((16, 64, 2000), generator=g, device=cuda) / 45
    y = X @ torch.randn((2000,), generator=g, device=cuda)
    lrs = [0.05, 0.1, 0.2, 0.4]
    kernels.reset_launches()
    res = api.fit(api.GradientDescent(lsq_loss), (X, y), transport="allreduce",
                  wire="topk:0.01+ef", steps=5, executor="sweep", sweep={"lr": lrs})
    assert kernels.LAUNCHES["topk_encode"] == 5
    for i, lr in enumerate(lrs):
        solo = api.fit(api.GradientDescent(lsq_loss, lr=lr), (X, y), transport="allreduce",
                       wire="topk:0.01+ef", steps=5)
        torch.testing.assert_close(res.theta[i], solo.theta, rtol=1e-6, atol=1e-7)
        assert res.ledger[i].summary() == solo.ledger.summary()


@pytest.mark.cuda
def test_mesh_on_a_world_of_one_over_nccl(cuda, tmp_path):
    """One card takes a world of one over NCCL (NCCL refuses two ranks on one
    GPU): real communicators and collectives, θ bitwise the local fit."""
    import torch.distributed as dist

    from repro_torch import api
    from repro_torch.launch.mesh import make_multipod_mesh, make_node_mesh
    from repro_torch.ml.linear import lsq_loss

    g = torch.Generator(device=cuda).manual_seed(4)
    X = torch.randn((8, 32, 300), generator=g, device=cuda) / 17
    y = X @ torch.randn((300,), generator=g, device=cuda)
    loc = api.fit(api.GradientDescent(lsq_loss), (X, y), transport="delay_line",
                  staleness=1, wire="topk:0.1+ef", steps=6)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rendezvous",
                            world_size=1, rank=0)
    try:
        mesh, pods = make_node_mesh(), make_multipod_mesh()
        assert mesh.device_type == "cuda" and tuple(pods.shape) == (1, 1)
        kw = dict(transport="delay_line", staleness=1, wire="topk:0.1+ef", steps=6)
        m = api.fit(api.GradientDescent(lsq_loss), (X, y), executor=api.MeshExecutor(mesh), **kw)
        p = api.fit(api.GradientDescent(lsq_loss), (X, y),
                    executor=api.MultiPodExecutor(pods), **kw)
        s = api.fit(api.GradientDescent(lsq_loss), (X, y), executor="mesh+sweep",
                    sweep={"lr": [0.1, 0.2]}, **kw)
    finally:
        dist.destroy_process_group()
    assert same_bits(m.theta, loc.theta) and same_bits(m.trajectory, loc.trajectory)
    assert same_bits(p.theta, m.theta)
    assert m.ledger.summary() == loc.ledger.summary()
    assert sum(v["total_bytes"] for v in p.ledger.summary()["by_hop"].values()) == \
        loc.ledger.total_bytes
    torch.testing.assert_close(s.theta[0], loc.theta, rtol=1e-6, atol=1e-7)


# ----------------------------------------------------------------------------
# Serving and tracing on the card (chip_smoke.py's serving-and-tracing phase)
# ----------------------------------------------------------------------------


def _gd_problem(device, K=4, N=64, D=300, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    Xs = torch.randn((K, N, D), generator=g, device=device) / D ** 0.5
    ys = Xs @ torch.randn((D,), generator=g, device=device)
    return Xs, ys


@pytest.mark.cuda
def test_serve_engine_on_the_card_matches_the_cpu(cuda):
    """A CUDA θ is served on the card: CUDA answers, within rtol 1e-5 /
    atol 1e-6 of the same engine's answers on the CPU, the same ledger."""
    from repro_torch import api
    from repro_torch.ml.linear import lsq_loss
    from repro_torch.serve import MicroBatcher, ServeEngine

    theta = torch.randn((300,), generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    X = torch.randn((37, 300), generator=torch.Generator().manual_seed(2)).numpy()
    gpu = ServeEngine(api.GradientDescent(lsq_loss), theta)
    cpu = ServeEngine(api.GradientDescent(lsq_loss), theta.cpu())
    assert gpu.device.type == "cuda"
    y = gpu.predict(X)
    assert y.is_cuda
    torch.testing.assert_close(y.cpu(), cpu.predict(X), rtol=1e-5, atol=1e-6)
    b = MicroBatcher(gpu, max_batch=8)
    tickets = [b.submit(x) for x in X]
    b.flush()
    got = torch.stack([t.result() for t in tickets])
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), cpu.predict(X), rtol=1e-5, atol=1e-6)
    assert gpu.ledger.uplink_bytes == 2 * 37 * 300 * 4


@pytest.mark.cuda
def test_serving_executor_launches_the_encode_once_a_round(cuda, tmp_path):
    from repro_torch import api
    from repro_torch.ml.linear import lsq_loss
    from repro_torch.serve import ModelRegistry

    Xs, ys = _gd_problem(cuda)
    reg = ModelRegistry(str(tmp_path))
    before = kernels.LAUNCHES["topk_encode"]
    res = api.fit(api.GradientDescent(lsq_loss, lr=0.5), (Xs, ys), transport="allreduce",
                  wire="topk:0.01+ef", steps=6, device="cuda",
                  executor=api.ServingExecutor(registry=reg, publish_as="m"))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["topk_encode"] == before + 6
    assert res.metrics["wire_kernel_launches"] == {"topk_encode": 6}
    eng = res.metrics["serve_engine"]
    assert eng.device.type == "cuda" and eng.theta.is_cuda
    loaded = reg.load("m")
    assert loaded.is_cuda and torch.equal(loaded.view(torch.int32), res.theta.view(torch.int32))


@pytest.mark.cuda
def test_traced_fit_on_the_card_is_bitwise_untraced(cuda):
    from repro_torch import api
    from repro_torch.ml.linear import lsq_loss
    from repro_torch.telemetry import Tracer

    Xs, ys = _gd_problem(cuda)

    def fit(**kw):
        return api.fit(api.GradientDescent(lsq_loss, lr=0.5), (Xs, ys), transport="allreduce",
                       wire="topk:0.01+ef", steps=6, device="cuda", **kw)

    base = fit()
    t = Tracer()
    res = fit(tracer=t, trace="phases")
    assert torch.equal(res.theta.view(torch.int32), base.theta.view(torch.int32))
    assert torch.equal(res.trajectory.view(torch.int32), base.trajectory.view(torch.int32))
    assert res.ledger.summary() == base.ledger.summary()
    names = {s["name"] for s in t.spans}
    assert {"fit/loop", "fit/ledger", "fit/metrics", "dispatch/local-update",
            "phase/local_step", "phase/encode"} <= names
    assert t.counters == {"program_cache/uncached": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_at_qwen2_vl_heads_after_mrope(cuda, dtype):
    """qwen2-vl-2b's heads (12 query, 2 KV, D 128) with q and k rotated by
    M-RoPE on a 16 × 16 patch grid, as ``attn_apply`` hands them to the
    kernel: one launch, within the flash limits of the plain version."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.models.layers import apply_mrope

    B, T, Tv = 2, 512, 256
    q, k, v = _flash_inputs(cuda, (B, T, T, 12, 2, 128), dtype)
    r = torch.arange(Tv, device=cuda)
    pos = torch.empty((3, B, T), dtype=torch.int64, device=cuda)
    pos[0, :, :Tv], pos[1, :, :Tv], pos[2, :, :Tv] = 0, r // 16, r % 16
    pos[:, :, Tv:] = 16 + torch.arange(T - Tv, device=cuda)
    q = apply_mrope(q, pos, 1e6, (16, 24, 24))
    k = apply_mrope(k, pos, 1e6, (16, 24, 24))
    name = fa_kernel.route(dtype)
    before = kernels.LAUNCHES[name]
    out = fa_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES[name] == before + 1
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    plain = tr(fa_ref.attention_ref(tr(q), tr(k), tr(v), causal=True))
    assert float((out.float() - plain.float()).abs().max()) <= FLASH_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_attention_at_deepseek_67b_heads(cuda, dtype):
    """deepseek-67b's heads (64 query over 8 KV, D 128: G 8), 16 slots at
    the lengths of a continuous batch: the split and merge pair within the
    decode limits of the plain version."""
    q, k, v, _ = _decode_inputs(cuda, (16, 320, 64, 8, 128), dtype, 67)
    vl = torch.tensor([0, 1, 320, 17, 64, 65, 100, 128, 129, 200, 255, 256, 257, 300, 319, 32],
                      dtype=torch.int32, device=cuda)
    before = dict(kernels.LAUNCHES)
    out = da_kernel.decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    for name in ("decode_attention", "decode_attention_merge"):
        assert kernels.LAUNCHES[name] == before[name] + 1
    plain = da_ref.decode_attention_plain(q, k, v, vl)
    assert float((out.float() - plain.float()).abs().max()) <= DECODE_TOL[dtype]
    assert bool((out[0] == 0).all())


@pytest.mark.cuda
def test_full_width_mamba_mixer_matches_the_cpu(cuda):
    """jamba-1.5-large-398b's mamba mixer at full width (d 8192, d_inner
    16,384, d_state 16, dt_rank 512) in f32 at B 1 × T 300 (a chunk and a
    padded one), then two decode steps from the returned cache: the card
    within 1e-4 of max |y| of the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import mamba
    from repro_torch.models.cache import mamba_cache_init
    from repro_torch.utils.tree import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("jamba-1.5-large-398b").replace(compute_dtype="float32")
    d_inner, _, d_state, d_conv = mamba._dims(cfg)
    gen = torch.Generator().manual_seed(5)
    p = mamba.mamba_init(gen, cfg, device="cpu")
    x = torch.randn((1, 302, cfg.d_model), generator=gen)
    pc = tree_map(lambda a: a.to(cuda), p)
    outs = {}
    for dev, params in (("cpu", p), ("cuda", pc)):
        cache = mamba_cache_init(1, d_conv, d_inner, d_state, torch.float32, dev)
        with torch.no_grad():
            ys = []
            for sl in (slice(0, 300), slice(300, 301), slice(301, 302)):
                y, cache = mamba.mamba_apply(params, cfg, x[:, sl].to(dev), cache=cache)
                ys.append(y.cpu())
        outs[dev] = (torch.cat(ys, 1), cache.ssm.cpu())
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


#: rows around grid.y's 65,535 blocks, past which each block loops over rows
MANY_ROWS = (65535, 65536, 100000)


def _row_chunks(rows: int, step: int = 16384):
    return [slice(i, min(i + step, rows)) for i in range(0, rows, step)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2000, 257])
@pytest.mark.parametrize("rows", MANY_ROWS)
def test_wire_kernels_at_many_rows(cuda, rows, n):
    """Encode, select, absmax, quant-dequant and the one-launch int8 encode
    (route A) on more rows than grid.y holds: one launch each, bitwise the
    plain version (n 257 puts most rows off 16 bytes)."""
    g = torch.Generator(device=cuda).manual_seed(rows + n)
    x = torch.randn((rows, n), generator=g, device=cuda)
    r = 0.25 * torch.randn((rows, n), generator=g, device=cuda)
    t = torch.topk(x.abs(), max(1, n // 100), dim=1).values[:, -1].contiguous()
    s = torch.clamp_min(q8_ref.absmax_ref(x), 1e-12) * (1.0 / 127.0)
    calls = [
        ("topk_encode", lambda: tk_kernel.encode_threshold(x, t, with_residual=True),
         lambda: tk_ref.encode_threshold_ref(x, t, with_residual=True)),
        ("topk_select", lambda: tk_kernel.encode_threshold(x, t, with_residual=False),
         lambda: tk_ref.encode_threshold_ref(x, t, with_residual=False)),
        ("int8_absmax", lambda: (q8_kernel.absmax(x),), lambda: (q8_ref.absmax_ref(x),)),
        ("int8_quant", lambda: (q8_kernel.quant_dequant(x, s),),
         lambda: (q8_ref.quant_dequant_ref(x, s),)),
        ("int8_encode", lambda: q8_kernel.int8_encode(x, r),
         lambda: q8_ref.int8_encode_ref(x, r)),
        ("int8_encode", lambda: q8_kernel.int8_encode(x), lambda: q8_ref.int8_encode_ref(x)),
    ]
    for name, kern, plain in calls:
        before = dict(kernels.LAUNCHES)
        got = kern()
        torch.cuda.synchronize()
        delta = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.KERNEL_NAMES}
        assert delta == {k: int(k == name) for k in kernels.KERNEL_NAMES}, name
        for a, b in zip(got, plain()):
            assert (a is None) == (b is None), name
            if a is not None:
                assert a.shape[0] == rows and same_bits(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("with_ef", [True, False], ids=["ef", "no-ef"])
@pytest.mark.parametrize("rows", MANY_ROWS)
def test_int8_encode_route_b_at_many_rows(cuda, rows, with_ef):
    """Route B of the int8 encode (rows of 16,392 > 16,384: absmax then
    quant-dequant, each a loop over rows past grid.y) on 65,535 to 100,000
    rows, up to 6.6 GB an operand: one launch of each, out, res and scale
    bitwise the plain version, taken a block of rows at a time (rows are
    independent)."""
    n = 16392
    g = torch.Generator(device=cuda).manual_seed(rows + with_ef)
    m = torch.randn((rows, n), generator=g, device=cuda)
    r = 0.25 * torch.randn((rows, n), generator=g, device=cuda) if with_ef else None
    before = dict(kernels.LAUNCHES)
    out, res, scale = q8_kernel.int8_encode(m, r)
    torch.cuda.synchronize()
    delta = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.KERNEL_NAMES}
    assert delta == {k: int(k in ("int8_absmax", "int8_quant")) for k in kernels.KERNEL_NAMES}
    assert (res is None) == (not with_ef)
    for sl in _row_chunks(rows):
        want = q8_ref.int8_encode_ref(m[sl], None if r is None else r[sl])
        assert same_bits(out[sl], want[0]) and same_bits(scale[sl], want[2])
        if with_ef:
            assert same_bits(res[sl], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_at_many_kv_rows(cuda, dtype):
    """B · Hkv = 65,536 (B 32,768 × Hkv 2, T = S = 80: two key tiles, one
    ragged): the f32 route's prep loops over grid.y's rows, its image
    bitwise ``tf32_image_ref``; both routes within their limits of the
    plain version."""
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.flash_attention import ref as fa_ref

    q, k, v = _flash_inputs(cuda, (32768, 80, 80, 4, 2, 16), dtype)
    if dtype == torch.float32:
        img = fa_kernel.tf32_image(k, v)
        want = fa_ref.tf32_image_ref(k, v)
        torch.cuda.synchronize()
        assert torch.equal(img.view(torch.int32), want.view(torch.int32))
        del img, want
    before = dict(kernels.LAUNCHES)
    out = fa_kernel.flash_attention(q, k, v)
    torch.cuda.synchronize()
    prep = int(dtype == torch.float32)
    assert sum(kernels.LAUNCHES.values()) == sum(before.values()) + 1 + prep
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    plain = tr(fa_ref.attention_ref(tr(q), tr(k), tr(v)))
    assert float((out.float() - plain.float()).abs().max()) <= FLASH_TOL[dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_attention_at_many_rows(cuda, dtype):
    """B = 65,536 rows (S 96, Hq 8, Hkv 2, D 32; valid lengths 0, 1, S and
    a ragged one among them): the split kernel loops over grid.y's rows,
    the pair within its limit of the plain version, one launch each."""
    q, k, v, vl = _decode_inputs(cuda, (65536, 96, 8, 2, 32), dtype, 3)
    vl = vl[torch.arange(65536, device=cuda) % 4].contiguous()  # the four lengths, repeated
    before = dict(kernels.LAUNCHES)
    out = da_kernel.decode_attention(q, k, v, vl)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["decode_attention"] == before["decode_attention"] + 1
    assert kernels.LAUNCHES["decode_attention_merge"] == before["decode_attention_merge"] + 1
    plain = da_ref.decode_attention_plain(q, k, v, vl)
    assert float((out.float() - plain.float()).abs().max()) <= DECODE_TOL[dtype]
    assert bool((out[vl == 0] == 0).all())
