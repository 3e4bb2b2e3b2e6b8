"""The roofline counts at known shapes."""

import pytest

from portbench.counts import fit, kmeans, peaks


def test_topk_encode_at_100k_clients():
    # 12 B an element and 8 B a row of (100,000, 2,000) at 3.35 TB/s
    assert fit.topk_encode_least_s(100_000, 2_000) * 1e3 == pytest.approx(0.71666, rel=1e-5)
    assert fit.topk_encode_least_s(16, 2_000) * 1e3 == pytest.approx(0.000114665, rel=1e-5)


@pytest.mark.parametrize("rows, scenarios, ms", [
    (16, 1, 0.955778),        # X and y once, the 16 residual rows twice
    (100_000, 1, 1.433313),   # the residual of 100,000 rows is 1.6 GB more
    (16, 8, 0.956313),        # a sweep reads X once for its 8 scenarios
])
def test_fit_round_at_the_epsilon_shape(rows, scenarios, ms):
    assert fit.round_least_s(400_000, 2_000, rows, scenarios) * 1e3 == pytest.approx(ms,
                                                                                    rel=1e-5)
    # bytes bound every one of these rounds: 4·N·D operations per scenario
    assert fit.round_ops(400_000, 2_000, scenarios) / peaks.TF32_OPS_PER_S < ms / 1e3


def test_kmeans_at_the_kdd_shape():
    n, k, d = 4_898_432, 1_000, 42
    assert kmeans.estep_ops(n, k, d) == 2 * n * k * d
    # operations bound the E-step: 4.115e11 at 495 TFLOP/s
    assert kmeans.estep_least_s(n, k, d) * 1e3 == pytest.approx(0.831249, rel=1e-5)
    assert kmeans.estep_bytes(n, k, d) / peaks.HBM_BYTES_PER_S * 1e3 == pytest.approx(
        0.245703, rel=1e-5)
    assert kmeans.call_least_s(n, k, d, 20) == pytest.approx(21 * kmeans.estep_least_s(n, k, d))


def test_least_time_takes_the_longer_bound():
    assert peaks.least_s(495e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_s(989e12, 0.0, "bfloat16") == pytest.approx(1.0)
