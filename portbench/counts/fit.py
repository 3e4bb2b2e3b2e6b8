"""Counts of a round of ``api.fit`` with ``GradientDescent`` over a linear
loss and a top-k wire with error feedback.

A round of one scenario needs the margins X·θ and the gradient Xᵀ·r:
2·N·D multiply-adds, 4·N·D operations.  Its compulsory traffic is X and y
read once, and the EF residual (rows × D f32) read once and written once.
A sweep of S scenarios multiplies the operations and the residual by S
and reads X once.
"""

from portbench.counts.peaks import HBM_BYTES_PER_S, least_s

F32 = 4


def round_ops(records: int, dim: int, scenarios: int = 1) -> float:
    return 4.0 * records * dim * scenarios


def round_bytes(records: int, dim: int, rows: int, scenarios: int = 1) -> float:
    """X (records × dim) and y read once; the residual of ``rows`` nodes
    read and written once in every scenario."""
    return F32 * (records * dim + records) + 2 * F32 * rows * dim * scenarios


def round_least_s(records: int, dim: int, rows: int, scenarios: int = 1) -> float:
    return least_s(round_ops(records, dim, scenarios), round_bytes(records, dim, rows, scenarios))


def topk_encode_bytes(rows: int, n: int) -> float:
    """The encode of ``rows`` rows of ``n`` with a residual: the message and
    the residual read once, the new residual written once (12 B an
    element), and a row's threshold read and its survivor count written
    (8 B a row); the kept output is what the next stage reads in place."""
    return 12.0 * rows * n + 8.0 * rows


def topk_encode_least_s(rows: int, n: int) -> float:
    return topk_encode_bytes(rows, n) / HBM_BYTES_PER_S
