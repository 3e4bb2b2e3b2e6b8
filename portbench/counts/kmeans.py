"""Counts of distributed k-means under l2.

An E-step needs every point's distance to every centroid: N·K·d
multiply-adds, 2·N·K·d operations on f32 inputs.  Its compulsory traffic
is X (N × d) and the centroids (K × d) read once.  An EM iteration adds
the M-step's sums, which read X again only in an implementation that does
not fuse them; its compulsory bytes are X, the centroids and the N
assignments (int32) once.
"""

from portbench.counts.peaks import least_s

F32 = 4
I32 = 4


def estep_ops(n: int, k: int, d: int) -> float:
    return 2.0 * n * k * d


def estep_bytes(n: int, k: int, d: int) -> float:
    return F32 * (n * d + k * d)


def estep_least_s(n: int, k: int, d: int) -> float:
    return least_s(estep_ops(n, k, d), estep_bytes(n, k, d))


def iter_bytes(n: int, k: int, d: int) -> float:
    return F32 * (n * d + k * d) + I32 * n


def iter_least_s(n: int, k: int, d: int) -> float:
    return least_s(estep_ops(n, k, d), iter_bytes(n, k, d))


def call_least_s(n: int, k: int, d: int, iters: int) -> float:
    """A call of ``iters`` EM iterations and its final assignment."""
    return iters * iter_least_s(n, k, d) + estep_least_s(n, k, d)
