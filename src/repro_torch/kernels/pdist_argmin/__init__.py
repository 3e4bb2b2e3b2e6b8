"""Nearest-centroid assignment under l1 / l2 / l-infinity (port of
``repro.kernels.pdist_argmin``)."""

from repro_torch.kernels.pdist_argmin import ops, ref

__all__ = ["ops", "ref"]
