"""Nearest-centroid assignment under l1 / l2 / l-infinity (port of
``repro.kernels.pdist_argmin``)."""
