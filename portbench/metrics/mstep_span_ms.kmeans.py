"""Device ms an EM iteration launched inside the program's ``kmeans/mstep``
spans: the sites' one-hot products and sums and the centroid update."""

from portbench.spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "device_s", lambda name: name == "kmeans/mstep")
