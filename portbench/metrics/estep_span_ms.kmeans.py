"""Device ms an EM iteration launched inside the program's ``kmeans/estep``
spans: the nearest-centroid pass of each iteration (the call's final
assignment is ``kmeans/assign``'s)."""

from portbench.spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "device_s", lambda name: name == "kmeans/estep")
