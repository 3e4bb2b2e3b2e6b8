"""Device ms an EM iteration of the E-step's kernels (prep, the tensor-core
nearest-centroid pass and the recheck of near ties); a call's final
assignment is spread over its iterations."""


def read(record):
    s = record["layers"].get("clustering E-step")
    return None if s is None or not record["units"] else s * 1e3 / record["units"]
