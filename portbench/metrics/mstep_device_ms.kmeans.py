"""Device ms an EM iteration of the M-step: the sites' one-hot products,
their fills and sums, as the name map puts them in ``clustering M-step``."""


def read(record):
    s = record["layers"].get("clustering M-step")
    return None if s is None or not record["units"] else s * 1e3 / record["units"]
