"""Device ms a round of the strategy's products (the margins X·θ and the
gradient Xᵀ·r, and the loss's X·θ of the round's metric): the traced
window's device operations that the name map puts in ``strategy``."""


def read(record):
    s = record["layers"].get("strategy")
    return None if s is None or not record["units"] else s * 1e3 / record["units"]
