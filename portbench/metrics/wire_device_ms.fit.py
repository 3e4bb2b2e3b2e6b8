"""Device ms a round of the wire: the exact per-row threshold
(``torch.topk`` on |c|) and the fused encode, as the name map puts them
in ``wire``."""


def read(record):
    s = record["layers"].get("wire")
    return None if s is None or not record["units"] else s * 1e3 / record["units"]
