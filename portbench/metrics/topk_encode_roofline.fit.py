"""The top-k encode kernel's share of its roofline: the least time of one
launch (12 B an element of the round's rows at the HBM rate) over its
measured device time a launch."""

import re


def read(record):
    hits = [o for o in record["ops"] if re.search(r"topk_encode_kernel", o["name"])]
    n = sum(o["count"] for o in hits)
    s = sum(o["seconds"] for o in hits)
    if not n or s <= 0:
        return None
    return 100.0 * record["counts"]["topk_encode_least_s"] / (s / n)
