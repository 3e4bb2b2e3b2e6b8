"""The whole EM iteration's share of the card's peak in the roofline form:
the least time of the calls done (``counts/kmeans.py``: each iteration's
operations at the TF32 rate or its bytes at the HBM rate, plus the final
assignment) over the traced window's wall."""


def read(record):
    if not record["chunks"] or not record["device_ops"]:
        return None
    return 100.0 * record["counts"]["call_least_s"] * record["chunks"] / record["window_s"]
