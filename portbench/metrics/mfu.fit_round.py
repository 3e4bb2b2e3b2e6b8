"""The whole round's share of the card's peak in the roofline form: the
least time of the rounds done (the longer of their operations at the
TF32 rate and their compulsory bytes at the HBM rate; ``counts/fit.py``)
over the traced window's wall."""


def read(record):
    if not record["units"] or not record["device_ops"]:
        return None
    return 100.0 * record["counts"]["round_least_s"] * record["units"] / record["window_s"]
