"""The share of the traced window in which no operation ran on the card."""


def read(record):
    if record["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
