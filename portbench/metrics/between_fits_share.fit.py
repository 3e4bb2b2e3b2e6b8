"""The share of the traced window's wall outside every ``dispatch/*`` span:
each fit's set-up, ledger and summary and the carry handed between fits."""

from portbench.spans import span_sum


def read(record):
    s = span_sum(record, "host_s", lambda name: name.startswith("dispatch/"))
    return None if s is None else 100.0 * (1.0 - s / record["window_s"])
