"""Bytes the nodes pushed a round, as the program's ``CommLedger`` counted
them over the traced window (a sweep sums its scenarios)."""


def read(record):
    return record["counters"].get("uplink_bytes_per_round")
