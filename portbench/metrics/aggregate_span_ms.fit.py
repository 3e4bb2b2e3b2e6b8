"""Device ms a round launched inside the program's ``fit/round/aggregate``
spans: the sum over nodes, the broadcast or delay line, the applied update
and the downlink count."""

from portbench.spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "device_s", lambda name: name == "fit/round/aggregate")
