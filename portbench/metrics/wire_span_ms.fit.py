"""Device ms a round launched inside the program's ``fit/round/wire``
spans: the wire's encode with its error feedback, the participation mask
and the uplink count."""

from portbench.spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "device_s", lambda name: name == "fit/round/wire")
