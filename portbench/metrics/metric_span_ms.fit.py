"""Device ms a round launched inside the program's ``fit/round/metric``
spans: the loss reported at the round's new θ, one more X·θ."""

from portbench.spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "device_s", lambda name: name == "fit/round/metric")
