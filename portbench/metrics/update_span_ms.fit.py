"""Device ms a round launched inside the program's ``fit/round/update``
spans: the strategy's local updates (the margins X·θ and the gradient
Xᵀ·r)."""

from portbench.spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "device_s", lambda name: name == "fit/round/update")
