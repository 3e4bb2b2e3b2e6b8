"""Idle ms a round of the card inside the executors' loops: the window's
idle gaps whose midpoint lies in a ``dispatch/*`` span or in a round span
inside one, over the rounds."""

from portbench.spans import per_unit_ms


def read(record):
    return per_unit_ms(record, "idle_s",
                       lambda name: name.startswith(("dispatch/", "fit/round/")))
