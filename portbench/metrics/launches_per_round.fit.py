"""Device operations (kernels, copies, fills) a round, counted in the
traced window."""


def read(record):
    if not record["device_ops"] or not record["units"]:
        return None
    return record["device_ops"] / record["units"]
