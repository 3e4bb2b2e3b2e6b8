"""The E-step's share of its roofline: the least time of the E-steps run
(2·N·K·d operations at the TF32 rate, or X and C once at the HBM rate,
whichever is longer) over the E-step kernels' device time.  An E-step is
one launch of the nearest-centroid kernel."""

import re


def read(record):
    launches = sum(o["count"] for o in record["ops"]
                   if re.search(r"nearest_tc_kernel", o["name"]))
    s = record["layers"].get("clustering E-step")
    if not launches or not s:
        return None
    return 100.0 * record["counts"]["estep_least_s"] * launches / s
