"""Kernels (K1): 100 x the least time of the `affinity` work
(`work/affinity.py`, from the traced frames' shapes) over the device time of
the kernels that file names. None where none of them ran."""

LAYER = "kernels"
UNIT = "%"
MOVES = "mps"


def read(trace):
    return trace.roofline_pct("affinity")
