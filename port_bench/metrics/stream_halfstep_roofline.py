"""Kernels (K8): 100 x the least time of the `stream_halfstep` work
(`work/stream_halfstep.py`, from the traced frames' shapes) over the device
time of the kernels that file names. None where none of them ran."""

LAYER = "kernels"
UNIT = "%"
MOVES = "mps"


def read(trace):
    return trace.roofline_pct("stream_halfstep")
