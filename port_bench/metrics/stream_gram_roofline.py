"""Kernels (K12): 100 x the least time of the `stream_gram` work
(`work/stream_gram.py`, from the traced frames' shapes) over the device time
of the kernels that file names. None where none of them ran."""

LAYER = "kernels"
UNIT = "%"
MOVES = "mps"


def read(trace):
    return trace.roofline_pct("stream_gram")
