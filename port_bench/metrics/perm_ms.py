"""Pixel order: ms a frame in the "Gather by perm" and "Scatter by perm"
spans (`models/filter.py`: the edit's gather into packed order and its
scatter back to pixel order, on the host), summed over the traced window
and divided by its frames."""

LAYER = "pixel order"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Gather by perm", "Scatter by perm")
