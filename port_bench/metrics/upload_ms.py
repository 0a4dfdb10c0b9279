"""Transfer: ms a frame in the "Upload" spans (`utils/transfer.py upload`:
the contiguous copy, the pinned staging copy and the enqueue), summed over
the traced window and divided by its frames."""

LAYER = "transfer"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Upload")
