"""Stage 2a: ms a frame in the "Nystrom approximation + Sinkhorn" ranges
(`ops/pipeline.py`, `models/batch.py`, `models/factored.py`), summed over
the traced window and divided by its frames. In stream mode they are the
host's queueing of the frame's stage 2a and its wait for rc; in single
mode the wait for the device is inside."""

LAYER = "stage 2a"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Nystrom approximation + Sinkhorn")
