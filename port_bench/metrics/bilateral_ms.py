"""Bilateral: ms a frame in the "Bilateral filter" range (`color/bilateral.py`,
plain PyTorch on the card), summed over the traced window and divided by
its frames. The range ends in a fetch, so its device time is inside."""

LAYER = "bilateral"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Bilateral filter")
