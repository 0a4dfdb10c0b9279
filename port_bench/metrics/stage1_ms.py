"""Stage 1: ms a frame in the "Computing kernel" range (`ops/pipeline.py
ka_eigh_host64`, float64 Ka and eigh on the host), summed over the traced
window and divided by its frames."""

LAYER = "stage 1"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Computing kernel")
