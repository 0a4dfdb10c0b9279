"""Host chain: ms a frame in the "Orthogonalize" range (`ops/orthogonalize.py
host_chain64`, float64 on the host), summed over the traced window and
divided by its frames."""

LAYER = "host chain"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Orthogonalize")
