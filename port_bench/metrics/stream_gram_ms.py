"""Stage 2a, factored route: ms a frame in the "Streaming gram" span
(`ops/pipeline.py train_filter_stage2a_streaming`: K12's Sb, up to the
host's copy of it), summed over the traced window and divided by its
frames."""

LAYER = "stage 2a"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Streaming gram")
