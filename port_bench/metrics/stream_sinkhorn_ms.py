"""Stage 2a, factored route: ms a frame in the "Streaming Sinkhorn" span
(`ops/pipeline.py train_filter_stage2a_streaming`: the K8 half-step loop
with its float64 projections, up to the host's copy of r and c, so the
span lasts as long as the loop's device work), summed over the traced
window and divided by its frames."""

LAYER = "stage 2a"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Streaming Sinkhorn")
