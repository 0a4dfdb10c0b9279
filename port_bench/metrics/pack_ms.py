"""Pixel order: ms a frame in the "Sample grid" and "Pack channel" spans
(`ops/sampling.py sample_grid`: the grid and its perm; `ops/pipeline.py
pack_channel`: the training channel's gather into packed order), summed
over the traced window and divided by its frames."""

LAYER = "pixel order"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Sample grid", "Pack channel")
