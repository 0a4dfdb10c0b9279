"""Entry: ms a frame of the model layer's own work, the root spans'
(`NLEFilter.<method>`, `models/filter.py`) time that no other span
covers: its copies, casts and cache compares (`port_bench/spans.py`)."""

from port_bench.spans import model_self_ms_per_frame

LAYER = "entry"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return model_self_ms_per_frame(trace)
