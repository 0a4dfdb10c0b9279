"""Stage 2a: ms a frame of the "Nystrom approximation + Sinkhorn" ranges'
self time (`port_bench/spans.py`): their duration less the spans inside
them on the same thread, the "Wait for device" for rc above all. In
single mode that is the host's queueing of K1, K3 and K6 and its carrier
guard on rc, without the wait."""

from port_bench.spans import self_ms_per_frame

LAYER = "stage 2a"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return self_ms_per_frame(trace, "Nystrom approximation + Sinkhorn")
