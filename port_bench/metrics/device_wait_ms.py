"""Transfer: ms a frame in the "Wait for device" spans (`utils/transfer.py
Fetch.result`: the host blocked on the card's copy event), summed over the
traced window and divided by its frames."""

LAYER = "transfer"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Wait for device")
