"""Device: the share of the traced window in which no kernel, copy or set
ran on the card, 1 - (union of their intervals) / window."""

LAYER = "device"
UNIT = "fraction"
MOVES = "mps"


def read(trace):
    if trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
