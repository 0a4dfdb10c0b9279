"""Kernels (K10, K11; K10's kernel also runs training's s0 pass): 100 x
the least time of the `factored_apply` work (`work/factored_apply.py`, from
the traced frames' shapes) over the device time of the kernels that file
names. None where none of them ran."""

LAYER = "kernels"
UNIT = "%"
MOVES = "mps"


def read(trace):
    return trace.roofline_pct("factored_apply")
