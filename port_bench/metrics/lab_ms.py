"""Host color: ms a frame in the "BGR to Lab" and "Lab to BGR" ranges
(`color/lab.py` on `native/labcolor.c`), summed over the traced window and
divided by its frames."""

LAYER = "host color"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("BGR to Lab", "Lab to BGR")
