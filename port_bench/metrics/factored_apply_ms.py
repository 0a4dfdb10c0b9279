"""Factored apply: ms a frame in the "Factored apply" spans
(`models/factored.py FactoredFilter.apply_u8`: the upload, the features of
the first apply, K10, K11, the round and clamp, and the wait for the
output; the host permutation around it is `perm_ms`), summed over the
traced window and divided by its frames."""

LAYER = "factored apply"
UNIT = "ms"
MOVES = "mps"


def read(trace):
    return trace.range_ms_per_frame("Factored apply")
