"""K10 and K11: the factored filter's passes over the rest pixels of one
frame, on one channel (the enhance's L plane).

Three sweeps of the q = n - p rest pixels against the p samples: the
apply's K10 (V^T y's tail, ap = K^T (c y)) and K11 (the output's tail,
K b), and training's s0 pass (ap0 = K^T 1), which runs K10's kernel too
and so is timed with it. Operations 12 an affinity entry a sweep
(ENTRY_FLOPS for the argument, the exponential not counted, and 2 for
the entry's multiply-add), as chip_smoke counts K10 and K11; bytes a sweep
the rest pixels' features and one row read or written and the p-side
operands, four bytes each. The kernels sum in float64 on fp32 entries; the
count is the fp32 algorithm's, so the share is of an fp32 bound. K10's
partials' reduction is left out (work/stream_halfstep.py). k does not
enter.
"""

from port_bench.roofline import ENTRY_FLOPS

KERNELS = ("stream_ap_kernel", "stream_atb_kernel")
SWEEPS = 3


def count(f):
    q = f.n - f.p
    flops = SWEEPS * (ENTRY_FLOPS + 2) * q * f.p
    nbytes = SWEEPS * 4 * (4 * q + 4 * f.p)
    return flops, nbytes
