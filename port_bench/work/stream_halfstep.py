"""K8: the phi-free Sinkhorn half-steps of one frame.

2 x iters half-steps, each one sweep over the q = n - p rest pixels
against the p samples: operations 14 an affinity entry (ENTRY_FLOPS for
the entry's argument, the exponential not counted, and 4 for its terms of
w = K u and ap = K^T x), as chip_smoke counts K8 and K9; bytes the rest
pixels' three features and mask read, x written, u and ap (p) read and
written, four bytes each. The kernel sums in float64 on fp32 entries;
the count is the fp32 algorithm's, so the share is of an fp32 bound. The
s0 pass (x = 1) runs K10's kernel and is counted in work/factored_apply.py;
the partials' reduction (a few us a launch, its kernel shared with K10)
is left out of both. m and k do not enter.
"""

from port_bench.roofline import ENTRY_FLOPS

KERNELS = ("stream_halfstep_kernel",)


def count(f):
    q = f.n - f.p
    steps = 2 * f.iters
    flops = steps * (ENTRY_FLOPS + 4) * q * f.p
    nbytes = steps * 4 * (5 * q + 5 * f.p)
    return flops, nbytes
