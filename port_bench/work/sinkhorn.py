"""K3 (K4 on a guard trip): the dense Sinkhorn half-steps of one frame.

2 x iters half-steps, each one pass over the rest block's factor: bytes
as the int16 carrier reads it (2 B an entry, (n - p) x m entries; an f32
pass after a guard trip reads twice that, so its share reads lower) plus
the float32 vectors (n in, 2 m), operations 4 an entry (a multiply-add
each way). The reduction of each pass's partial sums is timed with it.
"""

KERNELS = ("halfstep_bulk_kernel", "reduce_partials_kernel")


def count(f):
    nb = f.n - f.p
    steps = 2 * f.iters
    nbytes = steps * (2 * nb * f.m + 4 * (f.n + 2 * f.m))
    flops = steps * 4 * nb * f.m
    return flops, nbytes
