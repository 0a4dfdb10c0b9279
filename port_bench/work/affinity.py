"""K1: the Nystrom rows phi_b = K(rest, samples) Uinv of one frame.

Operations: ENTRY_FLOPS for each of the (n - p) x p affinity entries
(their exponential not counted) and 2 (n - p) p m for the product with
Uinv (p, m). Bytes: the rest pixels' three features read, Uinv read, phi_b
written, all float32. m is the kept rank, not the padded width, so the
bound is what the frame needs.
"""

from port_bench.roofline import ENTRY_FLOPS

KERNELS = ("affinity_panel_kernel",)


def count(f):
    nb = f.n - f.p
    flops = ENTRY_FLOPS * nb * f.p + 2 * nb * f.p * f.m
    nbytes = 4 * (3 * nb + f.p * f.m + nb * f.m)
    return flops, nbytes
