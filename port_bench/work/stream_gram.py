"""K12: the Sb gram of one frame, once a train, in the float64 form the
program runs (the sample-basis gram).

The kernel forms H = (c K)^T (c K), (p, p), over the q = n - p rest
pixels: each affinity entry's argument in fp32 (ENTRY_FLOPS, the
exponential not counted), its product with c in float64 (one operation an
entry), and H's lower triangle with the diagonal in float64, q p (p + 1)
operations (a multiply-add each of its p (p + 1) / 2 elements a pixel).
The congruence Sb = Uinv^T H Uinv (p x p x m) is a library product and not
timed here, so m does not enter. The float64 operations are counted at
the card's float64 rate outside the tensor cores (H100 SXM: 34 TFLOP/s,
NVIDIA data sheet), as fp32-rate operations: each weighs
PEAK_FP32 / PEAK_FP64, so the share is of the bound of this kernel's own
work. Bytes: the rest pixels' three features and c read, the samples'
features read, four bytes each, and H written, eight bytes an element.
"""

from port_bench.roofline import ENTRY_FLOPS, PEAK_FP32

KERNELS = ("stream_sample_gram_kernel", "stream_sample_gram_reduce_kernel")
PEAK_FP64 = 34e12


def count(f):
    q = f.n - f.p
    f64_ops = q * f.p + q * f.p * (f.p + 1)
    flops = ENTRY_FLOPS * q * f.p + f64_ops * PEAK_FP32 / PEAK_FP64
    nbytes = 4 * (4 * q + 3 * f.p) + 8 * f.p * f.p
    return flops, nbytes
