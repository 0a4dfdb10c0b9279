"""K6/K7: products of the row-scaled factor diag(c) phi with the scaling
fused, so c*phi never exists (CUDA, csrc/scaled_matmul.cu).

K6 replaces nle_tpu/ops/pallas/scaled_matmul_kernel.py:56 `_gram_kernel`
(via `scaled_gram_pallas`, call at :91): Sb = (diag(c) phi)^T (diag(c) phi).
K7 replaces :111 `_matmul_kernel` (via `scaled_matmul_pallas`, call at
:131): V = (diag(c) phi) B.

On the H100 both are fp32 FMA work on the CUDA cores (TF32 tensor cores
are off limits): K6's lower triangle is 0.50 TFLOP over a 2.6 GB read at
the 1 MP main path, compute-bound; K7 at kpad 64 is 0.08 TFLOP over
2.85 GB, near balance. K6 computes the 128 x 128 tiles of the lower
triangle only, over row splits chosen from the shapes alone (gram_plan);
a second kernel sums the splits in order and writes both triangles from
one value (no float atomics; bitwise symmetric and repeatable). K7 reads
phi once at kpad <= 128 and sums each output in increasing k.

Rows to exclude carry c = 0. c is (npad, 1) as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import cuda_or_cpu, round_up

GRAM_TILE = 128           # K6's output tile edge and column panel width
GRAM_SLAB = 32            # rows K6 stages a step; splits are multiples
# The longest fp32 register chain K6 runs, in rows: a block adds its
# accumulator into its scratch slot after every GRAM_CHAIN_ROWS rows, a
# 64 KB add that costs little beside the 2 MB of phi a chain reads.
GRAM_CHAIN_ROWS = 2048
# Blocks of K6 resident on an H100 SXM at once: 132 SMs x 2 (a 99 KB ring
# and <= 128 registers a thread). A constant, not a query: the plan, and so
# the summation order, depends on the shapes alone.
GRAM_SLOTS = 264
GRAM_MAX_WAVES = 4
GRAM_MIN_SPLIT_ROWS = 2048
# K7's widest B: kpad a multiple of 32 up to 256.
MATMUL_COL_ALIGN = 32
MATMUL_MAX_COLS = 256
PLAIN_GRAM_ROWS = 65536    # rows of the plain K6/K7's float64 chunks


class GramPlan(NamedTuple):
    """K6's row plan: split k covers rows [k split_rows, min((k + 1)
    split_rows, npad)), walked in register chains of chain_rows rows."""
    tiles: int
    nsplit: int
    split_rows: int
    chain_rows: int

    @property
    def scratch_bytes(self) -> int:
        return 4 * self.nsplit * self.tiles * GRAM_TILE * GRAM_TILE


def gram_plan(npad: int, mpad: int) -> GramPlan:
    """The split count whose tiles x splits best fills whole waves of
    GRAM_SLOTS blocks (ties to fewer splits), at most GRAM_MAX_WAVES waves
    and splits of at least GRAM_MIN_SPLIT_ROWS rows. A function of
    (npad, mpad) alone."""
    if npad < GRAM_SLAB or npad % GRAM_SLAB or mpad < GRAM_TILE \
            or mpad % GRAM_TILE:
        raise ValueError(f"K6 takes npad % {GRAM_SLAB} == 0 and mpad % "
                         f"{GRAM_TILE} == 0; got ({npad}, {mpad})")
    panels = mpad // GRAM_TILE
    tiles = panels * (panels + 1) // 2
    cap = max(1, min(npad // GRAM_MIN_SPLIT_ROWS,
                     -(-GRAM_MAX_WAVES * GRAM_SLOTS // tiles)))

    def fill(s: int) -> float:
        blocks = tiles * s
        return blocks / (GRAM_SLOTS * -(-blocks // GRAM_SLOTS))

    best = max(range(1, cap + 1), key=lambda s: (fill(s), -s))
    split_rows = round_up(-(-npad // best), GRAM_SLAB)
    return GramPlan(tiles, -(-npad // split_rows), split_rows,
                    GRAM_CHAIN_ROWS)


def scaled_gram_plain(phi: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(diag(c) phi)^T (diag(c) phi), summed in float64 by row chunks and
    rounded once to phi's dtype. An fp32 gram on the CPU sums in the order
    of the BLAS's run-time thread split, so its bits differ between
    processes; the float64 sum's one rounding does not."""
    acc = torch.zeros((phi.shape[1], phi.shape[1]), dtype=torch.float64,
                      device=phi.device)
    for lo in range(0, phi.shape[0], PLAIN_GRAM_ROWS):
        cphi = (phi[lo:lo + PLAIN_GRAM_ROWS]
                * c[lo:lo + PLAIN_GRAM_ROWS]).double()
        acc += cphi.T @ cphi
    return acc.to(phi.dtype)


def scaled_matmul_plain(phi: torch.Tensor, c: torch.Tensor,
                        B: torch.Tensor) -> torch.Tensor:
    """(diag(c) phi) @ B, summed in float64 by row chunks and rounded once
    to phi's dtype (as scaled_gram_plain, for the same reason)."""
    B64 = B.double()
    return torch.cat([
        ((phi[lo:lo + PLAIN_GRAM_ROWS] * c[lo:lo + PLAIN_GRAM_ROWS]).double()
         @ B64).to(phi.dtype)
        for lo in range(0, max(phi.shape[0], 1), PLAIN_GRAM_ROWS)])


def _check_rows(phi: torch.Tensor, c: torch.Tensor) -> None:
    if c.shape != (phi.shape[0], 1):
        raise ValueError(f"c {tuple(c.shape)} must be ({phi.shape[0]}, 1)")
    if phi.shape[0] % 64 or phi.shape[1] % 64:
        raise ValueError(
            f"phi {tuple(phi.shape)} must be padded to 64-multiples")


def _check_aligned(*tensors: torch.Tensor) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("kernel operands must be 16-byte aligned")


def scaled_gram(phi: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(diag(c) phi)^T (diag(c) phi) for phi (npad, mpad), c (npad, 1).
    On the card mpad must be a multiple of 128 (the path's rank bucket
    padding)."""
    _check_rows(phi, c)
    if not cuda_or_cpu(phi, c, dtype=torch.float32):
        return scaled_gram_plain(phi, c)
    npad, mpad = phi.shape
    plan = gram_plan(npad, mpad)
    _check_aligned(phi, c)
    lib = _build.load()
    out = torch.empty((mpad, mpad), dtype=torch.float32, device=phi.device)
    partial = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                          device=phi.device)
    with torch.cuda.device(phi.device):
        status = lib.nle_scaled_gram(
            phi.data_ptr(), c.data_ptr(), partial.data_ptr(), out.data_ptr(),
            npad, mpad, plan.nsplit, plan.split_rows, plan.chain_rows,
            _build.stream_ptr(phi))
    _build.check(status, "scaled_gram")
    _build.count_launch("scaled_gram")
    return out


def scaled_matmul(phi: torch.Tensor, c: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """(diag(c) phi) @ B for phi (npad, mpad), c (npad, 1), B (mpad, kpad)
    with kpad a multiple of 32 (on the card at most 256)."""
    _check_rows(phi, c)
    if B.shape[0] != phi.shape[1] or B.shape[1] % MATMUL_COL_ALIGN:
        raise ValueError(f"B {tuple(B.shape)} must be ({phi.shape[1]}, "
                         f"{MATMUL_COL_ALIGN}k)")
    if not cuda_or_cpu(phi, c, B, dtype=torch.float32):
        return scaled_matmul_plain(phi, c, B)
    npad, mpad = phi.shape
    kpad = B.shape[1]
    if not 0 < kpad <= MATMUL_MAX_COLS:
        raise ValueError(f"K7 takes at most {MATMUL_MAX_COLS} columns of B; "
                         f"got {kpad}")
    out = torch.empty((npad, kpad), dtype=torch.float32, device=phi.device)
    _check_aligned(phi, c, B, out)
    lib = _build.load()
    with torch.cuda.device(phi.device):
        status = lib.nle_scaled_matmul(
            phi.data_ptr(), c.data_ptr(), B.data_ptr(), out.data_ptr(),
            npad, mpad, kpad, _build.stream_ptr(phi))
    _build.check(status, "scaled_matmul")
    _build.count_launch("scaled_matmul")
    return out
