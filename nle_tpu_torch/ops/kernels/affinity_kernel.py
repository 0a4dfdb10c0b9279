"""K1: fused Gaussian-affinity x matrix product (CUDA, csrc/affinity.cu on
the affinity core csrc/affinity_core.cuh).

Replaces nle_tpu/ops/pallas/affinity_kernel.py:113 `_kernel` (via
`affinity_matmul_pallas`, call at :226) and its p > 1024 variant
`_kernel_ptiled` (K2, :128, call at :252):
    out (q, m) = exp(-(sw (dr^2 + dc^2) + pw dy^2)) @ B
with dr, dc, dy raw integer feature differences, squared before scaling.
The affinity block lives only in shared memory; K_AB never reaches device
memory.

On the H100 the product is compute-bound (0.77 TFLOP fp32 FMA + 0.6 G expf
at the 1 MP main path, ~41 MB of traffic). The core (affinity_plan) builds
each affinity entry once per column panel of up to AFF_PANEL_COLS columns
and multiplies it into 8 x TN fp32 outputs a thread (TN = 12 on a full
panel), the B slabs arriving through a cp.async ring; K12's phi step runs
on the same core. Accuracy rules (IEEE expf, no FMA contraction in the
argument, fp32 FMA contraction, no TF32) are in the source. The TPU needs
K2 once a whole (p, m) B block no longer fits its VMEM; here B streams
through shared memory AFF_K samples at a time at any p, so one kernel
serves both contracts: the dense phi_b at p > 1024 and the streaming stage
2b's V tail (B = W = Uinv GrT) on dense sampling grids. Each output sums
its p terms in one increasing fmaf chain, whatever p and the plan are.

Dispatch rule (the same for every kernel of the port): a CPU tensor goes
to the plain PyTorch version; a CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nle_tpu_torch.ops.affinity import affinity_block
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import cuda_or_cpu, round_up

COL_TILE = 128    # mpad granularity (the JAX package's lane padding)
# The affinity core (csrc/affinity_core.cuh, whose AC_* constants mirror
# these): AFF_K samples a step; column panels of at most AFF_PANEL_COLS
# (32 TN columns, TN = 12, 8 or 4); AFF_ROWS pixel rows a block, 4 threads
# a row, each building AFF_BUILD entries a step and owning 8 rows x TN
# columns; a ring of AFF_STAGES slabs of B.
AFF_K = 16
AFF_PANEL_COLS = 384
AFF_ROWS = 64
AFF_STAGES = 3
AFF_BUILD = 4
P_TILE = AFF_K       # p pads to a multiple of the core's step
ROW_TILE = AFF_ROWS  # K1's out_rows, K12's Qpad and chunks: whole blocks
PLAIN_ROWS = 16384   # pixel rows of the plain version's affinity blocks


class AffinityPlan(NamedTuple):
    """The core's launch for (Qpad, Ppad, Mpad): column panels `panels`
    (widths, in column order; a block builds each entry of its rows once
    a panel), `rows` pixel rows a block of 4 * rows threads, a ring of
    `stages` B slabs of AFF_K samples; shared_bytes for the widest
    panel (the ring and two affinity tiles)."""
    panels: tuple[int, ...]
    rows: int
    stages: int

    @property
    def threads(self) -> int:
        return 4 * self.rows

    @property
    def shared_bytes(self) -> int:
        return 4 * (self.stages * AFF_K * max(self.panels)
                    + 2 * AFF_K * self.rows)


def affinity_plan(qpad: int, ppad: int, mpad: int) -> AffinityPlan:
    """The affinity core's plan: full AFF_PANEL_COLS panels, then one of
    the remaining 128 or 256 columns; a function of the shapes alone.
    Raises on shapes the kernel cannot take."""
    if qpad < AFF_ROWS or qpad % AFF_ROWS:
        raise ValueError(f"Qpad {qpad} must be a positive multiple of "
                         f"{AFF_ROWS}")
    if ppad < AFF_K or ppad % AFF_K:
        raise ValueError(f"Ppad {ppad} must be a positive multiple of "
                         f"{AFF_K}")
    if mpad < COL_TILE or mpad % COL_TILE:
        raise ValueError(f"the affinity core takes Mpad a positive multiple "
                         f"of {COL_TILE}; got {mpad}")
    full, rest = divmod(mpad, AFF_PANEL_COLS)
    return AffinityPlan((AFF_PANEL_COLS,) * full + ((rest,) if rest else ()),
                        AFF_ROWS, AFF_STAGES)


def _pad_out(out: torch.Tensor, out_rows: int, mpad: int) -> torch.Tensor:
    full = out.new_zeros((out_rows, mpad))
    full[:out.shape[0], :out.shape[1]] = out
    return full


def affinity_matmul_plain(fa, fb, B, sw, pw, out_rows: int | None = None):
    """Plain PyTorch K1, in the operands' dtype: (PLAIN_ROWS, p) affinity
    blocks materialized one at a time, each times B (nle_tpu's
    affinity_matmul_xla). out_rows gives the zero-tailed (out_rows, mpad)
    layout. The products sum in float64 and round once to the operands'
    dtype: an fp32 product on the CPU sums in the order of the BLAS's code
    path and thread split, which differ between processes and machines."""
    B64 = B.double()
    out = torch.cat([
        (affinity_block(fb[i:i + PLAIN_ROWS], fa, sw, pw).double() @ B64)
        .to(B.dtype) for i in range(0, max(fb.shape[0], 1), PLAIN_ROWS)])
    if out_rows is None:
        return out
    return _pad_out(out, out_rows, round_up(B.shape[1], COL_TILE))


def affinity_matmul_kernel(fa: torch.Tensor, fb: torch.Tensor,
                           B: torch.Tensor, sw: float, pw: float,
                           out_rows: int | None = None) -> torch.Tensor:
    """out (q, m) = exp-affinity(fb, fa) @ B; fa (p, 3) sample features,
    fb (q, 3) pixel features, B (p, m), all float32 on one device.

    out_rows: return the direct-write padded (out_rows, mpad128) buffer
    with rows >= q and columns >= m exact zero (the split stage 2a's rest
    block), instead of the (q, m) product. Must be a multiple of 64 and
    >= q."""
    p, q, m = fa.shape[0], fb.shape[0], B.shape[1]
    mpad = round_up(m, COL_TILE)
    if out_rows is not None and (out_rows % ROW_TILE or out_rows < q):
        raise ValueError(
            f"out_rows ({out_rows}) must be a {ROW_TILE} multiple >= the "
            f"true row count ({q})")
    # The operands are copied into padded staging buffers: any strides do.
    if not cuda_or_cpu(fa, fb, B, dtype=torch.float32, contiguous=False):
        return affinity_matmul_plain(fa, fb, B, sw, pw, out_rows)
    ppad = round_up(max(p, 1), P_TILE)
    qpad = out_rows if out_rows is not None else round_up(max(q, 1), ROW_TILE)
    affinity_plan(qpad, ppad, mpad)    # raises on shapes the core refuses
    lib = _build.load()
    fa_s = fa.new_zeros((3, ppad))
    fa_s[:, :p] = fa.T
    fb_s = fb.new_zeros((3, qpad))
    fb_s[:, :q] = fb.T
    Bp = B.new_zeros((ppad, mpad))
    Bp[:p, :m] = B
    out = torch.empty((qpad, mpad), dtype=torch.float32, device=fb.device)
    # The core's C entry on all Qpad rows (r0 0), the tail from q on zero.
    with torch.cuda.device(fb.device):
        _build.check(lib.nle_affinity_matmul(
            fb_s.data_ptr(), fa_s.data_ptr(), Bp.data_ptr(), out.data_ptr(),
            qpad, ppad, mpad, 0, qpad, q, float(sw), float(pw),
            _build.stream_ptr(fb_s)), "affinity_matmul")
    _build.count_launch("affinity_matmul")
    return out if out_rows is not None else out[:q, :m]
