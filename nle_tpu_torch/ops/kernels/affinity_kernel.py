"""K1: fused Gaussian-affinity x matrix product (CUDA, csrc/affinity.cu).

Replaces nle_tpu/ops/pallas/affinity_kernel.py:113 `_kernel` (via
`affinity_matmul_pallas`, call at :226) and its p > 1024 variant
`_kernel_ptiled` (K2, :128, call at :252):
    out (q, m) = exp(-(sw (dr^2 + dc^2) + pw dy^2)) @ B
with dr, dc, dy raw integer feature differences, squared before scaling.
The (rows, p) affinity block lives only in shared memory; K_AB never
reaches device memory.

On the H100 the product is compute-bound (0.77 TFLOP fp32 FMA + 0.6 G expf
at the 1 MP main path, ~41 MB of traffic). The first version is a plain
register-tiled fp32 SGEMM with the affinity generated in the operand load;
accuracy rules (IEEE expf, no FMA contraction in the argument, fp32 FMA
contraction, no TF32) are in the source. The TPU needs K2 once a whole
(p, m) B block no longer fits its VMEM; this kernel streams B through
shared memory 16 samples at a time at any p, so one kernel serves both
contracts: the dense phi_b at p > 1024 and the streaming stage 2b's
V tail (B = W = Uinv GrT) on dense sampling grids. Each output sums its p
terms in one increasing chain, whatever p is.

Dispatch rule (the same for every kernel of the port): a CPU tensor goes
to the plain PyTorch version; a CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

from nle_tpu_torch.ops.affinity import affinity_block
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import cuda_or_cpu, round_up

ROW_TILE = 64     # output rows per block
P_TILE = 16       # contraction step; p pads to a multiple of it
COL_TILE = 128    # mpad granularity (the JAX package's lane padding)


def _pad_out(out: torch.Tensor, out_rows: int, mpad: int) -> torch.Tensor:
    full = out.new_zeros((out_rows, mpad))
    full[:out.shape[0], :out.shape[1]] = out
    return full


def affinity_matmul_plain(fa, fb, B, sw, pw, out_rows: int | None = None):
    """Plain PyTorch K1: the (q, p) block materialized, then one fp32
    matmul. out_rows gives the zero-tailed (out_rows, mpad) layout."""
    out = affinity_block(fb, fa, sw, pw) @ B
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
    lib = _build.load()
    ppad = round_up(max(p, 1), P_TILE)
    qpad = out_rows if out_rows is not None else round_up(max(q, 1), ROW_TILE)
    fa_s = fa.new_zeros((3, ppad))
    fa_s[:, :p] = fa.T
    fb_s = fb.new_zeros((3, qpad))
    fb_s[:, :q] = fb.T
    Bp = B.new_zeros((ppad, mpad))
    Bp[:p, :m] = B
    out = torch.empty((qpad, mpad), dtype=torch.float32, device=fb.device)
    with torch.cuda.device(fb.device):
        status = lib.nle_affinity_matmul(
            fb_s.data_ptr(), fa_s.data_ptr(), Bp.data_ptr(), out.data_ptr(),
            qpad, q, ppad, mpad, float(sw), float(pw), _build.stream_ptr(fb))
    _build.check(status, "affinity_matmul")
    _build.count_launch("affinity_matmul")
    return out if out_rows is not None else out[:q, :m]
