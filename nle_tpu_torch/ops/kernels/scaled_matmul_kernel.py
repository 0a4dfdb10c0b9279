"""K6/K7: products of the row-scaled factor diag(c) phi with the scaling
fused, so c*phi never exists (CUDA, csrc/scaled_matmul.cu).

K6 replaces nle_tpu/ops/pallas/scaled_matmul_kernel.py:56 `_gram_kernel`
(via `scaled_gram_pallas`, call at :91): Sb = (diag(c) phi)^T (diag(c) phi).
K7 replaces :111 `_matmul_kernel` (via `scaled_matmul_pallas`, call at
:131): V = (diag(c) phi) B.

On the H100 both are fp32 FMA work on the CUDA cores (TF32 tensor cores
are off limits): K6 0.86 TFLOP over a 2.6 GB read at the 1 MP main path,
compute-bound; K7 0.17 TFLOP over 2.6 GB, near balance. The gram's sum
over N rows cannot ride one block as the TPU's sequential grid does: rows
are cut into fixed chunks whose partial grams a second kernel sums in
chunk order (no float atomics; bitwise repeatable).

Rows to exclude carry c = 0. c is (npad, 1) as in the JAX package.
"""

from __future__ import annotations

import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import cuda_or_cpu, round_up

# Rows per gram chunk: 1 M rows -> 64 partial grams (105 MB of scratch at
# mpad = 640) and enough blocks (10 x 10 x 64) to fill the card.
GRAM_CHUNK_ROWS = 16384


def scaled_gram_plain(phi: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    cphi = phi * c
    return cphi.T @ cphi


def scaled_matmul_plain(phi: torch.Tensor, c: torch.Tensor,
                        B: torch.Tensor) -> torch.Tensor:
    return (phi * c) @ B


def _check_rows(phi: torch.Tensor, c: torch.Tensor) -> None:
    if c.shape != (phi.shape[0], 1):
        raise ValueError(f"c {tuple(c.shape)} must be ({phi.shape[0]}, 1)")
    if phi.shape[0] % 64 or phi.shape[1] % 64:
        raise ValueError(
            f"phi {tuple(phi.shape)} must be padded to 64-multiples")


def scaled_gram(phi: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(diag(c) phi)^T (diag(c) phi) for phi (npad, mpad), c (npad, 1)."""
    _check_rows(phi, c)
    if not cuda_or_cpu(phi, c, dtype=torch.float32):
        return scaled_gram_plain(phi, c)
    lib = _build.load()
    npad, mpad = phi.shape
    nsplit = max(1, -(-npad // GRAM_CHUNK_ROWS))
    chunk = round_up(-(-npad // nsplit), 16)
    out = torch.empty((mpad, mpad), dtype=torch.float32, device=phi.device)
    partial = torch.empty((nsplit, mpad, mpad), dtype=torch.float32,
                          device=phi.device)
    with torch.cuda.device(phi.device):
        status = lib.nle_scaled_gram(
            phi.data_ptr(), c.data_ptr(), partial.data_ptr(), out.data_ptr(),
            npad, mpad, nsplit, chunk, _build.stream_ptr(phi))
    _build.check(status, "scaled_gram")
    _build.count_launch("scaled_gram")
    return out


def scaled_matmul(phi: torch.Tensor, c: torch.Tensor,
                  B: torch.Tensor) -> torch.Tensor:
    """(diag(c) phi) @ B for phi (npad, mpad), c (npad, 1), B (mpad, kpad)."""
    _check_rows(phi, c)
    if B.shape[0] != phi.shape[1] or B.shape[1] % 64:
        raise ValueError(f"B {tuple(B.shape)} must be ({phi.shape[1]}, 64k)")
    if not cuda_or_cpu(phi, c, B, dtype=torch.float32):
        return scaled_matmul_plain(phi, c, B)
    lib = _build.load()
    npad, mpad = phi.shape
    kpad = B.shape[1]
    out = torch.empty((npad, kpad), dtype=torch.float32, device=phi.device)
    with torch.cuda.device(phi.device):
        status = lib.nle_scaled_matmul(
            phi.data_ptr(), c.data_ptr(), B.data_ptr(), out.data_ptr(),
            npad, mpad, kpad, _build.stream_ptr(phi))
    _build.check(status, "scaled_matmul")
    _build.count_launch("scaled_matmul")
    return out
