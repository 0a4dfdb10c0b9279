"""Photometric-spatial Gaussian affinity (port of nle_tpu/ops/affinity.py).

K(i, j) = exp(-(dr^2 + dc^2)/hx^2 - (y_i - y_j)^2/hy^2)
(reference `negativeWeightedDistance` + bulk exp, src/filter.cpp:104-145).

Precision note (load-bearing for golden parity): coordinates and 8-bit
intensities are small integers, so their differences and squares are exact
in float32; the bandwidth weights sw = 1/hx^2, pw = 1/hy^2 scale only after
squaring. Scaling the features before differencing costs ~100x more
precision, amplified through the Nystrom chain.

- `affinity_block`: the dense (p, q) block (Ka is built in f64 on the host,
  see ops/pipeline.py; this form serves the plain versions).
- `affinity_matmul`: K_AB^T @ B without materializing K_AB — kernel K1
  (ops/kernels/affinity_kernel.py) on a CUDA tensor, the plain version on
  a CPU tensor.
"""

from __future__ import annotations

import numpy as np
import torch


def features(rows: torch.Tensor, cols: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
    """Raw pixel features (row, col, intensity) as (N, 3) float32 —
    unscaled on purpose (see the precision note)."""
    return torch.stack([rows.float(), cols.float(), y.float()], dim=-1)


def bandwidth_weights(hx, hy) -> tuple[float, float]:
    """(sw, pw) = (1/hx^2, 1/hy^2) computed in float64 like the reference
    (src/filter.cpp:128-129), then rounded to float32 — the values the
    kernels and the JAX package multiply with."""
    sw = 1.0 / (float(hx) * float(hx))
    pw = 1.0 / (float(hy) * float(hy))
    return float(np.float32(sw)), float(np.float32(pw))


def affinity_block(fa: torch.Tensor, fb: torch.Tensor, sw, pw) -> torch.Tensor:
    """Dense (p, q) affinity block from raw feature rows fa (p, 3), fb (q, 3)."""
    dr = fa[:, None, 0] - fb[None, :, 0]
    dc = fa[:, None, 1] - fb[None, :, 1]
    dy = fa[:, None, 2] - fb[None, :, 2]
    return torch.exp(-(sw * (dr * dr + dc * dc) + pw * (dy * dy)))


def affinity_matmul(fa: torch.Tensor, fb: torch.Tensor, B: torch.Tensor,
                    sw: float, pw: float, *,
                    out_rows: int | None = None) -> torch.Tensor:
    """Fused exp-affinity x matrix product: rows = fb pixels, cols = B
    columns. out_rows selects the zero-tailed padded layout (see
    affinity_matmul_kernel)."""
    from nle_tpu_torch.ops.kernels.affinity_kernel import (
        affinity_matmul_kernel,
    )

    return affinity_matmul_kernel(fa, fb, B, sw, pw, out_rows=out_rows)
