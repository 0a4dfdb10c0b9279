"""Eigenvalue transforms that define the edits (port of
nle_tpu/ops/transform.py).

f(lam) = w0 + sum_{k>=1} (w_k - w_{k-1}) * lam^k — the polynomial that
re-weights the detail layers (reference transformEigenValues,
src/filter.cpp:334-347). Computed in float32 on the eigenvalues' device
with the same op order as nle_tpu's `_transform`, including XLA's
square-and-multiply expansion of an integer power and its fused
multiply-add, so the two packages give the same bits.

`shrink_eigenvalues` is the denoise transform lam -> min(lam, 1)^k
(reference src/filter.cpp:378-385), in the eigenvalues' dtype.
"""

from __future__ import annotations

import torch


def _integer_pow(x: torch.Tensor, k: int) -> torch.Tensor:
    """x**k by square-and-multiply, the expansion XLA uses for
    lax.integer_pow (acc *= x on set bits, x *= x between them)."""
    acc = None
    while k > 0:
        if k & 1:
            acc = x if acc is None else acc * x
        k >>= 1
        if k > 0:
            x = x * x
    return acc


def transform_eigenvalues(eigvals: torch.Tensor, weights) -> torch.Tensor:
    """f(S) in float32. Each fS + c * lam^k step is one fused multiply-add
    (a single rounding), as XLA compiles the JAX twin: c * lam^k is exact
    in float64 and the sum rounds once there before the float32 cast."""
    w = torch.as_tensor(list(weights), dtype=eigvals.dtype,
                        device=eigvals.device)
    fS = torch.full_like(eigvals, 0.0) + w[0]
    for k in range(1, w.shape[0]):
        term = (w[k] - w[k - 1]).double() * _integer_pow(eigvals, k).double()
        fS = (fS.double() + term).to(eigvals.dtype)
    return fS


def shrink_eigenvalues(eigvals: torch.Tensor, k) -> torch.Tensor:
    """min(lam, 1)^k in the eigenvalues' dtype; k is a real exponent (the
    CLI's shrink factor), so this is a pow, not a square-and-multiply."""
    k = torch.as_tensor(k, dtype=eigvals.dtype, device=eigvals.device)
    return torch.pow(torch.minimum(eigvals, torch.ones_like(eigvals)), k)
