"""Host f64 eigensolvers and the eps-guarded reciprocal (port of
nle_tpu/ops/linalg.py).

- `eigh64`: float64 LAPACK (scipy's evd solver, ascending), reading the
  LOWER triangle only — the repo-wide eigh rule.
- `topk_eigendecomposition`: the reference's optional Spectra path
  (src/filter.cpp:169-200) on ARPACK with a pinned start vector, so
  repeated trainings are bitwise repeatable.
- `safe_reciprocal` == `inplaceReciprocal` (src/filter.cpp:42-54):
  x -> 1/x where |x| >= eps else 0, on tensors.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
import torch


def eigh64(M: np.ndarray):
    """Host float64 symmetric eigendecomposition (ascending)."""
    return sla.eigh(M, driver="evd", check_finite=False)


def safe_reciprocal(x: torch.Tensor, eps: float) -> torch.Tensor:
    valid = x.abs() >= eps
    return torch.where(valid, 1.0 / torch.where(valid, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def topk_eigendecomposition(M: np.ndarray, n_largest: int,
                            eps: float = 1e-10):
    """Iterative top-k symmetric eigensolver on the host (ARPACK, largest
    magnitude, k clamped to n-1, eigenvalues below eps truncated).
    Non-convergence warns and continues, as the reference does; a hard
    ARPACK failure falls back to the dense solver."""
    import scipy.sparse.linalg as spla

    from nle_tpu_torch.utils.logging import logger

    M = np.asarray(M, np.float64)
    n = M.shape[0]
    k = min(n_largest, n - 1)
    if k < 1:
        lam, U = eigh64(M)
        lam, U = lam[::-1].copy(), U[:, ::-1].copy()
        keep = int(np.count_nonzero(lam >= eps))
        return U[:, :keep], lam[:keep]
    ncv = min(2 * k, n)
    v0 = np.full(n, 1.0 / np.sqrt(n))
    try:
        lam, U = spla.eigsh(M, k=k, which="LM", ncv=ncv, v0=v0)
    except spla.ArpackNoConvergence as e:
        logger.warning(
            "Eigen decomposition NOT successful. Results might be inaccurate."
        )
        lam, U = e.eigenvalues, e.eigenvectors
    except spla.ArpackError as e:
        logger.warning(
            "Top-k eigensolver failed (%s); falling back to dense eigh.", e)
        lam, U = eigh64(M)
        sel = np.argsort(np.abs(lam))[::-1][:k]
        lam, U = lam[sel], U[:, sel]
    order = np.argsort(lam)[::-1]
    lam = lam[order]
    U = U[:, order]
    keep = int(np.count_nonzero(lam >= eps))
    if keep < lam.size:
        U, lam = U[:, :keep], lam[:keep]
    return U, lam
