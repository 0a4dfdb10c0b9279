"""Eigensolvers and the eps-guarded inverses (port of nle_tpu/ops/linalg.py).

- `eigh64`: float64 LAPACK (scipy's evd solver, ascending), reading the
  LOWER triangle only — the repo-wide eigh rule.
- `eigh_descending` == `eigenDecomposition` (src/filter.cpp:204-228) on a
  tensor: the lower triangle mirrored, eigenvalues descending, those below
  eps masked to zero; in its dtype on its device, or with
  method="host64" in float64 LAPACK on the host.
- `topk_eigendecomposition`: the reference's optional Spectra path
  (src/filter.cpp:169-200) on ARPACK with a pinned start vector, so
  repeated trainings are bitwise repeatable.
- `safe_reciprocal` == `inplaceReciprocal` (src/filter.cpp:42-54):
  x -> 1/x where |x| >= eps else 0, on tensors; `safe_rsqrt` the
  x -> x^-1/2 where x >= eps else 0 of Lambda^{-1/2} (src/filter.cpp:
  289-291, 319-321).
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


def safe_rsqrt(x: torch.Tensor, eps: float) -> torch.Tensor:
    # x >= eps, not |x| >= eps: a negative x must give the masked 0.
    valid = x >= eps
    return torch.where(valid, torch.rsqrt(torch.where(valid, x,
                                                      torch.ones_like(x))),
                       torch.zeros_like(x))


EIGH_METHODS = ("xla", "host64", "host64-chain")


def eigh_descending(M: torch.Tensor, eps: float, method: str = "xla"):
    """Full symmetric eigendecomposition, descending, eps-masked: (U (n, n),
    lam (n,)) with lam[i] < eps replaced by 0. Only the lower triangle is
    read (mirrored explicitly, as Eigen's SelfAdjointEigenSolver reads it).

    method takes nle_tpu's strings: "xla" (and "host64-chain", whose float64
    work lives in an outer host chain) is torch.linalg.eigh in M's dtype on
    M's device; "host64" is float64 LAPACK on the host (eigh64), cast back
    to M's dtype and device."""
    if method not in EIGH_METHODS:
        # A misspelt method must not fall through to the f32 device eigh:
        # the chain's fidelity rests on which solver runs.
        raise ValueError(f"unknown eigh method {method!r} "
                         "(expected 'xla', 'host64', or 'host64-chain')")
    M = torch.tril(M) + torch.tril(M, -1).T
    if method == "host64":
        lam64, U64 = eigh64(M.detach().cpu().numpy().astype(np.float64))
        lam = torch.from_numpy(lam64).to(M.device, M.dtype)
        U = torch.from_numpy(U64).to(M.device, M.dtype)
    else:
        lam, U = torch.linalg.eigh(M)
    lam = torch.flip(lam, (0,))
    U = torch.flip(U, (1,))
    return U, torch.where(lam >= eps, lam, torch.zeros_like(lam))


def topk_eigendecomposition(M: np.ndarray, n_largest: int,
                            eps: float = 1e-10, *,
                            return_converged: bool = False):
    """Iterative top-k symmetric eigensolver on the host (ARPACK, largest
    magnitude, k clamped to n-1, eigenvalues below eps truncated).
    Non-convergence warns and continues, as the reference does; a hard
    ARPACK failure falls back to the dense solver. return_converged=True
    appends a bool, False when ARPACK stopped short: a short result that
    did not converge looks like an eps truncation by its length alone, so
    rank-finding callers (ka_eigh_topk_host64) need it."""
    import scipy.sparse.linalg as spla

    from nle_tpu_torch.utils.logging import logger

    M = np.asarray(M, np.float64)
    n = M.shape[0]
    k = min(n_largest, n - 1)
    converged = True
    if k < 1:
        lam, U = eigh64(M)
        lam, U = lam[::-1].copy(), U[:, ::-1].copy()
        keep = int(np.count_nonzero(lam >= eps))
        out = (U[:, :keep], lam[:keep])
        return (*out, True) if return_converged else out
    ncv = min(2 * k, n)
    v0 = np.full(n, 1.0 / np.sqrt(n))
    try:
        lam, U = spla.eigsh(M, k=k, which="LM", ncv=ncv, v0=v0)
    except spla.ArpackNoConvergence as e:
        logger.warning(
            "Eigen decomposition NOT successful. Results might be inaccurate."
        )
        lam, U = e.eigenvalues, e.eigenvectors
        converged = False
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
    return (U, lam, converged) if return_converged else (U, lam)
