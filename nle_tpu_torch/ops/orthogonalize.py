"""Host float64 orthogonalization chain (port of nle_tpu/ops/orthogonalize.py
`_scaled_congruence` and `host_chain64`, arithmetic unchanged).

Reference semantics (src/filter.cpp:282-331):
    Wa^{-1/2} = U diag(lam^{-1/2}) U^T
    Q  = Wa + Wa^{-1/2} (Wab Wab^T) Wa^{-1/2}
    eig(Q) -> (Vq, Sq), top-k
    V  = [Wa; Wab^T] Wa^{-1/2} Vq diag(Sq^{-1/2})
With the Sinkhorn factorization Wab = diag(r_a) Ga (diag(c_b) phi_b)^T,
Wab Wab^T = RGa Sb RGa^T where Sb is the device gram of the scaled rest
block, so the chain here works on m x m matrices only. It is chaos-
sensitive (near-degenerate eig(Wa) tail amplified by Wa^{-1/2}); float32
here costs ~25 dB of golden PSNR, hence float64 on the host.
"""

from __future__ import annotations

import numpy as np
import scipy.linalg as sla
from scipy.linalg import blas as slb

from nle_tpu_torch.ops.linalg import eigh64, topk_eigendecomposition


def _scaled_congruence(B: np.ndarray, sb: np.ndarray) -> np.ndarray:
    """B @ sb @ B.T for the symmetric PSD Sb gram via chol(sb), dtrmm and
    dsyrk (~1.3 m^3 flops against 4 m^3 for two dgemms). Only the LOWER
    triangle of the result is guaranteed; every consumer reads the lower
    triangle. If f32 accumulation noise makes Sb numerically indefinite,
    Cholesky fails and the plain product is used (deterministic either
    way)."""
    try:
        L = sla.cholesky(sb, lower=True, check_finite=False)
    except np.linalg.LinAlgError:
        return (B @ sb) @ B.T
    C = slb.dtrmm(1.0, L, B, side=1, lower=1)       # C = B @ L
    out = slb.dsyrk(1.0, C, lower=1)                # lower(C @ C.T)
    return np.asarray(out)


def host_chain64(wa, rga, sb, k: int, eps: float, q_solver: str = "auto"):
    """Float64 evaluation of the orthogonalization small-matrix chain in
    eig(Wa)'s basis: with Wa = Uw L Uw^T and E = Uw^T diag(r) Ga,
    Q~ = L + D (E Sb E^T) D, D = diag(rsqrt-safe(L)), is similar to the
    reference's Q and costs 3 m^3 instead of 5.

    sb may be a zero-arg callable, resolved after eig(Wa) + E.
    q_solver: "auto" (ARPACK top-k when m >= 128 and 4k <= m, else full
    LAPACK), "evd" or "topk". Returns float64 (Va (m, k), GrT (m, k),
    Sq (k,))."""
    wa = np.asarray(wa, np.float64)
    rga = np.asarray(rga, np.float64)
    m = wa.shape[0]
    if q_solver not in ("auto", "evd", "topk"):
        raise ValueError(
            f"q_solver={q_solver!r}: expected auto|evd|topk "
            "(NLE_Q_SOLVER?)")

    def eigh_desc_raw(M):
        # scipy's eigh reads only the lower triangle.
        lam, U = eigh64(M)
        return U[:, ::-1].copy(), lam[::-1].copy()

    def rsqrt_safe(x):
        valid = np.abs(x) >= eps
        return np.where(valid, 1.0 / np.sqrt(np.where(valid, x, 1.0)), 0.0)

    Uw, lw_raw = eigh_desc_raw(wa)
    d = rsqrt_safe(np.where(lw_raw >= eps, lw_raw, 0.0))
    E = Uw.T @ rga                                     # (m, m)
    sb = np.asarray(sb() if callable(sb) else sb, np.float64)
    Qt = _scaled_congruence(d[:, None] * E, sb)
    # The reference adds the unmasked Wa, so the raw spectrum goes on the
    # diagonal.
    Qt[np.arange(m), np.arange(m)] += lw_raw

    if q_solver == "auto":
        q_solver = "topk" if (m >= 128 and 4 * k <= m) else "evd"
    if q_solver == "topk" and k >= m:
        q_solver = "evd"
    Vq = np.zeros((m, k))
    Sq = np.zeros(k)
    if q_solver == "topk":
        # ARPACK matvecs read the full matrix: mirror the lower triangle.
        qt_low = np.tril(Qt)
        Uq, lq = topk_eigendecomposition(
            qt_low + np.tril(Qt, -1).T, min(k, m - 1), eps)
        r = min(k, Uq.shape[1])
        Vq[:, :r] = Uq[:, :r]
        Sq[:r] = lq[:r]
    else:
        Uq, lq = eigh_desc_raw(Qt)
        lq = np.where(lq >= eps, lq, 0.0)
        Vq[:, : min(k, m)] = Uq[:, :k]
        Sq[: min(k, m)] = lq[:k]
    X = d[:, None] * (Vq * rsqrt_safe(Sq)[None, :])
    T = Uw @ X
    va = wa @ T
    grt = E.T @ X
    return va, grt, Sq
