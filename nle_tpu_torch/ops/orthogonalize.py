"""Orthogonalization (port of nle_tpu/ops/orthogonalize.py: the host
float64 chain `_scaled_congruence` and `host_chain64`, arithmetic
unchanged; `orthogonalize_factored`, the whole-float64 route's chain on
the device; and `orthogonalize`, the reference's dense free function).

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

import torch

from nle_tpu_torch.ops.linalg import (
    eigh64,
    eigh_descending,
    safe_rsqrt,
    topk_eigendecomposition,
)
from nle_tpu_torch.utils.logging import chain_log


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
    Sq (k,)). Logs one chain_log record with the counts above eps."""
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
    wa_kept, q_kept = int(np.count_nonzero(d)), int(np.count_nonzero(Sq))
    chain_log.info("host chain: %d eigenvalues of Wa and %d of Q above eps "
                   "(k = %d)", wa_kept, q_kept, k,
                   extra={"wa_kept": wa_kept, "q_kept": q_kept, "k": k})
    X = d[:, None] * (Vq * rsqrt_safe(Sq)[None, :])
    T = Uw @ X
    va = wa @ T
    grt = E.T @ X
    return va, grt, Sq


def orthogonalize(Wa: torch.Tensor, Wab: torch.Tensor, n_eig_vectors: int = 5,
                  eps: float = 1e-10, eigh_method: str = "xla"):
    """The reference's dense free function (src/filter.cpp:282-331) on the
    explicit blocks Wa (m, m) and Wab (m, N - m): (V (N, k), Sq (k,)), k =
    min(n_eig_vectors, m), in the operands' dtype on their device. Both
    eighs read the lower triangle; eigh_method="host64" runs them in
    float64 LAPACK on the host (eigh_descending). The pipeline uses the
    factored forms; this one is for API parity."""
    Uw, lw = eigh_descending(Wa, eps, eigh_method)
    inv_root_wa = (Uw * safe_rsqrt(lw, eps)[None, :]) @ Uw.T
    Q = Wa + inv_root_wa @ (Wab @ Wab.T) @ inv_root_wa
    Uq, lq = eigh_descending(Q, eps, eigh_method)
    k = min(n_eig_vectors, Q.shape[0])
    Sq = lq[:k]
    T = inv_root_wa @ (Uq[:, :k] * safe_rsqrt(Sq, eps)[None, :])
    return torch.cat([Wa @ T, Wab.T @ T], dim=0), Sq


def orthogonalize_factored(Wa: torch.Tensor, RGa: torch.Tensor,
                           phi_b: torch.Tensor, c_b: torch.Tensor,
                           r_a: torch.Tensor, Ga: torch.Tensor,
                           n_eig_vectors: int, eps: float):
    """(V (N, k), Sq (k,)) in the operands' dtype on their device: the
    one-shot orthogonalization with Wab kept factored (Wab Wab^T = RGa Sb
    RGa^T, Sb = (c_b phi_b)^T (c_b phi_b)). Wa (m, m) the balanced top
    block, phi_b (N - m, m) the factor rows below it, c_b their Sinkhorn
    column scaling, r_a the top block's row scaling, Ga = phi[:m] * lam.
    The whole-float64 route (train_filter_stage2) runs it; the float32
    routes split it around host_chain64."""
    k = min(n_eig_vectors, Wa.shape[0])
    cphib = c_b[:, None] * phi_b
    Sb = cphib.T @ cphib
    Uw, lw = eigh_descending(Wa, eps)
    inv_root_wa = (Uw * safe_rsqrt(lw, eps)[None, :]) @ Uw.T
    Q = Wa + inv_root_wa @ (RGa @ Sb @ RGa.T) @ inv_root_wa
    Uq, lq = eigh_descending(Q, eps)
    Vq = Uq[:, :k]
    Sq = lq[:k]
    T = inv_root_wa @ (Vq * safe_rsqrt(Sq, eps)[None, :])
    Va = Wa @ T
    GrT = Ga.T @ (r_a[:, None] * T)
    return torch.cat([Va, cphib @ GrT], dim=0), Sq
