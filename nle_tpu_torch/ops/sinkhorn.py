"""Sinkhorn-Knopp balancing in the Nystrom factor space, plain PyTorch
(port of nle_tpu/ops/sinkhorn.py: `sinkhorn_vectors`, `sinkhorn`).

W = phi diag(lam) phi^T is never formed; each iteration is four skinny
(N, m) matvecs with the eps-guarded reciprocal (reference `sinkhorn`,
src/filter.cpp:230-254), in phi's dtype on phi's device. The routes that
run no kernel use it: use_kernels=False and the float64 route
(ops/pipeline.py). The kernel routes balance through K3/K4/K13/K14 and
K8/K9 (ops/kernels/). `sinkhorn` is the reference's dense free function:
the balanced blocks (Wa, Wab) themselves.
"""

from __future__ import annotations

import torch

from nle_tpu_torch.ops.linalg import safe_reciprocal


def sinkhorn_vectors(phi: torch.Tensor, lam: torch.Tensor, max_iter: int,
                     eps: float):
    """(r, c), each (N,): phi (N, m) the Nystrom factor, lam (m,) its
    masked eigenvalues."""
    n = phi.shape[0]
    r = torch.ones((n,), dtype=phi.dtype, device=phi.device)
    c = torch.zeros_like(r)

    def w_matvec(x):
        return phi @ (lam * (phi.T @ x))

    for _ in range(max_iter):
        c = safe_reciprocal(w_matvec(r), eps)
        r = safe_reciprocal(w_matvec(c), eps)
    return r, c


def balanced_top(phi: torch.Tensor, lam: torch.Tensor, r: torch.Tensor,
                 c: torch.Tensor, m: int):
    """(Ga, RGa, Wa) of the balanced filter's top block: Ga = phi[:m] lam,
    RGa = diag(r[:m]) Ga, Wa = RGa (diag(c[:m]) phi[:m])^T (m, m). The
    block boundary is the kept rank m, not p (the reference's sinkhorn
    reads p = phi.cols(), src/filter.cpp:247-250)."""
    phi_top = phi[:m]
    Ga = phi_top * lam[None, :]
    RGa = r[:m, None] * Ga
    return Ga, RGa, RGa @ (c[:m, None] * phi_top).T


def sinkhorn(phi: torch.Tensor, lam: torch.Tensor, max_iter: int = 10,
             eps: float = 1e-10):
    """The reference's dense free function (src/filter.cpp:230-254): (Wa
    (m, m), Wab (m, N - m)) with m = phi.shape[1], in phi's dtype on its
    device. Wab is (m, N - m): the pipeline never forms it; this form is
    for API parity."""
    r, c = sinkhorn_vectors(phi, lam, max_iter, eps)
    m = phi.shape[1]
    _, RGa, Wa = balanced_top(phi, lam, r, c, m)
    return Wa, RGa @ (c[m:, None] * phi[m:]).T
