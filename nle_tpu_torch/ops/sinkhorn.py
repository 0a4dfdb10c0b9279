"""Sinkhorn-Knopp balancing in the Nystrom factor space, plain PyTorch
(port of nle_tpu/ops/sinkhorn.py `sinkhorn_vectors`).

W = phi diag(lam) phi^T is never formed; each iteration is four skinny
(N, m) matvecs with the eps-guarded reciprocal (reference `sinkhorn`,
src/filter.cpp:230-254), in phi's dtype on phi's device. The routes that
run no kernel use it: use_kernels=False and the float64 route
(ops/pipeline.py). The kernel routes balance through K3/K4/K13/K14 and
K8/K9 (ops/kernels/).
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
