"""Plain reference of the enhance, for the benchmark's check.

The reference's trainForEnhancement and enhance (upstream
src/filter.cpp:412-443, 514-519, as tests/oracle_numpy.py enhance_image
writes them down): train the filter on the 8-bit Lab L plane, then
L' = clip(rint(V diag(f(S)) V^T L)) with f(lambda) = w0 + sum_{k>=1}
(w_k - w_{k-1}) lambda^k (transformEigenValues, src/filter.cpp:334-347),
back to BGR. In plain PyTorch on a chosen device; it imports nothing of
the program under test.

Training is reference/nle.py's (stage 1 in float64, phi stored float32
and read back into `precision` block by block, the Sinkhorn sums in
float64), and so is the edit (nle.Filter.apply_u8). One step is
evaluated otherwise, with the same mathematics: the orthogonalization.
nle.Filter forms Q = Wa + Wa^-1/2 B Wa^-1/2 (B = Wab Wab^T) as dense
products, whose float64 rounding reaches |Wa^-1/2|^2 |B| 1e-16, about
1e-10 here: it lifts eigenvalues of Q that are Wa's dropped ones (below
eps, where Wa^-1/2 is zero) over eps = 1e-10, by amounts that change with
the summation order (the CPU's thread count moves them). Here Q is taken
in Wa's eigenbasis, Wa = Uw diag(lw) Uw^T (all of lw, as Q adds the whole
Wa): Q~ = diag(lw) + D (Uw^T B Uw) D with D = diag(lw^-1/2) on lw >= eps
and 0 elsewhere, the matrix Uw^T Q Uw, so Q's eigenvalues, their cut at
eps and V = [Wa; Wab^T] Wa^-1/2 Vq Sq^-1/2 are the reference's, and the
dropped directions of Wa stay Q's eigenvalues below eps, as in exact
arithmetic.

`precision=torch.bfloat16` is the control, as in reference/nle.py.
"""

from __future__ import annotations

import numpy as np
import torch

from . import nle

EPS = nle.EPS


def transform(S: np.ndarray, weights) -> np.ndarray:
    """f(S) in float64 (src/filter.cpp:334-347)."""
    S = np.asarray(S, np.float64)
    out = np.full(S.shape, float(weights[0]))
    for k in range(1, len(weights)):
        out += (float(weights[k]) - float(weights[k - 1])) * S ** k
    return out


class Filter(nle.Filter):
    """nle.Filter's training with Q's eigenpairs taken in Wa's
    eigenbasis; its edit (apply_u8) unchanged. Also keeps the counts
    above eps: `wa_kept` (eigenvalues of Wa) and `q_kept` (S's size)."""

    def __init__(self, channel: np.ndarray, n_row_samples: int,
                 n_col_samples: int, hx: float, hy: float, n_iter: int,
                 k: int, *, device, precision=torch.float64,
                 eps: float = EPS):
        self.device = torch.device(device)
        self.wd = precision
        nrows, ncols = channel.shape
        self.perm, p = nle.packed_order(nrows, ncols, n_row_samples,
                                        n_col_samples)
        dev, f64 = self.device, torch.float64
        perm_d = torch.from_numpy(self.perm).to(dev)
        rr = (perm_d // ncols).to(f64)
        cc = (perm_d % ncols).to(f64)
        y = torch.from_numpy(np.ascontiguousarray(
            channel.reshape(-1)[self.perm], np.float64)).to(dev)
        del perm_d
        n = y.numel()
        # Stage 1: Ka of the samples, eigh, truncation at eps.
        Ka = nle._kernel(rr[:p], cc[:p], y[:p], rr[:p], cc[:p], y[:p], hx,
                         hy)
        U, lam = nle._eigh_desc(Ka.cpu(), eps)
        m = lam.numel()
        if m == 0:
            raise ValueError("Ka has no eigenvalue above eps")
        self.m, self.n = m, n
        self.block = max(1024, nle.BLOCK_ENTRIES // max(p, m))
        U, lam = U.to(dev), lam.to(dev)
        # Nystrom rows: phi = [U; Kab^T U / lam], stored float32.
        phi = torch.empty((n, m), dtype=torch.float32, device=dev)
        phi[:p] = U
        uinv = U / lam[None, :]
        for lo in range(p, n, self.block):
            hi = min(lo + self.block, n)
            kb = nle._kernel(rr[lo:hi], cc[lo:hi], y[lo:hi], rr[:p], cc[:p],
                             y[:p], hx, hy)
            phi[lo:hi] = kb @ uinv
            del kb
        del rr, cc, y
        self.phi = phi
        self.u64 = U
        # Sinkhorn: c = 1 / (phi (lam phi^T r)), r = 1 / (phi (lam phi^T c)).
        x = self._cols_dot(torch.ones(n, dtype=f64, device=dev))
        c = r = None
        for _ in range(n_iter):
            c, x = self._halfstep(lam * x)
            r, x = self._halfstep(lam * x)
        self.c = c
        # Orthogonalize, with the balanced block boundary at m.
        phi_a = self.u64[:m]
        RGa = r[:m, None] * (phi_a * lam[None, :])
        Wa = RGa @ (c[:m, None] * phi_a).T
        G = torch.zeros((m, m), dtype=f64, device=dev)
        for lo, blk in self._blocks(m):
            cb = self._w(blk) * self._w(c[lo:lo + blk.shape[0]])[:, None]
            G += (cb.T @ cb).to(f64)
        Wa_h, RGa_h, G_h = Wa.cpu(), RGa.cpu(), G.cpu()
        # eigh reads Wa's lower triangle, as nle._eigh_desc's does.
        lw, Uw = torch.linalg.eigh(Wa_h)
        lw, Uw = lw.flip(0), Uw.flip(1)
        keep = lw >= eps
        self.wa_kept = int(keep.sum())
        D = torch.where(keep, lw.clamp(min=eps).rsqrt(), torch.zeros_like(lw))
        E = Uw.T @ RGa_h
        Qt = D[:, None] * (E @ G_h @ E.T) * D[None, :]
        Qt += torch.diag(lw)
        Vt, Sq = nle._eigh_desc(Qt, eps)
        k = min(k, Vt.shape[1])
        Vt, Sq = Vt[:, :k], Sq[:k]
        self.q_kept = int(Sq.numel())
        M = Uw @ (D[:, None] * Vt) * nle._recip(Sq, eps).sqrt()[None, :]
        self.S = Sq.numpy().copy()
        self.head = (Wa_h @ M).to(dev)              # V's rows below m
        self.tail = (RGa_h.T @ M).to(dev)           # V_rest = c phi tail


def enhance(frame_bgr: np.ndarray, recipe, weights, *, device,
            precision=torch.float64):
    """(enhanced BGR uint8, S, (wa_kept, q_kept)): train on the Lab L
    plane with `recipe` (rows, cols, hx, hy, iterations, k), edit L with
    f(S) (src/filter.cpp:412-443, 514-519)."""
    lab = nle.lab_of(frame_bgr)
    L = np.ascontiguousarray(lab[..., 0])
    flt = Filter(L.astype(np.float64), *recipe, device=device,
                 precision=precision)
    out = lab.copy()
    out[..., 0] = flt.apply_u8(L, transform(flt.S, weights))
    return nle.bgr_of(out), flt.S, (flt.wa_kept, flt.q_kept)
