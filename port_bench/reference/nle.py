"""Plain reference of the nonlocal image edit, for the benchmark's check.

The arithmetic of the reference pipeline (upstream src/filter.cpp, as
tests/oracle_numpy.py writes it down in NumPy float64), in plain PyTorch
on a chosen device, so that a large frame fits on one card:

  sample grid -> Ka (float64) + eigh, truncated at eps -> Nystrom rows
  phi = [U; Kab^T U Lambda^-1] -> Sinkhorn (the oracle's r/c half-steps)
  -> orthogonalize (eigh of Wa, Q = Wa + Wa^-1/2 Wab Wab^T Wa^-1/2, top k)
  -> V = [Wa; Wab^T] Wa^-1/2 Vq Sq^-1/2 -> V diag(f(S)) V^T y, rounded.

It imports nothing of the program under test and takes only the frame.

Departures from the oracle, none of which changes the mathematics:
- phi (N, m) is built block by block and stored in float32 (half the
  bytes of float64); every product reads it back into `precision`
  (float64 for the reference) and sums across blocks in float64. The rounding to float32 is 6e-8 of an entry.
- Wab (m, N - m) is never formed: Wab Wab^T = RGa G RGa^T with the
  gram G = sum over blocks of (c phi)^T (c phi), and V's rest rows are
  c * (phi @ (RGa^T M)), made twice in blocks for the edit.
- Lab conversion is OpenCV's (cv2.cvtColor), which the upstream program
  calls and the oracle uses; the bilateral filter is
  cv::bilateralFilter's definition (reflect-101 border, circular
  support, Gaussian space and color weights, half-to-even rounding)
  evaluated in float64.

`precision=torch.bfloat16` is the control: the same N-scale products
with phi, the Sinkhorn vectors and V rounded to bfloat16 (the step that
would tempt a later change), the small host algebra still float64.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-10
# Rows of phi one block holds: about 2^27 float64 entries.
BLOCK_ENTRIES = 1 << 27


def lab_of(bgr_u8: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(np.ascontiguousarray(bgr_u8), cv2.COLOR_BGR2Lab)


def bgr_of(lab_u8: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.cvtColor(np.ascontiguousarray(lab_u8), cv2.COLOR_Lab2BGR)


def axis_samples(n: int, n_samples: int) -> np.ndarray:
    """samplePixels along one axis: step n // n_samples, centring offset,
    the inclusive upper bound r <= n - offset (src/filter.cpp:56-80)."""
    step = n // n_samples
    off = (step - 1 + (n - step * n_samples)) // 2
    r = np.arange(off, n)
    return r[(r <= n - off) & ((r - off) % step == 0)]


def packed_order(nrows: int, ncols: int, n_row_samples: int,
                 n_col_samples: int) -> tuple[np.ndarray, int]:
    """(perm, p): the flat pixel index of each packed row, the sampled
    pixels first (row-major), then the rest (row-major)."""
    if n_row_samples > nrows or n_col_samples > ncols:
        raise ValueError("more samples than pixels along an axis")
    sel = sample_pixels(nrows, ncols, n_row_samples, n_col_samples)
    mask = np.ones(nrows * ncols, bool)
    mask[sel] = False
    return np.concatenate([sel, np.nonzero(mask)[0]]), sel.size


def _recip(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    ok = x.abs() >= eps
    return torch.where(ok, 1.0 / torch.where(ok, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def _eigh_desc(M: torch.Tensor, eps: float = EPS):
    """eigh (lower triangle), descending, truncated at the first
    eigenvalue below eps (oracle eigen_decomposition)."""
    lam, U = torch.linalg.eigh(M)
    lam, U = lam.flip(0), U.flip(1)
    below = (lam < eps).nonzero()
    r = int(below[0]) if below.numel() else lam.numel()
    return U[:, :r], lam[:r]


def sample_pixels(nrows: int, ncols: int, n_row_samples: int,
                  n_col_samples: int) -> np.ndarray:
    """The flat pixel indices of the samples, row-major."""
    rs = axis_samples(nrows, n_row_samples)
    cs = axis_samples(ncols, n_col_samples)
    return (rs[:, None] * ncols + cs[None, :]).reshape(-1)


def kept_rank(y_sel: np.ndarray, sel: np.ndarray, ncols: int, hx: float,
              hy: float, eps: float = EPS) -> int:
    """The Nystrom rank m that stage 1 keeps: the eigenvalues of Ka, the
    float64 affinity of the samples (values y_sel at flat indices sel),
    down to the first below eps."""
    y = torch.from_numpy(np.asarray(y_sel, np.float64))
    r = torch.from_numpy((sel // ncols).astype(np.float64))
    c = torch.from_numpy((sel % ncols).astype(np.float64))
    return _eigh_desc(_kernel(r, c, y, r, c, y, hx, hy), eps)[1].numel()


def _kernel(r1, c1, y1, r2, c2, y2, hx, hy):
    """exp(-d2s / hx^2 - d2i / hy^2) between two pixel sets (rows 1,
    columns 2), float64 (src/filter.cpp:104-145)."""
    sw, pw = 1.0 / (hx * hx), 1.0 / (hy * hy)
    d = (r1[:, None] - r2[None, :]) ** 2
    d += (c1[:, None] - c2[None, :]) ** 2
    d *= -sw
    d -= pw * (y1[:, None] - y2[None, :]) ** 2
    return d.exp_()


class Filter:
    """A trained reference filter: phi (float32, packed order), the
    Sinkhorn c, and the small matrices of V = [Wa; Wab^T] M."""

    def __init__(self, channel: np.ndarray, n_row_samples: int,
                 n_col_samples: int, hx: float, hy: float, n_iter: int,
                 k: int, *, device, precision=torch.float64,
                 eps: float = EPS):
        self.device = torch.device(device)
        self.wd = precision
        nrows, ncols = channel.shape
        self.perm, p = packed_order(nrows, ncols, n_row_samples,
                                    n_col_samples)
        dev, f64 = self.device, torch.float64
        perm_d = torch.from_numpy(self.perm).to(dev)
        rr = (perm_d // ncols).to(f64)
        cc = (perm_d % ncols).to(f64)
        y = torch.from_numpy(np.ascontiguousarray(
            channel.reshape(-1)[self.perm], np.float64)).to(dev)
        n = y.numel()
        # Stage 1: Ka of the samples, eigh, truncation at eps.
        Ka = _kernel(rr[:p], cc[:p], y[:p], rr[:p], cc[:p], y[:p], hx, hy)
        U, lam = _eigh_desc(Ka.cpu(), eps)
        m = lam.numel()
        if m == 0:
            raise ValueError("Ka has no eigenvalue above eps")
        self.m, self.n = m, n
        self.block = max(1024, BLOCK_ENTRIES // max(p, m))
        U, lam = U.to(dev), lam.to(dev)
        # Nystrom rows: phi = [U; Kab^T U / lam], stored float32.
        phi = torch.empty((n, m), dtype=torch.float32, device=dev)
        phi[:p] = U
        uinv = U / lam[None, :]
        for lo in range(p, n, self.block):
            hi = min(lo + self.block, n)
            kb = _kernel(rr[lo:hi], cc[lo:hi], y[lo:hi], rr[:p], cc[:p],
                         y[:p], hx, hy)
            phi[lo:hi] = kb @ uinv
            del kb
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
        Uw, lw = _eigh_desc(Wa_h, eps)
        inv_root = _recip(lw, eps).sqrt()
        iw = (Uw * inv_root[None, :]) @ Uw.T
        Q = Wa_h + iw @ (RGa_h @ G_h @ RGa_h.T) @ iw
        Vq, Sq = _eigh_desc(Q, eps)
        k = min(k, Vq.shape[1])
        Vq, Sq = Vq[:, :k], Sq[:k]
        M = iw @ Vq * _recip(Sq, eps).sqrt()[None, :]
        self.S = Sq.numpy().copy()
        self.head = (Wa_h @ M).to(dev)              # V's rows below m
        self.tail = (RGa_h.T @ M).to(dev)           # V_rest = c phi tail

    def _w(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.wd)

    def _blocks(self, lo0: int = 0):
        for lo in range(lo0, self.n, self.block):
            yield lo, self.phi[lo:min(lo + self.block, self.n)]

    def _cols_dot(self, v: torch.Tensor) -> torch.Tensor:
        """phi^T v, summed in float64 across blocks."""
        out = torch.zeros(self.m, dtype=torch.float64, device=self.device)
        for lo, blk in self._blocks():
            out += (self._w(blk).T
                    @ self._w(v[lo:lo + blk.shape[0]])).to(torch.float64)
        return out

    def _halfstep(self, w: torch.Tensor):
        """v = 1 / (phi w) with the eps rule, and phi^T v, in one pass."""
        v = torch.empty(self.n, dtype=torch.float64, device=self.device)
        x = torch.zeros(self.m, dtype=torch.float64, device=self.device)
        ww = self._w(w)
        for lo, blk in self._blocks():
            b = self._w(blk)
            vb = _recip((b @ ww).to(torch.float64))
            v[lo:lo + b.shape[0]] = vb
            x += (b.T @ self._w(vb)).to(torch.float64)
        return v, x

    def _v_rows(self, lo: int, blk: torch.Tensor) -> torch.Tensor:
        """Rows lo.. of V (packed order), in the working precision."""
        hi = lo + blk.shape[0]
        V = self._w(blk) @ self._w(self.tail)
        V = V * self._w(self.c[lo:hi])[:, None]
        if lo < self.m:
            top = min(hi, self.m)
            V = V.clone()
            V[:top - lo] = self._w(self.head[lo:top])
        return V

    def apply_u8(self, planes_u8: np.ndarray, fS: np.ndarray) -> np.ndarray:
        """clip(rint(V diag(fS) V^T y)) of (H, W) or (H, W, C) uint8
        planes, pixel order in and out."""
        shape = planes_u8.shape
        y = planes_u8.reshape(self.n, -1)[self.perm]
        yd = torch.from_numpy(np.ascontiguousarray(y)).to(self.device)
        fs = torch.as_tensor(fS, dtype=torch.float64, device=self.device)
        t = torch.zeros((fs.numel(), y.shape[1]), dtype=torch.float64,
                        device=self.device)
        for lo, blk in self._blocks():
            V = self._v_rows(lo, blk)
            t += (V.T @ self._w(yd[lo:lo + blk.shape[0]])).to(torch.float64)
        t = self._w(fs[:, None] * t)
        out = torch.empty(yd.shape, dtype=torch.uint8, device=self.device)
        for lo, blk in self._blocks():
            f = (self._v_rows(lo, blk) @ t).to(torch.float64)
            out[lo:lo + blk.shape[0]] = f.round().clamp_(0, 255).to(
                torch.uint8)
        res = np.empty_like(y)
        res[self.perm] = out.cpu().numpy()
        return res.reshape(shape)


def shrink(S: np.ndarray, factor: float) -> np.ndarray:
    """min(S, 1)^factor (src/filter.cpp:378-385)."""
    return np.minimum(S, 1.0) ** factor


def bilateral_u8(L_u8: np.ndarray, sigma_color: float, sigma_space: float,
                 device) -> np.ndarray:
    """cv::bilateralFilter(d=-1) of an (H, W) uint8 plane, float64."""
    sc = float(sigma_color) if sigma_color > 0 else 1.0
    ss = float(sigma_space) if sigma_space > 0 else 1.0
    radius = max(int(round(ss * 1.5)), 1)
    h, w = L_u8.shape
    img = torch.from_numpy(L_u8.astype(np.float64)).to(device)
    rows = torch.from_numpy(np.pad(np.arange(h), radius, mode="reflect"))
    cols = torch.from_numpy(np.pad(np.arange(w), radius, mode="reflect"))
    pad = img[rows.to(device)][:, cols.to(device)]
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy * dy + dx * dx > radius * radius:
                continue
            win = pad[radius + dy:radius + dy + h, radius + dx:radius + dx + w]
            wgt = torch.exp(-0.5 * (win - img) ** 2 / (sc * sc)
                            - 0.5 * (dy * dy + dx * dx) / (ss * ss))
            num += wgt * win
            den += wgt
    return (num / den).round().clamp_(0, 255).to(torch.uint8).cpu().numpy()


def bilateral_at(L_u8: np.ndarray, sel: np.ndarray, sigma_color: float,
                 sigma_space: float) -> np.ndarray:
    """bilateral_u8's values at the flat pixel indices `sel` alone
    (float64 on the host; the same weights, border and rounding)."""
    sc = float(sigma_color) if sigma_color > 0 else 1.0
    ss = float(sigma_space) if sigma_space > 0 else 1.0
    radius = max(int(round(ss * 1.5)), 1)
    h, w = L_u8.shape
    rows = np.pad(np.arange(h), radius, mode="reflect")
    cols = np.pad(np.arange(w), radius, mode="reflect")
    r0, c0 = sel // w, sel % w
    img = L_u8.astype(np.float64)
    centre = img[r0, c0]
    num = np.zeros(sel.size)
    den = np.zeros(sel.size)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dy * dy + dx * dx > radius * radius:
                continue
            win = img[rows[r0 + radius + dy], cols[c0 + radius + dx]]
            wgt = np.exp(-0.5 * (win - centre) ** 2 / (sc * sc)
                         - 0.5 * (dy * dy + dx * dx) / (ss * ss))
            num += wgt * win
            den += wgt
    return np.clip(np.round(num / den), 0, 255)


def denoise(frame_bgr: np.ndarray, recipe, sigma_color: float,
            sigma_space: float, shrink_factor: float, *, device,
            precision=torch.float64):
    """(denoised BGR uint8, S): train on the bilateral-filtered L, filter
    both chroma planes with min(S, 1)^shrink (src/filter.cpp:349-410,
    521-538)."""
    lab = lab_of(frame_bgr)
    bl = bilateral_u8(lab[..., 0], sigma_color, sigma_space, device)
    flt = Filter(bl.astype(np.float64), *recipe, device=device,
                 precision=precision)
    out = lab.copy()
    out[..., 0] = bl
    out[..., 1:] = flt.apply_u8(np.ascontiguousarray(lab[..., 1:]),
                                shrink(flt.S, shrink_factor))
    return bgr_of(out), flt.S
