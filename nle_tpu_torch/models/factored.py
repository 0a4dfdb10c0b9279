"""The V-free factored filter: the capacity path past the stored (N, k) V
(port of nle_tpu/models/factored.py).

A trained filter is V diag(S) V^T with V (N, k): 200 B/pixel at k = 50.
But V's tail rows are V_rest = diag(c_rest) K W with W = Uinv GrT (p, k),
so applying the filter needs only the (p, k) head/W pair, the Sinkhorn
vector c, and the training features: ~17 B/pixel. The tail rows are
regenerated at apply time by two streaming passes (K10, K11), and training
runs the phi-free stage 2a (K8, or K9 past 1792 samples, and K12) and
stops before V. Every piece takes any sampling density.

`FactoredFilter.save/load` use the JAX package's npz format (y_train, c,
v_head, w, eigvals, shape, bandwidths, perm, factored), so a factored filter
trained by either package edits in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nle_tpu_torch.config import EPS, resolve_device
from nle_tpu_torch.ops.affinity import bandwidth_weights
from nle_tpu_torch.ops.pipeline import (
    bucket_m,
    factored_apply,
    factored_filter_pieces,
    host_orthogonalize,
    ka_eigh_host64,
    pack_channel,
    pack_stage1,
    train_filter_stage2a_streaming,
)
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.utils.logging import stage, warn_truncation


@dataclasses.dataclass
class FactoredFilter:
    """Apply-only factored filter state, in packed [selected; rest] order;
    the tensors live on one device."""

    y_train: np.ndarray    # (N,) packed training channel (uint8 or f32)
    c: torch.Tensor        # (N,) Sinkhorn column vector
    v_head: torch.Tensor   # (p, k) sampled-pixel rows of V
    w: torch.Tensor        # (p, k) tail generator Uinv GrT
    eigvals: torch.Tensor  # (k,)
    nrows: int
    ncols: int
    hx: float              # the affinity bandwidths: the tail is
    hy: float              # regenerated from features, so they are state
    perm: np.ndarray       # packed-order permutation
    # (rr, cc, y_train) as float32 on the filter's device, built at the first
    # apply and kept on the filter, so they free with it.
    _dev: tuple | None = dataclasses.field(
        default=None, init=False, repr=False, compare=False)

    @property
    def n_pixels(self) -> int:
        return self.nrows * self.ncols

    def _device_state(self):
        if self._dev is None:
            dev = self.c.device
            perm = torch.from_numpy(self.perm).to(dev)
            y = torch.from_numpy(np.ascontiguousarray(self.y_train)).to(dev)
            self._dev = ((perm // self.ncols).to(torch.float32),
                         (perm % self.ncols).to(torch.float32),
                         y.to(torch.float32))
        return self._dev

    def _apply_packed(self, y_packed: torch.Tensor, f_eigvals) -> torch.Tensor:
        rr, cc, y_train = self._device_state()
        sw, pw = bandwidth_weights(self.hx, self.hy)
        fs = torch.as_tensor(f_eigvals, dtype=torch.float32,
                             device=self.c.device)
        return factored_apply(y_packed, y_train, rr, cc, self.c, self.v_head,
                              self.w, fs, sw, pw, p=self.v_head.shape[0])

    def apply(self, channel, transformed_eigvals) -> np.ndarray:
        """V diag(f(S)) V^T c on a pixel-order channel, no clamp (host array
        in and out, the contract of NLEFilter.apply)."""
        channel_np = np.asarray(channel)
        if channel_np.size != self.n_pixels:
            raise ValueError(
                "Number of values in channel must match that of training "
                "image.")
        flat = channel_np.reshape(-1).astype(np.float32)[self.perm]
        out = self._apply_packed(
            torch.from_numpy(flat).to(self.c.device),
            transformed_eigvals).cpu().numpy()
        unpacked = np.empty_like(out)
        unpacked[self.perm] = out
        return unpacked.reshape(channel_np.shape)

    def apply_u8(self, channels_u8, scale_vals) -> np.ndarray:
        """Filter and clamp 8-bit channel(s), pixel order in and out, (H, W)
        or (H, W, C). All C channels ride one K10/K11 pass pair as kernel
        rows."""
        channels_u8 = np.asarray(channels_u8)
        flat = channels_u8.reshape(self.n_pixels, -1)[self.perm]   # (N, C)
        y = torch.from_numpy(np.ascontiguousarray(flat.T)).to(self.c.device)
        filt = self._apply_packed(y.to(torch.float32), scale_vals)
        out_t = torch.clamp(torch.round(filt), 0, 255).to(torch.uint8)
        unpacked = np.empty_like(flat)
        unpacked[self.perm] = out_t.cpu().numpy().T
        return unpacked.reshape(channels_u8.shape)

    def save(self, path: str) -> None:
        np.savez_compressed(
            path,
            y_train=self.y_train,
            c=self.c.cpu().numpy(),
            v_head=self.v_head.cpu().numpy(),
            w=self.w.cpu().numpy(),
            eigvals=self.eigvals.cpu().numpy(),
            shape=np.array([self.nrows, self.ncols]),
            bandwidths=np.array([self.hx, self.hy], np.float64),
            perm=self.perm,
            factored=np.array(True),
        )

    def to(self, device) -> "FactoredFilter":
        """This filter with its tensors on `device`."""
        dev = resolve_device(device)
        return dataclasses.replace(
            self, c=self.c.to(dev), v_head=self.v_head.to(dev),
            w=self.w.to(dev), eigvals=self.eigvals.to(dev))

    @classmethod
    def from_numpy(cls, arrays, device) -> "FactoredFilter":
        """Build from a mapping of host arrays (the npz keys), uploading to
        `device` ("cuda" or "cpu")."""
        dev = resolve_device(device)

        def up(key):
            return torch.from_numpy(np.asarray(arrays[key])).to(dev)

        return cls(
            y_train=np.asarray(arrays["y_train"]), c=up("c"),
            v_head=up("v_head"), w=up("w"), eigvals=up("eigvals"),
            nrows=int(arrays["shape"][0]), ncols=int(arrays["shape"][1]),
            hx=float(arrays["bandwidths"][0]),
            hy=float(arrays["bandwidths"][1]),
            perm=np.asarray(arrays["perm"]))

    @classmethod
    def load(cls, path: str, device) -> "FactoredFilter":
        from nle_tpu_torch.models.filter import load_filter_host

        return cls.from_numpy(load_filter_host(path), device)


def train_filter_factored(channel, n_row_samples: int, n_col_samples: int,
                          hx: float, hy: float, n_sinkhorn_iter: int = 10,
                          n_eig_vectors: int = 5, *, device,
                          eps: float | None = None) -> FactoredFilter:
    """Train a V-free factored filter on one channel (H, W) on `device`:
    the phi-free stage 2a (K8/K9 Sinkhorn, K12 gram), the host f64 chain, and
    the (p, k) head pieces; the (N, k) V is never built."""
    dev = resolve_device(device)
    channel_np = np.asarray(channel)
    nrows, ncols = channel_np.shape
    if eps is None:
        eps = EPS
    grid = sample_grid(nrows, ncols, n_row_samples, n_col_samples)
    p = grid.n_samples
    perm = torch.from_numpy(grid.perm).to(dev)
    rr = (perm // ncols).to(torch.float32)
    cc = (perm % ncols).to(torch.float32)
    del perm
    sw, pw = bandwidth_weights(hx, hy)
    packed_np, _ = pack_channel(channel_np, grid.perm)
    y = torch.from_numpy(np.ascontiguousarray(packed_np)).to(dev).to(
        torch.float32)

    with stage("Computing kernel"):
        Um64, lam64, _ = ka_eigh_host64(
            channel_np[grid.sel_rows, grid.sel_cols].astype(np.float64),
            grid.sel_rows, grid.sel_cols, hx, hy, float(eps))
    m = lam64.shape[0]
    if m == 0:
        raise ValueError("Affinity matrix Ka has no eigenvalues above eps.")
    warn_truncation(p, m, float(eps))
    mb = bucket_m(m, p)
    stage1 = torch.from_numpy(pack_stage1(Um64, lam64, mb=mb)).to(dev)
    with stage("Nystrom approximation + Sinkhorn"):
        rc, sb, c = train_filter_stage2a_streaming(
            y, rr, cc, stage1, sw, pw, p=p, m=m, mb=mb,
            n_sinkhorn_iter=n_sinkhorn_iter, eps=float(eps))
        rc_np = rc.cpu().double().numpy()
    del y, rr, cc
    k = min(n_eig_vectors, m)
    with stage("Orthogonalize"):
        va_np, Sq = host_orthogonalize(rc_np, sb.cpu().double().numpy(),
                                       Um64, lam64, m, mb, k, float(eps))
        va_grt = torch.from_numpy(va_np).to(dev, torch.float32)
        V_head, W = factored_filter_pieces(stage1, c, va_grt, p=p, m=m,
                                           mb=mb)
    return FactoredFilter(
        y_train=packed_np, c=c, v_head=V_head, w=W,
        eigvals=torch.from_numpy(Sq).to(dev, torch.float32), nrows=nrows,
        ncols=ncols, hx=float(hx), hy=float(hy), perm=grid.perm)
