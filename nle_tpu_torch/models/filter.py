"""NLEFilter — the model layer: train once, edit many (port of
nle_tpu/models/filter.py, enhance path).

`train_for_enhancement` learns the global filter eigensystem from the 8-bit
Lab luminance; `enhance` re-weights its eigen detail layers;
`train_and_enhance` does both with the first edit fused into stage 2b.
`TrainedFilter.save/load` use the JAX package's npz format (eigvecs,
eigvals, shape, perm), so a filter trained by either package edits in the
other.

The device is explicit: NLEFilter(device="cuda") runs the CUDA kernels
and raises without a card; device="cpu" runs their plain versions.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from nle_tpu_torch.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np
from nle_tpu_torch.config import resolve_device
from nle_tpu_torch.ops.pipeline import apply_filter_u8, pack_channel, train_filter
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.ops.transform import transform_eigenvalues
from nle_tpu_torch.utils.logging import stage


@dataclasses.dataclass
class TrainedFilter:
    """Top-k orthonormal eigenvectors and eigenvalues of the balanced
    affinity matrix W. `eigvecs` rows are in packed [selected; rest] order
    when `perm` is set (perm[i] = flat pixel index of packed row i);
    perm=None means pixel order."""

    eigvecs: torch.Tensor  # (N, k) float32
    eigvals: torch.Tensor  # (k,) float32
    nrows: int
    ncols: int
    perm: np.ndarray | None = None

    @property
    def n_pixels(self) -> int:
        return self.nrows * self.ncols

    def save(self, path: str) -> None:
        arrs = dict(
            eigvecs=self.eigvecs.cpu().numpy(),
            eigvals=self.eigvals.cpu().numpy(),
            shape=np.array([self.nrows, self.ncols]),
        )
        if self.perm is not None:
            arrs["perm"] = self.perm
        np.savez_compressed(path, **arrs)

    def to(self, device) -> "TrainedFilter":
        """This filter with its tensors on `device`."""
        dev = resolve_device(device)
        return dataclasses.replace(self, eigvecs=self.eigvecs.to(dev),
                                   eigvals=self.eigvals.to(dev))

    @classmethod
    def from_numpy(cls, arrays, device) -> "TrainedFilter":
        """Build from a mapping of host arrays (eigvecs, eigvals, shape,
        optional perm), uploading to `device` ("cuda" or "cpu")."""
        dev = resolve_device(device)
        return cls(
            eigvecs=torch.from_numpy(np.asarray(arrays["eigvecs"])).to(dev),
            eigvals=torch.from_numpy(np.asarray(arrays["eigvals"])).to(dev),
            nrows=int(arrays["shape"][0]),
            ncols=int(arrays["shape"][1]),
            perm=np.asarray(arrays["perm"]) if "perm" in arrays else None,
        )

    @classmethod
    def load(cls, path: str, device) -> "TrainedFilter":
        # np.savez_compressed appends ".npz" when missing; mirror that.
        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            path = path + ".npz"
        with np.load(path) as z:
            return cls.from_numpy({k: z[k] for k in z.files}, device)


def _to_lab(image):
    with stage("BGR to Lab"):
        return bgr_to_lab_u8_np(image)


def _check_image(image, n_pixels):
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError("Can only enhance RGB image.")
    if image.shape[0] * image.shape[1] != n_pixels:
        raise ValueError(
            "Cannot apply filter on image with different size from the image "
            "filter was trained on."
        )
    return image


class NLEFilter:
    """Train-and-edit wrapper around the functional pipeline, on one
    explicit device ("cuda" or "cpu"). A given `trained` filter moves to
    that device, so every edit runs where the caller asked."""

    def __init__(self, trained: TrainedFilter | None = None, *,
                 device="cuda", eps: float | None = None):
        self.device = resolve_device(device)
        self._eps = eps
        self._trained = None if trained is None else trained.to(self.device)

    @property
    def trained(self) -> TrainedFilter:
        if self._trained is None:
            raise RuntimeError("Filter has not been trained.")
        return self._trained

    def _train(self, channel, n_row_samples, n_col_samples, hx, hy,
               n_sinkhorn_iter, n_eigen_vectors, edit_weights=None):
        nrows, ncols = channel.shape
        grid = sample_grid(nrows, ncols, n_row_samples, n_col_samples)
        packed_np, _ = pack_channel(channel, grid.perm)
        packed_y = torch.from_numpy(np.ascontiguousarray(packed_np)).to(
            self.device)
        out = train_filter(
            channel, n_row_samples, n_col_samples, hx, hy, n_sinkhorn_iter,
            n_eigen_vectors, device=self.device, eps=self._eps, grid=grid,
            packed_y=packed_y, edit_weights=edit_weights)
        self._trained = TrainedFilter(out[0], out[1], nrows, ncols,
                                      perm=grid.perm)
        if edit_weights is not None:
            return self._trained, out[2]
        return self._trained

    def train_for_enhancement(self, image_bgr_u8, n_row_samples, n_col_samples,
                              hx, hy, n_sinkhorn_iter=10, n_eigen_vectors=5):
        """Train on the 8-bit Lab luminance (src/filter.cpp:514-519)."""
        lab = _to_lab(np.asarray(image_bgr_u8))
        L = lab[..., 0].astype(np.float32)
        return self._train(L, n_row_samples, n_col_samples, hx, hy,
                           n_sinkhorn_iter, n_eigen_vectors)

    def train_and_enhance(self, image_bgr_u8, n_row_samples, n_col_samples,
                          hx, hy, n_sinkhorn_iter=10, n_eigen_vectors=5,
                          weights=()) -> np.ndarray:
        """train_for_enhancement + enhance in one flow, with the first
        edit's apply fused into stage 2b; the filter stays trained."""
        image = np.asarray(image_bgr_u8)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("Can only enhance RGB image.")
        lab = _to_lab(image)
        L = lab[..., 0].astype(np.float32)
        trained, edit = self._train(
            L, n_row_samples, n_col_samples, hx, hy, n_sinkhorn_iter,
            n_eigen_vectors, edit_weights=list(weights))
        return self._recompose(lab, edit, trained.perm)

    def enhance(self, image_bgr_u8, weights) -> np.ndarray:
        """Detail-layer recomposition on L only (src/filter.cpp:412-443)."""
        t = self.trained
        image = _check_image(image_bgr_u8, t.n_pixels)
        lab = _to_lab(image)
        fS = transform_eigenvalues(t.eigvals, weights)
        flat = lab[..., 0].reshape(-1)
        if t.perm is not None:
            flat = flat[t.perm]
        y = torch.from_numpy(np.ascontiguousarray(flat)).to(self.device)
        return self._recompose(lab, apply_filter_u8(t.eigvecs, fS, y), t.perm)

    @staticmethod
    def _recompose(lab, filtered_dev, perm) -> np.ndarray:
        # The fetch waits for the device's queued work (stage 2b, apply).
        with stage("Fetch edit"):
            filtered = filtered_dev.cpu().numpy()
        with stage("Lab to BGR"):
            if perm is not None:
                unpacked = np.empty_like(filtered)
                unpacked[perm] = filtered
                filtered = unpacked
            out = lab.copy()
            out[..., 0] = filtered.reshape(lab.shape[:2])
            return lab_to_bgr_u8_np(out)
