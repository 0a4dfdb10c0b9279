"""NLEFilter — the model layer: train once, edit many (port of
nle_tpu/models/filter.py).

`train_for_enhancement` learns the global filter eigensystem from the 8-bit
Lab luminance; `enhance` re-weights its eigen detail layers;
`train_and_enhance` does both with the first edit fused into stage 2b.
`train_for_denoise` trains on the bilateral-filtered luminance and
`denoise` applies GLIDE's edit: the bilateral L, and the chroma planes
through the filter with shrunk eigenvalues (reference
src/filter.cpp:349-410, 521-538).
`TrainedFilter.save/load` use the JAX package's npz format (eigvecs,
eigvals, shape, perm), so a filter trained by either package edits in the
other. NLEFilter(factored=True) trains and edits the V-free FactoredFilter
(models/factored.py) instead; `load_filter` reads either kind of npz.

The device is explicit: NLEFilter(device="cuda") runs the CUDA kernels
and raises without a card; device="cpu" runs their plain versions.
A TrainedFilter may carry its training channel's device buffer (y_cache,
set by `_train` and by stream mode, models/batch.py), which the first u8
edit of that very channel reuses instead of uploading and gathering it
again.

The u8 edits permute on the device: the host uploads and fetches
pixel-order planes, and the gather into the filter's packed [selected;
rest] row order and the scatter back run as kernels
(ops/kernels/pixel_order_kernel.py) against `perm` as an int32 device
index, which the TrainedFilter builds at its first u8 edit and keeps. The
routes that run no hand-written kernel (use_kernels=False, float64)
permute on the device with the kernels' plain versions. The float `apply`
still permutes on the host.

Each public NLEFilter call is a span named `NLEFilter.<method>` around its
whole body: a frame's root span. The spans inside it on the same thread
(stages, "Sample grid", "Pack channel", "Upload", "Wait for device", and
the edit's "Gather by perm" and "Scatter by perm") belong to that frame.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from nle_tpu_torch.color.bilateral import bilateral_filter_u8
from nle_tpu_torch.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np
from nle_tpu_torch.config import resolve_device
from nle_tpu_torch.models.factored import FactoredFilter, train_filter_factored
from nle_tpu_torch.ops.kernels.pixel_order_kernel import (
    device_index,
    perm_gather,
    perm_scatter,
)
from nle_tpu_torch.ops.pipeline import (
    apply_filter,
    apply_filter_u8,
    pack_channel,
    train_filter,
)
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.ops.transform import (
    shrink_eigenvalues,
    transform_eigenvalues,
)
from nle_tpu_torch.utils.logging import logger, span, stage
from nle_tpu_torch.utils.transfer import Fetch, upload


@dataclasses.dataclass
class TrainedFilter:
    """Top-k orthonormal eigenvectors and eigenvalues of the balanced
    affinity matrix W. `eigvecs` rows are in packed [selected; rest] order
    when `perm` is set (perm[i] = flat pixel index of packed row i);
    perm=None means pixel order. The u8 edits permute their channels on
    the filter's device against `perm_index`, perm as int32 there
    (`device_perm`); the float `apply` and `eigvecs_pixel_order` permute
    on the host."""

    eigvecs: torch.Tensor  # (N, k), float32 (float64 on the float64 route)
    eigvals: torch.Tensor  # (k,), the same dtype
    nrows: int
    ncols: int
    perm: np.ndarray | None = None
    # (pixel-order u8 host copy, packed device tensor) of the TRAINING
    # channel: the train->edit flow filters that very channel, so the u8
    # edit reuses the device buffer, and skips its upload and its gather,
    # when the channel it is given equals the host copy. Never serialized;
    # a transfer cache only.
    y_cache: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # `perm` as int32 on the filter's device: the index of the u8 edit's
    # gather and scatter kernels, built at the first u8 edit (after
    # training, so never alive at its peak). A transfer cache like y_cache.
    perm_index: torch.Tensor | None = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def n_pixels(self) -> int:
        return self.nrows * self.ncols

    def nbytes(self) -> int:
        """Host and device bytes this filter holds: eigvecs (4k B/pixel)
        and eigvals, perm and its device index, and the training-channel
        cache. The index (4 B/pixel) counts before the first u8 edit builds
        it, so a byte budget read before the edits holds it."""
        n = sum(t.numel() * t.element_size()
                for t in (self.eigvecs, self.eigvals))
        if self.perm is not None:
            n += self.perm.nbytes + 4 * self.perm.size
        if self.y_cache is not None:
            flat_np, y_dev = self.y_cache
            n += flat_np.nbytes + y_dev.numel() * y_dev.element_size()
        return int(n)

    def device_perm(self) -> torch.Tensor:
        """`perm` as the int32 index on the filter's device (built once)."""
        idx = self.perm_index
        if idx is None or idx.device != self.eigvecs.device:
            idx = self.perm_index = device_index(self.perm,
                                                 self.eigvecs.device)
        return idx

    def eigvecs_pixel_order(self) -> np.ndarray:
        """Eigenvectors with rows in flat pixel order (host array)."""
        V = Fetch(self.eigvecs).result()
        if self.perm is None:
            return V
        out = np.empty_like(V)
        out[self.perm] = V
        return out

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
        """This filter with its tensors on `device` (the training-channel
        cache and the device index kept only where they already lie on
        `device`)."""
        eigvecs = self.eigvecs.to(resolve_device(device))
        # Compared with a tensor's device, not the request: "cuda" names
        # the device that tensors report as "cuda:0".
        dev = eigvecs.device
        y_cache, perm_index = self.y_cache, self.perm_index
        if y_cache is not None and y_cache[1].device != dev:
            y_cache = None
        if perm_index is not None and perm_index.device != dev:
            perm_index = None
        return dataclasses.replace(self, eigvecs=eigvecs,
                                   eigvals=self.eigvals.to(dev),
                                   y_cache=y_cache, perm_index=perm_index)

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
        return cls.from_numpy(load_filter_host(path), device)


def load_filter_host(path: str) -> dict:
    """Disk half of load_filter: the npz decompressed to host arrays."""
    # np.savez_compressed appends ".npz" when missing; mirror that.
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def filter_from_host(arrays, device):
    """Device half of load_filter: a FactoredFilter when the arrays carry
    the `factored` key, else a TrainedFilter, on `device`."""
    if "factored" in arrays:
        return FactoredFilter.from_numpy(arrays, device)
    return TrainedFilter.from_numpy(arrays, device)


def load_filter(path: str, device):
    """Load a saved filter of either kind (a TrainedFilter npz with eigvecs,
    or a FactoredFilter npz marked factored=True) onto `device`."""
    return filter_from_host(load_filter_host(path), device)


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


def _root_span(method):
    """Run the public call `method` inside the span NLEFilter.<name>."""
    name = f"NLEFilter.{method.__name__}"

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        with span(name):
            return method(self, *args, **kwargs)
    return call


def _scatter(packed: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Packed rows back to pixel order on the host: out[perm] = packed."""
    with span("Scatter by perm"):
        out = np.empty_like(packed)
        out[perm] = packed
        return out


def _unpermute_u8(t: TrainedFilter, packed: torch.Tensor,
                  plain: bool) -> torch.Tensor:
    """A u8 edit's packed device rows back to pixel order, on the device."""
    if t.perm is None:
        return packed
    with span("Scatter by perm"):
        return perm_scatter(packed, t.device_perm(), plain=plain)


class NLEFilter:
    """Train-and-edit wrapper around the functional pipeline, on one
    explicit device ("cuda" or "cpu"). A given `trained` filter (either
    kind) moves to that device, so every edit runs where the caller asked.
    factored=True trains the V-free FactoredFilter (the capacity path).
    train_kwargs go to train_filter as nle_tpu's NLEFilter passes them:
    eps, stage1 ("host64" | "topk" | "device"), dtype (float32 | float64),
    use_kernels (nle_tpu's use_pallas) and streaming. The factored path
    takes eps alone: it warns and ignores the others."""

    TRAIN_OPTIONS = ("eps", "stage1", "dtype", "use_kernels", "streaming")

    def __init__(self, trained=None, *, device="cuda", factored: bool = False,
                 **train_kwargs):
        unknown = sorted(set(train_kwargs) - set(self.TRAIN_OPTIONS))
        if unknown:
            raise TypeError(f"NLEFilter: unknown option(s) {unknown}")
        self.device = resolve_device(device)
        self._factored = factored
        self._train_kwargs = train_kwargs
        self._trained = None if trained is None else trained.to(self.device)
        self._lab_cache: tuple[np.ndarray, np.ndarray] | None = None
        # The training channel's device buffer, when the filter carries one
        # (stream mode, models/batch.py): the edit of that channel skips
        # its upload.
        self._packed_y_cache = getattr(self._trained, "y_cache", None)

    @property
    def trained(self):
        if self._trained is None:
            raise RuntimeError("Filter has not been trained.")
        return self._trained

    def _to_lab(self, image) -> np.ndarray:
        """BGR->Lab with a one-entry cache: the factored train->edit flow
        converts the same image twice. The cache keys on a private SNAPSHOT
        of the pixels, never the caller's array, so an in-place change of
        the image (img[:] = ...) misses the cache instead of returning the
        stale Lab; revalidation is an array_equal."""
        image = np.asarray(image)
        if self._lab_cache is not None:
            cached_img, cached_lab = self._lab_cache
            if (cached_img.shape == image.shape
                    and cached_img.dtype == image.dtype
                    and np.array_equal(cached_img, image)):
                return cached_lab
        with stage("BGR to Lab"):
            lab = bgr_to_lab_u8_np(image)
        self._lab_cache = (image.copy(), lab)
        return lab

    def seed_lab_cache(self, image_bgr_u8, lab) -> None:
        """Pre-populate the BGR->Lab cache with a conversion the caller
        already made (stream mode converts every frame to train on it).
        No defensive copy is taken: the caller must not change the image
        afterwards."""
        self._lab_cache = (np.asarray(image_bgr_u8), np.asarray(lab))

    def _train(self, channel, n_row_samples, n_col_samples, hx, hy,
               n_sinkhorn_iter, n_eigen_vectors, edit_weights=None):
        if self._factored:
            ignored = sorted(set(self._train_kwargs) - {"eps"})
            if ignored:
                logger.warning(
                    "factored training ignores option(s): %s (the factored "
                    "path is float32 kernel-streaming only).",
                    ", ".join(ignored))
            self._packed_y_cache = None
            self._trained = train_filter_factored(
                channel, n_row_samples, n_col_samples, hx, hy,
                n_sinkhorn_iter, n_eigen_vectors, device=self.device,
                eps=self._train_kwargs.get("eps"))
            return self._trained
        nrows, ncols = channel.shape
        grid = sample_grid(nrows, ncols, n_row_samples, n_col_samples)
        packed_np, flat_u8 = pack_channel(channel, grid.perm)
        packed_y = upload(packed_np, self.device)
        # Keep the uploaded u8 channel: the train->edit flow edits it.
        self._packed_y_cache = (None if flat_u8 is None
                                else (flat_u8, packed_y))
        out = train_filter(
            channel, n_row_samples, n_col_samples, hx, hy, n_sinkhorn_iter,
            n_eigen_vectors, device=self.device, grid=grid,
            packed_y=packed_y, edit_weights=edit_weights, pixel_order=False,
            **self._train_kwargs)
        self._trained = TrainedFilter(out[0], out[1], nrows, ncols,
                                      perm=grid.perm,
                                      y_cache=self._packed_y_cache)
        if edit_weights is not None:
            return self._trained, out[2]
        return self._trained

    @_root_span
    def train_for_enhancement(self, image_bgr_u8, n_row_samples, n_col_samples,
                              hx, hy, n_sinkhorn_iter=10, n_eigen_vectors=5):
        """Train on the 8-bit Lab luminance (src/filter.cpp:514-519)."""
        lab = self._to_lab(image_bgr_u8)
        L = lab[..., 0].astype(np.float32)
        return self._train(L, n_row_samples, n_col_samples, hx, hy,
                           n_sinkhorn_iter, n_eigen_vectors)

    @_root_span
    def train_and_enhance(self, image_bgr_u8, n_row_samples, n_col_samples,
                          hx, hy, n_sinkhorn_iter=10, n_eigen_vectors=5,
                          weights=()) -> np.ndarray:
        """train_for_enhancement + enhance in one flow, with the first
        edit's apply fused into stage 2b; the filter stays trained. The
        factored path has no stage 2b: it runs the two calls."""
        image = np.asarray(image_bgr_u8)
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError("Can only enhance RGB image.")
        if self._factored:
            self.train_for_enhancement(image, n_row_samples, n_col_samples,
                                       hx, hy, n_sinkhorn_iter,
                                       n_eigen_vectors)
            return self.enhance(image, weights)
        lab = self._to_lab(image)
        L = lab[..., 0].astype(np.float32)
        trained, edit = self._train(
            L, n_row_samples, n_col_samples, hx, hy, n_sinkhorn_iter,
            n_eigen_vectors, edit_weights=list(weights))
        return self._recompose(lab, edit, trained, self._plain_edit(trained))

    def _bilateral_L(self, lab, sigma_color, sigma_space) -> np.ndarray:
        """The bilateral-filtered L plane (host u8), computed on the
        filter's device."""
        with stage("Bilateral filter"):
            L = upload(np.ascontiguousarray(lab[..., 0]), self.device)
            return Fetch(bilateral_filter_u8(L, -1, sigma_color,
                                             sigma_space)).result()

    @_root_span
    def train_for_denoise(self, image_bgr_u8, n_row_samples, n_col_samples,
                          hx, hy, n_sinkhorn_iter, n_eigen_vectors,
                          sigma_color=10, sigma_space=10, *,
                          bilateral_L=None):
        """Train on the bilateral-prefiltered luminance
        (src/filter.cpp:521-538). bilateral_L: a precomputed bilateral L
        plane (host u8 (H, W)) to train on instead of computing it — the
        substitution point for another bilateral's exact output."""
        lab = self._to_lab(image_bgr_u8)
        if bilateral_L is None:
            bilateral_L = self._bilateral_L(lab, sigma_color, sigma_space)
        return self._train(np.asarray(bilateral_L).astype(np.float32),
                           n_row_samples, n_col_samples, hx, hy,
                           n_sinkhorn_iter, n_eigen_vectors)

    @_root_span
    def apply(self, channel, transformed_eigvals) -> np.ndarray:
        """V diag(f(S)) V^T c on a pixel-order channel, no clamp
        (src/filter.cpp:445-458); host array in and out."""
        t = self.trained
        if not isinstance(t, TrainedFilter):     # FactoredFilter (V-free)
            return t.apply(channel, transformed_eigvals)
        channel_np = np.asarray(channel)
        if channel_np.size != t.n_pixels:
            raise ValueError(
                "Number of values in channel must match that of training "
                "image.")
        flat = channel_np.reshape(-1)
        if t.perm is not None:
            with span("Gather by perm"):
                flat = flat[t.perm]
        # In V's dtype, as nle_tpu casts the channel (float64 on that route).
        dtype = t.eigvecs.dtype
        fS = torch.as_tensor(transformed_eigvals, dtype=dtype,
                             device=self.device)
        out = Fetch(apply_filter(t.eigvecs, fS, upload(
            flat, self.device).to(dtype))).result()
        if t.perm is not None:
            out = _scatter(out, t.perm)
        return out.reshape(channel_np.shape)

    def _plain_edit(self, t: TrainedFilter) -> bool:
        """Whether the u8 edit permutes with the plain versions of the
        kernels: on the routes that run no hand-written kernel
        (use_kernels=False, and the float64 route, whose V is float64)."""
        return (self._train_kwargs.get("use_kernels") is False
                or t.eigvecs.dtype == torch.float64)

    def _apply_edit_u8(self, channels_u8: np.ndarray, scale_vals) -> np.ndarray:
        """Filter and clamp 8-bit channel(s), pixel order in and out: (H, W)
        or (H, W, C), all C channels through one application. The single
        channel the filter was trained on reuses its device buffer."""
        t = self.trained
        if not isinstance(t, TrainedFilter):     # FactoredFilter (V-free)
            return t.apply_u8(channels_u8, scale_vals)
        shape = channels_u8.shape
        flat = channels_u8.reshape(t.n_pixels, -1)
        plain = self._plain_edit(t)
        # Reuse the training channel's packed device buffer only when this
        # channel is that very channel (a content check in pixel order,
        # never object identity).
        y = None
        if (self._packed_y_cache is not None and flat.shape[1] == 1
                and flat.dtype == np.uint8):
            cached_np, cached_dev = self._packed_y_cache
            if np.array_equal(flat[:, 0], cached_np):
                y = cached_dev
        if y is None:
            y = upload(flat[:, 0] if flat.shape[1] == 1 else flat,
                       self.device)
            if t.perm is not None:
                with span("Gather by perm"):
                    y = perm_gather(y, t.device_perm(), plain=plain)
        with stage("Fetch edit"):
            out = apply_filter_u8(t.eigvecs, scale_vals, y)
            out = Fetch(_unpermute_u8(t, out, plain)).result()
        return out.reshape(shape)

    @_root_span
    def enhance(self, image_bgr_u8, weights) -> np.ndarray:
        """Detail-layer recomposition on L only (src/filter.cpp:412-443)."""
        t = self.trained
        image = _check_image(image_bgr_u8, t.n_pixels)
        lab = self._to_lab(image)
        fS = transform_eigenvalues(t.eigvals, weights)
        out = lab.copy()
        out[..., 0] = self._apply_edit_u8(lab[..., 0], fS)
        with stage("Lab to BGR"):
            return lab_to_bgr_u8_np(out)

    @_root_span
    def denoise(self, image_bgr_u8, shrink_factor, sigma_color=10,
                sigma_space=10, *, bilateral_L=None) -> np.ndarray:
        """GLIDE-style global denoise (src/filter.cpp:349-410): the
        bilateral on L, the filter with eigenvalues shrunk to
        min(lam, 1)^shrink on both chroma planes in one application.
        bilateral_L: a precomputed bilateral L plane (host u8 (H, W)) to use
        instead of computing it."""
        t = self.trained
        image = _check_image(image_bgr_u8, t.n_pixels)
        lab = self._to_lab(image)
        teig = shrink_eigenvalues(t.eigvals, shrink_factor)
        out = lab.copy()
        if bilateral_L is None:
            bilateral_L = self._bilateral_L(lab, sigma_color, sigma_space)
        out[..., 0] = bilateral_L
        out[..., 1:] = self._apply_edit_u8(
            np.ascontiguousarray(lab[..., 1:]), teig)
        with stage("Lab to BGR"):
            return lab_to_bgr_u8_np(out)

    @staticmethod
    def _recompose(lab, filtered_dev, trained, plain) -> np.ndarray:
        # The fetch waits for the edit (stage 2b, apply) and its scatter
        # to pixel order, and for nothing queued after them.
        with stage("Fetch edit"):
            filtered = Fetch(_unpermute_u8(trained, filtered_dev,
                                           plain)).result()
        with stage("Lab to BGR"):
            out = lab.copy()
            out[..., 0] = filtered.reshape(lab.shape[:2])
            return lab_to_bgr_u8_np(out)
