"""Debug images (port of nle_tpu/utils/visualize.py; reference
src/filter.cpp:34-40, 82-92, 504-511): the headless forms of the
reference's imshow debugging. `rescale_for_visualization` min-max rescales
to uint8, `plot_sampled_points` marks the Nystrom sample grid on an image,
and `eigvec_images` renders the first <= 5 eigenvectors, which
--debug-eigvecs writes. Pure NumPy.
"""

from __future__ import annotations

import numpy as np

from nle_tpu_torch.ops.sampling import sample_grid


def rescale_for_visualization(arr) -> np.ndarray:
    """(x - min) / (max - min) * 255 (src/filter.cpp:34-40), as uint8."""
    arr = np.asarray(arr, np.float64)
    lo = arr.min()
    rng = arr.max() - lo
    if rng == 0:
        rng = 1.0
    return np.clip(np.rint((arr - lo) / rng * 255.0), 0, 255).astype(np.uint8)


def plot_sampled_points(image_bgr_u8, n_row_samples: int, n_col_samples: int,
                        radius: int = 2, color=(255, 0, 0)) -> np.ndarray:
    """A copy of the image with each sampled pixel marked by a filled disc
    of `radius` in `color` (src/filter.cpp:82-92), clipped at the
    borders."""
    img = np.array(image_bgr_u8, copy=True)
    h, w = img.shape[:2]
    g = sample_grid(h, w, n_row_samples, n_col_samples)
    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    disc = (dy**2 + dx**2) <= radius**2
    rr = (g.sel_rows[:, None] + dy[disc][None, :]).clip(0, h - 1).reshape(-1)
    cc = (g.sel_cols[:, None] + dx[disc][None, :]).clip(0, w - 1).reshape(-1)
    img[rr, cc] = color
    return img


def eigvec_images(trained, V: np.ndarray | None = None) -> list[np.ndarray]:
    """Min-max-rescaled (H, W) images of the first <= 5 eigenvectors, rows
    in pixel order. V: the pixel-order eigenvector matrix, when the caller
    has fetched it already (else trained.eigvecs_pixel_order())."""
    if V is None:
        V = trained.eigvecs_pixel_order()
    return [rescale_for_visualization(V[:, i]).reshape(trained.nrows,
                                                       trained.ncols)
            for i in range(min(V.shape[1], 5))]
