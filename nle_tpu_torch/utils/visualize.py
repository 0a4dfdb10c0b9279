"""Debug images of a trained filter (port of nle_tpu/utils/visualize.py
`rescale_for_visualization` and `eigvec_images`; reference
src/filter.cpp:34-40, 504-511): the headless form of the reference's
imshow of the first <= 5 eigenvectors, which --debug-eigvecs writes.
"""

from __future__ import annotations

import numpy as np


def rescale_for_visualization(arr) -> np.ndarray:
    """(x - min) / (max - min) * 255 (src/filter.cpp:34-40), as uint8."""
    arr = np.asarray(arr, np.float64)
    lo = arr.min()
    rng = arr.max() - lo
    if rng == 0:
        rng = 1.0
    return np.clip(np.rint((arr - lo) / rng * 255.0), 0, 255).astype(np.uint8)


def eigvec_images(trained, V: np.ndarray | None = None) -> list[np.ndarray]:
    """Min-max-rescaled (H, W) images of the first <= 5 eigenvectors, rows
    in pixel order. V: the pixel-order eigenvector matrix, when the caller
    has fetched it already (else trained.eigvecs_pixel_order())."""
    if V is None:
        V = trained.eigvecs_pixel_order()
    return [rescale_for_visualization(V[:, i]).reshape(trained.nrows,
                                                       trained.ncols)
            for i in range(min(V.shape[1], 5))]
