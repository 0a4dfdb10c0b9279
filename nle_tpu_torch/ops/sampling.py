"""Evenly-spaced pixel grid sampling for the Nystrom approximation.

Reproduces the exact selection rule of the reference `samplePixels`
(reference src/filter.cpp:56-80): integer steps `nrows // nRowSamples`,
centering offsets `(step - 1 + (nrows - step * nSamples)) // 2`, and the
*inclusive* upper bound `r <= nrows - rowOffset`. Note the rule may select
slightly more than nRowSamples*nColSamples pixels for some shapes — that is
reference behavior and is preserved (p is whatever the rule yields).

This is host-side static precomputation: for a fixed image shape and sample
counts, the selected-pixel set and the packed<->pixel permutation are fixed,
so everything on the device runs in packed order. Verbatim port of
nle_tpu/ops/sampling.py (pure NumPy; bit-equal by construction), with
`sample_grid` the span "Sample grid".
"""

from __future__ import annotations

import dataclasses

import numpy as np

from nle_tpu_torch.utils.logging import span


@dataclasses.dataclass(frozen=True)
class SampleGrid:
    """Static sampling layout for one (image shape, sample count) config.

    Attributes:
      nrows, ncols: image shape.
      sel_rows, sel_cols: (p,) int32 coordinates of sampled pixels, row-major.
      perm: (N,) int64 — flat pixel index of each packed position; packed
        order is [selected; rest], both row-major (src/filter.cpp:156-164).
        `pixel_array[perm] == packed_array` scatter / `packed = flat[perm]`
        gather. A trained filter's u8 edits run that gather and scatter on
        the device against perm as an int32 index
        (models/filter.py TrainedFilter.device_perm,
        ops/kernels/pixel_order_kernel.py).
    """

    nrows: int
    ncols: int
    sel_rows: np.ndarray
    sel_cols: np.ndarray
    perm: np.ndarray

    @property
    def n_pixels(self) -> int:
        return self.nrows * self.ncols

    @property
    def n_samples(self) -> int:
        return self.sel_rows.size

    def pack(self, flat_pixel_array: np.ndarray) -> np.ndarray:
        """Reorder a pixel-order array (N, ...) into packed [selected; rest]."""
        return flat_pixel_array[self.perm]

    def unpack_indices(self) -> np.ndarray:
        """Inverse permutation: packed position of each flat pixel index."""
        inv = np.empty_like(self.perm)
        inv[self.perm] = np.arange(self.perm.size)
        return inv


def _axis_samples(n: int, n_samples: int) -> np.ndarray:
    step = n // n_samples
    offset = (step - 1 + (n - step * n_samples)) // 2
    # r in [offset, n - offset] inclusive, r < n, (r - offset) % step == 0
    hi = min(n - 1, n - offset)
    return np.arange(offset, hi + 1, step, dtype=np.int64)


def sample_grid(nrows: int, ncols: int, n_row_samples: int, n_col_samples: int) -> SampleGrid:
    with span("Sample grid"):
        if n_row_samples > nrows or n_col_samples > ncols:
            # Same guard as reference computeKernel (src/filter.cpp:117-119).
            raise ValueError("Number of samples per row and col must be <= that of image.")
        rs = _axis_samples(nrows, n_row_samples)
        cs = _axis_samples(ncols, n_col_samples)
        sel_rows = np.repeat(rs, cs.size)
        sel_cols = np.tile(cs, rs.size)
        sel_flat = sel_rows * ncols + sel_cols  # row-major sorted by construction

        n = nrows * ncols
        is_sel = np.zeros(n, dtype=bool)
        is_sel[sel_flat] = True
        rest_flat = np.nonzero(~is_sel)[0]
        perm = np.concatenate([sel_flat, rest_flat])
        return SampleGrid(
            nrows=nrows,
            ncols=ncols,
            sel_rows=sel_rows.astype(np.int32),
            sel_cols=sel_cols.astype(np.int32),
            perm=perm,
        )
