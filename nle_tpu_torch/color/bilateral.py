"""Single-channel bilateral filter with cv::bilateralFilter's semantics
(port of nle_tpu/color/bilateral.py).

The denoise path bilateral-filters the 8-bit Lab L channel before training
and before the spectral edit (reference src/filter.cpp:371,534-535) with
d = -1: radius = round(sigmaSpace * 1.5) (Python's round, half to even),
at least 1; circular support dy^2 + dx^2 <= radius^2; BORDER_DEFAULT
(reflect-101); weights
    w = exp(-0.5 (dy^2 + dx^2) / sigmaSpace^2) * exp(-0.5 dI^2 / sigmaColor^2)
and half-to-even rounding of sum(w I) / sum(w).

Plain PyTorch on the tensor's device: the JAX package runs a lax.scan over
the offsets (no Pallas kernel), so this loops over the same offsets in the
same np.mgrid order and sums in float32 in that order. The constants are
rounded as nle_tpu rounds them: gc to float32 on the host, the spatial
weights from a float64 exp cast to float32. The reflect-101 padding is an
index map built with NumPy's own rule, which (unlike torch's reflect pad)
takes a radius at least the image side.
"""

from __future__ import annotations

import numpy as np
import torch


def _aperture(d: int, sigma_space: float) -> int:
    if d <= 0:
        radius = int(round(sigma_space * 1.5))
    else:
        radius = d // 2
    return max(radius, 1)


def _reflect101(n: int, radius: int) -> np.ndarray:
    """Source index of each padded position, as np.pad(mode="reflect")."""
    return np.pad(np.arange(n), radius, mode="reflect")


def bilateral_filter_u8(img_u8: torch.Tensor, d: int = -1,
                        sigma_color: float = 10.0,
                        sigma_space: float = 10.0) -> torch.Tensor:
    """(H, W) uint8 -> (H, W) uint8 bilateral-filtered, on img_u8's
    device. Sigmas <= 0 become 1.0."""
    sigma_color = float(sigma_color) if sigma_color > 0 else 1.0
    sigma_space = float(sigma_space) if sigma_space > 0 else 1.0
    radius = _aperture(d, sigma_space)
    gc = float(np.float32(-0.5 / (sigma_color * sigma_color)))
    gs = -0.5 / (sigma_space * sigma_space)

    dy, dx = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    keep = dy * dy + dx * dx <= radius * radius
    offs_y = dy[keep] + radius
    offs_x = dx[keep] + radius
    space_w = np.exp(gs * (dy[keep] ** 2 + dx[keep] ** 2)).astype(np.float32)

    img = img_u8.to(torch.float32)
    h, w = img.shape
    dev = img.device
    rows = torch.from_numpy(_reflect101(h, radius)).to(dev)
    cols = torch.from_numpy(_reflect101(w, radius)).to(dev)
    pad = img[rows][:, cols]
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for oy, ox, sw in zip(offs_y.tolist(), offs_x.tolist(), space_w.tolist()):
        win = pad[oy:oy + h, ox:ox + w]
        diff = win - img
        wgt = torch.exp(gc * (diff * diff)) * sw
        num = num + wgt * win
        den = den + wgt
    return torch.clamp(torch.round(num / den), 0, 255).to(torch.uint8)
