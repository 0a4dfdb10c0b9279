"""Seeded input frames: the one generator every traffic mix reads.

A pool of POOL photo-like BGR frames (low-frequency shading, six soft
discs, mild texture, the traffic's Gaussian noise) is made on the device
from the seed in a few large calls and copied to the host as uint8.
Frame i of a run is pool frame i % POOL with its exposure shifted by
offsets[i // POOL], a distinct nonzero offset in [-EXPOSURE_SPAN,
EXPOSURE_SPAN] drawn from the seed, so no frame repeats in a run (240
distinct frames) and every seed gives the same sizes and work.
"""

from __future__ import annotations

import cv2
import numpy as np
import torch

POOL = 4
EXPOSURE_SPAN = 30


def seed_words(seed: int) -> int:
    """The seed as a non-negative integer both generators take."""
    return int(seed) % (1 << 63)


def structured_pool(h: int, w: int, count: int, noise_sigma: float,
                    seed: int, device) -> np.ndarray:
    """(count, h, w, 3) uint8 BGR frames, made on `device` from `seed`."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed_words(seed))
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    shading = 110 + 50 * torch.sin(xx / (w / 5.0)) * torch.cos(yy / (h / 3.0))
    # Six discs a frame: centre row and column, radius, amplitude.
    u = torch.rand((count, 6, 4), generator=gen, device=dev,
                   dtype=torch.float64)
    out = np.empty((count, h, w, 3), np.uint8)
    for i in range(count):
        base = shading.clone()
        for cy, cx, rad, amp in u[i].tolist():
            cy, cx = cy * h, cx * w
            rad = (0.05 + 0.15 * rad) * min(h, w)
            dist = torch.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            base += (80 * amp - 40) / (1 + torch.exp(torch.clamp(
                dist / 8 - rad / 8, max=80.0)))
        sigma = 2.0 + float(noise_sigma)
        base += sigma * torch.randn((h, w), generator=gen, device=dev)
        img = torch.stack([base * 0.9 + 10, base, base * 1.05 - 5], dim=-1)
        out[i] = torch.clamp(torch.round(img), 0, 255).to(
            torch.uint8).cpu().numpy()
    return out


class FrameSource:
    """Frame i of a run, from the seed: pool frame i % pool, exposure
    shifted by a distinct offset in [-span, span] \\ {0}."""

    def __init__(self, shape, noise_sigma: float, seed: int, device,
                 pool: int = POOL, span: int = EXPOSURE_SPAN):
        h, w = shape
        self.pool = structured_pool(h, w, pool, float(noise_sigma), seed,
                                    device)
        rng = np.random.default_rng(seed_words(seed))
        self.offsets = rng.permutation(
            [d for d in range(-span, span + 1) if d != 0])
        self.n_pixels = h * w

    @property
    def capacity(self) -> int:
        """How many distinct frames this source gives."""
        return len(self.pool) * len(self.offsets)

    def frame(self, i: int) -> np.ndarray:
        if i >= self.capacity:
            raise IndexError(f"frame {i}: the source holds {self.capacity}")
        npool = len(self.pool)
        d = int(self.offsets[i // npool])
        lut = np.clip(np.arange(256) + d, 0, 255).astype(np.uint8)
        return cv2.LUT(self.pool[i % npool], lut)
