"""The port's bilateral filter (nle_tpu_torch/color/bilateral.py) against
nle_tpu's on the CPU, on numpy-made u8 frames: within 1 LSB everywhere
(the two packages' float32 exp may differ by an ulp, which can move a
rounding tie), with the share of differing pixels printed. The sigma pairs
take fractional values (7.5), radii that round half to even (sigma_space
3.0 -> round(4.5) = 4, 5.0 -> round(7.5) = 8), sigmas <= 0 (taken as 1)
and a frame smaller than the radius (reflect-101 past the image side)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.color.bilateral import bilateral_filter_u8 as jax_bilateral
from nle_tpu_torch.color.bilateral import _aperture, bilateral_filter_u8

SIGMAS = [(10.0, 10.0), (7.5, 7.5), (20.0, 3.0), (5.0, 5.0), (30.0, 2.0),
          (10.0, -1.0), (0.0, 4.0)]


def _frames():
    rng = np.random.default_rng(5)
    yy, xx = np.mgrid[0:64, 0:96]
    smooth = 120 + 60 * np.sin(xx / 9.0) + 40 * np.cos(yy / 6.0)
    noisy = np.clip(smooth + rng.normal(0, 15, smooth.shape), 0, 255)
    return {"noise 64x96": rng.integers(0, 256, (64, 96), np.uint8),
            "structured 64x96": noisy.astype(np.uint8),
            "7x9 under the radius": rng.integers(0, 256, (7, 9), np.uint8),
            "1x5": rng.integers(0, 256, (1, 5), np.uint8)}


FRAMES = _frames()


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("sigmas", SIGMAS, ids=str)
def test_bilateral_matches_nle_tpu(frame, sigmas):
    img = FRAMES[frame]
    sc, ss = sigmas
    want = np.asarray(jax_bilateral(jnp.asarray(img), -1, sc, ss))
    got = bilateral_filter_u8(torch.from_numpy(img), -1, sc, ss)
    assert got.dtype == torch.uint8 and tuple(got.shape) == img.shape
    d = np.abs(got.numpy().astype(np.int32) - want.astype(np.int32))
    print(f"{frame}, sigmas {sigmas}: max {d.max()} LSB, "
          f"{np.count_nonzero(d) / d.size:.4%} of pixels differ")
    assert d.max() <= 1


def test_radius_rounds_half_to_even():
    assert _aperture(-1, 3.0) == 4      # round(4.5)
    assert _aperture(-1, 5.0) == 8      # round(7.5)
    assert _aperture(-1, 10.0) == 15
    assert _aperture(-1, 0.2) == 1      # floored at 1
    assert _aperture(7, 10.0) == 3      # d > 0: d // 2
