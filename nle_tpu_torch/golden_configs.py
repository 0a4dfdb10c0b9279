"""The reference's reproducible golden configurations, as data (the port's
copy of nle_tpu/golden_configs.py: the same tables, no import of it).

The README parameter table (reference README.md:72-84), the denoise
configuration and the links.md recipes. Each enhance entry: (name, input,
golden, (nr, nc, hx, hy, iters, k), layer weights), the positional CLI
contract of the reference's `enhance` binary (reference
src/enhance.cpp:20-31).

The f64 anchors of the denoise configuration and the links.md recipes are
committed under tools/golden_cache/; the generators return them as they
stand and compute a missing one in this process through the port's float64
route on the CPU (train_filter(dtype=torch.float64), plain PyTorch),
which reads the input from DATA_DIR.
"""

from __future__ import annotations

import os

# The reference checkout's data folder (nle_tpu's DATA_DIR).
DATA_DIR = os.path.join(os.sep, "root", "reference", "data")

ENHANCE_CONFIGS = [
    ("flower", "flower-50.bmp", "flower-filtered.png",
     (10, 20, 100, 30, 50, 30), [2, 3, 4, 1]),
    ("bird", "bird.bmp", "bird-filtered.png",
     (10, 20, 1000, 20, 10, 10), [1, 5, 5, 1]),
    ("canyon", "canyon-dawn-20.bmp", "canyon-filtered.bmp",
     (20, 10, 500, 30, 40, 10), [2, 7, 5, 1]),
    ("brickwall", "brickwall-20.bmp", "brickwall-filtered.png",
     (10, 20, 1000, 25, 30, 50), [2, 3, 3, 1]),
    ("conifer", "conifer-10.bmp", "conifer-filtered.png",
     (25, 15, 800, 20, 40, 100), [2, 3, 5, 1]),
    ("forest", "forest-10.bmp", "forest-filtered.png",
     (20, 10, 5000, 30, 10, 10), [4, 6, 6, 1.05]),
    ("snow-mountain", "snow-mountain-15.bmp", "snow-mountain-filtered.png",
     (10, 20, 200, 30, 30, 10), [3, 10, 1, 1]),
    ("paper", "paper.jpg", "paper-filtered.png",
     (20, 20, 1000, 40, 50, 20), [0.5, 1, 5, 1]),
    ("rock2", "rock2.jpg", "rock2-filtered.png",
     (20, 30, 500, 10, 50, 50), [4, 3, 4, 1]),
    ("red-cherries", "red-cherries-10.bmp", "red-cherries-filtered.png",
     (20, 10, 400, 30, 50, 20), [2, 2, 2, 1]),
]

# The denoise configuration: the reference ships no denoised output
# (reference README.md:27), so its anchor is the float64 pipeline's own.
# Params follow the reference denoise CLI contract
# (src/denoise.cpp:22-31): nr nc hx hy iters k, then (sigmaColor,
# sigmaSpace, shrinkFactor).
DENOISE_CONFIG = ("taj-denoise", "taj-rgb-noise.jpg",
                  (10, 10, 200, 30, 10, 10), (10, 10, 2.0))

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_CACHE_DIR = os.path.join(_ROOT, "tools", "golden_cache")
DENOISE_GOLDEN = os.path.join(GOLDEN_CACHE_DIR, "taj-denoise-f64.png")

# The historical recipes of the reference's data/links.md:4-52 whose input
# ships in data/; their anchors are the float64 pipeline's outputs.
EXTENDED_RECIPES = [
    # name, input, (nr, nc, hx, hy, iters, k), weights   (links.md line)
    ("beach-clouds", "beach-clouds-15.bmp",
     (20, 10, 500, 30, 20, 20), [2, 5, 4, 2, 0.9]),      # links.md:8
    ("snow-mountain-links", "snow-mountain-15.bmp",
     (10, 20, 1000, 30, 20, 20), [3, 6, 8, 1.04]),       # links.md:16
    ("wood", "wood-20.bmp",
     (20, 10, 3000, 30, 10, 20), [4, 2, 2, 1.04]),       # links.md:24
    ("red-cherries-links", "red-cherries-10.bmp",
     (20, 10, 2000, 30, 10, 20), [2, 3, 3, 1.04]),       # links.md:28
    ("brickwall-links", "brickwall-20.bmp",
     (10, 20, 3000, 25, 10, 20), [2, 3, 3, 1.04]),       # links.md:36
]


def extended_golden_path(name: str) -> str:
    """The committed f64 anchor of a links.md recipe."""
    return os.path.join(GOLDEN_CACHE_DIR, f"{name}-f64.png")


def _float64_filter():
    import torch

    from nle_tpu_torch.models.filter import NLEFilter

    return NLEFilter(device="cpu", dtype=torch.float64)


def _read_input(name: str):
    from nle_tpu_torch.utils.imageio import imread_bgr

    return imread_bgr(os.path.join(DATA_DIR, name))


def _write(path: str, img) -> None:
    from nle_tpu_torch.utils.imageio import imwrite_bgr

    os.makedirs(os.path.dirname(path), exist_ok=True)
    imwrite_bgr(path, img)


def generate_extended_goldens() -> list:
    """Every links.md recipe's f64 anchor path, in EXTENDED_RECIPES order.
    A missing file is computed first through the port's float64 route on
    the CPU (seconds to minutes a recipe); the committed files are returned
    as they stand."""
    paths = []
    for name, inp, params, weights in EXTENDED_RECIPES:
        path = extended_golden_path(name)
        if not os.path.exists(path):
            _write(path, _float64_filter().train_and_enhance(
                _read_input(inp), *params, weights=weights))
        paths.append(path)
    return paths


def generate_denoise_golden() -> str:
    """The denoise configuration's f64 anchor path; a missing file is
    computed first through the port's float64 route on the CPU."""
    if not os.path.exists(DENOISE_GOLDEN):
        _, inp, params, (sigma_color, sigma_space, shrink) = DENOISE_CONFIG
        img = _read_input(inp)
        f = _float64_filter()
        f.train_for_denoise(img, *params, sigma_color, sigma_space)
        _write(DENOISE_GOLDEN, f.denoise(img, shrink, sigma_color,
                                         sigma_space))
    return DENOISE_GOLDEN
