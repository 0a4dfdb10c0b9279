"""The port's golden_configs against nle_tpu's: the same tables, the
committed f64 anchors returned as they stand, and the generators' compute
branch (the port's float64 route on the CPU) on a tiny input written for
the test, since the reference's data folder is not read here."""

import os

import numpy as np
import pytest
import torch

from nle_tpu import golden_configs as jg
from nle_tpu_torch import golden_configs as tg
from nle_tpu_torch.models.filter import NLEFilter
from nle_tpu_torch.utils.imageio import imread_bgr, imwrite_bgr

TABLES = ("DATA_DIR", "ENHANCE_CONFIGS", "DENOISE_CONFIG", "DENOISE_GOLDEN",
          "EXTENDED_RECIPES", "GOLDEN_CACHE_DIR")


@pytest.mark.parametrize("name", TABLES)
def test_tables_equal_nle_tpus(name):
    assert getattr(tg, name) == getattr(jg, name)


def test_extended_golden_paths_equal_nle_tpus():
    for name, *_ in jg.EXTENDED_RECIPES:
        assert tg.extended_golden_path(name) == jg.extended_golden_path(name)


@pytest.fixture()
def no_compute(monkeypatch):
    def refuse():
        raise AssertionError("a committed anchor was recomputed")

    monkeypatch.setattr(tg, "_float64_filter", refuse)


def test_generators_return_the_committed_files(no_compute):
    paths = tg.generate_extended_goldens()
    assert paths == [tg.extended_golden_path(r[0])
                     for r in tg.EXTENDED_RECIPES]
    assert tg.generate_denoise_golden() == tg.DENOISE_GOLDEN
    for path in paths + [tg.DENOISE_GOLDEN]:
        assert os.path.isfile(path), path


def _frame(seed, h=40, w=48):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 4.0)
    return np.clip(np.stack([base + rng.normal(0, 6, (h, w)) + 10 * c
                             for c in range(3)], -1), 0, 255).astype(np.uint8)


def test_generators_compute_a_missing_anchor(monkeypatch, tmp_path):
    """A missing anchor is computed in this process through the port's
    float64 route on the CPU and written where the table says; the files
    already there are left as they are."""
    data, cache = tmp_path / "data", tmp_path / "cache"
    data.mkdir()
    imwrite_bgr(str(data / "in.png"), _frame(0))
    params, weights = (4, 5, 40.0, 20.0, 8, 4), [1.0, 2.0, 1.5, 1.2]
    monkeypatch.setattr(tg, "DATA_DIR", str(data))
    monkeypatch.setattr(tg, "GOLDEN_CACHE_DIR", str(cache))
    monkeypatch.setattr(tg, "DENOISE_GOLDEN", str(cache / "dn-f64.png"))
    monkeypatch.setattr(tg, "DENOISE_CONFIG",
                        ("dn", "in.png", params, (10, 10, 2.0)))
    monkeypatch.setattr(tg, "EXTENDED_RECIPES",
                        [("a", "in.png", params, weights),
                         ("b", "in.png", params, weights)])
    cache.mkdir()
    kept = _frame(1)
    imwrite_bgr(tg.extended_golden_path("b"), kept)
    paths = tg.generate_extended_goldens()
    assert paths == [str(cache / "a-f64.png"), str(cache / "b-f64.png")]
    img = _frame(0)
    f64 = NLEFilter(device="cpu", dtype=torch.float64)
    np.testing.assert_array_equal(
        imread_bgr(paths[0]), f64.train_and_enhance(img, *params,
                                                    weights=weights))
    np.testing.assert_array_equal(imread_bgr(paths[1]), kept)
    assert tg.generate_denoise_golden() == str(cache / "dn-f64.png")
    f64.train_for_denoise(img, *params, 10, 10)
    np.testing.assert_array_equal(imread_bgr(tg.DENOISE_GOLDEN),
                                  f64.denoise(img, 2.0, 10, 10))
