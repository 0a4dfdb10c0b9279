"""The port's Lab conversions on the CPU: its verbatim copy of labcolor.c,
the C loader against the NumPy pair, the five device twins against
nle_tpu's jitted twins, and the model layer's caches (y_cache's content
guard, seed_lab_cache)."""

import logging
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.color import lab as jlab
from nle_tpu_torch import native
from nle_tpu_torch.color import lab as tlab
from nle_tpu_torch.models.filter import NLEFilter, TrainedFilter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cube_edges(rng):
    """The Lab-cube extremes (corners and axes) and a random interior, as
    tests/test_color.py takes them."""
    corners = np.stack(np.meshgrid([0, 255], [0, 255], [0, 255],
                                   indexing="ij"), -1).reshape(-1, 3)
    axes = np.stack([np.arange(256)] * 3, -1)
    rand = rng.integers(0, 256, (4096, 3))
    px = np.concatenate([corners, axes, rand]).astype(np.uint8)
    return px[: (px.shape[0] // 4) * 4].reshape(-1, 4, 3)


def test_labcolor_source_is_a_verbatim_copy():
    with open(os.path.join(ROOT, "nle_tpu", "native", "labcolor.c"), "rb") as a:
        want = a.read()
    with open(native.SOURCE, "rb") as b:
        assert b.read() == want


def test_c_path_bitwise_equals_numpy(tmp_path, rng):
    """A fresh build with the system's cc (into a temp build dir), then
    both directions bit for bit against the NumPy path on the cube's
    extremes and a random interior, and on a random image."""
    lib = native.load_from(str(tmp_path))
    assert lib is not None, "cc could not build labcolor.c"
    built = [f for f in os.listdir(tmp_path) if f.endswith(".built")]
    assert len(built) == 1 and "-march=native" in (tmp_path / built[0]).read_text()
    for px in (_cube_edges(rng), rng.integers(0, 256, (37, 53, 3), np.uint8)):
        np.testing.assert_array_equal(
            native.bgr2lab_u8(lib, px, tlab._GAMMA_TAB, tlab._CBRT_TAB,
                              tlab._XYZ_COEFFS, tlab._L_SCALE, tlab._L_SHIFT),
            tlab.bgr_to_lab_u8_numpy(px))
        np.testing.assert_array_equal(
            native.lab2bgr_u8(lib, px, tlab._IY_TAB, tlab._IFY_TAB,
                              tlab._IAB_TAB, tlab._IMIN_AB, tlab._ICOEFFS,
                              tlab._IGAMMA_TAB, tlab._IADIV_TAB,
                              tlab._IBDIV_TAB),
            tlab.lab_to_bgr_u8_numpy(px))
    # A second load finds the build and its marker: no rebuild.
    before = {f: os.path.getmtime(tmp_path / f) for f in os.listdir(tmp_path)}
    assert native.load_from(str(tmp_path)) is not None
    assert before == {f: os.path.getmtime(tmp_path / f)
                      for f in os.listdir(tmp_path)}


def test_host_pair_dispatches_to_c():
    """The model layer's host pair runs the C kernels where a C compiler
    exists (these tests need one), and equals the NumPy path."""
    assert native.load() is not None
    img = np.random.default_rng(3).integers(0, 256, (40, 60, 3), np.uint8)
    lab = tlab.bgr_to_lab_u8_np(img)
    np.testing.assert_array_equal(lab, tlab.bgr_to_lab_u8_numpy(img))
    np.testing.assert_array_equal(tlab.lab_to_bgr_u8_np(lab),
                                  tlab.lab_to_bgr_u8_numpy(lab))


def test_numpy_fallback_warns_once_naming_the_path(monkeypatch, caplog):
    monkeypatch.setattr(native, "load", lambda: None)
    tlab._warn_numpy_path.cache_clear()
    img = np.random.default_rng(4).integers(0, 256, (8, 9, 3), np.uint8)
    with caplog.at_level(logging.WARNING, logger="nle_tpu_torch"):
        lab = tlab.bgr_to_lab_u8_np(img)
        tlab.lab_to_bgr_u8_np(lab)
    warned = [r for r in caplog.records if "NumPy path" in r.getMessage()]
    assert len(warned) == 1
    np.testing.assert_array_equal(lab, tlab.bgr_to_lab_u8_numpy(img))
    tlab._warn_numpy_path.cache_clear()


@pytest.mark.parametrize("name", ["bgr_to_lab_u8", "lab_to_bgr_u8",
                                  "luminance_channel", "y_channel"])
def test_device_twin_bitwise_equals_nle_tpu(name, rng):
    for px in (_cube_edges(rng), rng.integers(0, 256, (48, 64, 3), np.uint8)):
        want = np.asarray(getattr(jlab, name)(jnp.asarray(px)))
        got = getattr(tlab, name)(torch.from_numpy(px)).numpy()
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_float_formula_within_one_lsb_of_nle_tpu(rng):
    """fp32 float formula: torch has no cbrt (x^(1/3) instead), so a value
    at a rounding tie may land one LSB from nle_tpu's."""
    px = rng.integers(0, 256, (64, 80, 3), np.uint8)
    want = np.asarray(jlab.bgr_to_lab_u8_float(jnp.asarray(px))).astype(int)
    got = tlab.bgr_to_lab_u8_float(torch.from_numpy(px)).numpy().astype(int)
    assert np.abs(got - want).max() <= 1
    assert np.mean(got != want) < 1e-3


def test_device_twins_equal_host_pair(rng):
    px = _cube_edges(rng)
    np.testing.assert_array_equal(
        tlab.bgr_to_lab_u8(torch.from_numpy(px)).numpy(),
        tlab.bgr_to_lab_u8_np(px))
    np.testing.assert_array_equal(
        tlab.lab_to_bgr_u8(torch.from_numpy(px)).numpy(),
        tlab.lab_to_bgr_u8_np(px))


@pytest.mark.skipif(os.environ.get("NLE_RUN_FULL_GOLDEN") != "1",
                    reason="full 256^3 cube check is slow; NLE_RUN_FULL_GOLDEN=1")
def test_device_twins_full_cube():
    L, A, B = np.meshgrid(np.arange(256, dtype=np.uint8),
                          np.arange(256, dtype=np.uint8),
                          np.arange(256, dtype=np.uint8), indexing="ij")
    cube = np.stack([L, A, B], axis=-1).reshape(4096, 4096, 3)
    t = torch.from_numpy(cube)
    np.testing.assert_array_equal(tlab.lab_to_bgr_u8(t).numpy(),
                                  tlab.lab_to_bgr_u8_numpy(cube))
    np.testing.assert_array_equal(tlab.bgr_to_lab_u8(t).numpy(),
                                  tlab.bgr_to_lab_u8_numpy(cube))


def _frame(seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 110 + 50 * np.sin(xx / 4.0) + 30 * np.cos(yy / 3.0)
    img = np.stack([base + rng.normal(0, 5, (h, w)) + 8 * c
                    for c in range(3)], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


ARGS = (4, 4, 40.0, 20.0, 6, 4)


def test_y_cache_serves_only_the_training_channel(monkeypatch):
    """The u8 edit reuses the training channel's device buffer only when
    the channel it edits equals the cached host copy: an edited frame
    misses the cache and uploads its own channel."""
    import nle_tpu_torch.models.filter as fmod

    img = _frame(1)
    f = NLEFilter(device="cpu")
    f.train_for_enhancement(img, *ARGS)
    cached_np, cached_dev = f.trained.y_cache
    assert cached_np.dtype == np.uint8 and cached_dev.dtype == torch.uint8
    uploads = []
    real = fmod.upload
    monkeypatch.setattr(fmod, "upload",
                        lambda a, d: uploads.append(a.copy()) or real(a, d))
    hit = f.enhance(img, [1, 2, 3, 1])
    assert uploads == []                     # the cached buffer served
    other = np.clip(img.astype(np.int32) + 9, 0, 255).astype(np.uint8)
    miss = f.enhance(other, [1, 2, 3, 1])
    assert len(uploads) == 1 and not np.array_equal(uploads[0], cached_np)
    # Each edit equals a filter without the cache editing the same frame.
    bare = NLEFilter(TrainedFilter(f.trained.eigvecs, f.trained.eigvals,
                                   f.trained.nrows, f.trained.ncols,
                                   perm=f.trained.perm), device="cpu")
    assert bare._packed_y_cache is None
    np.testing.assert_array_equal(hit, bare.enhance(img, [1, 2, 3, 1]))
    np.testing.assert_array_equal(miss, bare.enhance(other, [1, 2, 3, 1]))


def test_y_cache_is_adopted_counted_and_not_compared():
    img = _frame(2)
    f = NLEFilter(device="cpu")
    f.train_for_enhancement(img, *ARGS)
    t = f.trained
    adopted = NLEFilter(t, device="cpu")
    assert adopted._packed_y_cache is t.y_cache
    plain = TrainedFilter(t.eigvecs, t.eigvals, t.nrows, t.ncols,
                          perm=t.perm)
    assert plain == t                        # the cache is not compared
    n = t.eigvecs.numel() * 4 + t.eigvals.numel() * 4 + t.perm.nbytes
    assert plain.nbytes() == n
    assert t.nbytes() == n + 2 * t.n_pixels  # host u8 + device u8
    f2 = NLEFilter(device="cpu", factored=True)
    f2._packed_y_cache = t.y_cache
    f2.train_for_enhancement(img, *ARGS)
    assert f2._packed_y_cache is None        # the factored path clears it


def test_seed_lab_cache_is_adopted(monkeypatch):
    """A seeded Lab serves the edit: no second BGR->Lab conversion."""
    import nle_tpu_torch.models.filter as fmod

    img = _frame(3)
    f = NLEFilter(device="cpu")
    f.train_for_enhancement(img, *ARGS)
    want = f.enhance(img, [1, 2, 3, 1])
    lab = tlab.bgr_to_lab_u8_np(img)
    g = NLEFilter(f.trained, device="cpu")
    g.seed_lab_cache(img, lab)
    monkeypatch.setattr(fmod, "bgr_to_lab_u8_np", lambda x: pytest.fail(
        "the seeded Lab was not used"))
    np.testing.assert_array_equal(g.enhance(img, [1, 2, 3, 1]), want)
