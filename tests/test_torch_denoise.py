"""Denoise in the port (NLEFilter.train_for_denoise + denoise, dense and
factored; shrink_eigenvalues) against nle_tpu on the CPU, on numpy-made
noisy frames."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.models.filter import NLEFilter as JaxNLEFilter
from nle_tpu.ops.transform import shrink_eigenvalues as jax_shrink
from nle_tpu_torch import NLEFilter
from nle_tpu_torch.color.bilateral import bilateral_filter_u8
from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
from nle_tpu_torch.ops import pipeline as tpipe
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.ops.transform import shrink_eigenvalues
from nle_tpu_interpreted import interpreted


def _noisy_frame(h, w, seed=2):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(xx / 11.0) + 40 * np.cos(yy / 7.0)
    img = np.stack([base + 10 * c for c in range(3)], axis=-1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


# (frame shape, train args, sigma_color, sigma_space, shrink)
CASES = {
    "64x96 10 10 2": ((64, 96), (8, 8, 100.0, 30.0, 10, 8), 10.0, 10.0, 2.0),
    "48x72 7.5 3 1.5": ((48, 72), (6, 8, 50.0, 20.0, 5, 6), 7.5, 3.0, 1.5),
}


# Gates of the port's denoise against nle_tpu's, by route: (whole-image
# dB, chroma dB, share of a*b* values that differ). The factored route and
# the split layout (NLE_CPHI_BYTES=0, the layout past the small layout's
# limit) against nle_tpu's CPU default. The dense default, the small
# layout here, against nle_tpu's small layout with its kernels interpreted
# (the layout nle_tpu takes for these frames where its kernels run):
# measured 47.94 dB, chroma 52.59 dB and 33.4% at 48x72, 59.92 dB, 63.27
# dB and 2.8% at 64x96. Both packages' small layouts carry every row of
# phi, Um's too, on the int16 carrier, and at 48x72 (5 Sinkhorn
# iterations) the two carriers' rounding moves S by up to 1.4e-2; each
# package's small layout sits as far from the exact f32 route.
GATES = {"dense": (45.0, 50.0, 0.4), "factored": (45.0, 60.0, 0.01),
         "split": (45.0, 60.0, 0.01)}


@pytest.mark.parametrize("route", ["dense", "factored", "split"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_denoise_matches_nle_tpu(case, route, monkeypatch):
    monkeypatch.delenv("NLE_CPHI_BYTES", raising=False)
    shape, args, sc, ss, shrink = CASES[case]
    img = _noisy_frame(*shape)
    factored = route == "factored"
    if route == "split":
        monkeypatch.setenv("NLE_CPHI_BYTES", "0")
    tf = NLEFilter(device="cpu", factored=factored)
    tf.train_for_denoise(img, *args, sc, ss)
    got = tf.denoise(img, shrink, sc, ss)
    assert got.shape == img.shape and got.dtype == np.uint8
    if route == "dense":
        grid = sample_grid(*shape, *args[:2])
        assert tpipe.stage2_dense_small(grid.n_pixels, grid.n_samples)
        # nle_tpu's CPU default too, on the whole image (51.06 dB measured
        # at 48x72).
        jf = JaxNLEFilter()
        jf.train_for_denoise(img, *args, sc, ss)
        assert _psnr(got, jf.denoise(img, shrink, sc, ss)) >= 45.0
        interpreted(monkeypatch)
        jf = JaxNLEFilter(use_pallas=True)
    else:
        jf = JaxNLEFilter(factored=True) if factored else JaxNLEFilter()
    jf.train_for_denoise(img, *args, sc, ss)
    want = jf.denoise(img, shrink, sc, ss)
    db = _psnr(got, want)
    # The chroma planes alone (the outputs' a and b): the bilateral on L
    # moves the whole image most, so a wrong shrink of the chroma edit (k
    # 10% off) can stay above 45 dB on the whole image; it fails these.
    ab_got, ab_want = (bgr_to_lab_u8_np(x)[..., 1:].astype(np.int16)
                       for x in (got, want))
    ab_db = _psnr(ab_got, ab_want)
    share = float(np.mean(ab_got != ab_want))
    print(f"denoise {case} {route}: port vs nle_tpu {db:.2f} "
          f"dB, chroma {ab_db:.2f} dB, {share:.4%} of a*b* values differ")
    min_db, min_ab_db, max_share = GATES[route]
    assert db >= min_db
    assert ab_db >= min_ab_db
    assert share <= max_share


def test_bilateral_substitution_gives_the_same_bits():
    """bilateral_L given the internal bilateral's own output trains and
    denoises to the same bits as the internal path."""
    img = _noisy_frame(48, 64, seed=3)
    args = (6, 6, 80.0, 25.0, 5, 6)
    L = bilateral_filter_u8(torch.from_numpy(bgr_to_lab_u8_np(img)[..., 0]),
                            -1, 10.0, 10.0).numpy()
    a = NLEFilter(device="cpu")
    a.train_for_denoise(img, *args, 10.0, 10.0)
    out_a = a.denoise(img, 2.0, 10.0, 10.0)
    b = NLEFilter(device="cpu")
    b.train_for_denoise(img, *args, 10.0, 10.0, bilateral_L=L)
    np.testing.assert_array_equal(b.trained.eigvecs.numpy(),
                                  a.trained.eigvecs.numpy())
    np.testing.assert_array_equal(b.denoise(img, 2.0, 10.0, 10.0,
                                            bilateral_L=L), out_a)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [2.0, 1.5, 3, 0.5])
def test_shrink_eigenvalues_within_one_ulp(dtype, k):
    rng = np.random.default_rng(7)
    lam = np.concatenate([rng.uniform(0, 2, 200), [0.0, 1.0, 1e-10, 0.5]])
    lam = lam.astype(dtype)
    want = np.asarray(jax_shrink(jnp.asarray(lam), k))
    got = shrink_eigenvalues(torch.from_numpy(lam), k)
    assert got.dtype == torch.from_numpy(lam).dtype
    got = got.numpy()
    assert np.all(got <= 1.0)
    ulp = np.spacing(np.maximum(np.abs(want), np.finfo(dtype).tiny))
    assert np.all(np.abs(got - want) <= ulp), np.max(np.abs(got - want) / ulp)
