"""train_filter's row order in the port against nle_tpu's: both return
eigenvectors in pixel order by default (the reference's `m_eigvecs = P * V`)
and refuse a fused first edit in pixel order.

Input: a 40x48 channel of np.random.default_rng(0).random * 255, rounded,
args 6 6 100 30 5 4, on the CPU (nle_tpu with its CPU paths, the port with
its kernels' plain versions).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nle_tpu.ops.pipeline import apply_filter as japply_filter
from nle_tpu.ops.pipeline import train_filter as jtrain_filter
from nle_tpu.ops.transform import transform_eigenvalues as jtransform
from nle_tpu_torch.ops.pipeline import apply_filter, train_filter
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.ops.transform import transform_eigenvalues

ARGS = (6, 6, 100.0, 30.0, 5, 4)
WEIGHTS = [4.0, 3.0, 4.0, 1.0]


@pytest.fixture(scope="module")
def channel():
    rng = np.random.default_rng(0)
    return np.rint(rng.random((40, 48)) * 255).astype(np.float32)


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.fixture(scope="module")
def jax_defaults(channel):
    Vj, Sj = jtrain_filter(channel, *ARGS)
    fj = japply_filter(Vj, jtransform(Sj, jnp.asarray(WEIGHTS)),
                       jnp.asarray(channel))
    return np.asarray(Vj), np.asarray(Sj), np.asarray(fj)


@pytest.mark.parametrize("streaming", [None, True])
def test_train_filter_defaults_match_nle_tpu(channel, jax_defaults, streaming):
    """The port's defaults against nle_tpu's on the same channel: V per
    entry to 1e-5 (3.9e-6 measured on the dense route; the packed rows
    were 0.067 off), and the edit V f(S) V^T y of the exported
    apply_filter to >= 45 dB (74.94 dB measured; the packed rows gave
    9.40 dB)."""
    Vj, Sj, fj = jax_defaults
    V, S = train_filter(channel, *ARGS, device="cpu", streaming=streaming)
    np.testing.assert_allclose(S.numpy(), Sj, rtol=1e-4)
    assert np.abs(V.numpy() - Vj).max() <= 1e-5
    f = apply_filter(V, transform_eigenvalues(S, WEIGHTS),
                     torch.from_numpy(channel))
    assert f.shape == channel.shape
    assert _psnr(np.clip(f.numpy(), 0, 255), np.clip(fj, 0, 255)) >= 45.0


def test_pixel_order_false_returns_the_packed_rows(channel):
    """pixel_order=False gives the same rows in the packed [selected; rest]
    order: V_pixel[perm] == V_packed."""
    grid = sample_grid(*channel.shape, *ARGS[:2])
    V, S = train_filter(channel, *ARGS, device="cpu")
    Vp, Sp = train_filter(channel, *ARGS, device="cpu", pixel_order=False)
    assert torch.equal(S, Sp)
    assert torch.equal(V[torch.from_numpy(grid.perm)], Vp)


def test_edit_weights_in_pixel_order_raise(channel):
    """A fused first edit needs the packed order, as in nle_tpu
    (ops/pipeline.py raises ValueError there)."""
    with pytest.raises(ValueError, match="pixel_order=False"):
        jtrain_filter(channel, *ARGS, edit_weights=WEIGHTS)
    with pytest.raises(ValueError, match="pixel_order=False"):
        train_filter(channel, *ARGS, device="cpu", edit_weights=WEIGHTS)
    out = train_filter(channel, *ARGS, device="cpu", edit_weights=WEIGHTS,
                       pixel_order=False)
    assert len(out) == 3 and out[2].dtype == torch.uint8
