"""train_filter's row order in the port against nle_tpu's: both return
eigenvectors in pixel order by default (the reference's `m_eigvecs = P * V`)
and refuse a fused first edit in pixel order.

Input: a 40x48 channel of np.random.default_rng(0).random * 255, rounded,
args 6 6 100 30 5 4, on the CPU (nle_tpu with its CPU paths, and with its
Pallas kernels interpreted for its small layout; the port with its
kernels' plain versions).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from nle_tpu.ops.pipeline import apply_filter as japply_filter
from nle_tpu.ops.pipeline import train_filter as jtrain_filter
from nle_tpu.ops.transform import transform_eigenvalues as jtransform
from nle_tpu_torch.ops import pipeline as tpipe
from nle_tpu_torch.ops.pipeline import apply_filter, train_filter
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.ops.transform import transform_eigenvalues
from nle_tpu_interpreted import interpreted

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


@pytest.fixture(scope="module")
def jax_small(channel):
    """nle_tpu's train on its layout for this frame when its kernels run
    (the small one, stage2_dense_small), interpreted on the CPU."""
    mp = pytest.MonkeyPatch()
    interpreted(mp)
    try:
        Vj, Sj = jtrain_filter(channel, *ARGS, use_pallas=True)
        fj = japply_filter(Vj, jtransform(Sj, jnp.asarray(WEIGHTS)),
                           jnp.asarray(channel))
    finally:
        mp.undo()
    return np.asarray(Vj), np.asarray(Sj), np.asarray(fj)


def _held(channel, got, want, s_rtol: float, v_atol: float):
    V, S = got
    Vj, Sj, fj = want
    np.testing.assert_allclose(S.numpy(), Sj, rtol=s_rtol)
    assert np.abs(V.numpy() - Vj).max() <= v_atol
    f = apply_filter(V, transform_eigenvalues(S, WEIGHTS),
                     torch.from_numpy(channel))
    assert f.shape == channel.shape
    assert _psnr(np.clip(f.numpy(), 0, 255), np.clip(fj, 0, 255)) >= 45.0


@pytest.mark.parametrize("streaming", [None, True])
def test_train_filter_defaults_match_nle_tpu(channel, jax_defaults, jax_small,
                                            streaming, monkeypatch):
    """The port's defaults against nle_tpu's on the same channel, each edit
    V f(S) V^T y of the exported apply_filter to >= 45 dB (the packed rows
    gave 9.40 dB). streaming=None takes the small layout here in both
    packages: held to nle_tpu's small layout with its kernels interpreted,
    S to rtol 5e-4 and V per entry to 3e-4 (measured 3.1e-4 and 1.8e-4,
    edit 63.0 dB: its int16 half-step drops the lo*lo term of its bf16
    split, the port's takes exact fp32 products), and to nle_tpu's CPU
    default (XLA, no carrier) S to rtol 1e-4 with the edit >= 45 dB.
    streaming=True: to nle_tpu's CPU default, V per entry to 1e-5."""
    monkeypatch.delenv("NLE_CPHI_BYTES", raising=False)
    V, S = train_filter(channel, *ARGS, device="cpu", streaming=streaming)
    Vj, Sj, fj = jax_defaults
    if streaming is None:
        grid = sample_grid(*channel.shape, *ARGS[:2])
        assert tpipe.stage2_dense_small(grid.n_pixels, grid.n_samples)
        _held(channel, (V, S), jax_small, 5e-4, 3e-4)
        np.testing.assert_allclose(S.numpy(), Sj, rtol=1e-4)
        f = apply_filter(V, transform_eigenvalues(S, WEIGHTS),
                         torch.from_numpy(channel))
        assert _psnr(np.clip(f.numpy(), 0, 255), np.clip(fj, 0, 255)) >= 45.0
    else:
        _held(channel, (V, S), jax_defaults, 1e-4, 1e-5)


def test_train_filter_split_layout_matches_nle_tpu(channel, jax_defaults,
                                                   monkeypatch):
    """The split layout (NLE_CPHI_BYTES=0, the layout of frames past the
    small layout's limit) against nle_tpu's CPU default: V per entry to
    1e-5 (3.9e-6 measured; the packed rows were 0.067 off), S to rtol
    1e-4, the edit to >= 45 dB (74.94 dB measured)."""
    monkeypatch.setenv("NLE_CPHI_BYTES", "0")
    got = train_filter(channel, *ARGS, device="cpu")
    _held(channel, got, jax_defaults, 1e-4, 1e-5)


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
