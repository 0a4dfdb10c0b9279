"""train_filter's and NLEFilter's options in the port (stage1 "topk" and
"device", use_kernels=False, streaming=True, dtype=float64) against the
same options of nle_tpu on the CPU, the float64 route against
tests/oracle_numpy.py, the top-k solver's fall-back, and the options'
errors."""

import logging

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

import oracle_numpy as O
from nle_tpu.models.filter import NLEFilter as JaxNLEFilter
from nle_tpu.ops import pipeline as jpipe
from nle_tpu.ops.affinity import bandwidth_weights as jax_bandwidths
from nle_tpu.ops.sampling import sample_grid
from nle_tpu_torch import NLEFilter, TrainedFilter
from nle_tpu_torch.ops import linalg as tlinalg
from nle_tpu_torch.ops import pipeline as tpipe
from nle_tpu_torch.ops.affinity import bandwidth_weights
from nle_tpu_torch.ops.pipeline import apply_filter, train_filter
from nle_tpu_torch.ops.transform import transform_eigenvalues

WEIGHTS = [4, 3, 4, 1]
ARGS = (8, 8, 100.0, 30.0, 10, 8)
ARGS_CUT = (10, 12, 500.0, 10.0, 10, 8)     # Ka spectrum cut at eps


def _frame(h, w, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(xx / 11.0) + 40 * np.cos(yy / 7.0)
    img = np.stack([base + rng.normal(0, 6, (h, w)) + 10 * c
                    for c in range(3)], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _spy_m(monkeypatch, module):
    """Record the kept rank m each train_filter buckets."""
    seen = []
    real = module.bucket_m

    def spy(m, p):
        seen.append(m)
        return real(m, p)

    monkeypatch.setattr(module, "bucket_m", spy)
    return seen


# (nle_tpu NLEFilter kwargs, the port's) for one option each
ROUTES = {
    "stage1=topk": ({"stage1": "topk"}, {"stage1": "topk"}),
    "stage1=device": ({"stage1": "device"}, {"stage1": "device"}),
    "use_kernels=False": ({"use_pallas": False}, {"use_kernels": False}),
    "streaming=True": ({"streaming": True}, {"streaming": True}),
}


@pytest.mark.parametrize("shape,args", [((64, 96), ARGS), ((72, 80), ARGS),
                                        ((80, 96), ARGS_CUT)], ids=str)
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_matches_nle_tpu(route, shape, args, monkeypatch):
    jkw, tkw = ROUTES[route]
    img = _frame(*shape)
    m_jax = _spy_m(monkeypatch, jpipe)
    m_port = _spy_m(monkeypatch, tpipe)
    want = JaxNLEFilter(**jkw).train_and_enhance(img, *args, weights=WEIGHTS)
    got = NLEFilter(device="cpu", **tkw).train_and_enhance(
        img, *args, weights=WEIGHTS)
    db = _psnr(got, want)
    print(f"{route} {shape} {args}: port vs nle_tpu {db:.2f} dB, m "
          f"{m_port} (nle_tpu {m_jax})")
    assert m_port == m_jax and len(m_port) == 1
    assert db >= 45.0


@pytest.mark.parametrize("shape", [(64, 96), (72, 80)])
def test_float64_route_matches_nle_tpu(shape):
    img = _frame(*shape)
    jf = JaxNLEFilter(dtype=jnp.float64)
    want = jf.train_and_enhance(img, *ARGS, weights=WEIGHTS)
    tf = NLEFilter(device="cpu", dtype=torch.float64)
    got = tf.train_and_enhance(img, *ARGS, weights=WEIGHTS)
    assert tf.trained.eigvecs.dtype == torch.float64
    np.testing.assert_allclose(tf.trained.eigvals.numpy(),
                               np.asarray(jf.trained.eigvals), rtol=1e-8)
    db = _psnr(got, want)
    print(f"float64 {shape}: port vs nle_tpu {db:.2f} dB")
    assert db >= 45.0


def test_device_stage1_matches_nle_tpu():
    """stage1="device" alone: Ka and its float32 eigh in both packages,
    the same kept rank m and eigenvalues to float32 noise."""
    L = _frame(64, 96)[..., 0].astype(np.float32)
    grid = sample_grid(64, 96, 8, 8)
    y = L.reshape(-1)[grid.perm]
    rr = (grid.perm // 96).astype(np.float32)
    cc = (grid.perm % 96).astype(np.float32)
    p = grid.n_samples
    sw, pw = jax_bandwidths(100.0, 30.0)
    U, lam = jpipe.ka_eigh_stage(jnp.asarray(y), jnp.asarray(rr),
                                 jnp.asarray(cc), sw, pw, p=p, eps=1e-10,
                                 eigh_method="host64-chain")
    tsw, tpw = bandwidth_weights(100.0, 30.0)
    Ut, lamt = tpipe.ka_eigh_stage(torch.from_numpy(y), torch.from_numpy(rr),
                                   torch.from_numpy(cc), tsw, tpw, p=p,
                                   eps=1e-10)
    lam, lamt = np.asarray(lam), lamt.numpy()
    assert lamt.dtype == np.float32
    assert np.count_nonzero(lamt) == np.count_nonzero(lam)
    np.testing.assert_allclose(lamt, lam, rtol=1e-4, atol=1e-5 * lam.max())


# -- the float64 route against the float64 oracle ----------------------------

O_ARGS = (3, 4, 50.0, 30.0, 10, 5)


@pytest.fixture(scope="module")
def oracle_chan():
    rng = np.random.default_rng(7)
    chan = rng.integers(0, 256, (24, 32)).astype(np.float64)
    return chan, O.train_filter(chan, *O_ARGS)


@pytest.mark.parametrize("stage1", ["host64", "device"])
def test_float64_route_matches_the_oracle(oracle_chan, stage1):
    """Eigenvalues to a relative 1e-8, and the edit's u8 rounding within
    1 LSB of the oracle's."""
    chan, (V_o, S_o) = oracle_chan
    V, S = train_filter(chan, *O_ARGS, device="cpu", dtype=torch.float64,
                        stage1=stage1)
    assert V.dtype == S.dtype == torch.float64
    np.testing.assert_allclose(S.numpy(), S_o, rtol=1e-8)
    fS = O.transform_eigenvalues(S_o, WEIGHTS)
    want = np.clip(np.rint(O.apply_filter(V_o, fS, chan)), 0, 255)
    got = apply_filter(V, transform_eigenvalues(S, WEIGHTS),
                       torch.from_numpy(chan)).numpy()
    assert np.abs(np.clip(np.rint(got), 0, 255) - want).max() <= 1


# -- the top-k solver ---------------------------------------------------------

def _ka_inputs(seed=3, n=(8, 8), hy=30.0):
    L = _frame(64, 96, seed)[..., 0].astype(np.float64)
    grid = sample_grid(64, 96, *n)
    return (L[grid.sel_rows, grid.sel_cols], grid.sel_rows, grid.sel_cols,
            100.0, hy, 1e-10)


def test_topk_stage1_equals_nle_tpu_and_the_exact_solver():
    args = _ka_inputs()
    U, lam, Uinv = tpipe.ka_eigh_topk_host64(*args)
    Uj, lamj, _ = jpipe.ka_eigh_topk_host64(*args)
    np.testing.assert_array_equal(lam, lamj)
    np.testing.assert_array_equal(U, Uj)
    Ue, lame, _ = tpipe.ka_eigh_host64(*args)
    assert lam.shape == lame.shape
    np.testing.assert_allclose(lam, lame, rtol=1e-8)
    np.testing.assert_allclose(Uinv, U / lam[None, :])


def test_topk_falls_back_when_arpack_does_not_converge(monkeypatch, caplog):
    args = _ka_inputs()

    def no_convergence(M, k, **kw):
        lam, U = np.linalg.eigh(M)
        raise spla.ArpackNoConvergence("forced", lam[-2:], U[:, -2:])

    monkeypatch.setattr(spla, "eigsh", no_convergence)
    with caplog.at_level(logging.WARNING, logger="nle_tpu_torch"):
        U, lam, _ = tpipe.ka_eigh_topk_host64(*args)
    assert "NOT successful" in caplog.text
    Ue, lame, _ = tpipe.ka_eigh_host64(*args)
    np.testing.assert_array_equal(lam, lame)
    np.testing.assert_array_equal(U, Ue)
    M = O.compute_kernel(_frame(64, 96)[..., 0].astype(np.float64), 4, 4,
                         100.0, 30.0)[1]
    out = tlinalg.topk_eigendecomposition(M, 4, return_converged=True)
    assert len(out) == 3 and out[2] is False and out[1].size == 2
    assert len(tlinalg.topk_eigendecomposition(M, 4)) == 2


# -- errors and ignored options -----------------------------------------------

def test_option_errors():
    chan = _frame(40, 48)[..., 0].astype(np.float32)
    args = (5, 5, 100.0, 30.0, 3, 4)
    with pytest.raises(ValueError, match="streaming stage 2 requires"):
        train_filter(chan, *args, device="cpu", dtype=torch.float64,
                     streaming=True)
    with pytest.raises(ValueError, match="use_kernels=True needs"):
        train_filter(chan, *args, device="cpu", use_kernels=True)
    with pytest.raises(ValueError, match="use_kernels=False"):
        train_filter(chan, *args, device="cpu", use_kernels=False,
                     streaming=True)
    with pytest.raises(ValueError, match="stage1="):
        train_filter(chan, *args, device="cpu", stage1="hots64")
    for stage1 in ("host64", "topk", "device"):
        with pytest.raises(ValueError, match="no eigenvalues above eps"):
            train_filter(chan, *args, device="cpu", eps=1e9, stage1=stage1)
        with pytest.raises(ValueError, match="no eigenvalues above eps"):
            jpipe.train_filter(chan, *args, eps=1e9, stage1=stage1)
    with pytest.raises(TypeError, match="unknown option"):
        NLEFilter(device="cpu", use_pallas=False)


def test_factored_warns_and_ignores_the_options(caplog):
    img = _frame(48, 64)
    args = (6, 6, 100.0, 30.0, 5, 6)
    plain = NLEFilter(device="cpu", factored=True).train_and_enhance(
        img, *args, weights=WEIGHTS)
    with caplog.at_level(logging.WARNING, logger="nle_tpu_torch"):
        out = NLEFilter(device="cpu", factored=True, stage1="topk",
                        use_kernels=False).train_and_enhance(
            img, *args, weights=WEIGHTS)
    assert "factored training ignores option(s): stage1, use_kernels" in (
        caplog.text)
    np.testing.assert_array_equal(out, plain)


def test_float64_filter_keeps_its_dtype(tmp_path):
    """A float64 V through save/load, NLEFilter.apply (the channel cast to
    V's dtype, as nle_tpu casts it) and the u8 edit."""
    img = _frame(48, 64)
    args = (6, 6, 100.0, 30.0, 5, 6)
    f = NLEFilter(device="cpu", dtype=torch.float64)
    edit = f.train_and_enhance(img, *args, weights=WEIGHTS)
    path = str(tmp_path / "f64")
    f.trained.save(path)
    g = NLEFilter(TrainedFilter.load(path, "cpu"), device="cpu")
    assert g.trained.eigvecs.dtype == g.trained.eigvals.dtype == torch.float64
    np.testing.assert_array_equal(g.enhance(img, WEIGHTS), edit)
    L = img[..., 0].astype(np.float32)
    fs = transform_eigenvalues(g.trained.eigvals, WEIGHTS)
    out = g.apply(L, fs)
    assert out.dtype == np.float64 and out.shape == L.shape
    jf = JaxNLEFilter(dtype=jnp.float64)
    jf.train_for_enhancement(img, *args)
    jout = jf.apply(L, np.asarray(jf.trained.eigvals) * 0 + fs.numpy())
    assert np.asarray(jout).dtype == np.float64
