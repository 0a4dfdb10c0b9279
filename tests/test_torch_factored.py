"""The port's V-free factored filter and its model layer against nle_tpu,
on the CPU: NLEFilter(factored=True).train_and_enhance in both packages,
repeatable training, FactoredFilter npz files crossing between the
packages both ways, load_filter's dispatch on the two npz kinds, and the
one-entry Lab cache. The JAX side runs its streaming Pallas kernels in
interpret mode (its own CPU route)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.models.factored import FactoredFilter as JaxFactoredFilter
from nle_tpu.models.factored import train_filter_factored as jtrain_factored
from nle_tpu.models.filter import NLEFilter as JaxNLEFilter
from nle_tpu.models.filter import load_filter as jload_filter
from nle_tpu.ops.transform import transform_eigenvalues as jtransform
from nle_tpu_torch import FactoredFilter, NLEFilter, TrainedFilter, load_filter
from nle_tpu_torch.models.factored import train_filter_factored
from nle_tpu_torch.ops.transform import transform_eigenvalues

WEIGHTS = [4, 3, 4, 1]
ARGS = (6, 6, 100.0, 30.0, 8, 6)


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


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("shape", [(60, 80), (72, 90)])
def test_factored_train_and_enhance_matches_jax(shape):
    img = _frame(*shape)
    got = NLEFilter(device="cpu", factored=True).train_and_enhance(
        img, *ARGS, weights=WEIGHTS)
    want = JaxNLEFilter(factored=True).train_and_enhance(img, *ARGS,
                                                         weights=WEIGHTS)
    assert got.shape == img.shape and got.dtype == np.uint8
    db = _psnr(got, want)
    print(f"factored port vs nle_tpu {shape}: {db:.2f} dB")
    assert db >= 45.0, db


def test_factored_matches_dense_in_the_port():
    """The factored route against the port's dense route on one frame
    (the JAX package documents "within ~2 LSB")."""
    img = _frame(64, 80, seed=2)
    fac = NLEFilter(device="cpu", factored=True).train_and_enhance(
        img, *ARGS, weights=WEIGHTS)
    dense = NLEFilter(device="cpu").train_and_enhance(img, *ARGS,
                                                      weights=WEIGHTS)
    assert _psnr(fac, dense) >= 45.0


def test_factored_training_is_repeatable():
    L = _frame(50, 66, seed=3)[..., 0].astype(np.float32)
    a = train_filter_factored(L, *ARGS, device="cpu")
    b = train_filter_factored(L, *ARGS, device="cpu")
    for name in ("c", "v_head", "w", "eigvals"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name


@pytest.fixture(scope="module")
def jax_factored(tmp_path_factory):
    img = _frame(56, 72, seed=4)
    L = np.asarray(img[..., 0], np.float32)
    jf = jtrain_factored(L, *ARGS)
    path = str(tmp_path_factory.mktemp("factored") / "jax_factored.npz")
    jf.save(path)
    return img, L, jf, path


def _edits_agree(port_ff, jax_ff, L):
    """The same factored filter applied by both packages: the float
    outputs to fp32 summation order (1e-3 of a gray level), the u8 edits
    at most one LSB apart on at most 0.1% of the pixels (a rounding tie)."""
    fs_j = jtransform(jnp.asarray(jax_ff.eigvals), WEIGHTS)
    fs_t = transform_eigenvalues(port_ff.eigvals, WEIGHTS)
    np.testing.assert_array_equal(fs_t.numpy(), np.asarray(fs_j))
    np.testing.assert_allclose(port_ff.apply(L, fs_t), jax_ff.apply(L, fs_j),
                               atol=1e-3)
    chans = np.stack([L, 255 - L], axis=-1).astype(np.uint8)
    d = np.abs(port_ff.apply_u8(chans, fs_t).astype(np.int32)
               - jax_ff.apply_u8(chans, fs_j).astype(np.int32))
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size


def test_factored_filter_saved_by_nle_tpu_edits_in_the_port(jax_factored):
    _, L, jf, path = jax_factored
    port = FactoredFilter.load(path, "cpu")
    assert port.c.dtype == torch.float32 and port.hx == jf.hx
    _edits_agree(port, jf, L)


def test_factored_filter_saved_by_the_port_edits_in_nle_tpu(jax_factored,
                                                            tmp_path):
    _, L, _, _ = jax_factored
    port = train_filter_factored(L, *ARGS, device="cpu")
    path = str(tmp_path / "port_factored")
    port.save(path)
    z = _arrays(path + ".npz")
    assert set(z) == {"y_train", "c", "v_head", "w", "eigvals", "shape",
                      "bandwidths", "perm", "factored"}
    jf = jload_filter(path + ".npz")
    assert isinstance(jf, JaxFactoredFilter)
    _edits_agree(port, jf, L)
    again = FactoredFilter.load(path, "cpu")
    for name in ("c", "v_head", "w", "eigvals"):
        assert torch.equal(getattr(again, name), getattr(port, name))
    np.testing.assert_array_equal(again.perm, port.perm)


def test_load_filter_dispatches_on_the_npz_kind(jax_factored, tmp_path):
    img, _, _, fpath = jax_factored
    dense = NLEFilter(device="cpu")
    dense.train_for_enhancement(img, *ARGS)
    dpath = str(tmp_path / "dense.npz")
    dense.trained.save(dpath)
    assert isinstance(load_filter(fpath, "cpu"), FactoredFilter)
    assert isinstance(load_filter(dpath, "cpu"), TrainedFilter)
    with pytest.raises(TypeError):
        load_filter(fpath)            # the device has no default
    # A loaded factored filter drives NLEFilter's edits.
    edit = NLEFilter(load_filter(fpath, "cpu"), device="cpu").enhance(
        img, WEIGHTS)
    want = JaxNLEFilter(jload_filter(fpath)).enhance(img, WEIGHTS)
    assert _psnr(edit, want) >= 60.0


def test_nle_filter_apply_on_both_kinds(jax_factored):
    """NLEFilter.apply (float, no clamp) dispatches to either filter kind
    and agrees with nle_tpu's NLEFilter.apply."""
    img, L, jf, fpath = jax_factored
    fs = np.array(jtransform(jnp.asarray(jf.eigvals), WEIGHTS))
    got = NLEFilter(load_filter(fpath, "cpu"), device="cpu").apply(L, fs)
    want = JaxNLEFilter(jf).apply(L, jnp.asarray(fs))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3)
    dense = NLEFilter(device="cpu")
    dense.train_for_enhancement(img, *ARGS)
    V = dense.trained.eigvecs.numpy()
    out = dense.apply(L, fs[:V.shape[1]])
    packed = L.reshape(-1)[dense.trained.perm]
    want_d = np.empty_like(packed)
    want_d[dense.trained.perm] = V @ (fs[:V.shape[1]] * (V.T @ packed))
    np.testing.assert_allclose(out, want_d.reshape(L.shape), atol=1e-3)


def _apply_f64(ff, channel, fs):
    """A factored filter's apply, V diag(fs) V^T y, evaluated in float64
    with numpy from its stored state: the tail rows of V regenerated from
    the training features, entries and sums in float64."""
    perm, p = ff.perm, np.asarray(ff.v_head).shape[0]
    y = channel.reshape(-1).astype(np.float64)[perm]
    rr = (perm // ff.ncols).astype(np.float64)
    cc = (perm % ff.ncols).astype(np.float64)
    yt = np.asarray(ff.y_train, np.float64)
    # The affinity weights as both packages round them to float32.
    sw = float(np.float32(1.0 / (ff.hx * ff.hx)))
    pw = float(np.float32(1.0 / (ff.hy * ff.hy)))
    K = np.exp(-(sw * ((rr[p:, None] - rr[None, :p]) ** 2
                       + (cc[p:, None] - cc[None, :p]) ** 2)
                 + pw * (yt[p:, None] - yt[None, :p]) ** 2))    # (q, p)
    c, vh, w = (np.asarray(a, np.float64) for a in (ff.c, ff.v_head, ff.w))
    t = (y[:p] @ vh + ((c[p:] * y[p:]) @ K) @ w) * np.asarray(fs, np.float64)
    out = np.concatenate([vh @ t, c[p:] * (K @ (w @ t))])
    unpacked = np.empty_like(out)
    unpacked[perm] = out
    return unpacked.reshape(channel.shape)


def test_factored_apply_is_as_close_to_float64_as_nle_tpu(jax_factored):
    """The stored filter applied by each package against its float64
    evaluation: the port at most 2x nle_tpu's distance, a bound set by the
    reference package. (The plain twin of K10 once summed ~4,000 rows per
    sample in fp32 and sat 6x further than nle_tpu: 1.7e-3 gray levels.)"""
    _, L, jf, path = jax_factored
    port = FactoredFilter.load(path, "cpu")
    fs_t = transform_eigenvalues(port.eigvals, WEIGHTS)
    fs_j = jtransform(jnp.asarray(jf.eigvals), WEIGHTS)
    ref = _apply_f64(port, L, fs_t.numpy())
    d_jax = np.abs(np.asarray(jf.apply(L, fs_j), np.float64) - ref).max()
    d_port = np.abs(port.apply(L, fs_t).astype(np.float64) - ref).max()
    print(f"apply vs float64: nle_tpu {d_jax:.3e}, port {d_port:.3e}")
    assert d_port <= 2 * d_jax, (d_port, d_jax)


def test_factored_filter_moves_between_devices(jax_factored):
    _, _, _, path = jax_factored
    ff = FactoredFilter.load(path, "cpu")
    assert ff.to("cpu").c.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ff.to("cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            NLEFilter(device="cuda", factored=True)


def test_lab_cache_sees_in_place_changes(monkeypatch):
    """The factored train->edit flow converts the image once; an image
    changed in place is converted again, never served stale."""
    from nle_tpu_torch.models import filter as fmod

    calls = []
    real = fmod.bgr_to_lab_u8_np

    def counting(image):
        calls.append(1)
        return real(image)

    monkeypatch.setattr(fmod, "bgr_to_lab_u8_np", counting)
    img = _frame(48, 64, seed=6)
    f = NLEFilter(device="cpu", factored=True)
    first = f.train_and_enhance(img, *ARGS, weights=WEIGHTS)
    assert len(calls) == 1
    np.testing.assert_array_equal(f.enhance(img, WEIGHTS), first)
    assert len(calls) == 1
    img[:8] = 255 - img[:8]
    changed = f.enhance(img, WEIGHTS)
    assert len(calls) == 2
    assert not np.array_equal(changed, first)
    np.testing.assert_array_equal(
        f._to_lab(img), real(img))


@pytest.mark.cuda
def test_factored_on_the_card_matches_the_cpu():
    """The factored path on the card against the CPU (fp32 summation order
    only), and two card runs bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    img = _frame(64, 96, seed=7)
    g1 = NLEFilter(device="cuda", factored=True).train_and_enhance(
        img, *ARGS, weights=WEIGHTS)
    g2 = NLEFilter(device="cuda", factored=True).train_and_enhance(
        img, *ARGS, weights=WEIGHTS)
    cpu = NLEFilter(device="cpu", factored=True).train_and_enhance(
        img, *ARGS, weights=WEIGHTS)
    np.testing.assert_array_equal(g1, g2)
    assert _psnr(g1, cpu) >= 45.0
