"""The port's whole 1 MP enhance slice, at a small size, against nle_tpu:
NLEFilter(device="cpu").train_and_enhance versus a JAX reference composed
from train_filter's own sequence (Pallas kernels in interpret mode, the
split layout); saved filters crossing between the packages; the import and
device rules of the port."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np
from nle_tpu.models.filter import NLEFilter as JaxNLEFilter
from nle_tpu.models.filter import load_filter
from nle_tpu.ops import pipeline as jpipe
from nle_tpu.ops.affinity import bandwidth_weights
from nle_tpu.ops.sampling import sample_grid
from nle_tpu.ops.transform import transform_eigenvalues
from nle_tpu_torch import NLEFilter, TrainedFilter
from nle_tpu_torch.config import resolve_device

WEIGHTS = [4, 3, 4, 1]


def _frame(h, w, seed=1):
    """Structured synthetic BGR frame (as tests/test_carrier_guard.py
    builds its real-image-like channel)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(xx / 11.0) + 40 * np.cos(yy / 7.0)
    img = np.stack([base + rng.normal(0, 6, (h, w)) + 10 * c
                    for c in range(3)], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _jax_reference(img, n_rows, n_cols, hx, hy, iters, k_req, weights):
    """nle_tpu's train_filter sequence (ops/pipeline.py:1243-1422) with the
    Pallas kernels interpreted: train_filter itself cannot run here, since
    use_pallas=True without interpret fails on the CPU."""
    lab = bgr_to_lab_u8_np(img)
    L = lab[..., 0].astype(np.float32)
    h, w = L.shape
    grid = sample_grid(h, w, n_rows, n_cols)
    p = grid.n_samples
    Um64, lam64, _ = jpipe.ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, hx, hy, 1e-10)
    m = lam64.shape[0]
    mb = jpipe.bucket_m(m, p)
    s1 = jnp.asarray(jpipe.pack_stage1(Um64, lam64, np.float32, mb=mb))
    y = jnp.asarray(L.reshape(-1)[grid.perm])
    rr = jnp.asarray((grid.perm // w).astype(np.float32))
    cc = jnp.asarray((grid.perm % w).astype(np.float32))
    sw, pw = bandwidth_weights(hx, hy)
    rc, sb, factor, c_rest = jpipe.train_filter_stage2a(
        y, rr, cc, s1, sw, pw, p=p, mb=mb, n_sinkhorn_iter=iters, eps=1e-10,
        use_pallas=True, interpret=True, small=False, split=True)
    assert isinstance(factor, tuple)
    rc_np = np.asarray(rc, np.float64)
    k = min(k_req, m)
    va_np, Sq = jpipe.host_orthogonalize(rc_np, np.asarray(sb, np.float64),
                                         Um64, lam64, m, mb, k, 1e-10)
    va_grt = jnp.asarray(
        jpipe.pack_stage2b_upload(True, va_np, rc_np, Um64, m, p, k),
        jnp.float32)
    fs = transform_eigenvalues(jnp.asarray(Sq, jnp.float32), weights)
    _, edit = jpipe.train_filter_stage2b_edit(
        factor, c_rest, va_grt, y, fs, n=grid.n_pixels, mb=mb, scaled=False,
        interpret=True)
    edit = np.asarray(edit)
    unpacked = np.empty_like(edit)
    unpacked[grid.perm] = edit
    out = lab.copy()
    out[..., 0] = unpacked.reshape(h, w)
    return lab_to_bgr_u8_np(out)


@pytest.mark.parametrize("shape,args", [
    ((96, 128), (8, 8, 100.0, 30.0, 10, 8)),
    ((112, 120), (10, 10, 60.0, 20.0, 5, 10)),
])
def test_train_and_enhance_matches_jax(shape, args):
    img = _frame(*shape)
    got = NLEFilter(device="cpu").train_and_enhance(img, *args,
                                                    weights=WEIGHTS)
    want = _jax_reference(img, *args, WEIGHTS)
    assert got.shape == img.shape and got.dtype == np.uint8
    db = _psnr(got, want)
    print(f"port vs nle_tpu, {shape} {args}: {db:.2f} dB")
    assert db >= 45.0, db


@pytest.fixture(scope="module")
def frame_and_jax_filter(tmp_path_factory):
    img = _frame(80, 96, seed=3)
    jf = JaxNLEFilter()
    jf.train_for_enhancement(img, 8, 8, 100.0, 30.0, 8, 6)
    path = str(tmp_path_factory.mktemp("filters") / "jax_filter.npz")
    jf.trained.save(path)
    return img, jf, path


def _edits_agree(trained_np, img, out_jax, out_port):
    """The two packages apply V diag(f(S)) V^T y in fp32 in different
    summation orders, so a filtered L value at a rounding tie may land one
    LSB apart: allow that on at most 0.1% of the pixels, nothing more. One
    L LSB can move a BGR channel by up to 3 through Lab -> BGR, so the
    images are held to >= 60 dB."""
    from nle_tpu.ops.pipeline import apply_filter_u8 as j_apply
    from nle_tpu_torch.ops.pipeline import apply_filter_u8 as t_apply
    from nle_tpu_torch.ops.transform import (
        transform_eigenvalues as t_transform,
    )

    V, S, perm = (trained_np[k] for k in ("eigvecs", "eigvals", "perm"))
    y = bgr_to_lab_u8_np(img)[..., 0].reshape(-1)[perm]
    lj = np.asarray(j_apply(jnp.asarray(V), transform_eigenvalues(
        jnp.asarray(S), WEIGHTS), jnp.asarray(y)))
    lt = t_apply(torch.from_numpy(V), t_transform(torch.from_numpy(S),
                                                  WEIGHTS),
                 torch.from_numpy(y)).numpy()
    d = np.abs(lj.astype(np.int32) - lt.astype(np.int32))
    assert d.max() <= 1, d.max()
    assert np.count_nonzero(d) <= 1e-3 * d.size, np.count_nonzero(d)
    assert _psnr(out_jax, out_port) >= 60.0


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def test_filter_saved_by_nle_tpu_edits_in_the_port(frame_and_jax_filter):
    img, jf, path = frame_and_jax_filter
    port = NLEFilter(TrainedFilter.load(path, "cpu"), device="cpu")
    _edits_agree(_arrays(path), img, jf.enhance(img, WEIGHTS),
                 port.enhance(img, WEIGHTS))


def test_filter_saved_by_the_port_edits_in_nle_tpu(frame_and_jax_filter,
                                                   tmp_path):
    img = frame_and_jax_filter[0]
    port = NLEFilter(device="cpu")
    port.train_for_enhancement(img, 8, 8, 100.0, 30.0, 8, 6)
    path = str(tmp_path / "port_filter")
    port.trained.save(path)
    jf = JaxNLEFilter(load_filter(path + ".npz"))
    _edits_agree(_arrays(path + ".npz"), img, jf.enhance(img, WEIGHTS),
                 port.enhance(img, WEIGHTS))
    again = TrainedFilter.load(path, "cpu")
    np.testing.assert_array_equal(again.eigvecs.numpy(),
                                  port.trained.eigvecs.numpy())
    np.testing.assert_array_equal(again.perm, port.trained.perm)


def test_a_given_filter_moves_to_the_nle_filters_device(frame_and_jax_filter):
    """TrainedFilter.load names its device (no default), and NLEFilter puts
    a given filter on its own device: "cuda" without a card raises."""
    path = frame_and_jax_filter[2]
    with pytest.raises(TypeError):
        TrainedFilter.load(path)
    trained = TrainedFilter.load(path, "cpu")
    assert NLEFilter(trained, device="cpu").trained.eigvecs.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            NLEFilter(trained, device="cuda")


@pytest.mark.cuda
def test_a_cpu_filter_edits_on_the_card(frame_and_jax_filter):
    """A filter loaded on the CPU and given to NLEFilter(device="cuda")
    edits on the card, to the CPU edit up to fp32 summation order (the
    tolerance of _edits_agree)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    img, _, path = frame_and_jax_filter
    card = NLEFilter(TrainedFilter.load(path, "cpu"), device="cuda")
    assert card.trained.eigvecs.device.type == "cuda"
    cpu = NLEFilter(TrainedFilter.load(path, "cpu"), device="cpu")
    assert _psnr(card.enhance(img, WEIGHTS), cpu.enhance(img, WEIGHTS)) >= 60.0


def test_train_and_enhance_equals_train_then_enhance():
    img = _frame(64, 80, seed=4)
    f = NLEFilter(device="cpu")
    fused = f.train_and_enhance(img, 8, 8, 100.0, 30.0, 6, 6,
                                weights=WEIGHTS)
    np.testing.assert_array_equal(fused, f.enhance(img, WEIGHTS))


def test_port_imports_no_jax():
    """Every module of the port (stream mode, the C Lab loader, the bench
    and the tools included), imported in a fresh process, imports no JAX,
    no nle_tpu and no triton."""
    code = ("import importlib, pkgutil, sys, nle_tpu_torch; "
            "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
            "nle_tpu_torch.__path__, 'nle_tpu_torch.')]; "
            "assert 'nle_tpu_torch.models.batch' in sys.modules; "
            "assert 'nle_tpu_torch.tools.bench' in sys.modules; "
            "assert 'nle_tpu_torch.native' in sys.modules; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'nle_tpu', 'triton')))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=root)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr


def test_precision_is_pinned():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cuda_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        NLEFilter(device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        TrainedFilter.from_numpy(
            dict(eigvecs=np.zeros((4, 1), np.float32),
                 eigvals=np.zeros(1, np.float32), shape=np.array([2, 2])),
            device="cuda")


def test_unknown_device_raises():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
