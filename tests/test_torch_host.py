"""The port's host pieces against nle_tpu: the same float64/integer
arithmetic, so every comparison is bit-equal (assert_array_equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.color import lab as jlab
from nle_tpu.ops import orthogonalize as jorth
from nle_tpu.ops import pipeline as jpipe
from nle_tpu.ops import sampling as jsamp
from nle_tpu.ops import transform as jtrans
from nle_tpu_torch.color import lab as tlab
from nle_tpu_torch.ops import orthogonalize as torth
from nle_tpu_torch.ops import pipeline as tpipe
from nle_tpu_torch.ops import sampling as tsamp
from nle_tpu_torch.ops import transform as ttrans


@pytest.mark.parametrize("shape,samples", [
    ((96, 128), (8, 8)), ((101, 77), (7, 9)), ((832, 1216), (20, 30)),
])
def test_sample_grid_bit_equal(shape, samples):
    a = jsamp.sample_grid(*shape, *samples)
    b = tsamp.sample_grid(*shape, *samples)
    for field in ("sel_rows", "sel_cols", "perm"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.nrows, a.ncols) == (b.nrows, b.ncols)


@pytest.mark.parametrize("hx,hy", [(100.0, 30.0), (5.0, 30.0), (500.0, 10.0)])
def test_ka_eigh_host64_bit_equal(hx, hy):
    rng = np.random.default_rng(0)
    h, w = 96, 112
    L = rng.integers(0, 256, (h, w)).astype(np.float64)
    g = tsamp.sample_grid(h, w, 9, 9)
    args = (L[g.sel_rows, g.sel_cols], g.sel_rows, g.sel_cols, hx, hy, 1e-10)
    for x, y in zip(jpipe.ka_eigh_host64(*args), tpipe.ka_eigh_host64(*args)):
        np.testing.assert_array_equal(x, y)


def test_bucket_m_bit_equal(monkeypatch):
    for b in ("128", "64", "1"):
        monkeypatch.setenv("NLE_M_BUCKET", b)
        for m, p in [(1, 30), (30, 30), (1, 600), (129, 600), (517, 600),
                     (37, 600), (600, 600)]:
            assert tpipe.bucket_m(m, p) == jpipe.bucket_m(m, p)


@pytest.mark.parametrize("q_solver", ["evd", "topk", "auto"])
def test_host_chain64_bit_equal(q_solver):
    rng = np.random.default_rng(1)
    m, k = 140, 10
    A = rng.standard_normal((m, m))
    wa = A @ A.T / m + np.eye(m) * 1e-3
    rga = rng.standard_normal((m, m)) * 0.1
    Bs = rng.standard_normal((m, m))
    sb = Bs @ Bs.T
    got = torth.host_chain64(wa, rga, sb, k, 1e-10, q_solver=q_solver)
    want = jorth.host_chain64(wa, rga, sb, k, 1e-10, q_solver=q_solver)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)


def test_lab_conversions_bit_equal():
    rng = np.random.default_rng(2)
    bgr = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tlab.bgr_to_lab_u8_np(bgr),
                                  jlab.bgr_to_lab_u8_np(bgr))
    lab = rng.integers(0, 256, (64, 96, 3)).astype(np.uint8)
    np.testing.assert_array_equal(tlab.lab_to_bgr_u8_np(lab),
                                  jlab.lab_to_bgr_u8_np(lab))


@pytest.mark.parametrize("weights", [[4, 3, 4, 1], [1, 2], [0.5, 1.5, 2.0, 3.0, 1.0]])
def test_transform_eigenvalues_bit_equal(weights):
    rng = np.random.default_rng(3)
    S = np.sort(rng.uniform(0.0, 1.0, 50)).astype(np.float32)[::-1].copy()
    got = ttrans.transform_eigenvalues(torch.from_numpy(S), weights).numpy()
    want = np.asarray(jtrans.transform_eigenvalues(jnp.asarray(S), weights))
    np.testing.assert_array_equal(got, want)


def test_pack_stage2b_upload_and_guard_bit_equal():
    rng = np.random.default_rng(4)
    p, m, mb, k = 40, 30, 32, 6
    va = rng.standard_normal((mb, 2 * k))
    rc = rng.uniform(0.1, 1.0, (3, p))
    Um = rng.standard_normal((p, m))
    for split in (False, True):
        np.testing.assert_array_equal(
            tpipe.pack_stage2b_upload(split, va, rc, Um, m, p, k),
            jpipe.pack_stage2b_upload(split, va, rc, Um, m, p, k))
    for stat in (-1.0, 0.05, 0.5):
        rc[2, 0] = stat
        assert tpipe.check_carrier_guard(rc) == jpipe.check_carrier_guard(rc)
