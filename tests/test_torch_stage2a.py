"""Stage 2a of the port against nle_tpu's train_filter_stage2a (Pallas
kernels in interpret mode, called as tests/test_carrier_guard.py calls it)
in both layouts the port carries, and the int16 carrier guard on the
documented noise repro."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.ops import pipeline as jpipe
from nle_tpu.ops.affinity import bandwidth_weights as j_bandwidth_weights
from nle_tpu_torch.ops import pipeline as tpipe
from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
    resolve_int16,
    resolve_int16_guard,
)
from nle_tpu_torch.ops.sampling import sample_grid

ITERS = 10


def _problem(L, hx, hy, samples):
    h, w = L.shape
    grid = sample_grid(h, w, *samples)
    p = grid.n_samples
    Um64, lam64, _ = tpipe.ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols], grid.sel_rows, grid.sel_cols,
        hx, hy, 1e-10)
    m = lam64.shape[0]
    mb = tpipe.bucket_m(m, p)
    y = L.reshape(-1)[grid.perm].astype(np.float32)
    rr = (grid.perm // w).astype(np.float32)
    cc = (grid.perm % w).astype(np.float32)
    return dict(y=y, rr=rr, cc=cc, Um64=Um64, lam64=lam64, p=p, m=m, mb=mb,
                hx=hx, hy=hy, n=grid.n_pixels)


def _jax(prob, **kw):
    sw, pw = j_bandwidth_weights(prob["hx"], prob["hy"])
    s1 = jnp.asarray(jpipe.pack_stage1(prob["Um64"], prob["lam64"],
                                       np.float32, mb=prob["mb"]))
    rc, sb, _, _ = jpipe.train_filter_stage2a(
        jnp.asarray(prob["y"]), jnp.asarray(prob["rr"]),
        jnp.asarray(prob["cc"]), s1, sw, pw, p=prob["p"], mb=prob["mb"],
        n_sinkhorn_iter=ITERS, eps=1e-10, use_pallas=True, interpret=True,
        small=False, **kw)
    return np.asarray(rc, np.float64), np.asarray(sb, np.float64)


def _port(prob, small=False, **kw):
    from nle_tpu_torch.ops.affinity import bandwidth_weights

    sw, pw = bandwidth_weights(prob["hx"], prob["hy"])
    s1 = torch.from_numpy(tpipe.pack_stage1(prob["Um64"], prob["lam64"],
                                            mb=prob["mb"]))
    rc, sb, factor, c_rest = tpipe.train_filter_stage2a(
        torch.from_numpy(prob["y"]), torch.from_numpy(prob["rr"]),
        torch.from_numpy(prob["cc"]), s1, sw, pw, p=prob["p"], m=prob["m"],
        mb=prob["mb"], n_sinkhorn_iter=ITERS, eps=1e-10, small=small, **kw)
    return rc.double().numpy(), sb.double().numpy(), factor


@pytest.fixture(scope="module")
def structured_problem():
    rng = np.random.default_rng(1)
    h, w = 96, 112
    yy, xx = np.mgrid[0:h, 0:w]
    L = np.clip(120 + 60 * np.sin(xx / 11.0) + 40 * np.cos(yy / 7.0)
                + rng.normal(0, 6, (h, w)), 0, 255)
    return _problem(np.rint(L), 100.0, 30.0, (8, 8))


def _rel(a, b):
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


# Tolerances (max-abs error relative to max |JAX|). Split layout: the
# TPU's int16 half-step drops the lo*lo term of its bf16 split (~2^-17 per
# product) where the port takes exact fp32 products, so the trajectories
# part by a few 1e-6 over 2 x 10 half-steps (measured 3.7e-6 on rc, 2.1e-6
# on Sb): 1e-4. Assembled f32 layout: the same f32 algebra in another
# summation order (measured <= 3.8e-6): 2e-5.
@pytest.mark.parametrize("layout,kw,rtol", [
    ("split", dict(split=True), 1e-4),
    ("assembled_f32", dict(split=False, int16=False), 2e-5),
])
def test_stage2a_matches_jax(structured_problem, layout, kw, rtol):
    prob = structured_problem
    rc_t, sb_t, factor = _port(prob, **kw)
    rc_j, sb_j = _jax(prob, **kw)
    assert isinstance(factor, tuple) == (layout == "split")
    assert rc_t.shape == rc_j.shape
    assert _rel(rc_t[:2], rc_j[:2]) < rtol, _rel(rc_t[:2], rc_j[:2])
    assert _rel(sb_t, sb_j) < rtol, _rel(sb_t, sb_j)
    if layout == "split":
        # The crush statistic: the same quantizer on near-equal factors.
        assert abs(rc_t[2, 0] - rc_j[2, 0]) < 1e-3
        assert 0.0 <= rc_t[2, 0] < 0.2
    else:
        assert rc_t[2, 0] == rc_j[2, 0] == -1.0
    assert not tpipe.check_carrier_guard(rc_t)


def test_noise_repro_trips_the_ports_guard(monkeypatch):
    """The documented carrier failure domain (uniform noise at small hx,
    tests/test_carrier_guard.py) trips the port's guard too, and the f32
    fallback layout tracks the JAX package's f32 trajectory."""
    monkeypatch.delenv("NLE_INT16_GUARD", raising=False)
    monkeypatch.delenv("NLE_SINKHORN_INT16", raising=False)
    rng = np.random.default_rng(0)
    L = rng.uniform(0, 255, size=(120, 120)).astype(np.float64)
    prob = _problem(L, 5.0, 30.0, (10, 10))
    rc_q, _, factor = _port(prob, split=True)
    assert isinstance(factor, tuple)
    assert rc_q[2, 0] > 0.2, rc_q[2, 0]
    assert tpipe.check_carrier_guard(rc_q)
    rc_f, sb_f, _ = _port(prob, split=False, int16=False)
    assert rc_f[2, 0] == -1.0 and not tpipe.check_carrier_guard(rc_f)
    rc_j, sb_j = _jax(prob, split=False, int16=False)
    assert _rel(rc_f[:2], rc_j[:2]) < 2e-5
    assert _rel(sb_f, sb_j) < 2e-5
    assert np.isfinite(rc_f[:2]).all() and (rc_f[:2] >= 0).all()


def test_unported_layouts_raise(structured_problem):
    """The small layout, which raised here before it was ported, runs: the
    pre-scaled factor (rows below m exact zeros) with the (3, mb) rc and
    the gram of the assembled int16 layout's trajectory. It is held to
    nle_tpu in tests/test_torch_small_layout.py, as the assembled int16
    layout is in tests/test_torch_sinkhorn_modes.py."""
    prob = structured_problem
    rc_s, sb_s, cphi = _port(prob, small=True)
    rc_a, sb_a, phi = _port(prob, split=False)
    assert not isinstance(cphi, tuple) and cphi.shape == phi.shape
    assert not bool(cphi[:prob["m"]].any())
    np.testing.assert_array_equal(rc_s, rc_a)
    assert _rel(sb_s, sb_a) < 2e-5, _rel(sb_s, sb_a)


@pytest.fixture()
def clean_carrier_env(monkeypatch):
    monkeypatch.delenv("NLE_SINKHORN_INT16", raising=False)
    monkeypatch.delenv("NLE_INT16_GUARD", raising=False)
    return monkeypatch


@pytest.mark.parametrize("env,int16,guard", [
    ({}, True, 0.2),
    ({"NLE_SINKHORN_INT16": "off"}, False, 0.2),
    ({"NLE_INT16_GUARD": "off"}, True, None),
])
def test_carrier_knobs(clean_carrier_env, env, int16, guard):
    """The carrier streams unless NLE_SINKHORN_INT16=off; the guard trips
    above 0.2 unless NLE_INT16_GUARD=off."""
    for name, value in env.items():
        clean_carrier_env.setenv(name, value)
    assert resolve_int16() is int16
    assert resolve_int16_guard() == guard
    rc = np.full((3, 4), -1.0)
    rc[2, 0] = 0.5                   # a crush statistic over the threshold
    assert tpipe.check_carrier_guard(rc) is (guard is not None)
    rc[2, 0] = 0.1
    assert not tpipe.check_carrier_guard(rc)


@pytest.mark.parametrize("name,value,resolve,want", [
    ("NLE_SINKHORN_INT16", "on", resolve_int16, True),
    ("NLE_INT16_GUARD", "0.35", resolve_int16_guard, 0.35),
    ("NLE_SINKHORN_INT16", "quick", resolve_int16, ValueError),
    ("NLE_INT16_GUARD", "1.5", resolve_int16_guard, ValueError),
])
def test_unported_carrier_knob_values_raise(clean_carrier_env, name, value,
                                            resolve, want):
    """The JAX package's forced-on carrier and float guard threshold,
    which raised here until they were ported, now resolve as nle_tpu's;
    values nle_tpu refuses still raise instead of running something
    else (every value against nle_tpu: test_torch_sinkhorn_modes.py)."""
    clean_carrier_env.setenv(name, value)
    if want is ValueError:
        with pytest.raises(ValueError, match=name):
            resolve()
    else:
        assert resolve() == want


@pytest.mark.parametrize("value,frame,layouts", [
    ("auto", "smooth", [True]),
    ("off", "smooth", [False]),
    ("auto", "noise", [True, False]),
])
def test_train_filter_layout_follows_carrier_and_guard(clean_carrier_env,
                                                        value, frame,
                                                        layouts):
    """train_filter runs the split layout by default, the assembled f32
    layout under NLE_SINKHORN_INT16=off, and both in turn when the guard
    trips (uniform noise at small hx)."""
    seen = []
    real = tpipe.train_filter_stage2a

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(isinstance(out[2], tuple))
        return out

    clean_carrier_env.setattr(tpipe, "train_filter_stage2a", spy)
    # These frames stand for the large ones: past NLE_CPHI_BYTES, so the
    # small layout does not take them.
    clean_carrier_env.setenv("NLE_CPHI_BYTES", "0")
    clean_carrier_env.setenv("NLE_SINKHORN_INT16", value)
    rng = np.random.default_rng(2)
    if frame == "noise":
        L, hx = rng.uniform(0, 255, size=(120, 120)), 5.0
    else:
        yy, xx = np.mgrid[0:72, 0:80]
        L, hx = 120 + 60 * np.sin(xx / 11.0) + rng.normal(0, 4, (72, 80)), 100.0
    L = np.rint(np.clip(L, 0, 255)).astype(np.float32)
    V, S = tpipe.train_filter(L, 10, 10, hx, 30.0, 3, 4, device="cpu")
    assert seen == layouts
    assert V.shape == (L.size, 4) and bool(torch.isfinite(V).all())
    assert bool(torch.isfinite(S).all())
