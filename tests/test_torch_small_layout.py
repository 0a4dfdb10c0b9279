"""The small stage-2a layout of the port (stage2_dense_small,
train_filter_stage2a(small=True), _stage2b_dense_body(scaled=True))
against nle_tpu's, run as tests/test_bucketing.py runs it (use_pallas=True,
interpret=True, small=True), on a structured 64x80 frame: stage 2a, stage
2b, the carrier guard's f32 retrain, train_filter end to end in both
layouts, the predicate on a grid of shapes, and stream mode against single
mode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.ops import pipeline as jpipe
from nle_tpu.ops.affinity import bandwidth_weights as j_bandwidth_weights
from nle_tpu.ops.pallas.sinkhorn_kernel import padded_shape as j_padded_shape
from nle_tpu_torch.models import batch as tbatch
from nle_tpu_torch.ops import pipeline as tpipe
from nle_tpu_torch.ops.affinity import bandwidth_weights, features
from nle_tpu_torch.ops.kernels.affinity_kernel import affinity_matmul_plain
from nle_tpu_torch.ops.kernels.sinkhorn_kernel import padded_shape
from nle_tpu_torch.ops.sampling import sample_grid

ITERS = 10
K = 6
EPS = 1e-10
SHAPE = (64, 80)
SAMPLES = (8, 8)
HX, HY = 100.0, 30.0


def _channel(seed=1, shape=SHAPE):
    rng = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w]
    L = np.clip(120 + 60 * np.sin(xx / 9.0) + 40 * np.cos(yy / 6.0)
                + rng.normal(0, 6, (h, w)), 0, 255)
    return np.rint(L).astype(np.float32)


def _problem(L, samples=SAMPLES, hx=HX, k=K):
    h, w = L.shape
    grid = sample_grid(h, w, *samples)
    p = grid.n_samples
    Um64, lam64, _ = tpipe.ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, hx, HY, EPS)
    m = lam64.shape[0]
    return dict(L=L, grid=grid, samples=samples, hx=hx, k=k, p=p, m=m,
                mb=tpipe.bucket_m(m, p), Um64=Um64, lam64=lam64,
                n=grid.n_pixels,
                y=L.reshape(-1)[grid.perm].astype(np.float32),
                rr=(grid.perm // w).astype(np.float32),
                cc=(grid.perm % w).astype(np.float32))


@pytest.fixture(scope="module")
def prob():
    return _problem(_channel())


def _jax_2a(d, **kw):
    sw, pw = j_bandwidth_weights(d["hx"], HY)
    s1 = jnp.asarray(jpipe.pack_stage1(d["Um64"], d["lam64"], np.float32,
                                       mb=d["mb"]))
    return jpipe.train_filter_stage2a(
        jnp.asarray(d["y"]), jnp.asarray(d["rr"]), jnp.asarray(d["cc"]), s1,
        sw, pw, p=d["p"], mb=d["mb"], n_sinkhorn_iter=ITERS, eps=EPS,
        use_pallas=True, interpret=True, **kw)


def _port_2a(d, **kw):
    sw, pw = bandwidth_weights(d["hx"], HY)
    s1 = torch.from_numpy(tpipe.pack_stage1(d["Um64"], d["lam64"],
                                            mb=d["mb"]))
    return tpipe.train_filter_stage2a(
        torch.from_numpy(d["y"]), torch.from_numpy(d["rr"]),
        torch.from_numpy(d["cc"]), s1, sw, pw, p=d["p"], m=d["m"],
        mb=d["mb"], n_sinkhorn_iter=ITERS, eps=EPS, **kw)


def _np(x):
    return np.asarray(x.double().numpy() if isinstance(x, torch.Tensor)
                      else x, np.float64)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


@pytest.fixture()
def clean_env(monkeypatch):
    for name in ("NLE_SINKHORN_INT16", "NLE_INT16_GUARD", "NLE_STAGE2_SPLIT",
                 "NLE_SINKHORN_KERNEL", "NLE_SINKHORN_BF16", "NLE_CPHI_BYTES"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_frame_takes_the_small_layout(prob):
    """The frame's padded phi is far under NLE_CPHI_BYTES: both packages'
    predicates send it to the small layout."""
    assert tpipe.stage2_dense_small(prob["n"], prob["mb"])
    assert jpipe.stage2_dense_small(prob["n"], prob["mb"])
    assert tpipe.stage2b_factor_scaled(prob["n"], prob["mb"])
    assert tpipe.stage2b_factor_scaled(prob["n"], prob["mb"], torch.float64)


def _phi_contract(d, shape):
    """(2p + 4) u (|K| |Uinv|) on the rest rows of the padded factor, zero
    elsewhere: K1's contract (tests/test_torch_kernels.py), two fp32 p-term
    contractions of phi_b in different orders. (The top rows are Um in
    both packages.)"""
    sw, pw = bandwidth_weights(d["hx"], HY)
    s1 = torch.from_numpy(tpipe.pack_stage1(d["Um64"], d["lam64"],
                                            mb=d["mb"]))
    p, n, mb = d["p"], d["n"], d["mb"]
    uinv = tpipe._unpack_stage1(s1, p)[2]
    f = features(torch.from_numpy(d["rr"]), torch.from_numpy(d["cc"]),
                 torch.from_numpy(d["y"]))
    out = np.zeros(shape)
    out[p:n, :mb] = (2 * p + 4) * 2.0 ** -24 * _np(
        affinity_matmul_plain(f[:p], f[p:], uinv.abs(), sw, pw))
    return out


# Tolerances (max-abs error relative to max |JAX|), as
# tests/test_torch_stage2a.py's: 2e-5 on the f32 Sinkhorn (the same f32
# algebra in another summation order); 1e-4 on the int16 carrier, where
# the TPU's half-step drops the lo*lo term of its bf16 split (~2^-17 per
# product) and the port takes exact fp32 products. cphi = c_rest * phi
# adds phi_b's own rounding, entry by entry: |c| times K1's contract. (On
# its own the relative error would read 3.2e-4 here, all of it in the
# column of the smallest eigenvalue, 1.4e-5, where K(rest) Uinv cancels.)
@pytest.mark.parametrize("carrier,kw,rtol", [
    ("int16", {}, 1e-4),
    ("f32 retrain", dict(int16=False), 2e-5),
])
def test_stage2a_small_matches_jax(clean_env, prob, carrier, kw, rtol):
    rc_t, sb_t, cphi_t, c_t = _port_2a(prob, small=True, **kw)
    rc_j, sb_j, cphi_j, c_j = _jax_2a(prob, small=True, **kw)
    assert not isinstance(cphi_t, tuple) and not isinstance(cphi_j, tuple)
    assert rc_t.shape == rc_j.shape == (3, prob["mb"])
    assert cphi_t.shape == cphi_j.shape
    assert sb_t.shape == sb_j.shape == (prob["mb"], prob["mb"])
    for name, a, b in (("rc", rc_t[:2], rc_j[:2]), ("Sb", sb_t, sb_j),
                       ("c_rest", c_t, c_j)):
        assert _rel(a, b) < rtol, (name, _rel(a, b))
    cphi_j = _np(cphi_j)
    bound = (np.abs(_np(c_j)) * _phi_contract(prob, cphi_j.shape)
             + rtol * np.abs(cphi_j).max())
    assert np.all(np.abs(_np(cphi_t) - cphi_j) <= bound)
    # The factor is pre-scaled: rows below m are exact zeros.
    assert not bool(cphi_t[:prob["m"]].any())
    if kw:
        assert float(rc_t[2, 0]) == float(rc_j[2, 0]) == -1.0
    else:
        assert abs(float(rc_t[2, 0]) - float(rc_j[2, 0])) < 1e-3
        assert 0.0 <= float(rc_t[2, 0]) < 0.2
    assert not tpipe.check_carrier_guard(_np(rc_t))


def test_small_factor_is_the_assembled_factor_scaled(clean_env, prob):
    """The small layout scales the assembled factor in place: its cphi is
    c_rest * phi of the assembled layout's own run bit for bit (the same
    trajectory, the same rc), and its Sb is that factor's gram."""
    rc_s, sb_s, cphi, c_s = _port_2a(prob, small=True)
    rc_a, _, phi, c_a = _port_2a(prob, small=False, split=False)
    assert torch.equal(rc_s, rc_a) and torch.equal(c_s, c_a)
    assert torch.equal(cphi, c_a * phi)
    assert torch.equal(sb_s, (cphi.T @ cphi)[:prob["mb"], :prob["mb"]])


def test_limit_is_read_per_call(clean_env, prob, monkeypatch):
    """stage2_dense_small takes the limit as a parameter, else reads
    NLE_CPHI_BYTES when called (nle_tpu's name, default and parse)."""
    npad, mpad = padded_shape(prob["n"], prob["mb"])
    phi = 4 * npad * mpad
    assert tpipe.cphi_bytes_limit() == 64 << 20
    assert tpipe.stage2_dense_small(prob["n"], prob["mb"], phi)
    assert not tpipe.stage2_dense_small(prob["n"], prob["mb"], phi - 1)
    assert not tpipe.stage2b_factor_scaled(prob["n"], prob["mb"],
                                           torch.float32, phi - 1)
    monkeypatch.setenv("NLE_CPHI_BYTES", str(phi - 1))
    assert tpipe.cphi_bytes_limit() == phi - 1
    assert not tpipe.stage2_dense_small(prob["n"], prob["mb"])
    assert tpipe.stage2_dense_small(prob["n"], prob["mb"], phi)
    monkeypatch.setenv("NLE_CPHI_BYTES", str(phi))
    assert tpipe.stage2_dense_small(prob["n"], prob["mb"])


def _submit(d):
    sw, pw = bandwidth_weights(d["hx"], HY)
    s1 = torch.from_numpy(tpipe.pack_stage1(d["Um64"], d["lam64"],
                                            mb=d["mb"]))
    return tpipe.submit_dense(
        torch.from_numpy(d["y"]), torch.from_numpy(d["rr"]),
        torch.from_numpy(d["cc"]), s1, sw, pw, d["Um64"], d["lam64"],
        p=d["p"], m=d["m"], mb=d["mb"], n_sinkhorn_iter=ITERS, eps=EPS)


@pytest.mark.parametrize("limit", [None, "0"], ids=["small", "split"])
def test_one_reading_gives_both_gates(clean_env, prob, monkeypatch, limit):
    """submit_dense reads NLE_CPHI_BYTES once: the frame's layout and
    stage 2b's `scaled` agree, and a change of the variable between submit
    and finish moves neither (V bit for bit as without it)."""
    if limit is not None:
        monkeypatch.setenv("NLE_CPHI_BYTES", limit)
    want = tpipe.finish_dense(_submit(prob), K)
    frame = _submit(prob)
    assert frame.small is frame.scaled is (limit is None)
    assert isinstance(frame.factor, tuple) is (limit is not None)
    monkeypatch.setenv("NLE_CPHI_BYTES",
                       "0" if limit is None else str(1 << 40))
    got = tpipe.finish_dense(frame, K)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_small_resolves_from_the_predicate(clean_env, prob, monkeypatch):
    """small=None takes the small layout here (no split even when asked),
    and the split layout once NLE_CPHI_BYTES is 0."""
    rc_a, sb_a, f_a, _ = _port_2a(prob, split=True)
    rc_b, sb_b, f_b, _ = _port_2a(prob, small=True)
    assert not isinstance(f_a, tuple)
    assert torch.equal(f_a, f_b) and torch.equal(sb_a, sb_b)
    monkeypatch.setenv("NLE_CPHI_BYTES", "0")
    assert not tpipe.stage2_dense_small(prob["n"], prob["mb"])
    assert isinstance(_port_2a(prob, split=True)[2], tuple)


def _host(d, rc, sb, split=False):
    rc_np = _np(rc)
    k = min(d["k"], d["m"])
    va_np, Sq = tpipe.host_orthogonalize(rc_np, _np(sb), d["Um64"],
                                         d["lam64"], d["m"], d["mb"], k, EPS)
    return tpipe.pack_stage2b_upload(split, va_np, rc_np, d["Um64"], d["m"],
                                     d["p"], k).astype(np.float32), Sq


def test_stage2b_scaled_matches_jax(clean_env, prob):
    """Stage 2b on the small layout's factor: the port's scaled body
    against nle_tpu's train_filter_stage2b(scaled=True) on the same cphi
    and upload (the same fp32 product in another summation order)."""
    rc_j, sb_j, cphi_j, c_j = _jax_2a(prob, small=True)
    va, _ = _host(prob, rc_j, sb_j)
    V_j = jpipe.train_filter_stage2b(cphi_j, c_j, jnp.asarray(va),
                                     n=prob["n"], mb=prob["mb"], scaled=True,
                                     interpret=True)
    V_t = tpipe._stage2b_dense_body(
        torch.from_numpy(np.asarray(cphi_j)), torch.from_numpy(
            np.asarray(c_j)), torch.from_numpy(va), n=prob["n"],
        mb=prob["mb"], scaled=True)
    assert V_t.shape == V_j.shape == (prob["n"], va.shape[1] // 2)
    assert _rel(V_t, V_j) < 2e-6, _rel(V_t, V_j)


def test_scaled_gate_applies_c_once(clean_env, prob):
    """The two gates agree: stage 2b over the small layout's cphi with
    scaled=True equals stage 2b over the assembled layout's unscaled phi
    with scaled=False (K7's plain version applies c), to fp32 rounding;
    the wrong gate on cphi applies c twice and is far off."""
    rc, sb, cphi, c_rest = _port_2a(prob, small=True, int16=False)
    rc2, sb2, phi, c_rest2 = _port_2a(prob, small=False, split=False,
                                      int16=False)
    assert torch.equal(c_rest, c_rest2)
    va = torch.from_numpy(_host(prob, rc, sb)[0])
    kw = dict(n=prob["n"], mb=prob["mb"])
    V_s = tpipe._stage2b_dense_body(cphi, c_rest, va, scaled=True, **kw)
    V_u = tpipe._stage2b_dense_body(phi, c_rest2, va, scaled=False, **kw)
    assert _rel(V_s, V_u) < 1e-5, _rel(V_s, V_u)
    V_twice = tpipe._stage2b_dense_body(cphi, c_rest, va, scaled=False, **kw)
    assert _rel(V_twice, V_u) > 1e-2


def _jax_train(d, small, **kw):
    """nle_tpu's dense train_filter sequence with its Pallas kernels
    interpreted (tests/test_bucketing.py's run()): (V packed, S)."""
    rc, sb, factor, c_rest = _jax_2a(d, small=small, **kw)
    split = isinstance(factor, tuple)
    va, Sq = _host(d, rc, sb, split)
    V = jpipe.train_filter_stage2b(factor, c_rest, jnp.asarray(va),
                                   n=d["n"], mb=d["mb"], scaled=small,
                                   interpret=True)
    return np.asarray(V, np.float64), Sq, split


def _port_train(d, seen):
    """The port's train_filter (V packed, S); `seen` gets (small, int16,
    split, crush statistic) of each stage-2a call."""
    real = tpipe.train_filter_stage2a

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((kw["small"], kw.get("int16"), isinstance(out[2], tuple),
                     float(out[0][2, 0])))
        return out

    tpipe.train_filter_stage2a = spy
    try:
        V, S = tpipe.train_filter(d["L"], *d["samples"], d["hx"], HY, ITERS,
                                  d["k"], device="cpu", grid=d["grid"],
                                  pixel_order=False)
    finally:
        tpipe.train_filter_stage2a = real
    return _np(V), _np(S)


# V and S relative to max |JAX| on the int16 carrier (1e-4 per stage-2a
# output, above), in both layouts. V = cphi GrT also carries phi_b's own
# rounding (K1's contract, above), largest in the smallest eigenvalue's
# column: measured S 7.5e-6 and V 1.6e-4 on the small layout, S 1.3e-5
# and V 3.4e-5 on the split one (whose top rows are the host's f64).
@pytest.mark.parametrize("limit,small", [(None, True), (0, False)],
                         ids=["default", "NLE_CPHI_BYTES=0"])
def test_train_filter_matches_jax(clean_env, prob, monkeypatch, limit,
                                  small):
    if limit is not None:
        # nle_tpu reads NLE_CPHI_BYTES once, at import; the port per call.
        monkeypatch.setattr(jpipe, "_CPHI_BYTES_LIMIT", limit)
        monkeypatch.setenv("NLE_CPHI_BYTES", str(limit))
    assert jpipe.stage2_dense_small(prob["n"], prob["mb"]) is small
    seen = []
    V_t, S_t = _port_train(prob, seen)
    V_j, S_j, split_j = _jax_train(prob, small)
    assert [s[::2] for s in seen[:1]] == [(small, not small)]
    assert len(seen) == 1 and split_j is not small
    assert V_t.shape == V_j.shape
    assert _rel(S_t, S_j) < 1e-4, _rel(S_t, S_j)
    assert _rel(V_t, V_j) < 1e-3, _rel(V_t, V_j)


def test_guard_retrains_on_the_small_layout(clean_env):
    """The documented carrier failure domain (uniform noise at small hx,
    tests/test_carrier_guard.py's repro) trips the guard on the small
    layout too; the retrain is the small layout's f32 Sinkhorn, and V
    tracks nle_tpu's f32 small-layout train."""
    rng = np.random.default_rng(0)
    L = rng.uniform(0, 255, size=(120, 120)).astype(np.float32)
    d = _problem(L, samples=(10, 10), hx=5.0, k=4)
    assert tpipe.stage2_dense_small(d["n"], d["mb"])
    seen = []
    V_t, S_t = _port_train(d, seen)
    assert [s[:3] for s in seen] == [(True, None, False),
                                     (True, False, False)], seen
    assert seen[0][3] > 0.2 and seen[1][3] == -1.0
    V_j, S_j, _ = _jax_train(d, True, int16=False)
    # S at stage 2a's f32 tolerance; V also carries phi_b's rounding
    # (measured 5.5e-5).
    assert _rel(S_t, S_j) < 2e-5, _rel(S_t, S_j)
    assert _rel(V_t, V_j) < 2e-4, _rel(V_t, V_j)


def _dense_small_grid():
    """(n, mb) on both sides of the boundary 4 npad mpad = 64 MiB for
    every mpad from 128 to 1280 (npad rounds n up to 2048 rows)."""
    cases = []
    for mb in (1, 100, 128, 129, 256, 300, 512, 640, 700, 1024, 1200, 1280):
        mpad = -(-mb // 128) * 128
        rows = (64 << 20) // (4 * mpad) // 2048 * 2048
        cases += [(rows, mb), (rows + 1, mb), (rows - 2047, mb),
                  (rows + 2048, mb), (5000, mb), (1 << 22, mb)]
    return cases


@pytest.mark.parametrize("n,mb", _dense_small_grid())
def test_stage2_dense_small_matches_jax(n, mb):
    assert padded_shape(n, mb) == j_padded_shape(n, mb)
    assert tpipe.stage2_dense_small(n, mb) == jpipe.stage2_dense_small(n, mb)


def test_stage2_dense_small_boundary():
    """At mpad 128 the limit is 131072 padded rows: a 362x362 frame is the
    largest square under it."""
    assert tpipe.stage2_dense_small(362 * 362, 100)
    assert not tpipe.stage2_dense_small(363 * 363, 100)
    assert tpipe.stage2_dense_small(131072, 128)
    assert not tpipe.stage2_dense_small(131073, 128)


@pytest.mark.parametrize("lookahead", [1, 2])
def test_stream_mode_bitwise_single_mode(clean_env, lookahead):
    """Stream mode (submit_dense / finish_dense through
    train_filters_iter) gives single mode's filter bit for bit on the
    small layout."""
    chans = [_channel(seed) for seed in (3, 4, 5)]
    args = (*SAMPLES, HX, HY, ITERS, K)
    flts = list(tbatch.train_filters_iter(chans, *args, device="cpu",
                                          lookahead=lookahead))
    for chan, flt in zip(chans, flts):
        assert tpipe.stage2_dense_small(flt.n_pixels, 64)
        V, S = tpipe.train_filter(chan, *args, device="cpu",
                                  pixel_order=False)
        assert torch.equal(flt.eigvecs, V) and torch.equal(flt.eigvals, S)
