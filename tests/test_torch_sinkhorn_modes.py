"""The Sinkhorn modes of the port against nle_tpu, on numpy-made inputs:
every knob resolver value by value, K13's and K14's plain twins against
the interpreted Pallas kernels they replace, the assembled Sinkhorn loop
under each mode, and stage 2a and the whole edit under each mode.

The JAX package reads NLE_SINKHORN_KERNEL / NLE_SINKHORN_BF16 /
NLE_SINKHORN_INT16 while it traces, and its jit keys do not hold the
environment: every test that sets a knob and then calls a jitted JAX
function clears JAX's caches first (the `env` fixture), or it would compare against
a stale trace. On the CPU the port's wrappers take their plain versions;
the CUDA kernels are held against those by chip_smoke.py phase [10] and
the `cuda`-marked test at the end."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from nle_tpu.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np
from nle_tpu.ops import pipeline as jpipe
from nle_tpu.ops.affinity import bandwidth_weights as jbandwidth_weights
from nle_tpu.ops.pallas import sinkhorn_kernel as jsk
from nle_tpu.ops.sampling import sample_grid
from nle_tpu.ops.transform import transform_eigenvalues as jtransform
from nle_tpu.utils.logging import logger as jlogger
from nle_tpu_torch import NLEFilter
from nle_tpu_torch.ops import pipeline as tpipe
from nle_tpu_torch.ops.affinity import bandwidth_weights
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import sinkhorn_kernel as tsk
from nle_tpu_torch.utils.logging import logger as tlogger

EPS = 1e-10
KNOBS = ("NLE_SINKHORN_KERNEL", "NLE_SINKHORN_BF16", "NLE_SINKHORN_INT16",
         "NLE_INT16_GUARD", "NLE_STAGE2_SPLIT")
WEIGHTS = [4, 3, 4, 1]


@pytest.fixture()
def env(monkeypatch):
    """Every Sinkhorn knob unset; set(**knobs) sets some and clears JAX's
    caches (its traces read the knobs)."""
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)

    def set_knobs(**knobs):
        for name, value in knobs.items():
            if value is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, value)
        jax.clear_caches()

    yield set_knobs
    jax.clear_caches()


def _same(jfn, tfn):
    """Both calls return the same value, or both raise ValueError."""
    try:
        want = jfn()
    except ValueError:
        with pytest.raises(ValueError):
            tfn()
        return None
    got = tfn()
    assert got == want and type(got) is type(want), (got, want)
    return got


# -- the knob resolvers, value by value --------------------------------------

@pytest.mark.parametrize("value", [None, "off", "0", "false", "OFF", "all",
                                   "3", "0012", "-4", "99", "auto", "on", "1",
                                   "true", "fast", "2.5"])
def test_resolve_bf16_iters_matches_jax(env, value):
    env(NLE_SINKHORN_BF16=value)
    for max_iter, arg in ((10, None), (10, 5), (10, 99), (10, -3), (4, None),
                          (3, None), (50, None), (50, 0)):
        _same(lambda: jsk._resolve_bf16_iters(max_iter, arg),
              lambda: tsk.resolve_bf16_iters(max_iter, arg))


@pytest.mark.parametrize("value", [None, "auto", "on", "1", "true", "On",
                                   "off", "0", "false", "quick", ""])
def test_resolve_int16_matches_jax(env, value):
    env(NLE_SINKHORN_INT16=value)
    for n_bf16 in (0, 3):
        _same(lambda: jsk._resolve_int16(n_bf16),
              lambda: tsk.resolve_int16(n_bf16))


@pytest.mark.parametrize("value", [None, "auto", "on", "ON", "1", "true",
                                   "off", "0", "yes"])
def test_int16_forced_on_matches_jax(env, value):
    env(NLE_SINKHORN_INT16=value)
    _same(jsk.int16_forced_on, tsk.int16_forced_on)


@pytest.mark.parametrize("value", [None, "off", "OFF", "false", "none",
                                   "0.2", "0.35", "1", "1.0", "1e-3", "0",
                                   "-0.1", "1.5", "nan", "abc", ""])
def test_resolve_int16_guard_matches_jax(env, value):
    env(NLE_INT16_GUARD=value)
    _same(jsk.resolve_int16_guard, tsk.resolve_int16_guard)


@pytest.mark.parametrize("int16,guard,crush", [
    (None, None, 0.5), (None, None, 0.2), (None, None, 0.1),
    ("on", None, 0.5), ("true", None, 0.9), ("auto", None, 0.5),
    ("off", None, 0.5), (None, "off", 0.9), (None, "0.6", 0.5),
    (None, "0.6", 0.7), ("on", "0.05", 0.1), (None, "2", 0.5),
])
def test_carrier_guard_decision_matches_jax(env, int16, guard, crush):
    """Over the threshold the guard retrains (True), unless the carrier is
    forced on (warn, keep it: False) or the guard is off."""
    env(NLE_SINKHORN_INT16=int16, NLE_INT16_GUARD=guard)
    _same(lambda: jsk.carrier_guard_decision(crush, jlogger, "crush", "x"),
          lambda: tsk.carrier_guard_decision(crush, tlogger, "crush", "x"))


@pytest.mark.parametrize("split,kernel,int16,bf16", [
    (None, None, None, None), ("auto", None, None, None),
    ("off", None, None, None), ("0", None, None, None),
    ("on", None, None, None), ("true", None, None, None),
    ("on", None, "off", None), ("on", "auto", None, None),
    ("on", None, None, "auto"), (None, "auto", None, None),
    (None, None, "off", None), (None, None, "on", None),
    (None, None, None, "auto"), (None, None, None, "all"),
    (None, None, None, "1"), (None, "pallas", None, None),
    ("maybe", None, None, None), (None, None, "quick", None),
])
def test_resolve_split_stage2_matches_jax(env, split, kernel, int16, bf16):
    env(NLE_STAGE2_SPLIT=split, NLE_SINKHORN_KERNEL=kernel,
        NLE_SINKHORN_INT16=int16, NLE_SINKHORN_BF16=bf16)
    for max_iter in (10, 3):
        _same(lambda: jsk.resolve_split_stage2(max_iter),
              lambda: tsk.resolve_split_stage2(max_iter))


@pytest.mark.parametrize("value", [None, "manual", "auto", "AUTO", "pallas",
                                   ""])
def test_sinkhorn_kernel_knob_matches_jax(env, value):
    """NLE_SINKHORN_KERNEL: the JAX loop takes manual|auto and raises on
    anything else; the port's loop the same."""
    env(NLE_SINKHORN_KERNEL=value, NLE_SINKHORN_INT16="off")
    phi = np.ones((64, 8), np.float32)
    lam = np.ones((8,), np.float32)
    _same(lambda: jsk.sinkhorn_vectors_fused(
              jnp.asarray(phi), jnp.asarray(lam), 1, EPS,
              interpret=True) is not None,
          lambda: tsk.sinkhorn_vectors_fused(
              torch.from_numpy(phi), torch.from_numpy(lam), 1,
              EPS) is not None)
    if value is not None and value.lower() in ("manual", "auto"):
        assert tsk.resolve_sinkhorn_kernel() == value.lower()


def test_k13_tile_rule():
    """The JAX loop's tile rule: halve from 1024 while two f32 tiles
    pass 12 MiB, not below 256."""
    assert tsk.k13_tile(128) == tsk.k13_tile(640) == 1024
    assert tsk.k13_tile(1536) == 1024
    assert tsk.k13_tile(1664) == 512
    assert tsk.k13_tile(2176) == 512
    assert tsk.k13_tile(4096) == 256 == tsk.k13_tile(16384)


# -- K13 and K14 against the interpreted kernels ------------------------------

def _factor(rng, n, m, npad, mpad):
    phi = np.zeros((npad, mpad), np.float32)
    phi[:n, :m] = rng.random((n, m)) + 0.1
    t = np.zeros(mpad, np.float32)
    t[:m] = rng.random(m) + 0.1
    return phi, t


# (500, 7) at tile 256 is the JAX test's shape (tests/test_pallas_kernels.py
# :275-300); 9000 x 40 at tile 512 is 18 tiles, so the 8 stripes wrap.
@pytest.mark.parametrize("n,m,tile", [(500, 7, 256), (9000, 40, 512)])
def test_k13_plain_twin_matches_interpreted_kernel(n, m, tile):
    """The same f32 algebra in the same stripe order; rtol 1e-6 / atol 1e-7
    is the JAX package's own bound for this kernel against the manual one
    (tests/test_pallas_kernels.py:275-300)."""
    rng = np.random.default_rng(11)
    npad, mpad = jsk.padded_shape(n, m, tile=tile)
    phi, t = _factor(rng, n, m, npad, mpad)
    x, s = tsk.sinkhorn_halfstep_tiled(torch.from_numpy(phi),
                                       torch.from_numpy(t), EPS, tile)
    xj, sj = jsk.sinkhorn_halfstep_pallas(jnp.asarray(phi), jnp.asarray(t),
                                          EPS, interpret=True, tile=tile)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_array_equal(x.numpy()[n:], 0.0)
    with pytest.raises(ValueError, match="padded_shape"):
        tsk.sinkhorn_halfstep_tiled(torch.ones((300, 128)), torch.ones(128),
                                    EPS, 256)


@pytest.mark.parametrize("n,m", [(2000, 24), (3000, 200)])
def test_k14_plain_twin_matches_interpreted_bf16_kernel(n, m):
    """K14's twin against _kernel_manual on a bf16 buffer. Both round t and
    x to bf16 and sum exact products in fp32 in different orders: x to
    1e-6. s to 1e-5: an x one fp32 ulp apart can round to neighbouring
    bf16 values (2^-8 apart) on a rare row, moving s by that share of one
    of ~n terms."""
    rng = np.random.default_rng(12)
    npad, mpad = jsk.padded_shape(n, m)
    phi, t = _factor(rng, n, m, npad, mpad)
    phi_bf = torch.from_numpy(phi).to(torch.bfloat16)
    x, s = tsk.sinkhorn_halfstep(phi_bf, torch.from_numpy(t), EPS)
    xj, sj = jsk.sinkhorn_halfstep_manual(
        jnp.asarray(phi).astype(jnp.bfloat16), jnp.asarray(t), EPS,
        chunk=1024, interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-6)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5)
    # The bf16 rounding is real: the f32 half-step differs by far more.
    _, s32 = tsk.sinkhorn_halfstep(torch.from_numpy(phi),
                                   torch.from_numpy(t), EPS)
    assert float((s32 - s).abs().max() / s32.abs().max()) > 1e-4


@pytest.mark.parametrize("chunk", [512, 1024])
def test_k15_plain_probe_variants(monkeypatch, chunk):
    """K15's plain twin returns the TPU probe's (8, max(mpad, chunk))
    block, held against tools/bench_sk_dmaonly.py's probe itself (loaded
    by path, pallas_call in interpret mode): row 0 of dmaonly (the chunks'
    first rows, in order) exactly, wonly's chunk-folded w to 1e-6, wpart's
    sum_c w_c^T phi_c to 1e-5; rows 1-7 are 0."""
    import functools
    import importlib.util
    import os

    from jax.experimental import pallas as pl

    monkeypatch.setenv("NLE_JAX_CACHE_DIR", "off")
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "bench_sk_dmaonly.py")
    spec = importlib.util.spec_from_file_location("tools_dmaonly", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rng = np.random.default_rng(13)
    npad, mpad = 4096, 128
    phi = (rng.standard_normal((npad, mpad)) * 0.05 + 0.1).astype(np.float32)
    t = rng.random(mpad).astype(np.float32)
    P, T = torch.from_numpy(phi), torch.from_numpy(t)
    for variant, rtol in (("dmaonly", 0.0), ("wonly", 1e-6),
                          ("wpart", 1e-5)):
        want = np.asarray(tool.make(variant, chunk, npad, mpad)(
            jnp.asarray(phi), jnp.asarray(t)))
        got = tsk.sinkhorn_probe(P, T, variant, chunk).numpy()
        assert got.shape == want.shape == (8, max(mpad, chunk)), variant
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                   err_msg=variant)
    with pytest.raises(ValueError, match="variant"):
        tsk.sinkhorn_probe(P, T, "dma", chunk)


def test_probe_tool_measures_only_the_card():
    """The probe tool (nle_tpu_torch/tools/bench_sk_dmaonly.py) reports
    device times: without a card it refuses instead of timing the CPU."""
    from nle_tpu_torch.tools import bench_sk_dmaonly

    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py [10c] runs the tool")
    assert bench_sk_dmaonly.main([]) == 2
    with pytest.raises(RuntimeError, match="cuda"):
        bench_sk_dmaonly.probe_table(torch, 4096, 128)


# -- the assembled Sinkhorn loop under each mode ---------------------------

def _fused_factor():
    """tests/test_pallas_kernels.py:76-91's 1500 x 24 factor."""
    rng = np.random.default_rng(7)
    n, m = 1500, 24
    phi = np.abs(rng.standard_normal((n, m))).astype(np.float32) * 0.3 + 0.05
    lam = np.linspace(1.0, 0.2, m).astype(np.float32)
    return phi, lam


# Tolerances (relative to max |JAX|) with their reasons:
# - f32 and auto: one f32 algebra, other summation orders: 2e-5.
# - int16 (the carrier of all rows, assembled): the TPU kernel drops the
#   lo*lo term of its bf16 split (~2^-17 per product) where the port takes
#   exact products: 1e-4, as for the split layout (test_torch_stage2a.py).
# - bf16_iters=6: both round t and x to bf16; a sum one ulp apart can round
#   to a neighbouring bf16 value, a 2^-8 step the Sinkhorn map then carries:
#   1e-3, still 5x inside the 5e-3 the JAX package allows bf16 against f32
#   on this factor.
@pytest.mark.parametrize("mode,knobs,kw,rtol", [
    ("auto kernel", dict(NLE_SINKHORN_KERNEL="auto"), {}, 2e-5),
    ("bf16_iters=6", dict(NLE_SINKHORN_INT16="off"), dict(bf16_iters=6),
     1e-3),
    ("assembled int16", {}, {}, 1e-4),
    ("f32", dict(NLE_SINKHORN_INT16="off"), {}, 2e-5),
])
def test_sinkhorn_vectors_fused_matches_jax(env, mode, knobs, kw, rtol):
    env(**knobs)
    phi, lam = _fused_factor()
    n = phi.shape[0]
    r, c, stat = tsk.sinkhorn_vectors_fused(
        torch.from_numpy(phi), torch.from_numpy(lam), 8, EPS, n=n,
        with_stat=True, **kw)
    rj, cj, statj = jsk.sinkhorn_vectors_fused(
        jnp.asarray(phi), jnp.asarray(lam), 8, EPS, interpret=True, n=n,
        with_stat=True, **kw)
    for got, want in ((r, rj), (c, cj)):
        want = np.asarray(want, np.float64)
        err = np.max(np.abs(got.double().numpy() - want)) / np.abs(want).max()
        assert err < rtol, (mode, err)
    if mode == "assembled int16":
        assert 0.0 <= float(stat) == pytest.approx(float(statj), abs=1e-6)
    else:
        assert float(stat) == float(statj) == -1.0


def test_fused_loop_runs_each_mode_on_its_kernel(env, monkeypatch):
    """On the CPU the loop's half-steps go through the wrappers the CUDA
    launches sit behind: count the calls by factor dtype and kernel."""
    phi, lam = _fused_factor()
    calls = []
    real_h, real_t = tsk.sinkhorn_halfstep, tsk.sinkhorn_halfstep_tiled

    def halfstep(Q, t, eps):
        calls.append(str(Q.dtype).rsplit(".", 1)[-1])
        return real_h(Q, t, eps)

    def tiled(Q, t, eps, tile=None):
        calls.append("tiled")
        return real_t(Q, t, eps, tile)

    monkeypatch.setattr(tsk, "sinkhorn_halfstep", halfstep)
    monkeypatch.setattr(tsk, "sinkhorn_halfstep_tiled", tiled)
    for knobs, want in (
            (dict(NLE_SINKHORN_KERNEL="auto", NLE_SINKHORN_BF16="auto"),
             ["tiled"] * 20),
            (dict(NLE_SINKHORN_BF16="auto"),
             ["bfloat16"] * 16 + ["float32"] * 4),
            ({}, ["int16"] * 20),
            (dict(NLE_SINKHORN_INT16="off"), ["float32"] * 20)):
        calls.clear()
        env(**{**dict.fromkeys(KNOBS), **knobs})
        tsk.sinkhorn_vectors_fused(torch.from_numpy(phi),
                                   torch.from_numpy(lam), 10, EPS)
        assert calls == want, knobs


# -- stage 2a and the whole edit under each mode -----------------------------

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


ARGS = (8, 8, 100.0, 30.0, 10, 8)
# (knobs, the port's layout) per mode; nle_tpu runs each with
# split=False, as its train_filter resolves every one of them.
MODES = {
    "auto kernel": dict(NLE_SINKHORN_KERNEL="auto"),
    "bf16": dict(NLE_SINKHORN_BF16="auto"),
    "assembled int16": dict(NLE_STAGE2_SPLIT="off"),
    "f32": dict(NLE_SINKHORN_INT16="off"),
}


def _stage2a_inputs(img, args):
    lab = bgr_to_lab_u8_np(img)
    L = lab[..., 0].astype(np.float32)
    h, w = L.shape
    grid = sample_grid(h, w, args[0], args[1])
    p = grid.n_samples
    Um64, lam64, _ = jpipe.ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, args[2], args[3], EPS)
    m = lam64.shape[0]
    return dict(lab=lab, L=L, grid=grid, p=p, m=m, mb=jpipe.bucket_m(m, p),
                Um64=Um64, lam64=lam64, y=L.reshape(-1)[grid.perm],
                rr=(grid.perm // w).astype(np.float32),
                cc=(grid.perm % w).astype(np.float32))


def _jax_edit(d, args):
    """nle_tpu's train_filter sequence on the assembled layout (split=False)
    with its Pallas kernels interpreted; the knobs resolve inside."""
    p, m, mb = d["p"], d["m"], d["mb"]
    sw, pw = jbandwidth_weights(args[2], args[3])
    s1 = jnp.asarray(jpipe.pack_stage1(d["Um64"], d["lam64"], np.float32,
                                       mb=mb))
    y = jnp.asarray(d["y"])
    rc, sb, factor, c_rest = jpipe.train_filter_stage2a(
        y, jnp.asarray(d["rr"]), jnp.asarray(d["cc"]), s1, sw, pw, p=p,
        mb=mb, n_sinkhorn_iter=args[4], eps=EPS, use_pallas=True,
        interpret=True, small=False, split=False)
    rc_np = np.asarray(rc, np.float64)
    assert not jpipe.check_carrier_guard(rc_np)
    sb_np = np.asarray(sb, np.float64)
    k = min(args[5], m)
    va_np, Sq = jpipe.host_orthogonalize(rc_np, sb_np, d["Um64"], d["lam64"],
                                         m, mb, k, EPS)
    va_grt = jnp.asarray(jpipe.pack_stage2b_upload(False, va_np, rc_np,
                                                   d["Um64"], m, p, k),
                         jnp.float32)
    fs = jtransform(jnp.asarray(Sq, jnp.float32), WEIGHTS)
    _, edit = jpipe.train_filter_stage2b_edit(
        factor, c_rest, va_grt, y, fs, n=d["grid"].n_pixels, mb=mb,
        scaled=False, interpret=True)
    edit = np.asarray(edit)
    unpacked = np.empty_like(edit)
    unpacked[d["grid"].perm] = edit
    out = d["lab"].copy()
    out[..., 0] = unpacked.reshape(out.shape[:2])
    return rc_np, sb_np, lab_to_bgr_u8_np(out)


def _port_stage2a(d, args):
    sw, pw = bandwidth_weights(args[2], args[3])
    s1 = torch.from_numpy(tpipe.pack_stage1(d["Um64"], d["lam64"],
                                            mb=d["mb"]))
    rc, sb, factor, c_rest = tpipe.train_filter_stage2a(
        torch.from_numpy(d["y"]), torch.from_numpy(d["rr"]),
        torch.from_numpy(d["cc"]), s1, sw, pw, p=d["p"], m=d["m"],
        mb=d["mb"], n_sinkhorn_iter=args[4], eps=EPS, small=False)
    return rc.double().numpy(), sb.double().numpy(), factor, c_rest


# [r; c] relative to max |JAX| (reasons as for the loop above: 2e-5 for
# the f32 algebra, 1e-4 for the carrier's dropped lo*lo term, 1e-3 for the
# bf16 lead); the edit >= 45 dB, the JAX package's golden gate.
RC_TOL = {"auto kernel": 2e-5, "bf16": 1e-3, "assembled int16": 1e-4,
          "f32": 2e-5}
U = 2.0 ** -24


@pytest.mark.parametrize("mode", list(MODES))
def test_stage2a_and_edit_match_jax_in_each_mode(env, mode):
    img = _frame(64, 80, seed=3)
    d = _stage2a_inputs(img, ARGS)
    env(**MODES[mode])
    assert not tsk.resolve_split_stage2(ARGS[4])
    rc_t, sb_t, phi, c_rest = _port_stage2a(d, ARGS)
    rc_j, sb_j, want = _jax_edit(d, ARGS)
    assert not isinstance(phi, tuple)
    err = np.max(np.abs(rc_t[:2] - rc_j[:2])) / np.max(np.abs(rc_j[:2]))
    assert err < RC_TOL[mode], (mode, err)
    # Sb sums N rows per entry; any two fp32 summations of it lie within
    # 2 N u of the absolute gram of each other (the worst-case dot-product
    # bound). The interpreted JAX gram sits ~1e-4 of it from float64 on
    # this frame, the port ~3e-7, so the bound is the reference's class.
    cphi = (c_rest * phi).double().abs()
    ab = (cphi.T @ cphi)[:d["mb"], :d["mb"]].numpy()
    assert np.all(np.abs(sb_t - sb_j) <= 2 * phi.shape[0] * U * ab), mode
    if mode == "assembled int16":
        assert abs(rc_t[2, 0] - rc_j[2, 0]) < 1e-3 and rc_t[2, 0] >= 0.0
    else:
        assert rc_t[2, 0] == rc_j[2, 0] == -1.0
    got = NLEFilter(device="cpu").train_and_enhance(img, *ARGS,
                                                    weights=WEIGHTS)
    db = _psnr(got, want)
    print(f"{mode}: port vs nle_tpu {db:.2f} dB")
    assert db >= 45.0, (mode, db)


@pytest.mark.parametrize("frame,knobs,layouts,redo", [
    ("smooth", dict(NLE_SINKHORN_KERNEL="auto"), [False], False),
    ("smooth", dict(NLE_SINKHORN_BF16="auto"), [False], False),
    ("smooth", dict(NLE_STAGE2_SPLIT="off"), [False], False),
    ("noise", dict(NLE_STAGE2_SPLIT="off"), [False, False], True),
    ("noise", dict(NLE_SINKHORN_INT16="on"), [True], False),
    ("noise", dict(NLE_INT16_GUARD="0.9"), [True], False),
    ("noise", {}, [True, False], True),
])
def test_train_filter_follows_the_knobs(env, monkeypatch, frame, knobs,
                                        layouts, redo):
    """train_filter's stage 2a layouts in call order (True: split) and the
    guard: a forced-on carrier or a raised threshold keeps the quantized
    trajectory on the noise frame that trips the default guard."""
    seen = []
    real = tpipe.train_filter_stage2a

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(isinstance(out[2], tuple))
        return out

    monkeypatch.setattr(tpipe, "train_filter_stage2a", spy)
    # These frames stand for the large ones: past NLE_CPHI_BYTES, so the
    # small layout does not take them.
    monkeypatch.setenv("NLE_CPHI_BYTES", "0")
    env(**knobs)
    rng = np.random.default_rng(2)
    if frame == "noise":
        L, hx = rng.uniform(0, 255, size=(120, 120)), 5.0
    else:
        yy, xx = np.mgrid[0:72, 0:80]
        L, hx = 120 + 60 * np.sin(xx / 11.0) + rng.normal(0, 4, (72, 80)), 100.0
    L = np.rint(np.clip(L, 0, 255)).astype(np.float32)
    # Five iterations: NLE_SINKHORN_BF16=auto leads with three.
    V, S = tpipe.train_filter(L, 10, 10, hx, 30.0, 5, 4, device="cpu")
    assert seen == layouts
    assert (len(seen) == 2) is redo
    assert V.shape == (L.size, 4) and bool(torch.isfinite(V).all())


# -- on the card ---------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_sinkhorn_modes_match_plain_versions():
    """K13, K14 and K15 against their plain versions on the card (the
    bounds of chip_smoke.py [10a]), each launch counted once; K13 also bit
    for bit its earlier sweep, rebuilt from the unchanged
    tiled_sweep_kernel (nle_ab_tiles variant 0: x and the per-tile
    partials; s striped over them in the 8-stripe reduce's order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(14)
    npad, mpad = tsk.padded_shape(9000, 200)
    tile = tsk.k13_tile(mpad)
    phi, t = _factor(rng, 9000, 200, npad, mpad)
    P, T = torch.from_numpy(phi).to(dev), torch.from_numpy(t).to(dev)
    x_old = torch.empty((npad,), device=dev)
    s_tile_order = torch.empty((mpad,), device=dev)
    partial = torch.empty((npad // tile, mpad), device=dev)
    _build.check(tsk.launch_sweep(_build.load().nle_ab_tiles, P, T, x_old,
                                  partial, s_tile_order, npad, mpad, tile, 0,
                                  EPS), "nle_ab_tiles")
    _build.reset_launches()
    k13 = tsk.sinkhorn_halfstep_tiled(P, T, EPS)
    assert torch.equal(k13[0], x_old)
    assert torch.equal(k13[1], tsk.striped_sum(partial, tsk.K13_STRIPES))
    for got, want in (
            (k13, tsk.sinkhorn_halfstep_tiled_plain(P, T, EPS, tile)),
            (tsk.sinkhorn_halfstep(P.to(torch.bfloat16), T, EPS),
             tsk.sinkhorn_halfstep_plain(P.to(torch.bfloat16), T, EPS))):
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
    for variant in tsk.PROBE_VARIANTS:
        torch.testing.assert_close(
            tsk.sinkhorn_probe(P, T, variant, 1024),
            tsk.sinkhorn_probe_plain(P, T, variant, 1024),
            rtol=0 if variant == "dmaonly" else 1e-5, atol=0)
    torch.cuda.synchronize()
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "sinkhorn_halfstep_tiled": 1, "sinkhorn_halfstep_bf16": 1,
        "sinkhorn_probe_dmaonly": 1, "sinkhorn_probe_wonly": 1,
        "sinkhorn_probe_wpart": 1}
