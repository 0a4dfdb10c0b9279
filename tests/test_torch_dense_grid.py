"""Dense sampling grids in the port against nle_tpu, on the CPU: more than
1792 samples on the phi-free routes (K9, and K10/K11/K12 past Ppad 1792)
and more than 1024 on the dense route (K1 at K2's contract), the width
rule of the dense route on the card, and the slice as a whole (the
streaming and factored trains, and a p = 2112 factored filter crossing
between the packages as an npz).

The JAX side runs its Pallas kernels with interpret=True, as
tests/test_streaming.py does; on the CPU the port's wrappers take their
plain PyTorch versions. The port pads Ppad to 128 multiples where the JAX
package pads to 1024 multiples past 1792, so each comparison also shows
that the answer does not depend on the padding.

Kernel tolerances are rtol 1e-5, as the JAX tests use: a few thousand fp32
terms of one sign round far below it, and a dropped or double-counted tile
moves a sum by a whole term (> 1e-4 of it here). Signed sums (K1, K12) are
held to 1e-5 of the sum of absolute terms instead."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.models.factored import FactoredFilter as JaxFactoredFilter
from nle_tpu.models.factored import train_filter_factored as jtrain_factored
from nle_tpu.models.filter import load_filter as jload_filter
from nle_tpu.ops.affinity import bandwidth_weights as jbandwidth_weights
from nle_tpu.ops.affinity import features as jfeatures
from nle_tpu.ops.pallas import affinity_kernel as jak
from nle_tpu.ops.pallas import streaming_kernel as jsk
from nle_tpu.ops.pipeline import apply_filter as japply_filter
from nle_tpu.ops.pipeline import train_filter as jtrain_filter
from nle_tpu.ops.sampling import sample_grid
from nle_tpu.ops.transform import transform_eigenvalues as jtransform
from nle_tpu_torch import FactoredFilter
from nle_tpu_torch.models.factored import train_filter_factored
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import affinity_kernel as tak
from nle_tpu_torch.ops.kernels import sinkhorn_kernel as tsink
from nle_tpu_torch.ops.kernels import streaming_kernel as tsk
from nle_tpu_torch.ops.pipeline import apply_filter, train_filter
from nle_tpu_torch.ops.transform import transform_eigenvalues

EPS = 1e-10
SW = float(np.float32(1e-4))
PW = float(np.float32(1e-3))
RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """JAX's CPU runtime and torch's thread pool share the cores: the plain
    twins' many small blocks run several times faster on one torch thread
    than on a contended pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operands(p, q, seed):
    """Integer features of p samples and q rest pixels (no tile
    multiples), padded by each package's own rule."""
    rng = np.random.default_rng(seed)
    fa = rng.integers(0, 64, (p, 3)).astype(np.float32)
    fb = rng.integers(0, 64, (q, 3)).astype(np.float32)
    port = tsk.pad_stream_operands(torch.from_numpy(fa), torch.from_numpy(fb))
    jrows = jsk.pad_stream_operands(jnp.asarray(fa), jnp.asarray(fb))
    assert port[0].shape[1] == -(-p // 128) * 128
    assert port[1].shape == jrows[1].shape
    return rng, port, jrows


def _pad(v, n):
    return np.pad(v, [(0, 0)] * (v.ndim - 1) + [(0, n - v.shape[-1])])


# -- K9 and the halfstep dispatch ---------------------------------------------

@pytest.mark.parametrize("p", [2112, 2500])
def test_k9_matches_the_interpreted_ptiled_kernel(p):
    """The dispatcher sends Ppad > 1792 to K9 (its plain twin here), which
    matches _halfstep_ptiled_kernel run on the JAX package's padding."""
    rng, (fa_rows, fb_cols, mask), jrows = _operands(p, 700, p)
    u = rng.uniform(0.5, 1.5, p).astype(np.float32) * 1e-3
    u_pad = torch.from_numpy(_pad(u, fa_rows.shape[1]))
    x, ap = tsk.streaming_halfstep(fa_rows, fb_cols, mask, u_pad, SW, PW, EPS)
    x2, ap2 = tsk.streaming_halfstep_ptiled_plain(fa_rows, fb_cols, mask,
                                                  u_pad, SW, PW, EPS)
    assert torch.equal(x, x2) and torch.equal(ap, ap2)
    xj, apj = jsk.streaming_halfstep_ptiled_pallas(
        *jrows, jnp.asarray(_pad(u, jrows[0].shape[1])), SW, PW, EPS,
        interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=RTOL)
    np.testing.assert_array_equal(x.numpy()[700:], 0.0)
    np.testing.assert_allclose(ap.numpy()[:p], np.asarray(apj)[:p], rtol=RTOL)


def test_unit_x_past_1792_is_k10_with_the_mask():
    """The s0 pass past Ppad 1792 (tests/test_streaming.py:195's shapes):
    x is the mask and ap is K10 on it, as the JAX dispatcher does."""
    p, q = 2500, 1100
    _, (fa_rows, fb_cols, mask), jrows = _operands(p, q, 3)
    x, ap = tsk.streaming_halfstep(fa_rows, fb_cols, mask,
                                   torch.zeros(fa_rows.shape[1]), SW, PW,
                                   EPS, unit_x=True)
    assert torch.equal(x, mask[0])
    assert torch.equal(ap, tsk.streaming_ap_plain(fa_rows, fb_cols, mask, SW,
                                                  PW)[0])
    xj, apj = jsk.streaming_halfstep(*jrows, jnp.zeros(jrows[0].shape[1]), SW,
                                     PW, EPS, unit_x=True, interpret=True)
    np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
    np.testing.assert_allclose(ap.numpy()[:p], np.asarray(apj)[:p], rtol=RTOL)


def test_x_and_ap_do_not_depend_on_the_port_ppad():
    """The same half-step on Ppad 2176 (the port's padding of p = 2112)
    and on 2304 and 3072: only zero columns differ, so x and ap[:p] agree
    to the plain twin's own summation blocking (a few ulp)."""
    p = 2112
    rng, (fa_rows, fb_cols, mask), _ = _operands(p, 900, 7)
    assert fa_rows.shape[1] == 2176
    u = rng.uniform(0.5, 1.5, p).astype(np.float32) * 1e-3
    outs = []
    for ppad in (2176, 2304, 3072):
        fa_p = torch.nn.functional.pad(fa_rows, (0, ppad - 2176))
        x, ap = tsk.streaming_halfstep(fa_p, fb_cols, mask,
                                       torch.from_numpy(_pad(u, ppad)), SW,
                                       PW, EPS)
        outs.append((x.numpy(), ap.numpy()[:p]))
    for x, ap in outs[1:]:
        np.testing.assert_allclose(x, outs[0][0], rtol=1e-6)
        np.testing.assert_allclose(ap, outs[0][1], rtol=1e-6)


# -- K10, K11, K12 past Ppad 1792 ---------------------------------------------

@pytest.mark.parametrize("R", [1, 2, 3])
def test_k10_past_1792_matches_the_interpreted_kernel(R):
    p, q = 2112, 900
    rng, (fa_rows, fb_cols, _), jrows = _operands(p, q, 10 + R)
    X = np.zeros((R, fb_cols.shape[1]), np.float32)
    X[:, :q] = rng.random((R, q))
    got = tsk.streaming_ap(fa_rows, fb_cols, torch.from_numpy(X), SW, PW)
    want = jsk.streaming_ap_pallas(jrows[0], jrows[1], jnp.asarray(X), SW, PW,
                                   interpret=True)
    assert got.shape == (R, 2176)
    np.testing.assert_allclose(got.numpy()[:, :p], np.asarray(want)[:, :p],
                               rtol=RTOL)


@pytest.mark.parametrize("R", [1, 2, 3])
def test_k11_past_1792_matches_the_interpreted_kernel(R):
    p, q = 2112, 900
    rng, (fa_rows, fb_cols, _), jrows = _operands(p, q, 20 + R)
    B = rng.random((R, p)).astype(np.float32)
    got = tsk.streaming_atb(fa_rows, fb_cols,
                            torch.from_numpy(_pad(B, fa_rows.shape[1])), SW,
                            PW)
    want = jsk.streaming_atb_pallas(jrows[0], jrows[1],
                                    jnp.asarray(_pad(B, jrows[0].shape[1])),
                                    SW, PW, interpret=True)
    np.testing.assert_allclose(got.numpy()[:, :q], np.asarray(want)[:, :q],
                               rtol=RTOL)


def test_k12_past_1792_matches_streaming_scaled_gram_xla():
    """K12's plain twin against the XLA scan the JAX package runs once the
    gram no longer fits VMEM. Signed Uinv: held to 1e-5 of the gram of
    absolute terms, (|c phi|^T |c phi|), evaluated in float64."""
    p, q, m = 2112, 900, 300
    rng, (fa_rows, fb_cols, _), jrows = _operands(p, q, 31)
    fa = jrows[0][:, :p].T
    assert not jsk.gram_fits_vmem(p, m)
    uinv = (rng.standard_normal((p, m)) * 0.05).astype(np.float32)
    c = np.zeros((1, fb_cols.shape[1]), np.float32)
    c[0, :q] = rng.random(q)
    uinv_pad = np.zeros((fa_rows.shape[1], 384), np.float32)
    uinv_pad[:p, :m] = uinv
    got = tsk.streaming_scaled_gram(fa_rows, fb_cols, torch.from_numpy(c),
                                    torch.from_numpy(uinv_pad), SW,
                                    PW).numpy()[:m, :m]
    want = np.asarray(jsk.streaming_scaled_gram_xla(
        fa, jrows[1], jnp.asarray(c), jnp.asarray(uinv), SW, PW))
    fa64 = fa_rows.numpy().astype(np.float64)[:, :p]
    fb64 = fb_cols.numpy().astype(np.float64)
    K = np.exp(-(SW * ((fb64[0, :, None] - fa64[0]) ** 2
                       + (fb64[1, :, None] - fa64[1]) ** 2)
                 + PW * (fb64[2, :, None] - fa64[2]) ** 2))
    cphi = np.abs(c[0, :, None].astype(np.float64) * (K @ uinv))
    assert np.all(np.abs(got - want) <= RTOL * (cphi.T @ cphi) + 1e-12)


# -- K1 at K2's contract ------------------------------------------------------

@pytest.mark.parametrize("p", [1200, 2112])
def test_k1_matches_the_interpreted_ptiled_kernel(p):
    """K1's plain twin with out_rows against affinity_matmul_pallas, which
    takes _kernel_ptiled past 1024 samples (tests/test_pallas_kernels.py:56's
    shapes: q = 1400, m = 260): the (1536, 384) buffer, zero past q and m,
    and each entry within 1e-5 of (|K| |B|)."""
    q, m, out_rows = 1400, 260, 1536
    rng = np.random.default_rng(p)
    rows = rng.integers(0, 200, p + q).astype(np.float32)
    cols = rng.integers(0, 200, p + q).astype(np.float32)
    y = rng.integers(0, 256, p + q).astype(np.float32)
    f = np.array(jfeatures(jnp.asarray(rows), jnp.asarray(cols),
                           jnp.asarray(y)))
    sw, pw = (float(v) for v in jbandwidth_weights(500.0, 20.0))
    B = (rng.standard_normal((p, m)) * 0.1).astype(np.float32)
    assert -(-p // 128) * 128 > jak.MAX_PALLAS_P
    want = np.asarray(jak.affinity_matmul_pallas(
        jnp.asarray(f[:p]), jnp.asarray(f[p:]), jnp.asarray(B), sw, pw,
        interpret=True, out_rows=out_rows))
    got = tak.affinity_matmul_kernel(
        torch.from_numpy(f[:p]), torch.from_numpy(f[p:]), torch.from_numpy(B),
        sw, pw, out_rows=out_rows).numpy()
    assert got.shape == want.shape == (out_rows, 384)
    np.testing.assert_array_equal(got[q:], 0.0)
    np.testing.assert_array_equal(got[:, m:], 0.0)
    f64 = f.astype(np.float64)
    d = f64[p:, None, :] - f64[None, :p, :]
    K = np.exp(-(sw * (d[..., 0] ** 2 + d[..., 1] ** 2) + pw * d[..., 2] ** 2))
    bound = RTOL * (K @ np.abs(B.astype(np.float64)))
    assert np.all(np.abs(got[:q, :m] - want[:q, :m]) <= bound)


# -- the dense route's width on the card --------------------------------------

# An H100 80GB's memory as torch.cuda.mem_get_info reports it (79.19 GiB).
H100_BYTES = 85_024_112_640


def test_dense_route_width_rule_on_a_mocked_card(monkeypatch):
    """K3/K4 take mpad <= MAX_MPAD: a 4 MP frame at p = 2112 with a nearly
    full rank (mb 2112, mpad 2176) stays dense on an 80 GB card; past
    MAX_MPAD the auto rule streams, an explicit dense train raises a
    ValueError naming the limit, and the CPU's plain version takes any
    width. The K3/K4 wrapper itself refuses the width before it builds
    anything."""
    from nle_tpu_torch.ops import pipeline

    monkeypatch.delenv("NLE_STREAM_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (H100_BYTES - 2**29, H100_BYTES))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tsink.MAX_MPAD == 16384
    assert pipeline.padded_shape(2000 * 2000, 2112)[1] == 2176
    assert pipeline.resolve_streaming(None, cuda, 2000 * 2000, 2112) is False
    assert pipeline.resolve_streaming(False, cuda, 2000 * 2000, 2112) is False
    assert pipeline.resolve_streaming(None, cuda, 4000 * 4000, 2112) is True
    wide = tsink.MAX_MPAD + 1
    assert pipeline.resolve_streaming(None, cuda, 100_000, wide) is True
    assert pipeline.resolve_streaming(True, cuda, 100_000, wide) is True
    with pytest.raises(ValueError, match="MAX_MPAD = 16384"):
        pipeline.resolve_streaming(False, cuda, 100_000, wide)
    assert pipeline.resolve_streaming(False, cpu, 100_000, wide) is False
    monkeypatch.setattr(tsink, "cuda_or_cpu", lambda *a, **k: True)
    monkeypatch.setattr(_build, "load", lambda: pytest.fail("built"))
    with pytest.raises(ValueError, match="MAX_MPAD = 16384"):
        tsink.sinkhorn_halfstep(torch.zeros((64, 16512), dtype=torch.int16),
                                torch.zeros(16512), EPS)


# -- the slice: streaming and factored trains on a 48 x 44 grid ---------------

SHAPE = (96, 88)                     # a 48 x 44 grid samples p = 2112
KW = dict(hx=200.0, hy=30.0, n_sinkhorn_iter=5, n_eig_vectors=4, eps=1e-3)
WEIGHTS = [1.0, 2.0, 1.5, 1.1]


@pytest.fixture(scope="module")
def dense_grid():
    """A smooth numpy-made channel. eps = 1e-3 keeps the kept spectrum's
    condition at 1e3 (m = 90 of 2112): at the default 1e-10 this grid
    keeps eigenvalues down to 1e-10, Uinv = Um / lam reaches 1e10, and
    any fp32 reassociation moves the edit by tens of gray levels on every
    route, the JAX package's own included (its dense-grid test bounds the
    edit by that cone, tests/test_streaming.py:126). Here the packages are
    held to each other, not to the cone."""
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1]]
    L = (120 + 60 * np.sin(xx / 11.0) + 40 * np.cos(yy / 7.0)
         + rng.normal(0, 6, SHAPE))
    L = np.clip(np.rint(L), 0, 255).astype(np.float32)
    grid = sample_grid(*SHAPE, 48, 44)
    assert grid.n_samples == 2112
    return L, grid


def test_streaming_train_matches_jax_on_a_dense_grid(dense_grid):
    """train_filter(streaming=True) in both packages (K10's s0 pass, 2 x 5
    K9 half-steps, K12, then K1 at p = 2112 for V): S to rtol 1e-4, and the
    edit V f(S) V^T y to 0.01 gray levels (measured ~1e-3)."""
    L, grid = dense_grid
    Vj, Sj = jtrain_filter(L, 48, 44, streaming=True, pixel_order=False,
                           **KW)
    V, S = train_filter(L, 48, 44, device="cpu", streaming=True,
                        pixel_order=False, **KW)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-4)
    y = L.reshape(-1)[grid.perm]
    want = np.asarray(japply_filter(Vj, jtransform(Sj, jnp.asarray(WEIGHTS)),
                                    jnp.asarray(y)))
    got = apply_filter(V, transform_eigenvalues(S, WEIGHTS),
                       torch.from_numpy(y)).numpy()
    assert np.abs(got - want).max() < 0.01


def _psnr(a, b):
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _edits(L, grid, eps, routes):
    """The first edit (u8, packed order) of the streaming route's float64
    plain twin and of the port's f32 trains along routes ((label,
    streaming), ...)."""
    from nle_tpu_torch.tools.stream_precision import streaming_edit_f64

    args = (48, 44, KW["hx"], KW["hy"], KW["n_sinkhorn_iter"],
            KW["n_eig_vectors"])
    out = {"float64 twin": streaming_edit_f64(
        torch, L, grid, args, WEIGHTS, torch.device("cpu"), eps=eps)[0]}
    for label, mode in routes:
        out[label] = train_filter(L, *args, device="cpu", eps=eps,
                                  edit_weights=WEIGHTS, streaming=mode,
                                  pixel_order=False)[2]
    return {k: v.numpy() for k, v in out.items()}


def test_float64_streaming_twin_is_the_f32_route_when_well_conditioned(
        dense_grid):
    """The float64 twin of the streaming route (chip_smoke [9c]'s
    reference) computes what train_filter(streaming=True) computes: at
    eps = 1e-3 (kept spectrum conditioned at 1e3) the u8 edits agree to
    >= 60 dB (measured: bitwise)."""
    L, grid = dense_grid
    e = _edits(L, grid, 1e-3, (("streaming", True),))
    assert _psnr(e["float64 twin"], e["streaming"]) >= 60.0


def test_eps_1e10_exact_streaming_algebra_sides_with_the_dense_route(
        dense_grid):
    """The same grid at eps = 1e-10 keeps eigenvalues down to 1e-10
    (m = 381 of 2112). The streaming route's float64 twin, its algebra with
    the fp32 rounding taken away, lands on the dense route: >= 50 dB from
    nle_tpu's dense edit and from the port's (measured 54.2 and 55.9 dB).
    The fp32 streaming routes sit further off, nle_tpu's own included
    (measured 50.9 dB for nle_tpu's, 42.9 dB for the port's plain
    version): at this eps the streaming route's association amplifies its
    rounding by 1/lambda, and the gap to the dense route is that rounding,
    which chip_smoke [9c] bounds on the card against the same twin."""
    L, grid = dense_grid
    e = _edits(L, grid, 1e-10, (("streaming", True), ("dense", False)))
    kw = dict(KW, eps=1e-10)
    y = L.reshape(-1)[grid.perm]
    for label, mode in (("nle_tpu streaming", True), ("nle_tpu dense", False)):
        V, S = jtrain_filter(L, 48, 44, streaming=mode, pixel_order=False,
                             **kw)
        f = japply_filter(V, jtransform(S, jnp.asarray(WEIGHTS)),
                          jnp.asarray(y))
        e[label] = np.clip(np.rint(np.asarray(f)), 0, 255)
    twin = e["float64 twin"]
    assert _psnr(twin, e["nle_tpu dense"]) >= 50.0
    assert _psnr(twin, e["dense"]) >= 50.0
    assert _psnr(twin, e["nle_tpu streaming"]) >= 40.0
    assert _psnr(twin, e["streaming"]) >= 40.0


@pytest.fixture(scope="module")
def factored_pair(dense_grid, tmp_path_factory):
    """The same channel trained into a factored filter by both packages,
    each saved as an npz."""
    L, _ = dense_grid
    args = (48, 44, KW["hx"], KW["hy"], KW["n_sinkhorn_iter"],
            KW["n_eig_vectors"])
    jf = jtrain_factored(L, *args, eps=KW["eps"])
    pf = train_filter_factored(L, *args, device="cpu", eps=KW["eps"])
    d = tmp_path_factory.mktemp("dense_grid")
    jpath, ppath = str(d / "jax.npz"), str(d / "port")
    jf.save(jpath)
    pf.save(ppath)
    return L, jf, pf, jpath, ppath + ".npz"


def _edits_agree(port_ff, jax_ff, L):
    """One factored filter applied by both packages (K10/K11 past Ppad
    1792 here): float outputs to 1e-3 of a gray level (fp32 summation
    order), u8 edits at most one LSB apart on at most 0.1% of the pixels
    (a rounding tie)."""
    fs_j = jtransform(jnp.asarray(jax_ff.eigvals), WEIGHTS)
    fs_t = transform_eigenvalues(port_ff.eigvals, WEIGHTS)
    np.testing.assert_allclose(port_ff.apply(L, fs_t), jax_ff.apply(L, fs_j),
                               atol=1e-3)
    chans = np.stack([L, 255 - L], axis=-1).astype(np.uint8)
    d = np.abs(port_ff.apply_u8(chans, fs_t).astype(np.int32)
               - jax_ff.apply_u8(chans, fs_j).astype(np.int32))
    assert d.max() <= 1 and np.count_nonzero(d) <= 1e-3 * d.size


def test_factored_train_matches_jax_on_a_dense_grid(factored_pair):
    """train_filter_factored in both packages: eigenvalues to rtol 1e-4,
    the (p, k) head pieces in the shapes the npz carries, and each
    package's filter applied by itself to 0.01 gray levels of the other."""
    L, jf, pf, _, _ = factored_pair
    assert pf.v_head.shape == pf.w.shape == (2112, 4)
    np.testing.assert_allclose(pf.eigvals.numpy(), np.asarray(jf.eigvals),
                               rtol=1e-4)
    fs_j = jtransform(jnp.asarray(jf.eigvals), WEIGHTS)
    fs_t = transform_eigenvalues(pf.eigvals, WEIGHTS)
    assert np.abs(pf.apply(L, fs_t) - np.asarray(jf.apply(L, fs_j))).max() \
        < 0.01


def test_dense_grid_factored_filter_crosses_both_ways(factored_pair):
    """A p = 2112 factored filter saved by nle_tpu edits in the port, and
    one saved by the port edits in nle_tpu, each as its own package does."""
    L, jf, pf, jpath, ppath = factored_pair
    port = FactoredFilter.load(jpath, "cpu")
    assert port.w.shape == (2112, 4) and port.hx == jf.hx
    _edits_agree(port, jf, L)
    jax_side = jload_filter(ppath)
    assert isinstance(jax_side, JaxFactoredFilter)
    _edits_agree(pf, jax_side, L)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_dense_grid_kernels_match_plain_versions():
    """K9, K10/K11 (R = 1..3) and K12 at Ppad 2176, K1 at p = 1200 and
    2112, and K3/K4 at mpad 2176 against their plain versions on the card,
    each launch counted once; K9's x and ap are bitwise the same on Ppad
    2176 and 3072."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    cuda = torch.device("cuda")
    p, q = 2112, 5000
    rng, ops, _ = _operands(p, q, 41)
    fa_rows, fb_cols, mask = (t.to(cuda) for t in ops)
    u = torch.from_numpy(_pad(rng.uniform(0.5, 1.5, p).astype(np.float32)
                              * 1e-3, 2176)).to(cuda)
    _build.reset_launches()
    x, ap = tsk.streaming_halfstep(fa_rows, fb_cols, mask, u, SW, PW, EPS)
    xp, app = tsk.streaming_halfstep_ptiled_plain(fa_rows, fb_cols, mask, u,
                                                  SW, PW, EPS)
    torch.testing.assert_close(x, xp, rtol=RTOL, atol=0)
    torch.testing.assert_close(ap[:p], app[:p], rtol=RTOL, atol=0)
    fa3 = torch.nn.functional.pad(fa_rows, (0, 3072 - 2176))
    u3 = torch.nn.functional.pad(u, (0, 3072 - 2176))
    x3, ap3 = tsk.streaming_halfstep(fa3, fb_cols, mask, u3, SW, PW, EPS)
    assert torch.equal(x3, x) and torch.equal(ap3[:p], ap[:p])
    for R in (1, 2, 3):
        X = torch.rand((R, fb_cols.shape[1]), device=cuda) * mask
        torch.testing.assert_close(
            tsk.streaming_ap(fa_rows, fb_cols, X, SW, PW)[:, :p],
            tsk.streaming_ap_plain(fa_rows, fb_cols, X, SW, PW)[:, :p],
            rtol=RTOL, atol=0)
        B = torch.zeros((R, 2176), device=cuda)
        B[:, :p] = torch.rand((R, p), device=cuda)
        torch.testing.assert_close(
            tsk.streaming_atb(fa_rows, fb_cols, B, SW, PW),
            tsk.streaming_atb_plain(fa_rows, fb_cols, B, SW, PW),
            rtol=RTOL, atol=0)
    uinv = torch.zeros((2176, 128), device=cuda)
    uinv[:p, :70] = torch.rand((p, 70), device=cuda)
    c = torch.rand((1, fb_cols.shape[1]), device=cuda) * mask
    torch.testing.assert_close(
        tsk.streaming_scaled_gram(fa_rows, fb_cols, c, uinv, SW, PW),
        tsk.streaming_scaled_gram_plain(fa_rows, fb_cols, c, uinv, SW, PW),
        rtol=RTOL, atol=0)
    for pk in (1200, 2112):
        fa = torch.randint(0, 64, (pk, 3), device=cuda).float()
        fb = torch.randint(0, 64, (3000, 3), device=cuda).float()
        Bk = torch.rand((pk, 300), device=cuda)
        got = tak.affinity_matmul_kernel(fa, fb, Bk, SW, PW, out_rows=3072)
        assert bool((got[3000:] == 0).all())
        torch.testing.assert_close(
            got, tak.affinity_matmul_plain(fa, fb, Bk, SW, PW, out_rows=3072),
            rtol=RTOL, atol=0)
    phi = torch.rand((4096, 2176), device=cuda)
    t = torch.rand(2176, device=cuda) * 1e-3
    for Q in (phi, (phi * 32767).round().to(torch.int16)):
        xk, sk = tsink.sinkhorn_halfstep(Q, t, EPS)
        xq, sq = tsink.sinkhorn_halfstep_plain(Q, t, EPS)
        torch.testing.assert_close(xk, xq, rtol=RTOL, atol=0)
        torch.testing.assert_close(sk, sq, rtol=RTOL, atol=0)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    assert counts["streaming_halfstep_ptiled"] == 2
    assert counts["streaming_halfstep"] == 0
    assert (counts["streaming_ap"], counts["streaming_atb"],
            counts["streaming_gram"], counts["affinity_matmul"]) == (3, 3, 1, 2)
    assert (counts["sinkhorn_halfstep_f32"],
            counts["sinkhorn_halfstep_int16"]) == (1, 1)
