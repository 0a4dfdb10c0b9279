"""The port's streaming kernels (K8, K10, K11, K12), the streaming Sinkhorn
loop and train_filter(streaming=True) against nle_tpu, on numpy-made
inputs. The JAX side runs its Pallas kernels with interpret=True, as
tests/test_streaming.py runs them; on the CPU the port's wrappers take
their plain PyTorch versions. The CUDA kernels are held against those
plain versions by the `cuda`-marked test below and by chip_smoke.py.

Both sides build the same affinity entries (raw integer differences,
squared, then scaled, then exp) and sum them in other orders, so the
kernel-level tolerance is rtol 1e-5: a few hundred to a thousand fp32 terms
of one sign give relative rounding well below that, and a dropped or
double-counted tile moves a sum by a whole term (> 1e-3 of it here)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nle_tpu.ops.affinity import features as jfeatures
from nle_tpu.ops.pallas import streaming_kernel as jsk
from nle_tpu.ops.pipeline import ka_eigh_host64 as jka_eigh_host64
from nle_tpu.ops.pipeline import train_filter as jtrain_filter
from nle_tpu.ops.sampling import sample_grid
from nle_tpu_torch.ops.affinity import bandwidth_weights
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import streaming_kernel as tsk
from nle_tpu_torch.ops.pipeline import train_filter

EPS = 1e-10
SW = float(np.float32(1e-4))
PW = float(np.float32(1e-3))
RTOL = 1e-5


def _features(rng, n):
    return rng.integers(0, 64, (n, 3)).astype(np.float32)


@pytest.fixture()
def operands():
    """q = 900 rest pixels and p = 100 samples: neither a multiple of its
    tile (Qpad 1024, Ppad 128), so the ragged edges are exercised."""
    rng = np.random.default_rng(5)
    p, q = 100, 900
    fa, fb = _features(rng, p), _features(rng, q)
    fa_rows, fb_cols, mask = tsk.pad_stream_operands(torch.from_numpy(fa),
                                                     torch.from_numpy(fb))
    assert fa_rows.shape == (3, 128) and fb_cols.shape == (3, 1024)
    jrows = jsk.pad_stream_operands(jnp.asarray(fa), jnp.asarray(fb))
    for t, j in zip((fa_rows, fb_cols, mask), jrows):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    return rng, p, q, fa_rows, fb_cols, mask


def _j(t):
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("unit_x", [False, True])
def test_halfstep_matches_pallas_interpret(operands, unit_x):
    rng, p, q, fa_rows, fb_cols, mask = operands
    u = np.zeros(128, np.float32)
    u[:p] = rng.uniform(0.5, 1.5, p) * 0.01
    u = torch.from_numpy(u)
    x, ap = tsk.streaming_halfstep(fa_rows, fb_cols, mask, u, SW, PW, EPS,
                                   unit_x=unit_x)
    xj, apj = jsk.streaming_halfstep_pallas(
        _j(fa_rows), _j(fb_cols), _j(mask), _j(u), SW, PW, EPS,
        unit_x=unit_x, interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=RTOL)
    np.testing.assert_array_equal(x.numpy()[q:], 0.0)   # the mask kills pads
    np.testing.assert_allclose(ap.numpy()[:p], np.asarray(apj)[:p],
                               rtol=RTOL)


@pytest.mark.parametrize("R", [1, 2])
def test_ap_matches_pallas_interpret(operands, R):
    rng, p, q, fa_rows, fb_cols, _ = operands
    X = np.zeros((R, 1024), np.float32)
    X[:, :q] = rng.random((R, q))
    got = tsk.streaming_ap(fa_rows, fb_cols, torch.from_numpy(X), SW, PW)
    want = jsk.streaming_ap_pallas(_j(fa_rows), _j(fb_cols), jnp.asarray(X),
                                   SW, PW, interpret=True)
    assert got.shape == (R, 128)
    np.testing.assert_allclose(got.numpy()[:, :p], np.asarray(want)[:, :p],
                               rtol=RTOL)


@pytest.mark.parametrize("R", [0, 1, 2])
def test_atb_matches_pallas_interpret(operands, R):
    """R = 0 stands for a bare (Ppad,) vector, which gives (1, Qpad)."""
    rng, p, q, fa_rows, fb_cols, _ = operands
    B = np.zeros((max(R, 1), 128), np.float32)
    B[:, :p] = rng.random((max(R, 1), p))
    b = B[0] if R == 0 else B
    got = tsk.streaming_atb(fa_rows, fb_cols, torch.from_numpy(b), SW, PW)
    want = jsk.streaming_atb_pallas(_j(fa_rows), _j(fb_cols), jnp.asarray(b),
                                    SW, PW, interpret=True)
    assert got.shape == (max(R, 1), 1024)
    np.testing.assert_allclose(got.numpy()[:, :q], np.asarray(want)[:, :q],
                               rtol=RTOL)


def test_gram_matches_pallas_interpret(operands):
    """Signed Uinv: the gram's entries cancel, so the error is bounded
    relative to the sum of absolute terms, (|c phi|^T |c phi|)."""
    rng, p, q, fa_rows, fb_cols, _ = operands
    m, mpad = 70, 128
    uinv = np.zeros((128, mpad), np.float32)
    uinv[:p, :m] = rng.standard_normal((p, m)) * 0.05
    c = np.zeros((1, 1024), np.float32)
    c[0, :q] = rng.random(q)
    got = tsk.streaming_scaled_gram(fa_rows, fb_cols, torch.from_numpy(c),
                                    torch.from_numpy(uinv), SW, PW).numpy()
    want = np.asarray(jsk.streaming_scaled_gram_pallas(
        _j(fa_rows), _j(fb_cols), jnp.asarray(c), jnp.asarray(uinv), SW, PW,
        interpret=True))
    fa64 = fa_rows.numpy().astype(np.float64)
    fb64 = fb_cols.numpy().astype(np.float64)
    K = np.exp(-(SW * ((fb64[0, :, None] - fa64[0]) ** 2
                       + (fb64[1, :, None] - fa64[1]) ** 2)
                 + PW * (fb64[2, :, None] - fa64[2]) ** 2))
    cphi = np.abs(c[0, :, None].astype(np.float64) * (K @ uinv))
    bound = RTOL * (cphi.T @ cphi)
    assert np.all(np.abs(got - want) <= bound + 1e-12)


def test_cpu_wrappers_are_the_plain_versions(operands):
    """On the CPU each wrapper is its plain twin, bit for bit, and no
    kernel launch is counted."""
    rng, p, q, fa_rows, fb_cols, mask = operands
    _build.reset_launches()
    u = torch.from_numpy(np.pad(rng.random(p).astype(np.float32),
                                (0, 128 - p)))
    for a, b in zip(tsk.streaming_halfstep(fa_rows, fb_cols, mask, u, SW,
                                           PW, EPS),
                    tsk.streaming_halfstep_plain(fa_rows, fb_cols, mask, u,
                                                 SW, PW, EPS)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    X = torch.rand((3, 1024), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(tsk.streaming_ap(fa_rows, fb_cols, X, SW, PW),
                               tsk.streaming_ap_plain(fa_rows, fb_cols, X,
                                                      SW, PW), rtol=0, atol=0)
    Bm = X[:, :128].contiguous()
    torch.testing.assert_close(
        tsk.streaming_atb(fa_rows, fb_cols, Bm, SW, PW),
        tsk.streaming_atb_plain(fa_rows, fb_cols, Bm, SW, PW), rtol=0, atol=0)
    assert all(v == 0 for v in _build.LAUNCHES.values())


def test_dense_sampling_grids_raise():
    """Ppad > 1792 (a dense sampling grid) once raised; now the same four
    entry points, on the same Ppad = 2048 operands (the JAX package's
    padding of p = 1800), return the JAX package's answers: K9 through the
    dispatcher, K10, K11, and K12 against streaming_scaled_gram_xla, the
    JAX route for such grids."""
    rng = np.random.default_rng(1)
    fa, fb = _features(rng, 1800), _features(rng, 600)
    jrows = jsk.pad_stream_operands(jnp.asarray(fa), jnp.asarray(fb))
    fa_rows, fb_cols, mask = (torch.from_numpy(np.array(a)) for a in jrows)
    assert fa_rows.shape[1] == 2048
    u = np.zeros(2048, np.float32)
    u[:1800] = rng.uniform(0.5, 1.5, 1800) * 1e-3
    u = torch.from_numpy(u)
    x, ap = tsk.streaming_halfstep(fa_rows, fb_cols, mask, u, SW, PW, EPS)
    xj, apj = jsk.streaming_halfstep(*jrows, _j(u), SW, PW, EPS,
                                     interpret=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=RTOL)
    np.testing.assert_allclose(ap.numpy()[:1800], np.asarray(apj)[:1800],
                               rtol=RTOL)
    got = tsk.streaming_ap(fa_rows, fb_cols, mask, SW, PW)
    want = jsk.streaming_ap_pallas(*jrows[:2], jrows[2], SW, PW,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy()[:, :1800],
                               np.asarray(want)[:, :1800], rtol=RTOL)
    got = tsk.streaming_atb(fa_rows, fb_cols, u, SW, PW)
    want = jsk.streaming_atb_pallas(*jrows[:2], _j(u), SW, PW, interpret=True)
    np.testing.assert_allclose(got.numpy()[:, :600], np.asarray(want)[:, :600],
                               rtol=RTOL)
    uinv = np.zeros((2048, 128), np.float32)
    uinv[:1800, :90] = rng.random((1800, 90)) * 0.05
    got = tsk.streaming_scaled_gram(fa_rows, fb_cols, mask,
                                    torch.from_numpy(uinv), SW, PW).numpy()
    want = np.asarray(jsk.streaming_scaled_gram_xla(
        jnp.asarray(fa), jrows[1], jrows[2], jnp.asarray(uinv[:1800, :90]),
        SW, PW))
    np.testing.assert_allclose(got[:90, :90], want, rtol=RTOL)


# -- the Sinkhorn loop and the streaming train ------------------------------

@pytest.fixture(scope="module")
def small_channel():
    rng = np.random.default_rng(42)
    return rng.integers(0, 256, (40, 52)).astype(np.float32)


def test_streaming_sinkhorn_matches_jax(small_channel):
    """The same phi-free Sinkhorn (s0 pass + 2 x 10 half-steps) on both
    packages. Ten iterations of reciprocals carry the kernels' rounding
    differences along, so r and c are held to rtol 1e-4."""
    chan = small_channel
    grid = sample_grid(*chan.shape, 5, 5)
    p = grid.n_samples
    flat = chan.reshape(-1)[grid.perm]
    rr = (grid.perm // chan.shape[1]).astype(np.float32)
    cc = (grid.perm % chan.shape[1]).astype(np.float32)
    Um64, lam64, Uinv64 = jka_eigh_host64(
        chan[grid.sel_rows, grid.sel_cols], grid.sel_rows, grid.sel_cols,
        30.0, 10.0, EPS)
    sw, pw = bandwidth_weights(30.0, 10.0)
    Um, lam, Uinv = (a.astype(np.float32) for a in (Um64, lam64, Uinv64))
    f = np.stack([rr, cc, flat], axis=1).astype(np.float32)
    fj = jfeatures(jnp.asarray(rr), jnp.asarray(cc), jnp.asarray(flat))
    np.testing.assert_array_equal(np.asarray(fj), f)
    rj, cj = jsk.streaming_sinkhorn_vectors(
        fj[:p], fj[p:], jnp.asarray(Um), jnp.asarray(lam), jnp.asarray(Uinv),
        10, EPS, jnp.float32(sw), jnp.float32(pw), interpret=True)
    _build.reset_launches()
    ft = torch.from_numpy(f)
    r, c = tsk.streaming_sinkhorn_vectors(
        ft[:p], ft[p:], torch.from_numpy(Um), torch.from_numpy(lam), 10,
        EPS, sw, pw)
    assert r.shape == c.shape == (grid.n_pixels,)
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-4)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), rtol=1e-4)


def test_streaming_train_filter_matches_jax(small_channel):
    """train_filter(streaming=True) on both packages: S to rtol 1e-4, V per
    column up to sign (as tests/test_streaming.py:94 holds the JAX
    streaming path against its dense one)."""
    kw = dict(hx=30.0, hy=10.0, n_sinkhorn_iter=10, n_eig_vectors=4)
    Vj, Sj = jtrain_filter(small_channel, 5, 5, streaming=True,
                           pixel_order=False, **kw)
    V, S = train_filter(small_channel, 5, 5, device="cpu", streaming=True,
                        pixel_order=False, **kw)
    Vj, V = np.asarray(Vj), V.numpy()
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-4,
                               atol=1e-7)
    for j in range(V.shape[1]):
        sign = np.sign(np.dot(Vj[:, j], V[:, j])) or 1.0
        np.testing.assert_allclose(sign * V[:, j], Vj[:, j], rtol=5e-3,
                                   atol=2e-4)


def test_streaming_and_dense_trains_agree_in_the_port(small_channel):
    """The port's two stage-2 routes on one channel: the same S, and the
    same edit to sub-LSB."""
    from nle_tpu_torch.ops.pipeline import apply_filter
    from nle_tpu_torch.ops.transform import transform_eigenvalues

    kw = dict(hx=30.0, hy=10.0, n_sinkhorn_iter=10, n_eig_vectors=4,
              device="cpu")
    grid = sample_grid(*small_channel.shape, 5, 5)
    y = torch.from_numpy(small_channel.reshape(-1)[grid.perm])
    out = {}
    for mode in (False, True):
        V, S = train_filter(small_channel, 5, 5, streaming=mode,
                            pixel_order=False, **kw)
        out[mode] = apply_filter(V, transform_eigenvalues(
            S, [1.0, 1.6, 1.3, 1.1]), y).numpy()
    assert np.abs(out[True] - out[False]).max() < 0.5


@pytest.mark.parametrize("shape,grid_rc", [((12, 14), (3, 3)),
                                            ((4, 5), (4, 5))])
def test_streaming_tiny_and_full_grid_edges_match_jax(shape, grid_rc):
    """q < one row tile, and the full grid (p == N: an empty rest block,
    every streamed row a pad row), on both packages."""
    chan = np.random.default_rng(9).integers(0, 256, shape).astype(np.float32)
    kw = dict(hx=20.0, hy=20.0, n_sinkhorn_iter=5,
              n_eig_vectors=min(3, shape[0] * shape[1] - 1))
    Vj, Sj = jtrain_filter(chan, *grid_rc, streaming=True, pixel_order=False,
                           **kw)
    V, S = train_filter(chan, *grid_rc, device="cpu", streaming=True,
                        pixel_order=False, **kw)
    np.testing.assert_allclose(S.numpy(), np.asarray(Sj), rtol=1e-4,
                               atol=1e-7)
    np.testing.assert_allclose(np.abs(V.numpy()), np.abs(np.asarray(Vj)),
                               rtol=1e-3, atol=1e-5)


def test_streaming_auto_rule(monkeypatch):
    """Auto never streams on the CPU; an explicit request wins;
    NLE_STREAM_BYTES overrides the default drawn from the card's memory."""
    from nle_tpu_torch.ops.pipeline import resolve_streaming, stream_bytes_limit

    cpu = torch.device("cpu")
    assert resolve_streaming(None, cpu, 10**9, 600) is False
    assert resolve_streaming(True, cpu, 100, 8) is True
    assert resolve_streaming(False, cpu, 10**9, 600) is False
    monkeypatch.setenv("NLE_STREAM_BYTES", "12345")
    assert stream_bytes_limit(cpu) == 12345


# An H100 80GB's memory as torch.cuda.mem_get_info reports it (79.19 GiB).
H100_BYTES = 85_024_112_640


@pytest.mark.parametrize("shape,streams", [
    ((832, 1216), False),      # the 1 MP main frame: phi 2.6 GB
    ((2000, 2000), False),     # phi 10.2 GB
    ((3536, 3536), False),     # 12.5 MP: phi 32.0 GB, dense peak ~67 GB
    ((3900, 3900), False),     # 15.2 MP: phi 38.9 GB, dense peak ~82 GB
    ((4000, 4000), True),      # 16 MP, the capacity ladder's step below 32 MP
    ((5656, 5656), True),      # 32 MP: phi 82 GB
])
def test_streaming_auto_rule_on_an_80gb_card(monkeypatch, shape, streams):
    """The default limit is the card's available memory over the dense
    path's peak per phi byte (2.1: the assembled route holds two phi-sized
    arrays): on an empty 80 GB card the dense path keeps frames whose peak
    fits, up to ~15 MP, and streams the rest, 16 MP among them. mb = 600
    (p = 600 samples) pads to mpad = 640."""
    from nle_tpu_torch.ops import pipeline

    monkeypatch.delenv("NLE_STREAM_BYTES", raising=False)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (H100_BYTES - 2**29, H100_BYTES))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    cuda = torch.device("cuda")
    n = shape[0] * shape[1]
    limit = pipeline.stream_bytes_limit(cuda)
    assert limit * pipeline.DENSE_PEAK_PER_PHI_BYTE <= H100_BYTES
    assert pipeline.resolve_streaming(None, cuda, n, 600) is streams
    if not streams:
        npad, mpad = pipeline.padded_shape(n, 600)
        assert (pipeline.DENSE_PEAK_PER_PHI_BYTE * 4 * npad * mpad
                <= H100_BYTES - 2**29)


def test_int16_prep_does_not_depend_on_its_row_chunks(monkeypatch):
    """quantize_int16 and crush_counts work in row chunks (the dense stage
    2's peak memory): any chunking gives the one-pass result."""
    from nle_tpu_torch.ops.kernels import sinkhorn_kernel as sk

    rng = np.random.default_rng(11)
    phi = rng.standard_normal((300, 64)).astype(np.float32)
    phi *= 10.0 ** rng.uniform(-8, 0, phi.shape).astype(np.float32)
    phi[rng.random(phi.shape) < 0.2] = 0.0
    phi[:, 5] = 0.0
    phi = torch.from_numpy(phi)
    whole = sk.quantize_int16(phi), sk.crush_counts(phi, sk.quantize_int16(
        phi)[1])
    monkeypatch.setattr(sk, "PREP_CHUNK_ROWS", 7)
    chunked = sk.quantize_int16(phi), sk.crush_counts(phi, sk.quantize_int16(
        phi)[1])
    for a, b in zip(whole[0] + whole[1], chunked[0] + chunked[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert whole[0][0].dtype == torch.int16
    assert whole[0][1][5] == 1.0 and 0 < whole[1][0] < whole[1][1]


def test_streaming_row_kernels_take_one_to_three_rows(operands):
    """K10/K11 take one channel or a colour frame's three as rows; more
    rows raise on every device."""
    _, p, q, fa_rows, fb_cols, _ = operands
    with pytest.raises(ValueError, match="1 to 3"):
        tsk.streaming_ap(fa_rows, fb_cols, torch.zeros((4, 1024)), SW, PW)
    with pytest.raises(ValueError, match="1 to 3"):
        tsk.streaming_atb(fa_rows, fb_cols, torch.zeros((4, 128)), SW, PW)


# -- on the card -------------------------------------------------------------

@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_streaming_kernels_match_plain_versions(cuda, operands,
                                                     monkeypatch):
    """K8 (both forms), K10, K11 (R = 1, 2, 3) and K12 against their plain
    versions on the card, each launch counted once; and the auto rule
    honours NLE_STREAM_BYTES."""
    from nle_tpu_torch.ops.pipeline import resolve_streaming

    rng, p, q, fa_rows, fb_cols, mask = operands
    fa_rows, fb_cols, mask = (t.to(cuda) for t in (fa_rows, fb_cols, mask))
    u = np.zeros(128, np.float32)
    u[:p] = rng.uniform(0.5, 1.5, p) * 0.01
    u = torch.from_numpy(u).to(cuda)
    _build.reset_launches()
    for unit_x in (False, True):
        for a, b in zip(
                tsk.streaming_halfstep(fa_rows, fb_cols, mask, u, SW, PW, EPS,
                                       unit_x=unit_x),
                tsk.streaming_halfstep_plain(fa_rows, fb_cols, mask, u, SW,
                                             PW, EPS, unit_x=unit_x)):
            torch.testing.assert_close(a[:q], b[:q], rtol=RTOL, atol=0)
    for R in (1, 2, 3):
        X = torch.rand((R, 1024), device=cuda) * mask
        torch.testing.assert_close(
            tsk.streaming_ap(fa_rows, fb_cols, X, SW, PW)[:, :p],
            tsk.streaming_ap_plain(fa_rows, fb_cols, X, SW, PW)[:, :p],
            rtol=RTOL, atol=0)
        B = torch.zeros((R, 128), device=cuda)
        B[:, :p] = torch.rand((R, p), device=cuda)
        torch.testing.assert_close(
            tsk.streaming_atb(fa_rows, fb_cols, B, SW, PW),
            tsk.streaming_atb_plain(fa_rows, fb_cols, B, SW, PW),
            rtol=RTOL, atol=0)
    uinv = torch.zeros((128, 128), device=cuda)
    uinv[:p, :70] = torch.rand((p, 70), device=cuda)
    c = torch.rand((1, 1024), device=cuda) * mask
    torch.testing.assert_close(
        tsk.streaming_scaled_gram(fa_rows, fb_cols, c, uinv, SW, PW),
        tsk.streaming_scaled_gram_plain(fa_rows, fb_cols, c, uinv, SW, PW),
        rtol=RTOL, atol=0)
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] for k in (
        "streaming_halfstep", "streaming_ap", "streaming_atb",
        "streaming_gram")} == {"streaming_halfstep": 2, "streaming_ap": 3,
                               "streaming_atb": 3, "streaming_gram": 1}
    monkeypatch.setenv("NLE_STREAM_BYTES", "1")
    assert resolve_streaming(None, cuda, 1000, 8) is True
