"""The u8 edit's permutation on the device (ops/kernels/pixel_order_kernel.py):
the plain gather and scatter against NumPy's `flat[perm]` and
`out[perm] = packed`; the model layer's edits byte-equal to the same
filter edited through host fancy indexing; the pixel-order training-channel
cache and the filter's device index. The `cuda`-marked test holds the
kernel to its plain version bit for bit on the card (skipped without one).
No JAX here: the card's machine has none."""

import dataclasses

import numpy as np
import pytest
import torch

import nle_tpu_torch.models.filter as fmod
from nle_tpu_torch.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np
from nle_tpu_torch.models.filter import NLEFilter, TrainedFilter
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels.pixel_order_kernel import (
    device_index,
    perm_gather,
    perm_gather_plain,
    perm_scatter,
    perm_scatter_plain,
)
from nle_tpu_torch.ops.pipeline import apply_filter_u8, pack_channel
from nle_tpu_torch.ops.sampling import sample_grid
from nle_tpu_torch.ops.transform import (
    shrink_eigenvalues,
    transform_eigenvalues,
)

ARGS = (4, 4, 40.0, 20.0, 6, 4)      # samples, hx, hy, iterations, k
SIGMAS = (10.0, 10.0)
SHRINK = 2.0
WEIGHTS = [1.0, 2.5, 3.0, 1.0]
# Row counts that are odd and no multiple of the kernel's 16-row thread
# chunk or 4096-row tile: a sample grid of 37 x 53 and a random
# permutation past two tiles.
GRID = (37, 53, 5, 6)
RANDOM_N = 2 * 4096 + 77


def _frame(seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 110 + 50 * np.sin(xx / 4.0) + 30 * np.cos(yy / 3.0)
    img = np.stack([base + rng.normal(0, 5, (h, w)) + 8 * c
                    for c in range(3)], axis=-1)
    return np.clip(img, 0, 255).astype(np.uint8)


def _perm(kind: str) -> np.ndarray:
    if kind == "grid":
        return sample_grid(*GRID).perm
    return np.random.default_rng(5).permutation(RANDOM_N)


def _rows(n: int, c: int, seed: int = 0) -> np.ndarray:
    rows = np.random.default_rng(seed).integers(0, 256, (n, c), np.uint8)
    return rows[:, 0].copy() if c == 1 else rows


def _host_edit(t: TrainedFilter, channels_u8: np.ndarray, fs) -> np.ndarray:
    """The u8 edit through host fancy indexing: gather by perm, the
    filter, scatter by perm."""
    flat = channels_u8.reshape(t.n_pixels, -1)[t.perm]
    y = torch.from_numpy(np.ascontiguousarray(
        flat[:, 0] if flat.shape[1] == 1 else flat))
    out = apply_filter_u8(t.eigvecs, fs, y).numpy().reshape(flat.shape)
    unpacked = np.empty_like(out)
    unpacked[t.perm] = out
    return unpacked.reshape(channels_u8.shape)


@pytest.mark.parametrize("kind", ["grid", "random"])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_plain_twins_match_numpy(kind, c):
    perm = _perm(kind)
    n = perm.size
    assert n % 2 == 1 and n % 16
    x = _rows(n, c)
    idx = device_index(perm, torch.device("cpu"))
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), perm)
    want_gather = x[perm]
    want_scatter = np.empty_like(x)
    want_scatter[perm] = x
    xt = torch.from_numpy(x)
    for gather, scatter in ((perm_gather_plain, perm_scatter_plain),
                            (perm_gather, perm_scatter)):
        got = gather(xt, idx)
        assert got.dtype == torch.uint8 and got.shape == xt.shape
        np.testing.assert_array_equal(got.numpy(), want_gather)
        np.testing.assert_array_equal(scatter(xt, idx).numpy(), want_scatter)
        np.testing.assert_array_equal(scatter(gather(xt, idx), idx).numpy(),
                                      x)


def test_wrappers_check_their_operands():
    idx = torch.arange(8, dtype=torch.int32)
    with pytest.raises(TypeError, match="uint8"):
        perm_gather(torch.zeros(8, dtype=torch.float32), idx)
    with pytest.raises(TypeError, match="int32"):
        perm_scatter(torch.zeros(8, dtype=torch.uint8), idx.long())
    with pytest.raises(ValueError, match="C in"):
        perm_gather(torch.zeros((8, 4), dtype=torch.uint8), idx)
    with pytest.raises(ValueError, match="index"):
        perm_gather(torch.zeros(9, dtype=torch.uint8), idx)
    with pytest.raises(ValueError, match="CUDA device"):
        perm_scatter(torch.zeros(8, dtype=torch.uint8, device="meta"),
                     idx.to("meta"))
    with pytest.raises(ValueError, match="expected"):
        device_index(np.zeros((2, 4), np.int64), torch.device("cpu"))
    assert all(v == 0 for v in _build.LAUNCHES.values())


@pytest.mark.parametrize("kind", ["u8", "integral", "fractional"])
def test_pack_channel_checks_in_pixel_order(kind):
    """pack_channel returns the pixel-order u8 copy and the packed channel
    gathered from it; a channel that is not 8-bit keeps its dtype."""
    rng = np.random.default_rng(3)
    chan = rng.integers(0, 256, (37, 53)).astype(np.float32)
    if kind == "u8":
        chan = chan.astype(np.uint8)
    elif kind == "fractional":
        chan[3, 4] += 0.5
    perm = _perm("grid")
    packed, flat_u8 = pack_channel(chan, perm)
    np.testing.assert_array_equal(packed, chan.reshape(-1)[perm])
    if kind == "fractional":
        assert flat_u8 is None and packed.dtype == np.float32
        return
    assert packed.dtype == np.uint8 and flat_u8.dtype == np.uint8
    np.testing.assert_array_equal(flat_u8, chan.reshape(-1))
    assert not np.shares_memory(flat_u8, chan)


@pytest.mark.parametrize("call", ["denoise", "enhance", "train_and_enhance"])
def test_edits_match_host_indexing(call):
    """Each u8 edit is byte-equal to the same filter edited through host
    fancy indexing (enhance: the cached training channel and another
    frame's)."""
    img = _frame(1)
    lab = bgr_to_lab_u8_np(img)
    f = NLEFilter(device="cpu")
    if call == "denoise":
        f.train_for_denoise(img, *ARGS, *SIGMAS)
        got = [f.denoise(img, SHRINK, *SIGMAS)]
        out = lab.copy()
        out[..., 0] = f._bilateral_L(lab, *SIGMAS)
        out[..., 1:] = _host_edit(f.trained, np.ascontiguousarray(
            lab[..., 1:]), shrink_eigenvalues(f.trained.eigvals, SHRINK))
        want = [lab_to_bgr_u8_np(out)]
    else:
        if call == "enhance":
            f.train_for_enhancement(img, *ARGS)
            other = _frame(2)
            got = [f.enhance(img, WEIGHTS), f.enhance(other, WEIGHTS)]
            frames = (img, other)
        else:
            got = [f.train_and_enhance(img, *ARGS, WEIGHTS)]
            frames = (img,)
        fs = transform_eigenvalues(f.trained.eigvals, WEIGHTS)
        want = []
        for frame in frames:
            out = bgr_to_lab_u8_np(frame)
            out[..., 0] = _host_edit(f.trained, out[..., 0], fs)
            want.append(lab_to_bgr_u8_np(out))
    for a, b in zip(got, want):
        assert a.dtype == np.uint8 and np.array_equal(a, b)


def test_y_cache_is_in_pixel_order_and_a_hit_uploads_nothing(monkeypatch):
    img = _frame(3)
    f = NLEFilter(device="cpu")
    t = f.train_for_enhancement(img, *ARGS)
    cached_np, cached_dev = t.y_cache
    L = bgr_to_lab_u8_np(img)[..., 0].reshape(-1)
    np.testing.assert_array_equal(cached_np, L)
    np.testing.assert_array_equal(cached_dev.numpy(), L[t.perm])
    calls = []
    real = {name: getattr(fmod, name)
            for name in ("upload", "perm_gather", "perm_scatter")}
    for name, fn in real.items():
        monkeypatch.setattr(fmod, name, lambda *a, _n=name, _f=fn, **kw:
                            calls.append(_n) or _f(*a, **kw))
    f.enhance(img, WEIGHTS)
    assert calls == ["perm_scatter"]         # no upload, no gather
    calls.clear()
    f.enhance(_frame(4), WEIGHTS)
    assert calls == ["upload", "perm_gather", "perm_scatter"]


def test_perm_index_is_built_once_counted_and_dropped_off_device():
    img = _frame(5)
    f = NLEFilter(device="cpu")
    t = f.train_for_enhancement(img, *ARGS)
    assert t.perm_index is None
    before = t.nbytes()
    f.enhance(img, WEIGHTS)
    idx = t.perm_index
    assert idx.dtype == torch.int32 and np.array_equal(idx.numpy(), t.perm)
    # Counted before it is built: the edit adds nothing to nbytes.
    assert t.nbytes() == before == (
        t.eigvecs.numel() * 4 + t.eigvals.numel() * 4 + t.perm.nbytes
        + idx.numel() * 4 + 2 * t.n_pixels)
    f.enhance(_frame(6), WEIGHTS)
    assert t.perm_index is idx                   # built once
    plain = TrainedFilter(t.eigvecs, t.eigvals, t.nrows, t.ncols,
                          perm=t.perm)
    assert plain == t                            # not compared
    assert t.to("cpu").perm_index is idx
    # "cpu:0" names the device its tensors report as "cpu" (as "cuda"
    # and "cuda:0"): both caches stay.
    moved = t.to(torch.device("cpu", 0))
    assert moved.perm_index is idx and moved.y_cache is t.y_cache
    away = dataclasses.replace(t, perm_index=idx.to("meta"))
    assert away.to("cpu").perm_index is None


def test_serving_account_is_unchanged_by_a_following_edit():
    """The serving store reads a filter's bytes once, at insert: the
    edits that follow (the index's build, a channel that misses the
    cache) add nothing to them."""
    from nle_tpu_torch.serving.http import _FilterStore

    img = _frame(7)
    f = NLEFilter(device="cpu")
    f.train_for_enhancement(img, *ARGS)
    at_insert = _FilterStore._account(f)
    f.enhance(img, WEIGHTS)
    f.enhance(_frame(8), WEIGHTS)
    f.denoise(_frame(9), SHRINK, *SIGMAS)
    assert f.trained.perm_index is not None
    assert _FilterStore._account(f) == at_insert > 0


@pytest.mark.parametrize("options, plain", [
    ({}, False),
    ({"use_kernels": False}, True),
    ({"dtype": torch.float64}, True),
])
def test_the_plain_routes_permute_with_the_plain_versions(
        monkeypatch, options, plain):
    """use_kernels=False and the float64 route run no hand-written
    kernel, their edits' gather and scatter included: every permutation
    of their edits asks for the plain versions, and the kernel route's for
    the kernels."""
    seen = []
    for name in ("perm_gather", "perm_scatter"):
        real = getattr(fmod, name)
        monkeypatch.setattr(fmod, name, lambda *a, _f=real, **kw:
                            seen.append(kw["plain"]) or _f(*a, **kw))
    img = _frame(10)
    f = NLEFilter(device="cpu", **options)
    f.train_and_enhance(img, *ARGS, WEIGHTS)
    f.enhance(_frame(11), WEIGHTS)
    f.denoise(img, SHRINK, *SIGMAS)
    # The fused edit's scatter, then a gather and a scatter an edit.
    assert seen == [plain] * 5


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 3])
def test_cuda_kernel_matches_plain_twin(cuda, c):
    """Both modes bit for bit the plain version on the card, on the 8 MP
    frame's sample grid (3264 x 2448 at 10 x 10 samples) and on a ragged
    random permutation."""
    for perm in (sample_grid(2448, 3264, 10, 10).perm, _perm("random")):
        n = perm.size
        x = torch.from_numpy(_rows(n, c, seed=c)).to(cuda)
        idx = device_index(perm, cuda)
        for kernel, plain, name in (
                (perm_gather, perm_gather_plain, "perm_gather_u8"),
                (perm_scatter, perm_scatter_plain, "perm_scatter_u8")):
            _build.reset_launches()
            got = kernel(x, idx)
            torch.cuda.synchronize()
            assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
                name: 1}
            assert torch.equal(got, plain(x, idx))
            # The plain routes' request: the plain version, no launch.
            _build.reset_launches()
            assert torch.equal(kernel(x, idx, plain=True), got)
            assert not any(_build.LAUNCHES.values())
