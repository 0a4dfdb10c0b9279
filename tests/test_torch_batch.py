"""Stream mode of the port (nle_tpu_torch/models/batch.py) on the CPU:
every test of tests/test_batch.py mirrored on the port, the port's stream
edits bitwise equal to its single mode, and against nle_tpu's
train_filters_iter + NLEFilter(trained=...).enhance on the same seeded
frames (>= 45 dB, the bar of tests/test_torch_slice.py)."""

import numpy as np
import pytest
import torch

from nle_tpu.color.lab import bgr_to_lab_u8_np as j_bgr_to_lab
from nle_tpu.models import batch as jbatch
from nle_tpu.models.filter import NLEFilter as JaxNLEFilter
from nle_tpu_torch.models import batch as tbatch
from nle_tpu_torch.models.filter import NLEFilter
from nle_tpu_torch.ops.pipeline import apply_filter, train_filter
from nle_tpu_torch.ops.transform import transform_eigenvalues

ARGS = (4, 5, 40.0, 20.0, 8, 4)       # test_batch.py's size
WEIGHTS = [1.0, 2.0, 1.5, 1.2]


def _chans(seed, n, shape=(30, 40)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape).astype(np.float32) for _ in range(n)]


def _frames(seed, n, h=30, w=40):
    """Structured BGR frames (tests/test_torch_slice.py's _frame), each
    with its own noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = 120 + 60 * np.sin(xx / 5.0) + 40 * np.cos(yy / 4.0)
    out = []
    for _ in range(n):
        img = np.stack([base + rng.normal(0, 6, (h, w)) + 10 * c
                        for c in range(3)], axis=-1)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _pixel_rows(flt):
    V = flt.eigvecs.numpy()
    out = np.empty_like(V)
    out[flt.perm] = V
    return out


def _assert_matches_single(chans, flts):
    """test_batch.py's check: eigenvalues and the filter action of each
    stream filter against train_filter on its channel."""
    for chan, flt in zip(chans, flts):
        V1, S1 = train_filter(chan, *ARGS, device="cpu")
        np.testing.assert_allclose(flt.eigvals.numpy(), S1.numpy(),
                                   rtol=1e-5, atol=1e-8)
        fS = transform_eigenvalues(S1, WEIGHTS)
        c = torch.from_numpy(chan)
        out_p = apply_filter(torch.from_numpy(_pixel_rows(flt)), fS, c)
        out_1 = apply_filter(V1, fS, c)
        assert float((out_p - out_1).abs().max()) < 1e-3


def test_pipelined_matches_single():
    chans = _chans(5, 3)
    flts = tbatch.train_filters_pipelined(chans, *ARGS, device="cpu")
    _assert_matches_single(chans, flts)


def test_past_capacity_falls_back_to_sequential(monkeypatch):
    monkeypatch.setattr(tbatch, "fits_pipeline", lambda *a, **k: False)
    chans = _chans(6, 2)
    flts = tbatch.train_filters_pipelined(chans, *ARGS, device="cpu")
    _assert_matches_single(chans, flts)
    assert all(f.y_cache is not None for f in flts)


def test_iter_is_lazy_on_streaming_producers():
    frames = _chans(0, 6, (20, 24))
    pulled = []

    def producer():
        for i, f in enumerate(frames):
            pulled.append(i)
            yield f

    it = tbatch.train_filters_iter(producer(), 3, 4, 100.0, 30.0, 3, 3,
                                   device="cpu")
    first = next(it)
    assert first.eigvecs.shape[0] == 20 * 24
    assert len(pulled) <= 3, pulled   # first + lookahead, not the stream
    rest = list(it)
    assert len(rest) == 5 and len(pulled) == 6


def test_iter_mixed_shapes_raise():
    frames = _chans(1, 1, (20, 24)) + _chans(1, 1, (24, 20))
    with pytest.raises(ValueError, match="same-shape"):
        list(tbatch.train_filters_iter(frames, 3, 4, 100.0, 30.0, 3, 3,
                                       device="cpu"))


def test_iter_degenerate_stage1_raises_cleanly():
    bad = np.full((20, 24), np.nan, np.float32)
    with pytest.raises(ValueError):
        list(tbatch.train_filters_iter([bad], 3, 4, 100.0, 30.0, 3, 3,
                                       device="cpu"))


def test_zero_rank_stage1_raises_the_clean_error(monkeypatch):
    """m == 0 (unreachable for finite inputs, trace(Ka) = p) raises
    train_filter's own error from submit, never a zero-width stage 2."""
    from nle_tpu_torch.ops import pipeline

    monkeypatch.setattr(pipeline, "ka_eigh_host64", lambda *a: (
        np.zeros((12, 0)), np.zeros(0), np.zeros((12, 0))))
    with pytest.raises(ValueError, match="no eigenvalues above eps"):
        list(tbatch.train_filters_iter(_chans(2, 1, (20, 24)), 3, 4, 100.0,
                                       30.0, 3, 3, device="cpu"))


def _reuse_chans(seed):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (30, 40)).astype(np.float32)
    other = rng.integers(0, 256, (30, 40)).astype(np.float32)
    return [base, np.clip(base + 1, 0, 255), other, np.clip(other + 1, 0, 255)]


def test_reuse_delta_warm_start():
    chans = _reuse_chans(7)
    flts = list(tbatch.train_filters_iter(chans, *ARGS, device="cpu",
                                          reuse_delta=3.0))
    assert len(flts) == 4
    assert flts[1] is flts[0]          # within threshold -> reused
    assert flts[2] is not flts[0]      # big change -> retrained
    assert flts[3] is flts[2]          # near the NEW reference -> reused
    flts0 = list(tbatch.train_filters_iter(chans, *ARGS, device="cpu"))
    assert all(a is not b for a, b in zip(flts0, flts0[1:]))


def test_reuse_delta_casts_u8_before_the_difference():
    """uint8 channels are cast to float32 before the subtraction: a
    difference taken in uint8 would wrap (1 - 2 = 255) and miss."""
    base = np.random.default_rng(3).integers(1, 255, (30, 40)).astype(np.uint8)
    chans = [base, base - 1]
    flts = list(tbatch.train_filters_iter(chans, *ARGS, device="cpu",
                                          reuse_delta=1.0))
    assert flts[1] is flts[0]


def test_reuse_delta_sequential_fallback(monkeypatch):
    monkeypatch.setattr(tbatch, "fits_pipeline", lambda *a, **k: False)
    chans = _reuse_chans(8)[:2]
    flts = list(tbatch.train_filters_iter(chans, *ARGS, device="cpu",
                                          reuse_delta=3.0))
    assert flts[1] is flts[0]


def test_lookahead_schedules_match():
    chans = _chans(9, 4)
    f1 = list(tbatch.train_filters_iter(chans, *ARGS, device="cpu",
                                        lookahead=1))
    f2 = list(tbatch.train_filters_iter(chans, *ARGS, device="cpu",
                                        lookahead=2))
    assert len(f1) == len(f2) == 4
    for a, b in zip(f1, f2):
        assert torch.equal(a.eigvals, b.eigvals)
        assert torch.equal(a.eigvecs, b.eigvecs)


def test_lookahead_from_the_environment(monkeypatch):
    """NLE_STREAM_LOOKAHEAD applies when lookahead is None: with 2, the
    first filter comes after three frames were pulled."""
    monkeypatch.setenv("NLE_STREAM_LOOKAHEAD", "2")
    frames = _chans(4, 5, (20, 24))
    pulled = []

    def producer():
        for f in frames:
            pulled.append(1)
            yield f

    it = tbatch.train_filters_iter(producer(), 3, 4, 100.0, 30.0, 3, 3,
                                   device="cpu")
    next(it)
    assert len(pulled) == 3
    assert len(list(it)) == 4


def _stream_edits(frames, args, weights, lookahead=1):
    """The bench's flow, in order on one thread: Lab channels into the
    port's stream mode, each filter edited through NLEFilter(trained=...)
    with the producer's Lab seeded."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np

    labs = [bgr_to_lab_u8_np(f) for f in frames]
    outs = []
    for i, flt in enumerate(tbatch.train_filters_iter(
            [lab[..., 0].astype(np.float32) for lab in labs], *args,
            device="cpu", lookahead=lookahead)):
        f = NLEFilter(trained=flt, device="cpu")
        f.seed_lab_cache(frames[i], labs[i])
        outs.append(f.enhance(frames[i], weights))
    return outs


@pytest.mark.parametrize("lookahead", [1, 2])
def test_stream_edits_equal_single_mode_bitwise(lookahead):
    frames = _frames(11, 3)
    outs = _stream_edits(frames, ARGS, WEIGHTS, lookahead)
    for frame, out in zip(frames, outs):
        single = NLEFilter(device="cpu").train_and_enhance(
            frame, *ARGS, weights=WEIGHTS)
        np.testing.assert_array_equal(out, single)


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def test_stream_edits_match_nle_tpu():
    """The golden gate: the port's stream edits against nle_tpu's stream
    mode and NLEFilter(trained=...).enhance on the same frames (nle_tpu
    takes its "small" layout at this size, the port its split layout)."""
    frames = _frames(12, 3)
    outs = _stream_edits(frames, ARGS, WEIGHTS)
    chans = [j_bgr_to_lab(f)[..., 0].astype(np.float32) for f in frames]
    for frame, out, jflt in zip(frames, outs,
                                jbatch.train_filters_iter(chans, *ARGS)):
        want = JaxNLEFilter(trained=jflt).enhance(frame, WEIGHTS)
        db = _psnr(out, want)
        print(f"port stream vs nle_tpu stream: {db:.2f} dB")
        assert db >= 45.0, db


def test_fits_pipeline_rule(monkeypatch):
    """The capacity rule on the card, from NLE_STREAM_BYTES (no card
    needed): (lookahead + DENSE_PEAK_PER_PHI_BYTE) x phi <=
    DENSE_PEAK_PER_PHI_BYTE x the limit; never past MAX_MPAD; always on
    the CPU."""
    from nle_tpu_torch.ops.pipeline import DENSE_PEAK_PER_PHI_BYTE as K

    n, nr, nc = 832 * 1216, 20, 30
    phi = 4 * 1011712 * 640            # n is 494 x 2048 rows; p 600 -> 640
    for look in (1, 2, 3):
        limit = int((look + K) * phi / K)
        monkeypatch.setenv("NLE_STREAM_BYTES", str(limit + 1))
        assert tbatch.fits_pipeline(n, nr, nc, look, device="cuda")
        monkeypatch.setenv("NLE_STREAM_BYTES", str(limit - 1000))
        assert not tbatch.fits_pipeline(n, nr, nc, look, device="cuda")
    monkeypatch.setenv("NLE_STREAM_BYTES", str(1 << 60))
    assert not tbatch.fits_pipeline(n, 130, 130, device="cuda")
    monkeypatch.setenv("NLE_STREAM_BYTES", "0")
    assert tbatch.fits_pipeline(n, nr, nc, 8, device="cpu")


def test_stream_mode_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: device='cuda' is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        list(tbatch.train_filters_iter(_chans(0, 1, (20, 24)), 3, 4, 100.0,
                                       30.0, 3, 3))
