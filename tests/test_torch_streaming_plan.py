"""The launch plan of the port's one-build half-step (K8's kernel, which
also serves K9 up to Ppad 4096) and the wrapper's dispatch by shape, on
the CPU: the plan is pure Python and the launch is checked against a
stand-in for the kernel library, so no card is needed. The kernel itself
is held against its plain version on the card by chip_smoke.py."""

from __future__ import annotations

import contextlib
import os
import re

import numpy as np
import pytest
import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import streaming_kernel as tsk

PPADS = (128, 640, 1792, 2176, 4096)
# 32 rows; a TILE_Q multiple; the 1 MP, 4 MP, 16 MP and 32 MP frames' Qpad.
QPADS = (32, 512, 1011712, 3998208, 15998464, 31990272)
SMEM_LIMIT = 232448            # a Hopper block's shared memory, bytes
CSRC = os.path.join(os.path.dirname(tsk.__file__), "..", "..", "csrc",
                    "streaming.cu")


@pytest.mark.parametrize("ppad", PPADS)
@pytest.mark.parametrize("qpad", QPADS)
def test_plan_covers_every_row_and_column_once(qpad, ppad):
    """Thread t's columns t * cols + c (c < cols, those < Ppad) cover
    every sample column once (the dead ones past Ppad fall on the last
    threads); the blocks' contiguous row ranges cover every row once in
    whole 32-row chunks (an even number of row groups each), at most 1056
    blocks."""
    plan = tsk.halfstep_plan(qpad, ppad)
    cols = (np.arange(plan.threads)[:, None] * plan.cols
            + np.arange(plan.cols)[None]).ravel()
    seen = np.bincount(cols[cols < ppad], minlength=ppad)
    assert np.array_equal(seen, np.ones(ppad, np.int64))
    # The fewest whole warps for cols columns a thread.
    assert plan.threads == -(-(-(-ppad // plan.cols)) // 32) * 32
    begins = np.arange(plan.blocks) * plan.per_block
    ends = np.minimum(begins + plan.per_block, qpad)
    assert begins[0] == 0 and ends[-1] == qpad
    assert np.array_equal(begins[1:], ends[:-1])
    rows = ends - begins
    assert (rows > 0).all() and (rows % tsk.HS_ROW_GRAIN == 0).all()
    assert ((rows // plan.rows) % 2 == 0).all()
    assert plan.blocks <= tsk.HS_MAX_BLOCKS


@pytest.mark.parametrize("ppad", PPADS)
def test_plan_fits_a_hopper_block(ppad):
    """Shared bytes (the ring of staged pixel rows, two groups' x and each
    warp's sums of w) within the 227 KB a block may use; (cols, rows,
    threads) one of the kernel's instantiations, within its launch
    bound."""
    plan = tsk.halfstep_plan(31990272, ppad)
    assert plan.shared_bytes <= SMEM_LIMIT
    assert plan.shared_bytes == (16 * tsk.HS_RING * 32
                                 + 4 * 2 * plan.rows * (1 + plan.threads // 32))
    assert (plan.cols, plan.rows, plan.threads) in {
        (c, g, t) for c, g, most in tsk.HS_TILES for t in range(32, most + 1, 32)}


def test_plan_is_a_function_of_the_shapes_alone(monkeypatch):
    """The partials, and the order they are summed in, do not depend on
    the card: the plan reads nothing of the device."""
    want = {(q, p): tsk.halfstep_plan(q, p) for q in QPADS for p in PPADS}

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "get_device_name", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert {k: tsk.halfstep_plan(*k) for k in want} == want


@pytest.mark.parametrize("qpad,ppad", [(0, 640), (48, 640), (512, 0),
                                       (512, 100), (512, 4224), (512, 8192)])
def test_plan_raises_on_shapes_the_kernel_cannot_take(qpad, ppad):
    with pytest.raises(ValueError):
        tsk.halfstep_plan(qpad, ppad)


def test_plan_mirrors_the_kernel_source():
    """The plan's constants are those of csrc/streaming.cu: the blocks'
    row rule (ST_MAX_BLOCKS, ST_ROW_GRAIN), ap's 32-row chunks, the ring,
    and the instantiations (cols, rows, most threads) with their launch
    bounds."""
    with open(CSRC) as fh:
        src = fh.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("ST_MAX_BLOCKS") == tsk.HS_MAX_BLOCKS
    assert const("ST_ROW_GRAIN") == tsk.HS_ROW_GRAIN
    assert const("HS_SUM_ROWS") == tsk.HS_ROW_GRAIN
    assert const("HS_RING") == tsk.HS_RING
    assert const("HS_SEGMENT") == tsk.HS_SEGMENT
    tiles = re.search(r"#define HS_TILES\(X\) (.*)", src).group(1)
    assert tuple(tuple(int(v) for v in t) for t in re.findall(
        r"X\((\d+), (\d+), (\d+)\)", tiles)) == tsk.HS_TILES
    assert "__launch_bounds__(HsTile<C, G>::kMaxThreads)" in src


def test_every_plan_sums_w_in_one_order():
    """w's order of adds is one tree over the sample index at every plan:
    a thread's columns are an aligned subtree (cols a power of two), and
    HS_SEGMENT samples, the leaves of the Kahan sum, are one warp's
    columns or an aligned pair of warps'. The plan takes the tiles in
    order, the first that holds Ppad."""
    for cols, _, _ in tsk.HS_TILES:
        assert cols >= 2 and cols & (cols - 1) == 0
        assert tsk.HS_SEGMENT // (32 * cols) in (1, 2)
        assert tsk.HS_SEGMENT % (32 * cols) == 0
    want = {640: (4, 4), 2176: (4, 4), 2560: (4, 4), 2688: (8, 4),
            3072: (8, 4), 3200: (8, 2), 4096: (8, 2)}
    for ppad, tile in want.items():
        plan = tsk.halfstep_plan(1024, ppad)
        assert (plan.cols, plan.rows) == tile, ppad


def test_the_fused_dispatch_is_unchanged():
    """The JAX dispatch stays: K8's contract up to Ppad 1792, K9 past it;
    the one-build kernel serves both up to 4096 and two passes run only
    past it, by Ppad alone."""
    assert tsk.MAX_STREAM_P_FUSED == 1792
    for ppad in range(128, tsk.HS_MAX_PPAD + 1, 128):
        assert tsk.halfstep_route(ppad) == "one_build"
    for ppad in (4224, 6144, 8192, 16384):
        assert tsk.halfstep_route(ppad) == "two_pass"


class _FakeLib:
    """Stands in for the kernel library: records each call, returns a
    status."""

    def __init__(self, status=0):
        self.calls = []
        self.status = status

    def __getattr__(self, name):
        if not name.startswith("nle_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return self.status

        return fn


@pytest.fixture()
def fake_card(monkeypatch):
    """The wrappers' CUDA branch on CPU tensors, against _FakeLib."""
    lib = _FakeLib()
    monkeypatch.setattr(tsk, "cuda_or_cpu", lambda *a, **k: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    _build.reset_launches()
    yield lib
    _build.reset_launches()


def _operands(qpad, ppad):
    return (torch.zeros((3, ppad)), torch.zeros((3, qpad)),
            torch.ones((1, qpad)), torch.zeros(ppad))


@pytest.mark.parametrize("ppad,entry,counter", [
    (640, "streaming_halfstep", "streaming_halfstep"),
    (1792, "streaming_halfstep", "streaming_halfstep"),
    (2176, "streaming_halfstep", "streaming_halfstep_ptiled"),
    (4096, "streaming_halfstep_ptiled", "streaming_halfstep_ptiled"),
])
def test_the_launch_reads_the_plan(fake_card, ppad, entry, counter):
    """Both entry points reach the one-build kernel with halfstep_plan's
    numbers as they are, once per half-step, counted under the kernel's
    name; the partial scratch has the plan's block count."""
    qpad = 1024
    x, ap = getattr(tsk, entry)(*_operands(qpad, ppad), 0.1, 0.2, 1e-10)
    plan = tsk.halfstep_plan(qpad, ppad)
    [(name, args)] = fake_card.calls
    assert name == "nle_stream_halfstep_onebuild"
    assert args[7:15] == (qpad, ppad, *plan)
    assert args[15:18] == (0.1, 0.2, 1e-10)
    assert x.shape == (qpad,) and ap.shape == (ppad,)
    assert _build.LAUNCHES[counter] == 1
    assert sum(_build.LAUNCHES.values()) == 1


def test_two_passes_only_past_4096(fake_card):
    """Past HS_MAX_PPAD the same entry point runs K9's two passes."""
    tsk.streaming_halfstep(*_operands(1024, 4224), 0.1, 0.2, 1e-10)
    [(name, args)] = fake_card.calls
    assert name == "nle_stream_halfstep_ptiled"
    assert args[7:9] == (1024, 4224)
    assert _build.LAUNCHES["streaming_halfstep_ptiled"] == 1


def test_unit_x_is_k10s_kernel_on_the_mask(fake_card):
    """K8's s0 pass (unit_x): x is the mask and ap is K10's kernel (R = 1)
    on it, counted as K8's launch; no one-build kernel."""
    fa, fb, mask, u = _operands(1024, 640)
    x, ap = tsk.streaming_halfstep(fa, fb, mask, u, 0.1, 0.2, 1e-10,
                                   unit_x=True)
    [(name, args)] = fake_card.calls
    assert name == "nle_stream_ap" and args[5:8] == (1024, 640, 1)
    assert x is mask[0] or torch.equal(x, mask[0])
    assert ap.shape == (640,)
    assert _build.LAUNCHES["streaming_halfstep"] == 1


def test_a_failed_launch_raises(fake_card):
    """No fallback: a status other than 0 raises and counts nothing."""
    fake_card.status = 1
    with pytest.raises(RuntimeError, match="streaming_halfstep_ptiled"):
        tsk.streaming_halfstep_ptiled(*_operands(1024, 2176), 0.1, 0.2,
                                      1e-10)
    assert sum(_build.LAUNCHES.values()) == 0


# -- on the card --------------------------------------------------------------

SW = float(np.float32(1e-4))
PW = float(np.float32(1e-3))
EPS = 1e-10
RTOL = 1e-5


def _card_operands(p, q, ppad, seed):
    """Integer features of p samples and q rest pixels on the card, the
    samples zero-padded to ppad, and u (zero past p)."""
    rng = np.random.default_rng(seed)
    fa = torch.from_numpy(rng.integers(0, 64, (p, 3)).astype(np.float32))
    fb = torch.from_numpy(rng.integers(0, 64, (q, 3)).astype(np.float32))
    fa_rows, fb_cols, mask = (t.cuda() for t in
                              tsk.pad_stream_operands(fa, fb))
    fa_rows = torch.nn.functional.pad(fa_rows, (0, ppad - fa_rows.shape[1]))
    u = torch.zeros(ppad)
    u[:p] = torch.from_numpy(rng.uniform(0.5, 1.5, p).astype(np.float32)
                             * 1e-3)
    return fa_rows.contiguous(), fb_cols, mask, u.cuda()


@pytest.mark.cuda
def test_cuda_halfstep_is_bitwise_the_same_at_every_ppad_and_plan():
    """x and ap[:p] of the one-build kernel on p = 600 samples zero-padded
    to Ppad 640 ... 4096 (plans of 4 and 8 columns a thread, 2 and 4 rows
    a group): bitwise the same, and within RTOL of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    p, q = 600, 5000
    plans, ref = set(), None
    _build.reset_launches()
    for ppad in (640, 1024, 1792, 2176, 3072, 4096):
        fa_rows, fb_cols, mask, u = _card_operands(p, q, ppad, 7)
        plan = tsk.halfstep_plan(fb_cols.shape[1], ppad)
        plans.add((plan.cols, plan.rows))
        x, ap = tsk.streaming_halfstep_ptiled(fa_rows, fb_cols, mask, u, SW,
                                              PW, EPS)
        if ref is None:
            ref = (x, ap[:p])
            xp, app = tsk.streaming_halfstep_ptiled_plain(
                fa_rows, fb_cols, mask, u, SW, PW, EPS)
            torch.testing.assert_close(x, xp, rtol=RTOL, atol=0)
            torch.testing.assert_close(ap[:p], app[:p], rtol=RTOL, atol=0)
        assert torch.equal(x, ref[0]) and torch.equal(ap[:p], ref[1]), ppad
    assert plans == {(4, 4), (8, 4), (8, 2)}
    assert _build.LAUNCHES["streaming_halfstep_ptiled"] == 6


@pytest.mark.cuda
def test_cuda_two_passes_past_4096_match_the_plain_version():
    """Ppad 4224 (p = 4200) runs K9's two passes: x and ap within RTOL of
    the plain version, two launches bitwise equal, each counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    p, q = 4200, 5000
    fa_rows, fb_cols, mask, u = _card_operands(p, q, 4224, 11)
    assert tsk.halfstep_route(4224) == "two_pass"
    _build.reset_launches()
    x, ap = tsk.streaming_halfstep(fa_rows, fb_cols, mask, u, SW, PW, EPS)
    x2, ap2 = tsk.streaming_halfstep(fa_rows, fb_cols, mask, u, SW, PW, EPS)
    assert torch.equal(x, x2) and torch.equal(ap, ap2)
    xp, app = tsk.streaming_halfstep_ptiled_plain(fa_rows, fb_cols, mask, u,
                                                  SW, PW, EPS)
    torch.testing.assert_close(x, xp, rtol=RTOL, atol=0)
    torch.testing.assert_close(ap[:p], app[:p], rtol=RTOL, atol=0)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "streaming_halfstep_ptiled": 2}
