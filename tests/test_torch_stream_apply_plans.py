"""The launch plans of K10's and K11's kernels (the factored apply's two
kernels; K10's also serves the s0 pass and pass 2 of the two-pass K9,
K11's pass 1), their wrappers' launches, the plain K11's float64 sums and
the float64 half-step chip_smoke holds K8 against, on the CPU: the plans
are pure Python and each launch is checked against a stand-in for the
kernel library, so no card is needed. The kernels themselves are held
against their plain versions, and bit for bit against an earlier version,
on the card (chip_smoke.py, tools/affinity_ab.py)."""

from __future__ import annotations

import contextlib
import os
import re

import numpy as np
import pytest
import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import streaming_kernel as tsk
from nle_tpu_torch.tools import stream_precision as sp

PPADS = (128, 640, 1792, 2176, 4224, 6272)
# 32 rows; a TILE_Q multiple; the 1 MP, 4 MP, 16 MP and 32 MP frames' Qpad.
QPADS = (32, 512, 1011712, 3998208, 15998464, 31990272)
ROWS = (1, 2, 3)
SMEM_LIMIT = 232448            # a Hopper block's shared memory, bytes
REGISTERS = 65536              # an SM's 32-bit registers
CSRC = os.path.join(os.path.dirname(tsk.__file__), "..", "..", "csrc",
                    "streaming.cu")


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("ppad", PPADS)
@pytest.mark.parametrize("qpad", QPADS)
def test_ap_plan_covers_every_row_and_column_once(qpad, ppad, R):
    """Thread t of p-tile y owns the columns y * ptile + t * cols + c that
    lie in its tile: every sample column once, with the fewest whole warps
    a tile. The row ranges are the partials' rule (K8's, from Qpad alone):
    every row once, in whole 32-row chains, at most 1056 blocks."""
    plan = tsk.ap_plan(qpad, ppad, R)
    assert plan.ptile % plan.cols == 0
    assert plan.threads == -(-(plan.ptile // plan.cols) // 32) * 32
    assert plan.tiles == -(-ppad // plan.ptile)
    seen = np.zeros(ppad, np.int64)
    for y in range(plan.tiles):
        j = (y * plan.ptile + np.arange(plan.threads)[:, None] * plan.cols
             + np.arange(plan.cols)[None]).ravel()
        live = j < min((y + 1) * plan.ptile, ppad)
        seen += np.bincount(j[live], minlength=ppad)
    assert np.array_equal(seen, np.ones(ppad, np.int64))
    half = tsk.halfstep_plan(qpad, 640)
    assert (plan.blocks, plan.per_block) == (half.blocks, half.per_block)
    begins = np.arange(plan.blocks) * plan.per_block
    ends = np.minimum(begins + plan.per_block, qpad)
    assert begins[0] == 0 and ends[-1] == qpad
    assert np.array_equal(begins[1:], ends[:-1])
    assert ((ends - begins) % tsk.HS_ROW_GRAIN == 0).all()
    assert plan.blocks <= tsk.HS_MAX_BLOCKS


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("ppad", PPADS)
@pytest.mark.parametrize("qpad", QPADS)
def test_atb_plan_covers_every_row_and_sample_once(qpad, ppad, R):
    """Steps of threads x rows rows, strided over the blocks, cover every
    row once; the chunks cover every sample once, each a multiple of 32
    samples (so the 32-sample chains start at multiples of 32 from sample
    0 whatever the chunk), at most AT_CHUNK, in the fewest pieces."""
    plan = tsk.atb_plan(qpad, ppad, R)
    span = plan.threads * plan.rows
    steps = -(-qpad // span)
    assert 1 <= plan.blocks <= steps
    owner = np.arange(steps) % plan.blocks
    assert np.array_equal(np.bincount(owner, minlength=plan.blocks) > 0,
                          np.ones(plan.blocks, bool))
    i = (np.arange(steps)[:, None, None] * span
         + np.arange(plan.rows)[None, :, None] * plan.threads
         + np.arange(plan.threads)[None, None, :]).ravel()
    seen = np.bincount(i[i < qpad], minlength=qpad)
    assert np.array_equal(seen, np.ones(qpad, np.int64))
    assert plan.pchunk % 32 == 0
    assert plan.pchunk <= max(tsk.AT_CHUNK, 32 * -(-ppad // 32))
    nchunks = -(-ppad // plan.pchunk)
    assert nchunks == -(-ppad // tsk.AT_CHUNK)
    assert (nchunks - 1) * plan.pchunk < ppad <= nchunks * plan.pchunk


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("ppad", PPADS)
def test_plans_fit_a_hopper_block(ppad, R):
    """Shared bytes within the 227 KB a block may use (K10: the ring of
    AP_RING 32-row chunks of the 3 + R row arrays; K11: one or two chunk
    buffers, 16 + 8 R B a sample), threads within the
    instantiation's launch bound, and at least 64 registers a thread
    under it. K11's grid is what the SMs hold at once."""
    qpad = 31990272
    ap = tsk.ap_plan(qpad, ppad, R)
    _, cols, rows, most = tsk.AP_TILES[R - 1]
    assert (ap.cols, ap.rows) == (cols, rows) and ap.threads <= most
    assert REGISTERS // most >= 64
    assert ap.shared_bytes == 4 * tsk.AP_RING * (3 + R) * 32 <= SMEM_LIMIT
    atb = tsk.atb_plan(qpad, ppad, R)
    assert (atb.threads, atb.rows) == (tsk.AT_THREADS,
                                       tsk.AT_TILES[R - 1][1])
    assert REGISTERS // (tsk.AT_THREADS * tsk.AT_MIN_BLOCKS) >= 64
    nbuf = 2 if atb.pchunk < ppad else 1
    assert atb.shared_bytes == nbuf * atb.pchunk * (16 + 8 * R)
    assert atb.shared_bytes <= SMEM_LIMIT
    per_sm = atb.blocks // tsk.AT_SMS
    assert per_sm * (atb.shared_bytes + tsk.AT_BLOCK_RESERVED) \
        <= tsk.AT_SM_SHARED


def test_k10_plan_fills_an_sm_at_the_main_paths_ppad():
    """At Ppad 640 (the 1 MP and 32 MP paths) K10's R = 1 plan runs the
    1056 row ranges as eight blocks an SM of a 132-SM card, at least 32
    warps an SM, within the 64 registers a thread the launch bound
    gives."""
    plan = tsk.ap_plan(31990272, 640, 1)
    assert plan.tiles == 1 and plan.blocks == 8 * 132
    assert 8 * plan.threads // 32 >= 32
    assert 8 * plan.threads * 64 <= REGISTERS


def test_plans_are_functions_of_the_shapes_alone(monkeypatch):
    """The plans read nothing of the device."""
    keys = [(q, p, r) for q in QPADS for p in PPADS for r in ROWS]
    want = {k: (tsk.ap_plan(*k), tsk.atb_plan(*k)) for k in keys}

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "get_device_name", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert {k: (tsk.ap_plan(*k), tsk.atb_plan(*k)) for k in keys} == want


@pytest.mark.parametrize("plan", ["ap_plan", "atb_plan"])
@pytest.mark.parametrize("qpad,ppad,R", [
    (0, 640, 1), (48, 640, 1), (512, 0, 1), (512, 100, 1), (512, 640, 0),
    (512, 640, 4)])
def test_plans_raise_on_shapes_the_kernels_cannot_take(plan, qpad, ppad, R):
    with pytest.raises(ValueError):
        getattr(tsk, plan)(qpad, ppad, R)


def test_plans_mirror_the_kernel_source():
    """The plans' constants are csrc/streaming.cu's: K10's instantiations
    (R, cols, rows, most threads) with their launch bound and its ring;
    K11's rows by R, threads, blocks an SM the registers hold and chunk;
    the kernels' Ppad grain."""
    with open(CSRC) as fh:
        src = fh.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    def table(name, n):
        line = re.search(rf"#define {name}\(X\) (.*)", src).group(1)
        pat = r"X\(" + ", ".join([r"(\d+)"] * n) + r"\)"
        return tuple(tuple(int(v) for v in t) for t in re.findall(pat, line))

    assert table("AP_TILES", 4) == tsk.AP_TILES
    assert table("AT_TILES", 2) == tsk.AT_TILES
    assert const("AP_RING") == tsk.AP_RING
    assert const("AT_THREADS") == tsk.AT_THREADS
    assert const("AT_MIN_BLOCKS") == tsk.AT_MIN_BLOCKS
    assert const("ST_ATB_CHUNK") == tsk.AT_CHUNK
    assert const("ST_P_GRAIN") == tsk.ST_P_GRAIN
    assert "__launch_bounds__(ApTile<R>::kMaxThreads)" in src
    assert "__launch_bounds__(AT_THREADS, AT_MIN_BLOCKS)" in src


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


@pytest.mark.parametrize("R", ROWS)
@pytest.mark.parametrize("ppad", (640, 2176))
def test_k10_and_k11_launches_read_the_plans(fake_card, ppad, R):
    """streaming_ap and streaming_atb reach their C entries with
    ap_plan's and atb_plan's numbers as they are, once each, counted
    under their own names."""
    qpad = 1024
    fa, fb = torch.zeros((3, ppad)), torch.zeros((3, qpad))
    ap = tsk.streaming_ap(fa, fb, torch.zeros((R, qpad)), 0.1, 0.2)
    out = tsk.streaming_atb(fa, fb, torch.zeros((R, ppad)), 0.1, 0.2)
    (n10, a10), (n11, a11) = fake_card.calls
    assert n10 == "nle_stream_ap"
    assert a10[5:16] == (qpad, ppad, R, *tsk.ap_plan(qpad, ppad, R))
    assert a10[16:18] == (0.1, 0.2)
    assert n11 == "nle_stream_atb"
    assert a11[4:12] == (qpad, ppad, R, *tsk.atb_plan(qpad, ppad, R))
    assert a11[12:14] == (0.1, 0.2)
    assert ap.shape == (R, ppad) and out.shape == (R, qpad)
    assert {k: v for k, v in _build.LAUNCHES.items() if v} == {
        "streaming_ap": 1, "streaming_atb": 1}


@pytest.mark.parametrize("ppad,entry", [(2176, "two_pass_halfstep"),
                                        (4224, "streaming_halfstep")])
def test_two_passes_read_both_plans(fake_card, ppad, entry):
    """K9's two passes (forced, or past Ppad 4096) take atb_plan and then
    ap_plan at R = 1, in one call counted as K9's launch."""
    qpad = 1024
    args = (torch.zeros((3, ppad)), torch.zeros((3, qpad)),
            torch.ones((1, qpad)), torch.zeros(ppad), 0.1, 0.2, 1e-10)
    x, ap = getattr(tsk, entry)(*args)
    [(name, a)] = fake_card.calls
    assert name == "nle_stream_halfstep_ptiled"
    assert a[7:22] == (qpad, ppad, *tsk.atb_plan(qpad, ppad, 1),
                       *tsk.ap_plan(qpad, ppad, 1))
    assert a[22:25] == (0.1, 0.2, 1e-10)
    assert x.shape == (qpad,) and ap.shape == (ppad,)
    assert _build.LAUNCHES["streaming_halfstep_ptiled"] == 1
    assert sum(_build.LAUNCHES.values()) == 1


def test_unit_x_reads_the_ap_plan(fake_card):
    """K8's s0 pass is K10's kernel on the mask, on ap_plan at R = 1."""
    qpad, ppad = 1024, 640
    tsk.streaming_halfstep(torch.zeros((3, ppad)), torch.zeros((3, qpad)),
                           torch.ones((1, qpad)), torch.zeros(ppad), 0.1,
                           0.2, 1e-10, unit_x=True)
    [(name, a)] = fake_card.calls
    assert name == "nle_stream_ap"
    assert a[5:16] == (qpad, ppad, 1, *tsk.ap_plan(qpad, ppad, 1))


@pytest.mark.parametrize("entry", ["streaming_ap", "streaming_atb",
                                   "two_pass_halfstep"])
def test_a_failed_launch_raises(fake_card, entry):
    """No fallback: a status other than 0 raises and counts nothing."""
    fake_card.status = 1
    qpad, ppad = 1024, 640
    fa, fb = torch.zeros((3, ppad)), torch.zeros((3, qpad))
    args = {"streaming_ap": (fa, fb, torch.zeros((1, qpad)), 0.1, 0.2),
            "streaming_atb": (fa, fb, torch.zeros((1, ppad)), 0.1, 0.2),
            "two_pass_halfstep": (fa, fb, torch.ones((1, qpad)),
                                  torch.zeros(ppad), 0.1, 0.2, 1e-10)}[entry]
    with pytest.raises(RuntimeError, match="failed to launch"):
        getattr(tsk, entry)(*args)
    assert sum(_build.LAUNCHES.values()) == 0


def test_plain_k11_sums_a_cancelling_b_in_float64():
    """streaming_atb_plain sums its Ppad terms in float64, as the ap twins
    do: with every entry 1 (pixels and samples on one feature point) and
    b = [2^30, 1 x 64, -2^30], each row's sum is 64 exactly; an fp32 chain
    loses the ones to 2^30's spacing (128) and ends at 0."""
    p, q = 66, 40
    fa = torch.full((p, 3), 7.0)
    fb = torch.full((q, 3), 7.0)
    fa_rows, fb_cols, _ = tsk.pad_stream_operands(fa, fb)
    b = torch.zeros(fa_rows.shape[1])
    b[0], b[1:65], b[65] = 2.0 ** 30, 1.0, -(2.0 ** 30)
    chain = np.float32(0)
    for v in b[:p].numpy():
        chain = np.float32(chain + v)
    assert chain == 0.0
    out = tsk.streaming_atb_plain(fa_rows, fb_cols, b, 1e-3, 1e-2)
    assert out.dtype == torch.float32 and out.shape == (1, fb_cols.shape[1])
    assert torch.equal(out[0, :q], torch.full((q,), 64.0))
    # The two-pass K9's plain twin takes its w from it.
    x, _ = tsk.streaming_halfstep_ptiled_plain(
        fa_rows, fb_cols, torch.ones((1, fb_cols.shape[1])), b, 1e-3, 1e-2,
        1e-10)
    assert torch.equal(x[:q], torch.full((q,), 1.0 / 64.0))


@pytest.mark.parametrize("seed", (0, 1))
def test_float64_halfstep_is_the_plain_version_in_float64(seed):
    """The float64 half-step chip_smoke's K8 gate reads (and the float64
    twin's loop runs on): on integer features its entries are bitwise the
    plain version's in float64, its x and ap those of the two-pass plain
    twin in float64 to 1e-12 (another association), and u None is the s0
    pass. Non-integer features are refused."""
    rng = np.random.default_rng(seed)
    p, q = 150, 2000

    def feats(n):
        return np.stack([rng.integers(0, 2000, n), rng.integers(0, 2000, n),
                         rng.integers(0, 256, n)], 1).astype(np.float64)

    fa_rows, fb_cols, mask = tsk.pad_stream_operands(
        torch.from_numpy(feats(p)), torch.from_numpy(feats(q)))
    mask = mask.double()
    sw, pw = 1.0 / 500.0 ** 2, 1.0 / 10.0 ** 2
    assert torch.equal(sp.affinity64_rows(torch, fa_rows, fb_cols, 100, 900,
                                          sw, pw),
                       tsk._affinity_rows(fa_rows, fb_cols, 100, 900, sw, pw))
    u = torch.zeros(fa_rows.shape[1], dtype=torch.float64)
    u[:p] = torch.from_numpy(rng.uniform(0.5, 1.5, p))
    half = sp.halfstep64(torch, fa_rows, fb_cols, mask, sw, pw, 1e-10)
    x, ap = half(u)
    xp, app = tsk.streaming_halfstep_ptiled_plain(fa_rows, fb_cols, mask, u,
                                                  sw, pw, 1e-10)
    torch.testing.assert_close(x, xp, rtol=1e-12, atol=0)
    torch.testing.assert_close(ap[:p], app[:p], rtol=1e-12, atol=0)
    x0, ap0 = half(None)
    assert torch.equal(x0, mask[0])
    torch.testing.assert_close(
        ap0[:p], tsk.streaming_ap_plain(fa_rows, fb_cols, mask, sw, pw)[0, :p],
        rtol=1e-12, atol=0)
    with pytest.raises(ValueError):
        sp.halfstep64(torch, fa_rows + 0.5, fb_cols, mask, sw, pw, 1e-10)


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_k10_k11_match_the_plain_versions_at_every_plan():
    """K10 and K11 at R = 1, 2, 3 on integer features, at Ppads of one and
    several p-tiles and sample chunks: within 1e-6 of the float64 plain
    versions, relative to the sums of absolute terms."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    f64 = torch.float64
    for p, q, ppad, seed in ((600, 5000, 640, 1), (2112, 7000, 2176, 2),
                             (1200, 900, 6272, 3)):
        rng = np.random.default_rng(seed)
        fa = torch.from_numpy(rng.integers(0, 64, (p, 3)).astype(np.float32))
        fb = torch.from_numpy(rng.integers(0, 64, (q, 3)).astype(np.float32))
        fa_rows, fb_cols, mask = (t.cuda() for t in
                                  tsk.pad_stream_operands(fa, fb))
        fa_rows = torch.nn.functional.pad(
            fa_rows, (0, ppad - fa_rows.shape[1])).contiguous()
        qpad = fb_cols.shape[1]
        X = torch.from_numpy(rng.uniform(-1, 1, (3, qpad)).astype(
            np.float32)).cuda() * mask
        B = torch.zeros((3, ppad), device="cuda")
        B[:, :p] = torch.from_numpy(rng.uniform(-1, 1, (3, p)).astype(
            np.float32)).cuda()
        fa64, fb64 = fa_rows.to(f64), fb_cols.to(f64)
        sw, pw = float(np.float32(1e-3)), float(np.float32(1e-2))
        for R in ROWS:
            ap = tsk.streaming_ap(fa_rows, fb_cols, X[:R].contiguous(), sw, pw)
            want = tsk.streaming_ap_plain(fa64, fb64, X[:R].to(f64), sw, pw)
            absw = tsk.streaming_ap_plain(fa64, fb64, X[:R].abs().to(f64),
                                          sw, pw)
            assert ((ap[:, :p].double() - want[:, :p]).abs()
                    <= 1e-6 * absw[:, :p]).all(), (ppad, R)
            out = tsk.streaming_atb(fa_rows, fb_cols, B[:R].contiguous(), sw,
                                    pw)
            want = tsk.streaming_atb_plain(fa64, fb64, B[:R].to(f64), sw, pw)
            absw = tsk.streaming_atb_plain(fa64, fb64, B[:R].abs().to(f64),
                                           sw, pw)
            assert ((out[:, :q].double() - want[:, :q]).abs()
                    <= 1e-6 * absw[:, :q]).all(), (ppad, R)
