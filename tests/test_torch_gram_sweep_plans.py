"""The launch plans of K12 (the phi-free scaled gram, stream_gram_plan)
and of K3/K4/K14 (the Sinkhorn half-step's bulk-copy sweep,
sinkhorn_plan), on the CPU: every row, column and lower-triangle tile
covered once, shared memory within a Hopper block, a function of the
shapes alone, and the shapes each refuses; each wrapper's launch against
a stand-in for the kernel library; the exact int16 conversion the sweep
uses; and the streaming loop's float64 projections against its float64
twin. The cuda-marked tests hold the kernels to their plain versions on
the card."""

from __future__ import annotations

import contextlib
import os
import re

import numpy as np
import pytest
import torch

from nle_tpu_torch.ops.affinity import bandwidth_weights, features
from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels import affinity_kernel as tak
from nle_tpu_torch.ops.kernels import sinkhorn_kernel as tsink
from nle_tpu_torch.ops.kernels import streaming_kernel as tsk
from nle_tpu_torch.ops.kernels.scaled_matmul_kernel import GRAM_TILE
from nle_tpu_torch.ops.pipeline import (
    _unpack_stage1,
    bucket_m,
    ka_eigh_host64,
    pack_stage1,
)
from nle_tpu_torch.ops.sampling import sample_grid

SMEM_LIMIT = 232448            # a Hopper block's shared memory, bytes
CSRC = os.path.join(os.path.dirname(tsk.__file__), "..", "..", "csrc")
# (Qpad, Ppad, Mpad): the 1 MP, [7] 32 MP, [9a] 16 MP and [9c] 4 MP
# streaming shapes, and small ones.
GRAM_SHAPES = ((1011712, 640, 640), (31990272, 640, 384),
               (15998464, 2176, 384), (3998208, 2176, 1792),
               (512, 128, 128), (4096, 640, 256))
DTYPES = (torch.int16, torch.float32, torch.bfloat16)
# (npad, mpad): the 1 MP split and assembled factors, [9d]'s 2^20 rows at
# mpad 2176, the widest factor, and ragged small ones.
SWEEP_SHAPES = ((1011712, 640), (1013760, 640), (1 << 20, 2176),
                (4096, 16384), (5000, 640), (37, 128), (1, 8))


def _const(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name)) as fh:
        return fh.read()


def _covered_once(starts, ends, n) -> bool:
    seen = np.zeros(n, np.int64)
    for a, b in zip(starts, ends):
        assert a < b
        seen[a:b] += 1
    return bool((seen == 1).all())


def _tri_tile(t: int) -> tuple[int, int]:
    """K6's tile t of the lower triangle, row-major (csrc/scaled_matmul.cu
    tri_tile)."""
    i = int((np.sqrt(8.0 * t + 1.0) - 1.0) * 0.5)
    while i * (i + 1) // 2 > t:
        i -= 1
    while (i + 1) * (i + 2) // 2 <= t:
        i += 1
    return i, t - i * (i + 1) // 2


# -- K12: stream_gram_plan ---------------------------------------------------

@pytest.mark.parametrize("qpad,ppad,mpad,chunk", [
    (*shape, chunk) for shape in GRAM_SHAPES for chunk in (None, 2048, 64)
    if chunk != 64 or shape[0] <= 1 << 16])
def test_gram_plan_covers_rows_columns_and_tiles_once(qpad, ppad, mpad,
                                                      chunk):
    """The chunks cover every row once (all full but the last), the
    column panels every column once, and K6's plan of each chunk every
    one of its rows once and every lower-triangle 128 x 128 tile once."""
    plan = tsk.stream_gram_plan(qpad, ppad, mpad, chunk)
    starts = [k * plan.chunk for k in range(plan.nchunks - 1)]
    starts.append(qpad - plan.last)
    ends = starts[1:] + [qpad]
    assert _covered_once(starts, ends, qpad)
    assert all(e - s == plan.chunk for s, e in zip(starts[:-1], ends[:-1]))
    assert 0 < plan.last <= plan.chunk
    cols = np.cumsum((0,) + plan.panels)
    assert _covered_once(cols[:-1], cols[1:], mpad)
    assert all(w % GRAM_TILE == 0 and w <= tak.AFF_PANEL_COLS
               for w in plan.panels)
    for rows, k6 in ((plan.chunk, plan.full), (plan.last, plan.tail)):
        a = [k * k6.split_rows for k in range(k6.nsplit)]
        b = [min(x + k6.split_rows, rows) for x in a]
        assert _covered_once(a, b, rows)
        panels = mpad // GRAM_TILE
        tiles = {_tri_tile(t) for t in range(k6.tiles)}
        assert k6.tiles == panels * (panels + 1) // 2 == len(tiles)
        assert tiles == {(i, j) for i in range(panels) for j in range(i + 1)}


@pytest.mark.parametrize("mpad,builds", ((128, 1), (256, 1), (384, 1),
                                         (640, 2), (768, 2), (1792, 5),
                                         (2176, 6)))
def test_gram_plan_builds_each_entry_once_up_to_384_columns(mpad, builds):
    """A block builds its panel's entries once for all the panel's
    columns: one build an entry per chunk up to Mpad 384 (the [7] and
    [9a] capacity rows), ceil(Mpad / 384) past it."""
    plan = tsk.stream_gram_plan(4096, 640, mpad)
    assert len(plan.panels) == builds == -(-mpad // tak.AFF_PANEL_COLS)


@pytest.mark.parametrize("qpad,ppad,mpad", GRAM_SHAPES)
def test_gram_plan_fits_a_hopper_block(qpad, ppad, mpad):
    """The phi step's shared memory (the affinity core's ring of Uinv slabs
    and two affinity tiles) fits a block, and the chunk's scratch stays
    near GRAM_CHUNK_BYTES; the chunk is a whole number of K6's shortest
    splits unless it is all of Qpad."""
    plan = tsk.stream_gram_plan(qpad, ppad, mpad)
    widest = max(plan.panels)
    assert plan.phi == tak.affinity_plan(qpad, ppad, mpad)
    assert plan.shared_bytes == 4 * (plan.phi.stages * 16 * widest
                                     + 2 * 16 * plan.phi.rows)
    assert plan.shared_bytes <= SMEM_LIMIT
    assert 4 * plan.chunk * mpad <= tsk.GRAM_CHUNK_BYTES
    assert plan.chunk == qpad or plan.chunk % tsk.GRAM_CHUNK_GRAIN == 0


def test_gram_plan_is_a_function_of_the_shapes_alone(monkeypatch):
    """K12's partial sums, and their order, do not depend on the card:
    the plan reads nothing of the device."""
    want = {s: tsk.stream_gram_plan(*s) for s in GRAM_SHAPES}

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "get_device_name", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert {s: tsk.stream_gram_plan(*s) for s in want} == want


@pytest.mark.parametrize("qpad,ppad,mpad,chunk", [
    (32, 640, 384, None), (100, 640, 384, None), (512, 8, 384, None),
    (512, 100, 384, None), (512, 640, 64, None), (512, 640, 200, None),
    (512, 640, 0, None), (512, 640, 384, 100), (512, 640, 384, 0)])
def test_gram_plan_raises_on_shapes_the_kernels_cannot_take(qpad, ppad,
                                                            mpad, chunk):
    with pytest.raises(ValueError):
        tsk.stream_gram_plan(qpad, ppad, mpad, chunk)


# -- K12's float64 form: stream_sample_gram_plan ---------------------------

@pytest.mark.parametrize("qpad,ppad", sorted({s[:2] for s in GRAM_SHAPES}))
def test_sample_gram_plan_covers_rows_and_tiles_once(qpad, ppad):
    """The sample-basis gram's splits cover every row once in whole
    GS_ROWS steps (all but the last full), its tiles are H's lower
    GS_TILE tiles, and the grid reaches GS_BLOCKS blocks where the rows
    allow it."""
    plan = tsk.stream_sample_gram_plan(qpad, ppad)
    nt = ppad // tsk.GS_TILE
    assert plan.tiles == nt * (nt + 1) // 2
    assert plan.split_rows % tsk.GS_ROWS == 0
    a = [k * plan.split_rows for k in range(plan.nsplit)]
    assert _covered_once(a, [min(x + plan.split_rows, qpad) for x in a],
                         qpad)
    if qpad >= tsk.GS_BLOCKS * tsk.GS_ROWS:
        assert plan.tiles * plan.nsplit >= tsk.GS_BLOCKS
    assert plan.scratch_bytes == (8 * plan.nsplit * plan.tiles
                                  * tsk.GS_TILE ** 2)


@pytest.mark.parametrize("qpad,ppad", [(16, 640), (512, 100), (512, 96),
                                       (100, 640)])
def test_sample_gram_plan_raises_on_shapes_the_kernel_cannot_take(qpad,
                                                                  ppad):
    with pytest.raises(ValueError):
        tsk.stream_sample_gram_plan(qpad, ppad)


def test_sample_gram_mirrors_the_kernel_source():
    """The plan's tile and step are the kernel's, and its static shared
    memory (two GS_ROWS x GS_TILE float64 tiles of entries and the step's
    rows) fits a block's 48 KiB of static shared memory."""
    src = _read("streaming.cu")
    assert _const(src, "GS_TILE") == tsk.GS_TILE
    assert _const(src, "GS_ROWS") == tsk.GS_ROWS
    static = 2 * 8 * tsk.GS_ROWS * tsk.GS_TILE + 4 * 4 * tsk.GS_ROWS
    assert static <= 48 * 1024


def test_sample_gram_plain_sums_the_fp32_entries_in_float64():
    """The float64 form's plain twin (and its CPU route) is H = (c K)^T
    (c K) on the fp32 entries with float64 products and sums: the fp32
    entries' float64 gram to 1e-14 of the gram of absolute terms, and
    unlike that gram summed in fp32."""
    rng = np.random.default_rng(11)
    p, q = 90, 3000
    fa = torch.from_numpy(rng.integers(0, 64, (p, 3)).astype(np.float32))
    fb = torch.from_numpy(rng.integers(0, 64, (q, 3)).astype(np.float32))
    fa_rows, fb_cols, mask = tsk.pad_stream_operands(fa, fb)
    c = torch.from_numpy(rng.random((1, fb_cols.shape[1])).astype(
        np.float32)) * mask
    got = tsk.streaming_sample_gram(fa_rows, fb_cols, c, SW, PW)
    assert got.dtype == torch.float64
    assert torch.equal(got, tsk.streaming_sample_gram_plain(
        fa_rows, fb_cols, c, SW, PW))
    K = tsk._affinity_rows(fa_rows, fb_cols, 0, fb_cols.shape[1], SW, PW)
    assert K.dtype == torch.float32
    ck = c[0, :, None].double() * K.double()
    want = ck.T @ ck
    assert bool(((got - want).abs()[:p, :p] <= 1e-14 * want[:p, :p]).all())
    ck32 = c[0, :, None] * K
    off32 = ((ck32.T @ ck32).double() - want).abs()[:p, :p]
    assert float((off32 / want[:p, :p]).max()) > 1e-9


def test_gram_plan_mirrors_the_kernel_source():
    """K12's phi step is the affinity core's (csrc/affinity_core.cuh, K1's
    C entry), whose constants the plan mirrors: the block's rows, the
    samples a step, the ring's slabs and the widest column panel, whose
    8 x 12 outputs a thread give 96 FMAs for 5 shared float4 loads; then
    K6's gram."""
    core = _read("affinity_core.cuh")
    plan = tsk.stream_gram_plan(4096, 640, 640)
    assert _const(core, "AC_ROWS") == plan.phi.rows
    assert _const(core, "AC_K") == tak.AFF_K
    assert _const(core, "AC_STAGES") == plan.phi.stages
    assert _const(core, "AC_MAX_COLS") == tak.AFF_PANEL_COLS == 32 * 12
    src = _read("streaming.cu")
    assert "nle_affinity_matmul(fb, fa, uinv, phi_chunk" in src
    assert "gram_phi_kernel" not in src
    assert "nle_scaled_gram(" in src


# -- K3/K4/K14: sinkhorn_plan ------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("npad,mpad", SWEEP_SHAPES)
def test_sweep_plan_covers_every_row_once(npad, mpad, dtype):
    """The CTAs' contiguous ranges cover every row once, none empty, at
    most SK_CTAS of them; each range's sub-tiles of `rows` rows cover it
    once (only the factor's last sub-tile ragged); every column chunk of
    a row is one 16-byte bulk-copy unit."""
    plan = tsink.sinkhorn_plan(npad, mpad, dtype)
    assert 1 <= plan.ctas <= tsink.SK_CTAS
    begins = [b * plan.per_cta for b in range(plan.ctas)]
    ends = [min(b + plan.per_cta, npad) for b in begins]
    assert _covered_once(begins, ends, npad)
    assert plan.per_cta % plan.rows == 0
    tiles = [t for b, e in zip(begins, ends) for t in range(b, e, plan.rows)]
    tile_ends = [min(t + plan.rows, npad) for t in tiles]
    assert _covered_once(tiles, tile_ends, npad)
    assert all(e - t == plan.rows for t, e in zip(tiles[:-1], tile_ends))
    assert plan.rows & (plan.rows - 1) == 0
    esize = torch.empty((), dtype=dtype).element_size()
    assert mpad * esize % 16 == 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("npad,mpad", SWEEP_SHAPES)
def test_sweep_plan_fits_a_hopper_block(npad, mpad, dtype):
    """Shared bytes: the slots' mbarriers (128 B), the ring of at least two
    slots, a partial s row for each row group of the s pass (as many whole
    copies of a row's 16-byte chunks as 256 threads hold), t for 16-bit
    factors and x's two buffers; within a block's 227 KB at every width up
    to MAX_MPAD."""
    plan = tsink.sinkhorn_plan(npad, mpad, dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    chunks = mpad * esize // 16
    groups = 1 if chunks >= 256 else 256 // chunks
    assert groups == tsink.sweep_groups(mpad, dtype)
    assert groups == 1 or groups * chunks <= 256
    vectors = groups + (1 if esize == 2 else 0)
    assert plan.shared_bytes == (128 + plan.slots * plan.rows * mpad * esize
                                 + 4 * (vectors * mpad + 64))
    assert plan.shared_bytes <= SMEM_LIMIT
    assert 2 <= plan.slots <= tsink.SK_MAX_SLOTS
    assert 1 <= plan.rows <= tsink.SK_MAX_ROWS
    assert tsink.sinkhorn_plan(64, tsink.MAX_MPAD, dtype).shared_bytes \
        <= SMEM_LIMIT


def test_sweep_plan_is_a_function_of_the_shapes_alone(monkeypatch):
    want = {(n, m, d): tsink.sinkhorn_plan(n, m, d)
            for n, m in SWEEP_SHAPES for d in DTYPES}

    def no_card(*args, **kwargs):
        raise AssertionError("the plan asked the device")

    for name in ("is_available", "device_count", "get_device_properties",
                 "get_device_name", "mem_get_info"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert {k: tsink.sinkhorn_plan(*k) for k in want} == want


@pytest.mark.parametrize("npad,mpad,dtype", [
    (1024, 644, torch.int16), (1024, 4, torch.int16),
    (1024, 6, torch.float32), (1024, 12, torch.bfloat16),
    (0, 640, torch.int16), (1024, 0, torch.float32),
    (1024, 20000, torch.int16), (1024, 20000, torch.float32)])
def test_sweep_plan_raises_on_shapes_the_kernel_cannot_take(npad, mpad,
                                                            dtype):
    """A row that is not a 16-byte multiple (int16 at 644 columns is 1,288
    B), an empty factor, and a width whose ring and vectors outgrow a
    block."""
    with pytest.raises(ValueError):
        tsink.sinkhorn_plan(npad, mpad, dtype)


def test_sweep_plan_mirrors_the_kernel_source():
    src = _read("sinkhorn.cu")
    assert _const(src, "HB_MAX_ROWS") == tsink.SK_MAX_ROWS
    assert _const(src, "HB_MAX_SLOTS") == tsink.SK_MAX_SLOTS
    assert _const(src, "HB_BARRIER_BYTES") == 128
    assert _const(src, "HB_THREADS") == tsink.SK_THREADS
    assert "cp.async.bulk" in _read("common.cuh")
    assert "nle::bulk_copy(" in src and "nle::mbar_wait(" in src


def test_int16_converts_exactly_through_the_float_bits():
    """The sweep's int16 -> f32 conversion (csrc/sinkhorn.cu Chunk<int16>):
    the float with bits 0x4B000000 | (q ^ 0x8000) is 2^23 + 2^15 + q, so
    subtracting 2^23 + 2^15 is q, for every int16."""
    q = np.arange(-32768, 32768, dtype=np.int64)
    bits = (0x4B000000 | ((q & 0xFFFF) ^ 0x8000)).astype(np.uint32)
    f = bits.view(np.float32) - np.float32(8421376.0)
    assert f.dtype == np.float32
    assert np.array_equal(f, q.astype(np.float32))


# -- the launches, against a stand-in library ---------------------------------

class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("nle_"):
            raise AttributeError(name)

        def fn(*args):
            self.calls.append((name, args))
            return 0

        return fn


@pytest.fixture()
def fake_card(monkeypatch):
    lib = _FakeLib()
    for mod in (tsk, tsink):
        monkeypatch.setattr(mod, "cuda_or_cpu", lambda *a, **k: True)
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    _build.reset_launches()
    yield lib
    _build.reset_launches()


def test_gram_launch_reads_the_plan(fake_card):
    """K12's entry point gets stream_gram_plan's numbers as they are and
    scratch of the plan's sizes; one launch, counted as streaming_gram."""
    qpad, ppad, mpad = 4096, 640, 640
    out = tsk.streaming_scaled_gram(
        torch.zeros((3, ppad)), torch.zeros((3, qpad)),
        torch.zeros((1, qpad)), torch.zeros((ppad, mpad)), 0.1, 0.2)
    plan = tsk.stream_gram_plan(qpad, ppad, mpad)
    [(name, args)] = fake_card.calls
    assert name == "nle_stream_gram"
    assert args[9:19] == (qpad, ppad, mpad, plan.chunk, plan.last,
                          plan.full.nsplit, plan.full.split_rows,
                          plan.tail.nsplit, plan.tail.split_rows,
                          plan.full.chain_rows)
    assert args[19:21] == (0.1, 0.2)
    assert out.shape == (mpad, mpad)
    assert _build.LAUNCHES["streaming_gram"] == 1
    assert sum(_build.LAUNCHES.values()) == 1


def test_sample_gram_launch_reads_the_plan(fake_card):
    """K12's float64 entry point gets stream_sample_gram_plan's numbers as
    they are and scratch of the plan's size; one launch, counted as
    streaming_gram."""
    qpad, ppad = 4096, 640
    out = tsk.streaming_sample_gram(
        torch.zeros((3, ppad)), torch.zeros((3, qpad)),
        torch.zeros((1, qpad)), 0.1, 0.2)
    plan = tsk.stream_sample_gram_plan(qpad, ppad)
    [(name, args)] = fake_card.calls
    assert name == "nle_stream_sample_gram"
    assert args[5:10] == (qpad, ppad, *plan)
    assert args[10:12] == (0.1, 0.2)
    assert out.shape == (ppad, ppad) and out.dtype == torch.float64
    assert _build.LAUNCHES["streaming_gram"] == 1
    assert sum(_build.LAUNCHES.values()) == 1


def test_gram_keep_phi_is_card_only():
    with pytest.raises(ValueError, match="card only"):
        tsk.streaming_scaled_gram(
            torch.zeros((3, 128)), torch.zeros((3, 512)),
            torch.zeros((1, 512)), torch.zeros((128, 128)), 0.1, 0.2,
            keep_phi=True)


@pytest.mark.parametrize("dtype,entry,counter", [
    (torch.int16, "nle_sinkhorn_halfstep_i16", "sinkhorn_halfstep_int16"),
    (torch.float32, "nle_sinkhorn_halfstep_f32", "sinkhorn_halfstep_f32"),
    (torch.bfloat16, "nle_sinkhorn_halfstep_bf16", "sinkhorn_halfstep_bf16"),
])
def test_halfstep_launch_reads_the_plan(fake_card, dtype, entry, counter):
    """K3/K4/K14's entry point gets sinkhorn_plan's numbers as they are,
    a (ctas, mpad) partial scratch, and counts one launch; a row of the
    wrong width raises before anything is built."""
    npad, mpad = 5000, 640
    Q = torch.zeros((npad, mpad), dtype=dtype)
    x, s = tsink.sinkhorn_halfstep(Q, torch.zeros(mpad), 1e-10)
    plan = tsink.sinkhorn_plan(npad, mpad, dtype)
    [(name, args)] = fake_card.calls
    assert name == entry
    assert args[5:12] == (npad, mpad, *plan)
    assert args[12] == 1e-10
    assert x.shape == (npad,) and s.shape == (mpad,)
    assert _build.LAUNCHES[counter] == 1
    fake_card.calls.clear()
    with pytest.raises(ValueError, match="16-byte"):
        tsink.sinkhorn_halfstep(torch.zeros((64, 4), dtype=torch.int16),
                                torch.zeros(4), 1e-10)
    assert not fake_card.calls


# -- the streaming loop's float64 projections --------------------------------

def test_streaming_loop_projections_stay_near_the_float64_twin():
    """On a dense grid (96 x 88, 48 x 44 samples) with eigenvalues kept
    down to 1e-10, the loop around the plain f32 half-steps ends with c
    within 1e-4 (median) of the same loop in float64, and at least 3x
    closer than nle_tpu's loop order with every projection in fp32
    (measured 4.3e-5 against 3.5e-4 at 50 iterations)."""
    from nle_tpu_torch.tools.stream_precision import sinkhorn_loop

    shape, (hx, hy, eps, iters) = (96, 88), (200.0, 30.0, 1e-10, 50)
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    L = (120 + 60 * np.sin(xx / 11.0) + 40 * np.cos(yy / 7.0)
         + rng.normal(0, 6, shape))
    L = np.clip(np.rint(L), 0, 255).astype(np.float32)
    grid = sample_grid(*shape, 48, 44)
    p = grid.n_samples
    Um64, lam64, _ = ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, hx, hy, eps)
    assert lam64.min() < 1e-9
    Um, lam, Uinv = _unpack_stage1(torch.from_numpy(
        pack_stage1(Um64, lam64, mb=bucket_m(lam64.shape[0], p))), p)
    perm = torch.from_numpy(grid.perm)
    f = features((perm // shape[1]).float(), (perm % shape[1]).float(),
                 torch.from_numpy(L.reshape(-1)[grid.perm]))
    sw, pw = bandwidth_weights(hx, hy)
    fa_rows, fb_cols, mask = tsk.pad_stream_operands(f[:p], f[p:])
    q, ppad = f.shape[0] - p, fa_rows.shape[1]
    f64 = torch.float64
    fa64, fb64, mask64 = fa_rows.to(f64), fb_cols.to(f64), mask.to(f64)
    Umt = torch.from_numpy(np.ascontiguousarray(Um64))
    lamt = torch.from_numpy(np.ascontiguousarray(lam64))
    _, c64 = sinkhorn_loop(
        torch, lambda u: tsk.streaming_halfstep_ptiled_plain(
            fa64, fb64, mask64, u, sw, pw, eps),
        lambda: tsk.streaming_ap_plain(fa64, fb64, mask64, sw, pw)[0],
        Umt, lamt, Umt / lamt[None], q, ppad, iters, eps)

    def half(u):
        return tsk.streaming_halfstep_ptiled_plain(fa_rows, fb_cols, mask, u,
                                                   sw, pw, eps)

    ap0 = tsk.streaming_ap_plain(fa_rows, fb_cols, mask, sw, pw)[0]
    _, c32 = sinkhorn_loop(torch, half, lambda: ap0, Um, lam, Uinv, q, ppad,
                           iters, eps)
    c_rest = tsk.streaming_loop(half, ap0, Um, lam, ppad, iters, eps)[3]

    def median_rel(c):
        return float(((c[:q].double() - c64[p:]) / c64[p:]).abs().median())

    port, fp32 = median_rel(c_rest), median_rel(c32[p:])
    assert port < 1e-4
    assert 3 * port < fp32


# -- on the card ---------------------------------------------------------------

SW = float(np.float32(1e-4))
PW = float(np.float32(1e-3))
EPS = 1e-10


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")


@pytest.mark.cuda
@pytest.mark.parametrize("ppad,mpad,q", [(640, 128, 5000),
                                         (640, 384, 400_000),
                                         (2176, 640, 250_000)])
def test_cuda_k12_matches_its_float64_version(ppad, mpad, q):
    """K12 over one chunk and over three (174,080 and 104,448 rows a chunk
    at Mpad 384 and 640) and over one, two and one column panels: within
    1e-5 of the gram of absolute terms from its float64 plain version,
    bitwise symmetric, two launches bitwise equal; the last chunk's phi
    rows are bitwise K1's rows for the same pixels."""
    _need_card()
    rng = np.random.default_rng(5)
    p, m = ppad - 40, mpad - 30
    fa = torch.from_numpy(rng.integers(0, 64, (p, 3)).astype(np.float32))
    fb = torch.from_numpy(rng.integers(0, 64, (q, 3)).astype(np.float32))
    fa_rows, fb_cols, mask = (t.cuda() for t in
                              tsk.pad_stream_operands(fa, fb))
    assert fa_rows.shape[1] == ppad
    qpad = fb_cols.shape[1]
    uinv = torch.zeros((ppad, mpad), device="cuda")
    uinv[:p, :m] = torch.from_numpy(
        rng.standard_normal((p, m)).astype(np.float32) * 0.05).cuda()
    c = torch.from_numpy(rng.random((1, qpad)).astype(np.float32)).cuda() \
        * mask
    _build.reset_launches()
    got, phi = tsk.streaming_scaled_gram(fa_rows, fb_cols, c, uinv, SW, PW,
                                         keep_phi=True)
    again = tsk.streaming_scaled_gram(fa_rows, fb_cols, c, uinv, SW, PW)
    assert torch.equal(got, again) and torch.equal(got, got.T)
    f64 = torch.float64
    want = tsk.streaming_scaled_gram_plain(
        fa_rows.to(f64), fb_cols.to(f64), c.to(f64), uinv.to(f64), SW, PW)
    bound = tsk.streaming_scaled_gram_plain(
        fa_rows.to(f64), fb_cols.to(f64), c.abs().to(f64),
        uinv.abs().to(f64), SW, PW)
    assert bool(((got - want).abs() <= 1e-5 * bound).all())
    plan = tsk.stream_gram_plan(qpad, ppad, mpad)
    assert plan.nchunks == (1 if q < 10_000 else 3)
    lo = qpad - plan.last
    k1 = tak.affinity_matmul_kernel(fa.cuda(), fb.cuda()[lo:], uinv[:p, :m],
                                    SW, PW)
    assert torch.equal(phi[:q - lo, :m], k1)
    assert _build.LAUNCHES["streaming_gram"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("ppad,q", [(640, 1_000_000), (2176, 60_000)])
def test_cuda_sample_gram_matches_its_plain_version(ppad, q):
    """K12's float64 form against its plain version on the same fp32
    entries: bitwise symmetric, two launches bitwise equal, and within
    2 (Qpad + 1) 2^-53 of the gram of absolute terms (each side's float64
    chains), a bound that the same H summed in fp32 fails."""
    _need_card()
    rng = np.random.default_rng(6)
    p = ppad - 40
    fa = torch.from_numpy(rng.integers(0, 64, (p, 3)).astype(np.float32))
    fb = torch.from_numpy(rng.integers(0, 64, (q, 3)).astype(np.float32))
    fa_rows, fb_cols, mask = (t.cuda() for t in
                              tsk.pad_stream_operands(fa, fb))
    qpad = fb_cols.shape[1]
    c = torch.from_numpy(rng.random((1, qpad)).astype(np.float32)).cuda() \
        * mask
    _build.reset_launches()
    got = tsk.streaming_sample_gram(fa_rows, fb_cols, c, SW, PW)
    again = tsk.streaming_sample_gram(fa_rows, fb_cols, c, SW, PW)
    assert torch.equal(got, again) and torch.equal(got, got.T)
    assert _build.LAUNCHES["streaming_gram"] == 2
    want = tsk.streaming_sample_gram_plain(fa_rows, fb_cols, c, SW,
                                           PW)[:p, :p]
    bound = 2 * (qpad + 1) * 2.0 ** -53 * want
    assert bool(((got[:p, :p] - want).abs() <= bound).all())
    h32 = torch.zeros((ppad, ppad), device="cuda")
    for lo in range(0, qpad, 1 << 16):
        hi = min(lo + (1 << 16), qpad)
        ck = c[0, lo:hi, None] * tsk._affinity_rows(fa_rows, fb_cols, lo, hi,
                                                    SW, PW)
        h32 += ck.T @ ck
    assert not bool(((h32[:p, :p].double() - want).abs() <= bound).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("npad,mpad", [(5000, 640), (4096, 2176),
                                       (37, 128), (600, 16384)])
def test_cuda_halfstep_sweep_matches_its_plain_version(npad, mpad, dtype):
    """K3/K4/K14 on ragged and wide factors: x and s within 1e-5 of the
    plain version (which rounds t and x as K14 does), two launches
    bitwise equal, each counted."""
    _need_card()
    rng = np.random.default_rng(9)
    phi = torch.from_numpy(rng.random((npad, mpad)).astype(np.float32))
    Q = ((phi * 32767).round().to(torch.int16) if dtype == torch.int16
         else phi.to(dtype)).cuda()
    t = torch.from_numpy(rng.random(mpad).astype(np.float32) * 1e-3).cuda()
    _build.reset_launches()
    x, s = tsink.sinkhorn_halfstep(Q, t, EPS)
    x2, s2 = tsink.sinkhorn_halfstep(Q, t, EPS)
    assert torch.equal(x, x2) and torch.equal(s, s2)
    xp, sp = tsink.sinkhorn_halfstep_plain(Q, t, EPS)
    torch.testing.assert_close(x, xp, rtol=1e-5, atol=0)
    torch.testing.assert_close(s, sp, rtol=1e-5, atol=0)
    assert sum(_build.LAUNCHES.values()) == 2
