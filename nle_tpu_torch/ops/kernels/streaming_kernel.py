"""K8-K12: the phi-free (streaming) stage-2 kernels (CUDA,
csrc/streaming.cu), their plain PyTorch twins, and the streaming Sinkhorn
loop (port of nle_tpu/ops/pallas/streaming_kernel.py).

The dense pipeline stores the Nystrom factor phi (N, mpad): 2.5 kB per
pixel at mpad = 640, past the H100's 80 GB near 32 MP. These kernels
recompute the (rows, p) affinity K between rest pixels and samples from
the raw features inside every pass, using

    phi_rest t      = K (Uinv t)          K8's w, then x = 1 / w
    phi_rest^T x    = Uinv^T (K^T x)      K8's ap / K10
    Sb = (c phi_rest)^T (c phi_rest)      K12, phi recomputed per row chunk
    V_rest = c (K W),  W = Uinv GrT       K1 (stage 2b) or K11 (factored)

so per-pixel state is the features and a few vectors. Each entry is
nle::affinity (csrc/common.cuh), the entry K1 stores in phi: the streaming
values differ from the dense ones only by the association of the
contractions (~1e-7 relative).

- K8 replaces `_halfstep_kernel` (:105, call :163):
  x = mask * safe_recip(K u, eps), ap = K^T x in one sweep, Ppad <= 1792;
  unit_x gives x = mask (the s0 = phi^T 1 pass, K10's kernel on the mask).
- K9 replaces `_halfstep_ptiled_kernel` (:189, call :263): K8's x and ap
  at any Ppad. Up to HS_MAX_PPAD = 4096 it runs K8's kernel (each entry
  built once per half-step, halfstep_plan); past it two passes, each
  entry built twice (halfstep_route: a dispatch by shape alone).
- K10 replaces `_ap_kernel` (:299, call :345): ap (R, Ppad) = K^T x.
- K11 replaces `_atb_kernel` (:369, call :411): out (R, Qpad) = K b.
- K12 replaces `_gram_kernel` (:453, call :492) and, where the TPU's VMEM
  no longer holds the gram (dense sampling grids), the XLA scan
  `streaming_scaled_gram_xla` (:512): per row chunk of stream_gram_plan,
  phi's rows built with each entry once per column panel of up to 384
  columns, then K6's lower-triangle gram of the chunk, the chunks added in
  order with compensation.
(K is written (pixels, samples) here; the JAX docstrings call the same
products K_AB^T u and K_AB x.)

On the H100, K8-K11 are bound by instruction issue (the IEEE
expf and the rounded argument of every entry), not by bytes, so K8 builds
each entry once per half-step at every Ppad up to 4096; K12 is fp32
FMA work like K1 and K6. Cross-block sums are fixed-order partials, never
float atomics: training stays bitwise repeatable.

Layout: the public functions keep the JAX argument layout, features as
(3, Qpad) / (3, Ppad) rows and vectors as (1, Qpad) or (R, Qpad) rows. The
TPU's lane-padding reason for it does not apply on the card; the layout
still gives coalesced loads.

Every entry point takes any Ppad (dense sampling grids: 48 x 44 = 2112
samples). The JAX package pads Ppad to 1024 multiples past 1792, a TPU
tile reason; the port pads to 128 at every p (pad_stream_operands), and x
and ap[:p] do not depend on the padding.

Dispatch rule (the same for every kernel of the port): a CPU tensor goes
to the plain PyTorch version; a CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import cuda_or_cpu, round_up
from nle_tpu_torch.ops.kernels.affinity_kernel import (
    ROW_TILE,
    AffinityPlan,
    affinity_plan,
)
from nle_tpu_torch.ops.kernels.scaled_matmul_kernel import GramPlan, gram_plan
from nle_tpu_torch.ops.linalg import safe_reciprocal

TILE_Q = 512                 # Qpad alignment (the JAX package's row tile)
P_ALIGN = 128                # Ppad alignment (every kernel's sample step)
MAX_STREAM_P_FUSED = 1792    # K8's regime (Ppad <= this); K9 past it
MAX_ROWS = 3                 # K10/K11 rows: one channel, or a colour frame's
PLAIN_CHUNK_ROWS = 8192      # rows of one affinity block in the plain twins
PLAIN_CPU_ENTRIES = 1 << 18  # on the CPU, entries of one: cache-sized blocks
# K8's kernel (csrc/streaming.cu stream_halfstep_kernel): a block holds all
# Ppad sample columns in registers, `cols` a thread, and builds `rows` pixel
# rows a step. Its instantiations (cols, rows, most threads a block), the
# csrc's HS_TILES, in the order the plan takes them (the first that holds
# Ppad): 4 x 4 to 640 threads (Ppad 2560; the fastest on the H100 at Ppad
# 640 and 2176), 8 x 4 to 384 (3072), 8 x 2 to 512 (4096). cols is a power
# of two, so a thread's columns are an aligned subtree of w's fixed sum
# order (csrc: HS_SEGMENT). Past HS_MAX_PPAD, 65,536 registers no longer
# hold the columns and two groups of entries: K9 runs two passes there.
HS_TILES = ((4, 4, 640), (8, 4, 384), (8, 2, 512))
HS_MAX_PPAD = max(cols * most for cols, _, most in HS_TILES)   # 4096
# Blocks own contiguous row ranges of whole HS_ROW_GRAIN-row chains, at most
# HS_MAX_BLOCKS of them (8 per SM of a 132-SM card): csrc's ST_MAX_BLOCKS
# and ST_ROW_GRAIN, the rule of every streaming kernel's partials.
HS_MAX_BLOCKS = 1056
HS_ROW_GRAIN = 32
HS_RING = 3                  # 32-row chunks of pixel features staged ahead
HS_SEGMENT = 256             # samples of w's tree below its Kahan sum


class HalfstepPlan(NamedTuple):
    """The launch of K8's kernel. Thread t of a block owns the sample
    columns t * cols + c, c < cols (those < Ppad); block b owns the rows
    [b * per_block, min((b + 1) * per_block, Qpad)), walked `rows` at a
    time. shared_bytes: a ring of HS_RING 32-row chunks of pixel features
    (16 B a row), the fp32 x of two row groups and each warp's float64
    sums of w for them."""
    threads: int
    cols: int
    rows: int
    blocks: int
    per_block: int
    shared_bytes: int


def halfstep_plan(qpad: int, ppad: int) -> HalfstepPlan:
    """K8's kernel's plan for (Qpad, Ppad): a function of the shapes alone,
    so the block partials of ap, and the order they are summed in, do not
    depend on the card. Raises on shapes the kernel cannot take."""
    _check_stream_shape(qpad, ppad, 1)
    if ppad % P_ALIGN or ppad > HS_MAX_PPAD:
        raise ValueError(f"Ppad {ppad} must be a multiple of {P_ALIGN} up to "
                         f"{HS_MAX_PPAD} (past it: two passes)")

    cols, rows, _ = next(t for t in HS_TILES
                         if round_up(-(-ppad // t[0]), 32) <= t[2])
    threads = round_up(-(-ppad // cols), 32)
    blocks, per_block = _row_ranges(qpad)
    return HalfstepPlan(threads, cols, rows, blocks, per_block,
                        16 * HS_RING * HS_ROW_GRAIN + 4 * 2 * rows
                        + 8 * 2 * rows * (threads // 32))


def _row_ranges(qpad: int) -> tuple[int, int]:
    """(blocks, rows a block) of the partials' rule (csrc rows_per_block):
    contiguous ranges of whole HS_ROW_GRAIN-row chains, at most
    HS_MAX_BLOCKS, from Qpad alone."""
    per_block = max(HS_ROW_GRAIN,
                    round_up(-(-qpad // HS_MAX_BLOCKS), HS_ROW_GRAIN))
    return -(-qpad // per_block), per_block


def _check_stream_shape(qpad: int, ppad: int, rows: int) -> None:
    if qpad < HS_ROW_GRAIN or qpad % HS_ROW_GRAIN:
        raise ValueError(f"Qpad {qpad} must be a positive multiple of "
                         f"{HS_ROW_GRAIN}")
    if ppad < ST_P_GRAIN or ppad % ST_P_GRAIN:
        raise ValueError(f"Ppad {ppad} must be a positive multiple of "
                         f"{ST_P_GRAIN}")
    if not 1 <= rows <= MAX_ROWS:
        raise ValueError(f"{rows} rows: K10/K11 take 1 to {MAX_ROWS}")


# K10's kernel (csrc stream_ap_kernel): thread t of a block owns the `cols`
# consecutive sample columns t * cols + c of its p-tile, features in
# registers; warp 0 stages the pixel rows (r, c, y and the R rows of x)
# into a ring of AP_RING 32-row chunks; the inner loop takes `rows` rows a
# step. Its instantiations, one per R: (R, cols, rows, most threads a
# block), the csrc's AP_TILES. At R = 1, five columns a thread make Ppad
# 640 (the 1 MP and 32 MP paths) eight 128-thread blocks an SM under the
# 64-register launch bound: 32 warps, all 1056 row ranges in one wave.
AP_TILES = ((1, 5, 4, 1024), (2, 4, 4, 512), (3, 4, 2, 512))
AP_RING = 3
ST_P_GRAIN = 16              # the kernels' Ppad grain (csrc ST_P_GRAIN)


class ApPlan(NamedTuple):
    """The launch of K10's kernel: a (blocks, tiles) grid. Block (b, y)
    owns the rows [b * per_block, min((b + 1) * per_block, Qpad)) and the
    p-tile [y * ptile, min((y + 1) * ptile, Ppad)); its thread t the
    columns y * ptile + t * cols + c, c < cols (those in the tile),
    walked `rows` pixel rows a step. shared_bytes: the ring of AP_RING
    32-row chunks of the 3 + R row arrays."""
    threads: int
    cols: int
    rows: int
    ptile: int
    tiles: int
    blocks: int
    per_block: int
    shared_bytes: int


def ap_plan(qpad: int, ppad: int, R: int) -> ApPlan:
    """K10's kernel's plan for (Qpad, Ppad) and R rows of x: a function of
    the shapes alone. The row ranges are the partials' rule
    (_row_ranges), so each column's sum order is a function of Qpad alone
    and the output does not depend on the plan; the columns go in the
    fewest p-tiles of at most cols x most threads. Raises on shapes the
    kernel cannot take."""
    _check_stream_shape(qpad, ppad, R)
    _, cols, rows, most = AP_TILES[R - 1]
    tiles = -(-ppad // (cols * most))
    ptile = round_up(-(-ppad // tiles), cols)
    blocks, per_block = _row_ranges(qpad)
    return ApPlan(round_up(ptile // cols, 32), cols, rows, ptile,
                  -(-ppad // ptile), blocks, per_block,
                  4 * AP_RING * (3 + R) * HS_ROW_GRAIN)


# K11's kernel (csrc stream_atb_kernel): AT_THREADS threads a block, each
# owning `rows` pixel rows of a step of AT_THREADS x rows rows (features in
# registers); the samples staged in shared memory, (r, c, y) a float4 and
# b_0 .. b_{R-1} a double each, pchunk at a time (the fewest even pieces
# of at most AT_CHUNK samples; two buffers when there is more than one).
# rows by R, the csrc's AT_TILES; the launch bound (256 threads,
# AT_MIN_BLOCKS an SM) caps the registers at 64. Rows are
# independent, so the grid does not change a bit: it is as many blocks as
# AT_SMS SMs hold at once (at most AT_MIN_BLOCKS each, fewer where the
# shared bytes do not fit), the steps strided over them.
AT_TILES = ((1, 4), (2, 2), (3, 2))
AT_THREADS = 256
AT_MIN_BLOCKS = 4
AT_CHUNK = 1536
AT_SMS = 132
AT_SM_SHARED = 233472        # shared bytes of an H100 SM
AT_BLOCK_RESERVED = 1024     # of them, held back for each block


class AtbPlan(NamedTuple):
    """The launch of K11's kernel: `blocks` blocks of `threads` threads,
    each thread `rows` pixel rows of a step; the samples in chunks of
    pchunk; shared_bytes: one or two chunk buffers of 16 + 8 R B a
    sample."""
    threads: int
    rows: int
    blocks: int
    pchunk: int
    shared_bytes: int


def _even_piece(n: int, most: int) -> int:
    """csrc even_piece: n in the fewest pieces of at most `most`, each a
    multiple of 32 (the last may be shorter)."""
    pieces = -(-n // most)
    return round_up(-(-n // pieces), 32)


def atb_plan(qpad: int, ppad: int, R: int) -> AtbPlan:
    """K11's kernel's plan for (Qpad, Ppad) and R rows of b: a function of
    the shapes alone (no row's sum depends on it). Raises on shapes the
    kernel cannot take."""
    _check_stream_shape(qpad, ppad, R)
    rows = AT_TILES[R - 1][1]
    pchunk = _even_piece(ppad, AT_CHUNK)
    nbuf = 2 if pchunk < ppad else 1
    shared = nbuf * pchunk * (16 + 8 * R)
    per_sm = min(AT_MIN_BLOCKS,
                 AT_SM_SHARED // (shared + AT_BLOCK_RESERVED))
    steps = -(-qpad // (AT_THREADS * rows))
    return AtbPlan(AT_THREADS, rows, min(steps, AT_SMS * max(per_sm, 1)),
                   pchunk, shared)


# K12 (csrc/streaming.cu nle_stream_gram): each chunk's phi rows by the
# affinity core K1 runs on (affinity_kernel.affinity_plan: each entry built
# once per column panel of at most AFF_PANEL_COLS, so once per chunk up to
# mpad 384), then K6's kernel on the chunk.
# phi rows of one chunk: as many as GRAM_CHUNK_BYTES of scratch hold, in
# whole GRAM_CHUNK_GRAIN-row pieces (K6's shortest split), so the chunk's
# gram step fills the card (mpad 384: 174,080 rows, 44 splits x 6 tiles).
GRAM_CHUNK_BYTES = 1 << 28
GRAM_CHUNK_GRAIN = 2048


class StreamGramPlan(NamedTuple):
    """K12's launch: Qpad rows in `nchunks` chunks of `chunk` rows, the
    last one `last` rows; each chunk's phi rows by the affinity core's
    plan `phi`, then K6's gram on them by K6's plan `full` (a full chunk)
    or `tail` (the last one)."""
    chunk: int
    nchunks: int
    last: int
    phi: AffinityPlan
    full: GramPlan
    tail: GramPlan

    @property
    def panels(self) -> tuple[int, ...]:
        """The phi step's column panels (widths, in column order)."""
        return self.phi.panels

    @property
    def shared_bytes(self) -> int:
        """The phi step's shared memory for its widest panel: the Uinv ring
        and the two affinity tiles."""
        return self.phi.shared_bytes


def stream_gram_plan(qpad: int, ppad: int, mpad: int,
                     chunk: int | None = None) -> StreamGramPlan:
    """K12's plan for (Qpad, Ppad, Mpad) and the chunk rows (by default
    GRAM_CHUNK_BYTES of phi rows, at most Qpad): a function of the shapes
    alone, so K12's partial sums and their order do not depend on the
    card. Qpad and the chunk are whole ROW_TILE-row pieces (the affinity
    core's blocks). Raises on shapes the kernels cannot take."""
    if qpad < ROW_TILE or qpad % ROW_TILE:
        raise ValueError(f"Qpad {qpad} must be a positive multiple of "
                         f"{ROW_TILE}")
    phi = affinity_plan(qpad, ppad, mpad)
    if chunk is None:
        chunk = max(GRAM_CHUNK_GRAIN,
                    GRAM_CHUNK_BYTES // (4 * mpad) // GRAM_CHUNK_GRAIN
                    * GRAM_CHUNK_GRAIN)
    if chunk < ROW_TILE or chunk % ROW_TILE:
        raise ValueError(f"chunk {chunk} must be a positive multiple of "
                         f"{ROW_TILE}")
    chunk = min(chunk, qpad)
    last = qpad - (qpad - 1) // chunk * chunk
    return StreamGramPlan(chunk, -(-qpad // chunk), last, phi,
                          gram_plan(chunk, mpad), gram_plan(last, mpad))


# K12's float64 form (csrc/streaming.cu nle_stream_sample_gram): H =
# (diag(c) K)^T (diag(c) K), (Ppad, Ppad) in GS_TILE tiles, its lower tiles
# times row splits a grid of about GS_BLOCKS blocks (8 per SM of a 132-SM
# card), each split whole GS_ROWS-row steps.
GS_TILE = 64
GS_ROWS = 32
GS_BLOCKS = 1056


class SampleGramPlan(NamedTuple):
    """The sample-basis gram's launch: `tiles` lower GS_TILE tiles of H
    times `nsplit` contiguous row ranges of `split_rows` rows (the last
    shorter); scratch of nsplit * tiles * GS_TILE^2 doubles."""
    tiles: int
    nsplit: int
    split_rows: int

    @property
    def scratch_bytes(self) -> int:
        return 8 * self.nsplit * self.tiles * GS_TILE * GS_TILE


def stream_sample_gram_plan(qpad: int, ppad: int) -> SampleGramPlan:
    """The sample-basis gram's plan for (Qpad, Ppad): a function of the
    shapes alone, so each element's sum order (rows in increasing order
    within a split, the splits in order) does not depend on the card.
    Raises on shapes the kernel cannot take."""
    _check_stream_shape(qpad, ppad, 1)
    if ppad % GS_TILE:
        raise ValueError(f"Ppad {ppad} must be a multiple of {GS_TILE}")
    nt = ppad // GS_TILE
    tiles = nt * (nt + 1) // 2
    want = -(-GS_BLOCKS // tiles)
    split_rows = round_up(-(-qpad // want), GS_ROWS)
    return SampleGramPlan(tiles, -(-qpad // split_rows), split_rows)


def halfstep_route(ppad: int) -> str:
    """Which kernel runs a half-step on the card at this Ppad: "one_build"
    (K8's kernel, each entry built once) up to HS_MAX_PPAD, "two_pass"
    (K9's passes, K11's kernel then K10's) past it. Shape alone decides;
    nothing falls back."""
    return "one_build" if ppad <= HS_MAX_PPAD else "two_pass"


def pad_stream_operands(fa: torch.Tensor, fb: torch.Tensor):
    """The ONE padding rule of the streaming kernels: sample features
    (p, 3) -> (3, Ppad), rest features (q, 3) -> (3, Qpad), and the (1, Qpad)
    validity mask. Qpad is a TILE_Q multiple, Ppad a P_ALIGN multiple;
    pad entries are zero."""
    p, q = fa.shape[0], fb.shape[0]
    qpad = round_up(max(q, 1), TILE_Q)
    ppad = round_up(p, P_ALIGN)
    fa_rows = fa.new_zeros((3, ppad))
    fa_rows[:, :p] = fa.T
    fb_cols = fb.new_zeros((3, qpad))
    fb_cols[:, :q] = fb.T
    mask = (torch.arange(qpad, device=fb.device) < q).to(torch.float32)[None]
    return fa_rows, fb_cols, mask


# -- plain PyTorch twins (row chunks: one (chunk, Ppad) block at a time) ----
#
# ap = K^T x sums every pixel row into each sample: thousands of terms, which
# a plain fp32 matvec on the CPU adds one row after another (a relative error
# of ~2e-6 at 4,000 rows, 18x the interpreted Pallas kernel's). The ap twins
# therefore take the fp32 entries and accumulate in float64 within and
# across chunks, rounding once at the end: the class of the CUDA kernels'
# compensated sums (nle::kahan_add). K11's twin (out = K b, the two-pass
# K9's w) sums its Ppad terms in float64 too. Since the kernels sum in
# float64 as well (K8, K10, K11, the sample-basis gram), the twins are their
# arithmetic: fp32 entries, float64 sums; ap and the gram are returned in
# float64, K11's rows and x rounded once to fp32. The fp32 K12's twin (its
# phi-chunk gram, off the training path) stays fp32.
_ACC = torch.float64

def _affinity_rows(fa_rows, fb_cols, lo: int, hi: int, sw, pw):
    """(hi - lo, Ppad) affinity of pixels lo..hi against every sample, in
    nle::affinity's op order (exact differences, squared, then scaled)."""
    dr = fb_cols[0, lo:hi, None] - fa_rows[0][None, :]
    dc = fb_cols[1, lo:hi, None] - fa_rows[1][None, :]
    dy = fb_cols[2, lo:hi, None] - fa_rows[2][None, :]
    return torch.exp(-(sw * (dr * dr + dc * dc) + pw * (dy * dy)))


def _chunks(fa_rows, fb_cols):
    qpad = fb_cols.shape[1]
    step = (PLAIN_CHUNK_ROWS if fb_cols.is_cuda
            else max(64, PLAIN_CPU_ENTRIES // fa_rows.shape[1]))
    for lo in range(0, qpad, step):
        yield lo, min(lo + step, qpad)


def streaming_halfstep_plain(fa_rows, fb_cols, mask, u_pad, sw, pw, eps,
                             unit_x: bool = False):
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    if unit_x:
        x = mask[0]
    else:
        x = fb_cols.new_empty((qpad,))
        u_acc = u_pad.to(_ACC)
    ap = fa_rows.new_zeros((ppad,), dtype=_ACC)
    for lo, hi in _chunks(fa_rows, fb_cols):
        A = _affinity_rows(fa_rows, fb_cols, lo, hi, sw, pw).to(_ACC)
        if not unit_x:
            x[lo:hi] = safe_reciprocal(A @ u_acc, eps) * mask[0, lo:hi]
        ap += x[lo:hi].to(_ACC) @ A
    return x, ap


def streaming_halfstep_ptiled_plain(fa_rows, fb_cols, mask, u_pad, sw, pw,
                                    eps):
    """K9's plain twin: its two passes' arithmetic is K8's (x from each
    row's float64 w = K u, rounded once; ap = K^T x in float64), so it is
    K8's twin."""
    return streaming_halfstep_plain(fa_rows, fb_cols, mask, u_pad, sw, pw,
                                    eps)


def streaming_ap_plain(fa_rows, fb_cols, x_rows, sw, pw):
    ap = fa_rows.new_zeros((x_rows.shape[0], fa_rows.shape[1]), dtype=_ACC)
    for lo, hi in _chunks(fa_rows, fb_cols):
        ap += x_rows[:, lo:hi].to(_ACC) @ _affinity_rows(
            fa_rows, fb_cols, lo, hi, sw, pw).to(_ACC)
    return ap


def streaming_atb_plain(fa_rows, fb_cols, b_rows, sw, pw):
    """out = K b with the fp32 entries summed in _ACC, rounded once: the
    class of the kernel's compensated row sums, as the ap twins."""
    b_rows = b_rows[None] if b_rows.ndim == 1 else b_rows
    out = fb_cols.new_empty((b_rows.shape[0], fb_cols.shape[1]))
    b_acc = b_rows.to(_ACC)
    for lo, hi in _chunks(fa_rows, fb_cols):
        out[:, lo:hi] = b_acc @ _affinity_rows(fa_rows, fb_cols, lo, hi,
                                               sw, pw).to(_ACC).T
    return out


def streaming_sample_gram_plain(fa_rows, fb_cols, c_row, sw, pw):
    """H (Ppad, Ppad) = (diag(c) K)^T (diag(c) K) in float64 on the fp32
    entries (the sample-basis gram's twin)."""
    ppad = fa_rows.shape[1]
    H = fa_rows.new_zeros((ppad, ppad), dtype=_ACC)
    for lo, hi in _chunks(fa_rows, fb_cols):
        ck = c_row[0, lo:hi, None].to(_ACC) * _affinity_rows(
            fa_rows, fb_cols, lo, hi, sw, pw).to(_ACC)
        H += ck.T @ ck
    return H


def streaming_scaled_gram_plain(fa_rows, fb_cols, c_row, uinv_pad, sw, pw):
    mpad = uinv_pad.shape[1]
    Sb = fa_rows.new_zeros((mpad, mpad))
    for lo, hi in _chunks(fa_rows, fb_cols):
        cphi = c_row[0, lo:hi, None] * (
            _affinity_rows(fa_rows, fb_cols, lo, hi, sw, pw) @ uinv_pad)
        Sb += cphi.T @ cphi
    return Sb


# -- the kernel wrappers ------------------------------------------------------

def _check_layout(fa_rows, fb_cols) -> None:
    if fa_rows.shape[0] != 3 or fb_cols.shape[0] != 3:
        raise ValueError("features must be (3, Ppad) and (3, Qpad) rows")
    if fb_cols.shape[1] % TILE_Q or fa_rows.shape[1] % P_ALIGN:
        raise ValueError(
            f"Qpad {fb_cols.shape[1]} must be a {TILE_Q} multiple and Ppad "
            f"{fa_rows.shape[1]} a {P_ALIGN} multiple (pad_stream_operands)")


def _check_rows(rows) -> None:
    if not 1 <= rows.shape[0] <= MAX_ROWS:
        raise ValueError(f"{rows.shape[0]} rows: K10/K11 take 1 to {MAX_ROWS}")


def _mixed_on_card(f32_operands, vectors) -> bool:
    """cuda_or_cpu for K8, K9 and K11: the features (and mask) fp32, the
    vectors u or b fp32 or float64 (the kernels take them in float64)."""
    on_card = cuda_or_cpu(*f32_operands, *vectors)
    if on_card:
        cuda_or_cpu(*f32_operands, dtype=torch.float32)
        for v in vectors:
            if v.dtype not in (torch.float32, torch.float64):
                raise TypeError(f"kernel operand dtype {v.dtype}, expected "
                                "torch.float32 or torch.float64")
    return on_card


def _halfstep_kernel(fa_rows, fb_cols, mask, u_pad, sw, pw, eps, name,
                     route):
    """Launch the half-step on the card along route (halfstep_route's
    names): K8's kernel on halfstep_plan, or K9's two passes; u and ap
    float64 either way."""
    lib = _build.load()
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    dev = fb_cols.device
    x = torch.empty((qpad,), dtype=torch.float32, device=dev)
    if route == "one_build":
        entry, plan = lib.nle_stream_halfstep_onebuild, halfstep_plan(qpad,
                                                                      ppad)
        blocks = plan.blocks
    else:
        # Pass 1 on atb_plan, pass 2 on ap_plan (R = 1).
        apl = ap_plan(qpad, ppad, 1)
        entry, plan = lib.nle_stream_halfstep_ptiled, (
            *atb_plan(qpad, ppad, 1), *apl)
        blocks = apl.blocks
        fb_cols = _aligned(fb_cols)
    f64 = torch.float64
    u_pad = u_pad.to(f64).contiguous()
    ap = torch.empty((ppad,), dtype=f64, device=dev)
    partial = torch.empty((blocks, ppad), dtype=f64, device=dev)
    with torch.cuda.device(dev):
        status = entry(
            fb_cols.data_ptr(), fa_rows.data_ptr(), mask.data_ptr(),
            u_pad.data_ptr(), x.data_ptr(), partial.data_ptr(), ap.data_ptr(),
            qpad, ppad, *plan, float(sw), float(pw), float(eps),
            _build.stream_ptr(fb_cols))
    _build.check(status, name)
    _build.count_launch(name)
    return x, ap


def streaming_halfstep(fa_rows, fb_cols, mask, u_pad, sw, pw, eps,
                       unit_x: bool = False):
    """One phi-free Sinkhorn half-step over the rest pixels, the
    streaming_halfstep dispatch of the JAX package: Ppad <= 1792 is K8;
    past it unit_x runs K10 with x = mask, and a real half-step K9.

    fa_rows (3, Ppad), fb_cols (3, Qpad), mask (1, Qpad), u_pad (Ppad,) =
    Uinv t zero-padded, fp32 or float64. Returns (x (Qpad,) fp32, ap
    (Ppad,) float64); pad columns of ap are garbage the caller slices off.
    unit_x: x = mask, u unused (K10's kernel on the mask, counted as K8's
    launch)."""
    _check_layout(fa_rows, fb_cols)
    if fa_rows.shape[1] > MAX_STREAM_P_FUSED:
        if unit_x:
            return mask[0], streaming_ap(fa_rows, fb_cols, mask, sw, pw)[0]
        return streaming_halfstep_ptiled(fa_rows, fb_cols, mask, u_pad, sw,
                                         pw, eps)
    if not _mixed_on_card((fa_rows, fb_cols, mask), (u_pad,)):
        return streaming_halfstep_plain(fa_rows, fb_cols, mask, u_pad, sw,
                                        pw, eps, unit_x)
    if not unit_x:
        return _halfstep_kernel(fa_rows, fb_cols, mask, u_pad, sw, pw, eps,
                                "streaming_halfstep",
                                halfstep_route(fa_rows.shape[1]))
    return mask[0], _ap_kernel(fa_rows, fb_cols, mask, sw, pw,
                               "streaming_halfstep")[0]


def streaming_halfstep_ptiled(fa_rows, fb_cols, mask, u_pad, sw, pw, eps):
    """K8's contract (unit_x excluded) at any Ppad (K9): x (Qpad,) =
    mask * safe_recip(K u, eps), then ap (Ppad,) = K^T x. On the card K8's
    kernel up to HS_MAX_PPAD, two passes past it (halfstep_route)."""
    _check_layout(fa_rows, fb_cols)
    if not _mixed_on_card((fa_rows, fb_cols, mask), (u_pad,)):
        return streaming_halfstep_ptiled_plain(fa_rows, fb_cols, mask, u_pad,
                                               sw, pw, eps)
    return _halfstep_kernel(fa_rows, fb_cols, mask, u_pad, sw, pw, eps,
                            "streaming_halfstep_ptiled",
                            halfstep_route(fa_rows.shape[1]))


def two_pass_halfstep(fa_rows, fb_cols, mask, u_pad, sw, pw, eps):
    """K9's two passes on the card at any Ppad (the route halfstep_route
    takes past HS_MAX_PPAD): K11's kernel with x = mask * safe_recip(w,
    eps) as its epilogue, then K10's on x; counted as K9's launch. The
    yardstick chip_smoke holds K8's one-build kernel to at the same
    Ppad. On CPU tensors K9's plain version."""
    _check_layout(fa_rows, fb_cols)
    if not _mixed_on_card((fa_rows, fb_cols, mask), (u_pad,)):
        return streaming_halfstep_ptiled_plain(fa_rows, fb_cols, mask, u_pad,
                                               sw, pw, eps)
    return _halfstep_kernel(fa_rows, fb_cols, mask, u_pad, sw, pw, eps,
                            "streaming_halfstep_ptiled", "two_pass")


def streaming_ap(fa_rows, fb_cols, x_rows, sw, pw):
    """ap (R, Ppad) float64 = K^T x for x (R, Qpad) fp32, 1 <= R <= 3, zero
    on pad columns (K10: fp32 entries, float64 sums)."""
    _check_layout(fa_rows, fb_cols)
    _check_rows(x_rows)
    if not cuda_or_cpu(fa_rows, fb_cols, x_rows, dtype=torch.float32):
        return streaming_ap_plain(fa_rows, fb_cols, x_rows, sw, pw)
    return _ap_kernel(fa_rows, fb_cols, x_rows, sw, pw, "streaming_ap")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it at a 16-byte aligned address: K10's kernel
    stages fb's and x's rows with 16-byte cp.async copies."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ap_kernel(fa_rows, fb_cols, x_rows, sw, pw, name):
    """K10's kernel on ap_plan: x (R, Qpad) -> ap (R, Ppad) float64, counted
    under name."""
    lib = _build.load()
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    R = x_rows.shape[0]
    plan = ap_plan(qpad, ppad, R)
    dev = fb_cols.device
    fb_cols, x_rows = _aligned(fb_cols), _aligned(x_rows)
    ap = torch.empty((R, ppad), dtype=torch.float64, device=dev)
    partial = torch.empty((plan.blocks, R * ppad), dtype=torch.float64,
                          device=dev)
    with torch.cuda.device(dev):
        status = lib.nle_stream_ap(
            fb_cols.data_ptr(), fa_rows.data_ptr(), x_rows.data_ptr(),
            partial.data_ptr(), ap.data_ptr(), qpad, ppad, R, *plan,
            float(sw), float(pw), _build.stream_ptr(fb_cols))
    _build.check(status, name)
    _build.count_launch(name)
    return ap


def streaming_atb(fa_rows, fb_cols, b_rows, sw, pw):
    """out (R, Qpad) fp32 = K b for b (R, Ppad) zero beyond the true p
    (K11: fp32 entries, b and the sums float64, each row rounded once),
    1 <= R <= 3; a bare (Ppad,) vector gives (1, Qpad). Rows are
    independent."""
    _check_layout(fa_rows, fb_cols)
    b_rows = b_rows[None] if b_rows.ndim == 1 else b_rows
    _check_rows(b_rows)
    if not _mixed_on_card((fa_rows, fb_cols), (b_rows,)):
        return streaming_atb_plain(fa_rows, fb_cols, b_rows, sw, pw)
    b_rows = b_rows.to(torch.float64).contiguous()
    lib = _build.load()
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    R = b_rows.shape[0]
    plan = atb_plan(qpad, ppad, R)
    out = torch.empty((R, qpad), dtype=torch.float32, device=fb_cols.device)
    with torch.cuda.device(fb_cols.device):
        status = lib.nle_stream_atb(
            fb_cols.data_ptr(), fa_rows.data_ptr(), b_rows.data_ptr(),
            out.data_ptr(), qpad, ppad, R, *plan, float(sw), float(pw),
            _build.stream_ptr(fb_cols))
    _build.check(status, "streaming_atb")
    _build.count_launch("streaming_atb")
    return out


def streaming_sample_gram(fa_rows, fb_cols, c_row, sw, pw):
    """H (Ppad, Ppad) float64 = (diag(c) K)^T (diag(c) K) over the rest
    rows (K12's float64 form: fp32 entries, float64 products and sums), so
    Sb = Uinv^T H Uinv without phi. c_row (1, Qpad) fp32, zero on pad
    columns. Pad sample columns of H hold finite garbage the caller's zero
    Uinv rows drop. Counted as K12's launch."""
    _check_layout(fa_rows, fb_cols)
    if not cuda_or_cpu(fa_rows, fb_cols, c_row, dtype=torch.float32):
        return streaming_sample_gram_plain(fa_rows, fb_cols, c_row, sw, pw)
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    plan = stream_sample_gram_plan(qpad, ppad)
    lib = _build.load()
    dev = fb_cols.device
    f64 = torch.float64
    partial = torch.empty(plan.scratch_bytes // 8, dtype=f64, device=dev)
    H = torch.empty((ppad, ppad), dtype=f64, device=dev)
    with torch.cuda.device(dev):
        status = lib.nle_stream_sample_gram(
            fb_cols.data_ptr(), fa_rows.data_ptr(), c_row.data_ptr(),
            partial.data_ptr(), H.data_ptr(), qpad, ppad, *plan, float(sw),
            float(pw), _build.stream_ptr(fb_cols))
    _build.check(status, "streaming_gram")
    _build.count_launch("streaming_gram")
    return H


def streaming_scaled_gram(fa_rows, fb_cols, c_row, uinv_pad, sw, pw, *,
                          keep_phi: bool = False):
    """Sb (Mpad, Mpad) = (c phi_rest)^T (c phi_rest), phi_rest = K Uinv
    recomputed per row chunk, all fp32 (K12's fp32 form; the training
    routes take its float64 form, streaming_sample_gram, since the fp32
    phi loses Sb's small directions). c_row (1, Qpad) is zero on pad
    columns; uinv_pad (Ppad, Mpad), Mpad a 64 multiple (on the card a 128
    multiple). On the card the rows go in stream_gram_plan's chunks;
    keep_phi also returns the phi rows of the last chunk, pixel rows
    [Qpad - plan.last, Qpad) (the check that they are K1's)."""
    _check_layout(fa_rows, fb_cols)
    ppad, mpad = uinv_pad.shape
    if ppad != fa_rows.shape[1] or mpad % 64:
        raise ValueError(f"uinv_pad {tuple(uinv_pad.shape)} must be "
                         f"({fa_rows.shape[1]}, 64k)")
    if not cuda_or_cpu(fa_rows, fb_cols, c_row, uinv_pad,
                       dtype=torch.float32):
        if keep_phi:
            raise ValueError("keep_phi reads the kernel's scratch: card only")
        return streaming_scaled_gram_plain(fa_rows, fb_cols, c_row,
                                           uinv_pad, sw, pw)
    qpad = fb_cols.shape[1]
    plan = stream_gram_plan(qpad, ppad, mpad)
    lib = _build.load()
    dev = fb_cols.device
    f32 = torch.float32
    phi_chunk = torch.empty((plan.chunk, mpad), dtype=f32, device=dev)
    scratch = torch.empty(max(plan.full.scratch_bytes,
                              plan.tail.scratch_bytes) // 4,
                          dtype=f32, device=dev)
    part = torch.empty((mpad, mpad), dtype=f32, device=dev)
    comp = torch.empty((mpad, mpad), dtype=f32, device=dev)
    out = torch.empty((mpad, mpad), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        status = lib.nle_stream_gram(
            fb_cols.data_ptr(), fa_rows.data_ptr(), c_row.data_ptr(),
            uinv_pad.data_ptr(), phi_chunk.data_ptr(), scratch.data_ptr(),
            part.data_ptr(), comp.data_ptr(), out.data_ptr(), qpad, ppad,
            mpad, plan.chunk, plan.last, plan.full.nsplit,
            plan.full.split_rows, plan.tail.nsplit, plan.tail.split_rows,
            plan.full.chain_rows, float(sw), float(pw),
            _build.stream_ptr(fb_cols))
    _build.check(status, "streaming_gram")
    _build.count_launch("streaming_gram")
    return (out, phi_chunk[:plan.last]) if keep_phi else out


# -- the streaming Sinkhorn loop ---------------------------------------------

def streaming_loop(halfstep, ap0, Um, lam_m, ppad: int, max_iter: int,
                   eps: float):
    """The streaming Sinkhorn loop around a half-step (u_pad (Ppad,)
    float64 -> (x_rest, ap)) and the s0 pass's ap0 = K^T 1: returns (r_top,
    r_rest, c_top, c_rest), the top rows (the p samples) float64, the rest
    as the half-step gives them (fp32).

    The p-row projections around each half-step (u = Uinv t, x_top =
    safe_recip(Um t), s = Um^T x_top + Uinv^T ap) run in float64, with
    Uinv = Um / lambda formed in float64, and u goes to the half-step in
    float64. With eigenvalues down to 1e-10 s carries 1/lambda, and fp32
    rounding of these small products, repeated every half-step, moved the
    loop's c 2-10x further from its float64 twin than the kernels' own
    rounding does (PERF.md); in float64 they cost a few p x m matvecs a
    half-step. Give Um and lam_m in float64 (stage 1's own values): their
    fp32 rounding moves c ~4e-6 from the float64 loop's, against ~5e-8
    (PERF.md). The JAX package runs them in fp32."""
    f64 = torch.float64
    p = Um.shape[0]
    Um64 = Um.to(f64)
    lam64 = lam_m.to(f64)
    keep = lam64 > 0
    Uinv64 = torch.where(keep, Um64 / torch.where(keep, lam64, 1.0), 0.0)

    def half(t):
        u_pad = torch.nn.functional.pad(Uinv64 @ t, (0, ppad - p))
        x_top = safe_reciprocal(Um64 @ t, eps)
        x_rest, ap = halfstep(u_pad.contiguous())
        return x_top, x_rest, Um64.T @ x_top + Uinv64.T @ ap[:p].to(f64)

    s = Um64.sum(dim=0) + Uinv64.T @ ap0[:p].to(f64)
    r_top = r_rest = c_top = c_rest = None
    for _ in range(max_iter):
        c_top, c_rest, s = half(lam64 * s)
        r_top, r_rest, s = half(lam64 * s)
    return r_top, r_rest, c_top, c_rest


def streaming_sinkhorn_vectors(fa, fb, Um, lam_m, max_iter: int,
                               eps: float, sw, pw, top64: bool = False):
    """Sinkhorn balancing without phi: (r, c), each (N,) in packed
    [selected; rest] order for N = p + q. The p sampled rows of phi are Um
    (float64 projections, streaming_loop, which forms Uinv = Um / lam in
    float64, so nle_tpu's f32 Uinv argument is not taken; Um and lam_m are
    best stage 1's float64 values); the rest rows are recomputed every
    half-step by K8 (K9 past Ppad 1792), after one unit_x pass for s0 =
    phi^T 1 (K10 past 1792): 1 + 2 max_iter launches. The vectors are fp32;
    top64 also returns the p top rows of r and c in float64 (the host
    chain's Wa is built from them)."""
    p = Um.shape[0]
    q = fb.shape[0]
    fa_rows, fb_cols, mask = pad_stream_operands(fa, fb)
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    _, ap0 = streaming_halfstep(fa_rows, fb_cols, mask,
                                fa_rows.new_zeros((ppad,)), sw, pw, eps,
                                unit_x=True)
    if max_iter < 1:
        r = torch.cat([fa_rows.new_ones((p,)), fb_cols.new_ones((q,))])
        c = fa_rows.new_zeros((p + q,))
        if top64:
            return r, c, r[:p].double(), c[:p].double()
        return r, c
    r_top, r_rest, c_top, c_rest = streaming_loop(
        lambda u: streaming_halfstep(fa_rows, fb_cols, mask, u, sw, pw, eps),
        ap0, Um, lam_m, ppad, max_iter, eps)
    r = torch.cat([r_top.float(), r_rest[:q]])
    c = torch.cat([c_top.float(), c_rest[:q]])
    return (r, c, r_top, c_top) if top64 else (r, c)
