"""The Sinkhorn half-step kernels (CUDA, csrc/sinkhorn.cu), the int16
carrier around them, the Sinkhorn knobs, and the two Sinkhorn loops of
stage 2a.

Each half-step reads the factor once and computes
    x = safe_recip(Q t, eps),   s = Q^T x.
- K3 (int16) and K4 (f32) replace nle_tpu/ops/pallas/sinkhorn_kernel.py:121
  `_kernel_manual` (via `sinkhorn_halfstep_manual`, call :312), its
  packed-int16 and f32 branches; K14 is its bf16 branch, the
  NLE_SINKHORN_BF16 preview mode (t and x rounded to bf16 before their
  products, as the TPU casts them; not golden-safe).
- K13 replaces `_kernel` (:45, via `sinkhorn_halfstep_pallas`, call :95),
  the f32 half-step behind NLE_SINKHORN_KERNEL=auto: K4's function in the
  TPU kernel's decomposition (TILE_N row tiles, s summed in 8 stripes), on
  K4's staging (a persistent grid of whole tiles, k13_plan) with its own
  fixed sum orders.
- K15 replaces the probe of tools/bench_sk_dmaonly.py:68 and returns its
  (8, max(mpad, chunk)) block (dmaonly / wonly / wpart): K13's sweep with
  one block per chunk and parts of its work dropped, the measured
  streaming floor the half-steps are judged against
  (nle_tpu_torch/tools/bench_sk_dmaonly.py).

`sinkhorn_vectors_split` (the default split layout) runs K3 2 x n_iter
times a train; `sinkhorn_vectors_fused` (the assembled layout) runs the
bf16 lead on K14, the int16 carrier on K3, or f32 on K4 (K13 under
NLE_SINKHORN_KERNEL=auto), as the JAX loop resolves its knobs.

On the H100 the half-step is memory-bound (1.3 GB int16 or bf16 / 2.6 GB
f32 per call at the 1 MP main path, 2.6 GFLOP). K3/K4/K14 run a persistent
grid (sinkhorn_plan, from the shapes alone) whose CTAs stream their row
ranges through a shared-memory ring filled by bulk copies on mbarriers
(K19's staging), form w one warp per row, and add the CTA's partial s
while the sub-tile is on chip; partial sums go to a scratch reduced in a
fixed order (no float atomics, so training is bitwise repeatable). A row
must be a 16-byte multiple (the bulk copy's unit). K3
takes exact fp32 products of the int16 values, where the TPU splits them
into bf16 pieces and drops the lo*lo term (~2^-17 relative): the port is
tight against its plain version and differs from the TPU by that class.

TPU-only machinery left behind: the int32 pair-packing of the int16 copy
(`pack_pairs_int32`, an (8,128)-tiling device) — the port stores a plain
(npad, mpad) int16 tensor in natural row order — the packed chunk sizing
(`_packed_chunk`) and the doubled bf16 DMA chunk. The TILE_N halving rule
stays: it is K13's decomposition.

The knobs are read at call time (the port has no jit), with the JAX
package's values and precedence: NLE_SINKHORN_KERNEL (manual|auto),
NLE_SINKHORN_BF16 (resolve_bf16_iters), NLE_SINKHORN_INT16
(resolve_int16, int16_forced_on), NLE_INT16_GUARD (resolve_int16_guard)
and NLE_STAGE2_SPLIT (resolve_split_stage2).

Width: the kernels take mpad <= MAX_MPAD factor columns (a dense sampling
grid's nearly full rank reaches mpad 2176 at p = 2112); the plain versions
take any width.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import (
    SHARED_LIMIT,
    cuda_or_cpu,
    round_up,
)
from nle_tpu_torch.ops.linalg import safe_reciprocal

# Widest factor K3/K4 take, the port's one width limit of the dense route
# (the wrapper refuses wider, resolve_streaming streams past it): a one-row
# f32 tile plus the t and s rows still fit the kernel's shared memory.
MAX_MPAD = 16384

# Row alignment of every N-scale buffer of stage 2: a multiple of every
# kernel's row tile, and the JAX package's padded_shape rule (2 x 1024), so
# the two packages lay out the same shapes.
ROW_ALIGN = 2048


# K13's row tile (the TPU kernel's TILE_N), halved for wide factors.
TILE_N = 1024


def k13_tile(mpad: int, tile: int = TILE_N) -> int:
    """K13's row tile for an mpad-wide factor: the JAX loop's rule
    (sinkhorn_vectors_fused), halved while two f32 tiles exceed 12 MiB,
    down to 256 rows."""
    while tile > 256 and 2 * tile * mpad * 4 > 12 * 2**20:
        tile //= 2
    return tile


def padded_shape(n: int, m: int) -> tuple[int, int]:
    """(rows, cols) of the assembled f32 factor [Um; phi_b]."""
    return round_up(max(n, 1), ROW_ALIGN), round_up(max(m, 1), 128)


def split_row_pad(nb: int) -> int:
    """Padded row count of the rest block in the split stage 2a."""
    return round_up(max(nb, 1), ROW_ALIGN)


# -- the int16 carrier (K5 quantize prep: plain torch in this port) --------

# Rows of phi one step of the int16 prep reads at a time. Its f32 and bool
# temporaries stay ~170 MB at mpad 640, so the split stage 2a holds phi_b
# and its int16 copy (1.5 x phi) instead of three phi-sized arrays, which
# also fragmented the allocator's cache near the card's capacity.
PREP_CHUNK_ROWS = 65536


def _row_chunks(rows: int):
    for lo in range(0, rows, PREP_CHUNK_ROWS):
        yield lo, min(lo + PREP_CHUNK_ROWS, rows)


def quantize_int16(phi: torch.Tensor):
    """Per-COLUMN int16 quantization of an f32 factor. Returns (q int16,
    scale (cols,) with 1.0 on all-zero columns, colmax (cols,)); phi ~
    q * scale. torch.round rounds half to even, like jnp.round. Works in
    row chunks; every step is elementwise or an exact max, so the result
    does not depend on the chunking."""
    colmax = torch.stack([phi[lo:hi].abs().amax(dim=0)
                          for lo, hi in _row_chunks(phi.shape[0])]).amax(dim=0)
    scale = torch.where(colmax > 0, colmax / 32767.0, torch.ones_like(colmax))
    q16 = torch.empty(phi.shape, dtype=torch.int16, device=phi.device)
    for lo, hi in _row_chunks(phi.shape[0]):
        q = phi[lo:hi] / scale[None, :]
        q16[lo:hi] = q.round_().clamp_(-32767, 32767)
    return q16, scale, colmax


def crush_counts(phi: torch.Tensor, scale: torch.Tensor):
    """(crushed, nonzero) counts as float32 scalars: an entry is crushed
    when it is nonzero and quantizes to 0 (|phi| < scale/2). Summed per
    row chunk, then over the chunks."""
    num = phi.new_zeros(())
    den = phi.new_zeros(())
    for lo, hi in _row_chunks(phi.shape[0]):
        chunk = phi[lo:hi]
        nz = chunk != 0
        num += ((chunk.abs() < 0.5 * scale[None, :]) & nz).sum(
            dtype=torch.float32)
        den += nz.sum(dtype=torch.float32)
    return num, den


def carrier_crush_frac(phi: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Fraction of nonzero factor entries the int16 carrier crushes to 0 —
    the runtime validity statistic of the quantized trajectory (real
    images <= 0.09, uniform noise at small hx >= 0.32; see nle_tpu
    carrier_crush_frac)."""
    num, den = crush_counts(phi, scale)
    return num / torch.clamp(den, min=1.0)


# -- the Sinkhorn knobs (read at call time) ---------------------------------

# Crush-fraction threshold of the carrier guard: the geometric middle of
# the measured gap (real images <= 0.09, uniform noise at small hx >= 0.32).
INT16_GUARD = 0.2


def resolve_sinkhorn_kernel() -> str:
    """NLE_SINKHORN_KERNEL: "manual" (default; K3/K4/K14) or "auto" (K13,
    f32 only). Any other value raises: a typo must not silently select the
    manual kernel."""
    kind = os.environ.get("NLE_SINKHORN_KERNEL", "manual").lower()
    if kind not in ("manual", "auto"):
        raise ValueError(
            f"NLE_SINKHORN_KERNEL={kind!r}: expected manual|auto")
    return kind


def resolve_bf16_iters(max_iter: int, bf16_iters: int | None) -> int:
    """How many leading iterations run on the bf16 factor copy (K14).

    Off by default: the bf16 trajectory carries ~1e-3 relative error into
    (r, c) that the f32 polish cannot erase within the fixed iteration
    budget (nle_tpu measured rock2 62 -> 24 dB golden PSNR); a preview
    mode only. An explicitly set env var wins over the argument:
      - unset: the argument (None -> 0), clamped to [0, max_iter];
      - off/0/false: 0;
      - all: every iteration, no f32 polish;
      - an integer: that count, clamped;
      - auto/on/1/true: the argument if given, else all but the last 2
        iterations (0 when that leaves fewer than 2).
    Anything else raises ValueError."""
    raw = os.environ.get("NLE_SINKHORN_BF16")
    arg = 0 if bf16_iters is None else max(0, min(max_iter, bf16_iters))
    if raw is None:
        return arg
    env = raw.lower()
    if env in ("off", "0", "false"):
        return 0
    if env == "all":
        return max_iter
    if env not in ("auto", "on", "1", "true"):
        try:
            return max(0, min(max_iter, int(env)))
        except ValueError:
            raise ValueError(
                f"NLE_SINKHORN_BF16={env!r}: expected off/auto/all or an "
                "integer iteration count") from None
    if bf16_iters is not None:
        return arg
    lead = max_iter - 2
    return lead if lead >= 2 else 0


def resolve_int16(n_bf16: int = 0) -> bool:
    """Whether the f32 iterations stream the per-column-scaled int16 copy
    (K3): NLE_SINKHORN_INT16 auto (default) or on/1/true, and no bf16 lead
    scheduled (the bf16 schedule's trailing iterations are an f32 polish);
    off/0/false never. Anything else raises ValueError."""
    raw = os.environ.get("NLE_SINKHORN_INT16", "auto").lower()
    if raw in ("off", "0", "false"):
        return False
    if raw not in ("auto", "on", "1", "true"):
        raise ValueError(
            f"NLE_SINKHORN_INT16={raw!r}: expected auto/on/off")
    return n_bf16 == 0


def int16_forced_on() -> bool:
    """Whether the operator explicitly forced the int16 carrier on
    (NLE_SINKHORN_INT16=on/1/true, not the default auto): the guard then
    warns and keeps the carrier."""
    return os.environ.get(
        "NLE_SINKHORN_INT16", "auto").lower() in ("on", "1", "true")


def resolve_int16_guard() -> float | None:
    """The guard's crush-fraction threshold, or None when disabled.
    NLE_INT16_GUARD: off/false/none disables, a float in (0, 1] overrides,
    unset is INT16_GUARD. Anything else raises ValueError."""
    raw = os.environ.get("NLE_INT16_GUARD", str(INT16_GUARD)).lower()
    if raw in ("off", "false", "none"):
        return None
    try:
        val = float(raw)
    except ValueError:
        raise ValueError(
            f"NLE_INT16_GUARD={raw!r}: expected off or a float threshold"
        ) from None
    if not 0.0 < val <= 1.0:
        raise ValueError(
            f"NLE_INT16_GUARD={val}: threshold must be in (0, 1]")
    return val


def carrier_guard_decision(crush: float, log, context: str,
                           action: str) -> bool:
    """The guard policy: over the threshold -> warn + True (the caller
    retrains through the f32 carrier), unless the operator forced the
    carrier on (warn + False: the override wins)."""
    threshold = resolve_int16_guard()
    if threshold is None or not crush > threshold:
        return False
    if int16_forced_on():
        log.warning(
            "int16 Sinkhorn carrier out of its validity domain (%s %.3f "
            "> %.3f) but NLE_SINKHORN_INT16 is forced on — continuing "
            "with the quantized trajectory; expect degraded output on "
            "this input.", context, crush, threshold)
        return False
    log.warning(
        "int16 Sinkhorn carrier out of its validity domain (%s %.3f > "
        "%.3f: this input packs more dynamic range into phi columns than "
        "int16's ~4.5 decades): %s through the f32 carrier. "
        "NLE_INT16_GUARD tunes/disables this guard.",
        context, crush, threshold, action)
    return True


def resolve_split_stage2(max_iter: int) -> bool:
    """Whether dense stage 2a takes the split layout: exactly when the int16
    carrier resolves (manual kernel, no bf16 lead, NLE_SINKHORN_INT16 not
    off), under NLE_STAGE2_SPLIT auto (default). off forces the assembled
    layout; on raises ValueError when the carrier does not resolve (the
    split layout cannot run without it). Anything else raises."""
    raw = os.environ.get("NLE_STAGE2_SPLIT", "auto").lower()
    if raw in ("off", "0", "false"):
        return False
    if raw not in ("auto", "on", "1", "true"):
        raise ValueError(
            f"NLE_STAGE2_SPLIT={raw!r}: expected auto/on/off")
    kernel_kind = os.environ.get("NLE_SINKHORN_KERNEL", "manual").lower()
    carrier = (kernel_kind == "manual"
               and resolve_int16(resolve_bf16_iters(max_iter, None)))
    if raw in ("on", "1", "true") and not carrier:
        raise ValueError(
            "NLE_STAGE2_SPLIT=on but the int16 carrier does not resolve "
            f"(NLE_SINKHORN_KERNEL={kernel_kind!r}, NLE_SINKHORN_INT16/"
            "bf16-lead state): the split layout cannot run without the "
            "carrier — fix the conflicting knob or use auto")
    return carrier


def colsum64(phi: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """phi^T x for a float32 phi (rows, cols) and x (rows,), accumulated in
    float64 by row chunks (no float64 copy of phi) and rounded once to
    float32: the plain versions' class of the kernels' compensated sums."""
    acc = torch.zeros((phi.shape[1],), dtype=torch.float64, device=phi.device)
    for lo, hi in _row_chunks(phi.shape[0]):
        acc += phi[lo:hi].T.double() @ x[lo:hi].double()
    return acc.float()


def rowdot64(phi: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """phi t for a float32 phi (rows, cols) and t (cols,), each row's sum
    in float64 (row chunks) and rounded once to float32.

    An fp32 matrix-vector product on the CPU sums in the order in which
    the BLAS splits it over its threads, which follows the thread count
    it picks at run time, so its bits differ between processes. A float64
    sum of the exact fp32 products is ~1e-16 relative from exact, so its
    one rounding to float32 gives the same bits whatever the split."""
    out = torch.empty((phi.shape[0],), dtype=torch.float32, device=phi.device)
    t64 = t.double()
    for lo, hi in _row_chunks(phi.shape[0]):
        out[lo:hi] = phi[lo:hi].double() @ t64
    return out


# -- K3/K4/K14 ---------------------------------------------------------------

_HALFSTEP = {
    torch.int16: ("nle_sinkhorn_halfstep_i16", "sinkhorn_halfstep_int16"),
    torch.float32: ("nle_sinkhorn_halfstep_f32", "sinkhorn_halfstep_f32"),
    torch.bfloat16: ("nle_sinkhorn_halfstep_bf16", "sinkhorn_halfstep_bf16"),
}


def sinkhorn_halfstep_plain(Q: torch.Tensor, t: torch.Tensor, eps: float):
    """Plain PyTorch half-step: (x, s) = (safe_recip(Q t), Q^T x) with Q
    cast to float32 (exact for int16 and bf16). For a bf16 Q, t and x are
    rounded to bf16 before their products, as K14 (and the TPU) take them.
    s is colsum64: the kernels compensate their long sums over rows, and a
    plain fp32 matvec over ~10^4 rows on the CPU strayed 1.2e-4 from
    float64 over ten iterations on the guard's noise frame (nle_tpu 6.6e-7).
    Q t is rowdot64, so x has the same bits at every CPU thread count."""
    Qf = Q.float()
    bf16 = Q.dtype == torch.bfloat16
    if bf16:
        t = t.to(torch.bfloat16).float()
    x = safe_reciprocal(rowdot64(Qf, t), eps)
    return x, colsum64(Qf, x.to(torch.bfloat16).float() if bf16 else x)


# K3/K4/K14's bulk-copy sweep (csrc/sinkhorn.cu halfstep_bulk_kernel): a
# persistent grid of at most SK_CTAS CTAs (two an SM of a 132-SM card; a
# constant, so the plan and the order of s depend on the shapes alone),
# each walking its contiguous row range in sub-tiles of `rows` rows through
# a ring of `slots` shared-memory slots filled by bulk copies. On the H100
# two CTAs an SM with two 40 KB slots each ran fastest of the ring and
# sub-tile sizes tried at 1 MP and at mpad 2176 (PERF.md).
SK_CTAS = 264
SK_THREADS = 256
SK_MAX_ROWS = 32          # rows of a sub-tile (x's shared buffers)
SK_MAX_SLOTS = 16         # mbarriers in the shared memory's first 128 B
SK_SLOT_BYTES = 40 << 10  # a sub-tile: the most rows (a power of 2) held
SK_RING_BYTES = 96 << 10  # the ring: as many slots as this holds, 2 at least


class SinkhornPlan(NamedTuple):
    """K3/K4/K14's launch: CTA b owns rows [b per_cta, min((b + 1)
    per_cta, npad)), walked `rows` at a time through `slots` bulk-copied
    sub-tiles; shared_bytes: the slots' mbarriers, the ring, a partial s
    row per row group (sweep_groups), t for 16-bit factors and x's two
    buffers."""
    rows: int
    slots: int
    ctas: int
    per_cta: int
    shared_bytes: int


def sweep_groups(mpad: int, dtype: torch.dtype) -> int:
    """Row groups of the sweep's s pass (csrc bulk_groups): as many whole
    copies of a row's 16-byte chunks as the block's threads hold, each
    summing every groups-th row into its own partial s row."""
    chunks = mpad * torch.empty((), dtype=dtype).element_size() // 16
    return 1 if chunks >= SK_THREADS else SK_THREADS // max(chunks, 1)


def sinkhorn_plan(npad: int, mpad: int, dtype: torch.dtype,
                  chunk: int | None = None) -> SinkhornPlan:
    """The half-step kernels' plan for an (npad, mpad) factor of dtype: a
    function of the shapes alone. chunk (K15's probe): each CTA's row
    range a whole number of `chunk` rows, each of whole sub-tiles. Raises
    on shapes the kernel cannot take: a row that is not a 16-byte multiple
    (the bulk copy's unit) or a width whose ring and vectors do not fit
    one block's shared memory."""
    if dtype not in _HALFSTEP:
        raise TypeError(f"half-step factor dtype {dtype}: int16, float32 "
                        "or bfloat16")
    esize = torch.empty((), dtype=dtype).element_size()
    row_bytes = mpad * esize
    if npad < 1 or mpad < 1 or row_bytes % 16:
        raise ValueError(f"the half-step kernels take rows of a 16-byte "
                         f"multiple; got ({npad}, {mpad}) {dtype}")
    rows = 1
    while rows < SK_MAX_ROWS and 2 * rows * row_bytes <= SK_SLOT_BYTES:
        rows *= 2
    if chunk is not None:
        if chunk < 1:
            raise ValueError(f"chunk {chunk} must be positive")
        while chunk % rows:
            rows //= 2
    per_cta = round_up(-(-npad // SK_CTAS), chunk or rows)
    # No more slots than a CTA has sub-tiles.
    slots = min(SK_MAX_SLOTS, per_cta // rows,
                SK_RING_BYTES // (rows * row_bytes))
    slots = max(2, slots)
    vectors = sweep_groups(mpad, dtype) + (1 if esize == 2 else 0)
    shared = 128 + slots * rows * row_bytes + 4 * (vectors * mpad
                                                   + 2 * SK_MAX_ROWS)
    if shared > SHARED_LIMIT:
        raise ValueError(f"a {mpad}-column {dtype} factor needs {shared} B "
                         f"of shared memory (limit {SHARED_LIMIT})")
    return SinkhornPlan(rows, slots, -(-npad // per_cta), per_cta, shared)


def launch_sweep(fn, Q, t, x, partial, s, *args):
    """Call a sweep's C entry on (Q, t, x, partial, s, *args) on Q's device
    and current stream; returns its cudaError_t."""
    with torch.cuda.device(Q.device):
        return fn(Q.data_ptr(), t.data_ptr(), x.data_ptr(), partial.data_ptr(),
                  s.data_ptr(), *args, _build.stream_ptr(Q))


def _check_width(Q: torch.Tensor, t: torch.Tensor) -> None:
    if t.dtype != torch.float32:
        raise TypeError(f"t dtype {t.dtype}, expected float32")
    if Q.shape[1] > MAX_MPAD:
        raise ValueError(f"half-step factor of {Q.shape[1]} columns: the "
                         f"kernel takes at most MAX_MPAD = {MAX_MPAD}")


def sinkhorn_halfstep(Q: torch.Tensor, t: torch.Tensor, eps: float):
    """One fused half-step. Q (npad, mpad) int16 (K3), float32 (K4) or
    bfloat16 (K14), t (mpad,) float32. Returns (x (npad,), s (mpad,)),
    float32."""
    if Q.dtype not in _HALFSTEP:
        raise TypeError(f"half-step factor dtype {Q.dtype}: int16, float32 "
                        "or bfloat16")
    if not cuda_or_cpu(Q, t):
        return sinkhorn_halfstep_plain(Q, t, eps)
    _check_width(Q, t)
    npad, mpad = Q.shape
    plan = sinkhorn_plan(npad, mpad, Q.dtype)
    if Q.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("half-step operands must be 16-byte aligned")
    lib = _build.load()
    x = torch.empty((npad,), dtype=torch.float32, device=Q.device)
    s = torch.empty((mpad,), dtype=torch.float32, device=Q.device)
    partial = torch.empty((plan.ctas, mpad), dtype=torch.float32,
                          device=Q.device)
    fn, name = _HALFSTEP[Q.dtype]
    _build.check(launch_sweep(getattr(lib, fn), Q, t, x, partial, s, npad,
                              mpad, *plan, float(eps)), name)
    _build.count_launch(name)
    return x, s


# -- K13 ---------------------------------------------------------------------

K13_STRIPES = 8   # the TPU kernel's (8, mpad) s accumulator


def striped_sum(parts: torch.Tensor, stripes: int) -> torch.Tensor:
    """The kernels' fixed-order sum of per-tile partials (nparts, len):
    part i added to stripe i % stripes in increasing i, then the stripes
    in order, plain fp32 adds. stripes = 8 is the TPU kernels' (8, mpad)
    accumulator and its jnp.sum; stripes = 1 one accumulator in order."""
    nparts, width = parts.shape
    # Zero parts pad the count to a stripe multiple: adding 0 is exact.
    nk = -(-nparts // stripes)
    parts = torch.nn.functional.pad(parts, (0, 0, 0, nk * stripes - nparts))
    parts = parts.view(nk, stripes, width)
    acc = torch.zeros((stripes, width), dtype=parts.dtype,
                      device=parts.device)
    for k in range(nk):
        acc += parts[k]
    total = torch.zeros((width,), dtype=parts.dtype, device=parts.device)
    for r in range(stripes):
        total += acc[r]
    return total


def tile_partials(phi: torch.Tensor, x: torch.Tensor,
                  tile: int) -> torch.Tensor:
    """Each row tile's partial x_tile^T phi_tile, (npad / tile, mpad)."""
    npad, mpad = phi.shape
    ntiles = npad // tile
    return torch.bmm(x.view(ntiles, 1, tile),
                     phi.view(ntiles, tile, mpad))[:, 0]


def _check_tiles(phi: torch.Tensor, tile: int) -> None:
    npad, mpad = phi.shape
    if npad % tile or mpad % 128:
        raise ValueError(
            f"phi_pad {tuple(phi.shape)} must be (k*{tile}, j*128) — use "
            "padded_shape()")


def sinkhorn_halfstep_tiled_plain(phi: torch.Tensor, t: torch.Tensor,
                                  eps: float, tile: int):
    """K13's plain twin: x = safe_recip(phi t); each tile's partial
    x_tile^T phi_tile, added to stripe i % 8 in increasing tile i, then
    the 8 stripes summed in order (the TPU kernel's s order)."""
    _check_tiles(phi, tile)
    x = safe_reciprocal(phi @ t, eps)
    return x, striped_sum(tile_partials(phi, x, tile), K13_STRIPES)


class K13Plan(NamedTuple):
    """K13's launch: CTA b owns the whole tiles [b per_cta, min((b + 1)
    per_cta, ntiles)), their rows walked `rows` at a time (rows divides the
    tile) through `slots` bulk-copied sub-tiles; shared_bytes: the slots'
    mbarriers, the ring, the tile's s row and x's two buffers."""
    rows: int
    slots: int
    ctas: int
    per_cta: int
    shared_bytes: int


def k13_plan(npad: int, mpad: int, tile: int) -> K13Plan:
    """K13's plan for an (npad, mpad) f32 factor in row tiles of `tile`: a
    function of the shapes alone, so the kernel's split of the work does
    not depend on the card. K4's staging (sinkhorn_plan: sub-tiles of at
    most SK_SLOT_BYTES, a ring of at most SK_RING_BYTES, at most SK_CTAS
    CTAs), with sub-tiles that divide the tile and every CTA a run of whole
    tiles: two CTAs fit an SM to mpad 5760. Raises on shapes the
    kernel cannot take: a tile that does not divide npad, a row that is not
    a 16-byte multiple, or a width whose ring and s row do not fit one
    block's shared memory."""
    row_bytes = 4 * mpad
    if npad < 1 or mpad < 1 or row_bytes % 16:
        raise ValueError(f"K13 takes a non-empty factor whose rows are a "
                         f"16-byte multiple; got ({npad}, {mpad})")
    if tile < 1 or npad % tile:
        raise ValueError(f"K13 tile {tile}: npad {npad} must be a positive "
                         "multiple of it")
    rows = 1
    while (rows < SK_MAX_ROWS and tile % (2 * rows) == 0
           and 2 * rows * row_bytes <= SK_SLOT_BYTES):
        rows *= 2
    ntiles = npad // tile
    per_cta = -(-ntiles // SK_CTAS)
    # No more slots than a CTA has sub-tiles.
    slots = max(2, min(SK_MAX_SLOTS, per_cta * tile // rows,
                       SK_RING_BYTES // (rows * row_bytes)))
    shared = 128 + slots * rows * row_bytes + 4 * (mpad + 2 * SK_MAX_ROWS)
    if shared > SHARED_LIMIT:
        raise ValueError(f"K13 at mpad {mpad} needs {shared} B of shared "
                         f"memory (limit {SHARED_LIMIT})")
    return K13Plan(rows, slots, -(-ntiles // per_cta), per_cta, shared)


def tiled_halfstep_launch(phi: torch.Tensor, t: torch.Tensor, eps: float,
                          tile: int):
    """Launch K13 on a CUDA phi (npad, mpad) float32 with npad a multiple
    of `tile` (any width up to MAX_MPAD) on k13_plan and count it."""
    _check_width(phi, t)
    npad, mpad = phi.shape
    plan = k13_plan(npad, mpad, tile)
    if phi.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("K13 operands must be 16-byte aligned")
    lib = _build.load()
    x = torch.empty((npad,), dtype=torch.float32, device=phi.device)
    s = torch.empty((mpad,), dtype=torch.float32, device=phi.device)
    partial = torch.empty((npad // tile, mpad), dtype=torch.float32,
                          device=phi.device)
    _build.check(launch_sweep(lib.nle_sinkhorn_tiled_f32, phi, t, x, partial,
                              s, npad, mpad, tile, *plan, float(eps)),
                 "sinkhorn_halfstep_tiled")
    _build.count_launch("sinkhorn_halfstep_tiled")
    return x, s


def sinkhorn_halfstep_tiled(phi: torch.Tensor, t: torch.Tensor, eps: float,
                            tile: int | None = None):
    """K13: K4's function in the TPU kernel's decomposition. phi (npad,
    mpad) float32 with npad a multiple of the row tile (default
    k13_tile(mpad)) and mpad of 128, t (mpad,) float32. Returns (x (npad,),
    s (mpad,))."""
    if phi.dtype != torch.float32:
        raise TypeError(f"K13 factor dtype {phi.dtype}: float32 only")
    tile = k13_tile(phi.shape[1]) if tile is None else tile
    if not cuda_or_cpu(phi, t):
        return sinkhorn_halfstep_tiled_plain(phi, t, eps, tile)
    _check_tiles(phi, tile)
    return tiled_halfstep_launch(phi, t, eps, tile)


# -- K15: the streaming probe ----------------------------------------------

PROBE_VARIANTS = {"dmaonly": 1, "wonly": 2, "wpart": 3}
PROBE_ROWS = 8               # the probe's (8, width) output block
PROBE_WONLY_COLS = 1024      # its s[0, :1024] += w[:, :1024]


def check_probe(npad: int, mpad: int, variant: str, chunk: int) -> int:
    """Raise ValueError where the TPU probe drops rows (npad % chunk) or
    fails to trace (wonly: the (1, min(1024, width)) and (1, min(1024,
    chunk)) slices must agree, width = max(mpad, chunk)). Returns the
    output width."""
    if variant not in PROBE_VARIANTS:
        raise ValueError(f"probe variant {variant!r}: expected one of "
                         f"{sorted(PROBE_VARIANTS)}")
    if chunk < 1 or npad % chunk:
        raise ValueError(f"probe chunk {chunk}: npad {npad} must be a "
                         "positive multiple of it (the TPU probe would "
                         "drop rows)")
    width = max(mpad, chunk)
    if (variant == "wonly" and min(PROBE_WONLY_COLS, width)
            != min(PROBE_WONLY_COLS, chunk)):
        raise ValueError(
            f"wonly at chunk {chunk}, mpad {mpad}: the TPU probe does not "
            f"trace (s[0, :{min(PROBE_WONLY_COLS, width)}] += "
            f"w[:, :{min(PROBE_WONLY_COLS, chunk)}])")
    return width


def sinkhorn_probe_plain(phi: torch.Tensor, t: torch.Tensor, variant: str,
                         chunk: int) -> torch.Tensor:
    """K15's plain twin: the TPU probe's (8, max(mpad, chunk)) block. Row
    0 over the chunks of `chunk` rows, added in chunk order: dmaonly
    sum_i phi[i chunk]; wonly sum_c w_c[:L] with w_c = phi_c t and L =
    min(1024, chunk); wpart sum_c w_c^T phi_c. Every other element 0."""
    npad, mpad = phi.shape
    width = check_probe(npad, mpad, variant, chunk)
    out = torch.zeros((PROBE_ROWS, width), dtype=torch.float32,
                      device=phi.device)
    if variant == "dmaonly":
        out[0, :mpad] = striped_sum(phi[::chunk], 1)
        return out
    w = phi @ t
    if variant == "wonly":
        fold = min(PROBE_WONLY_COLS, chunk)
        out[0, :fold] = striped_sum(w.view(-1, chunk)[:, :fold], 1)
    else:
        out[0, :mpad] = striped_sum(tile_partials(phi, w, chunk), 1)
    return out


def sinkhorn_probe(phi: torch.Tensor, t: torch.Tensor, variant: str,
                   chunk: int) -> torch.Tensor:
    """K15: the TPU probe of tools/bench_sk_dmaonly.py on an f32 phi
    (npad, mpad), on K4's bulk-copy sweep with each CTA's rows whole
    chunks (sinkhorn_plan's chunk); returns what sinkhorn_probe_plain
    returns."""
    if phi.dtype != torch.float32:
        raise TypeError(f"probe factor dtype {phi.dtype}: float32 only")
    npad, mpad = phi.shape
    width = check_probe(npad, mpad, variant, chunk)
    if not cuda_or_cpu(phi, t):
        return sinkhorn_probe_plain(phi, t, variant, chunk)
    _check_width(phi, t)
    plan = sinkhorn_plan(npad, mpad, phi.dtype, chunk)
    if phi.data_ptr() % 16 or t.data_ptr() % 16:
        raise ValueError("probe operands must be 16-byte aligned")
    lib = _build.load()
    x = torch.empty((npad,), dtype=torch.float32, device=phi.device)
    out = torch.empty((PROBE_ROWS, width), dtype=torch.float32,
                      device=phi.device)
    partial = torch.empty((npad // chunk, mpad), dtype=torch.float32,
                          device=phi.device)
    name = f"sinkhorn_probe_{variant}"
    _build.check(launch_sweep(lib.nle_sinkhorn_probe_f32, phi, t, x, partial,
                              out, npad, mpad, chunk,
                              PROBE_VARIANTS[variant], *plan), name)
    _build.count_launch(name)
    return out


# -- the Sinkhorn loops of stage 2a ----------------------------------------

def _no_reduce(v: torch.Tensor) -> torch.Tensor:
    return v


def sinkhorn_vectors_split(Um_pad: torch.Tensor, lam_pad: torch.Tensor,
                           phib_pad: torch.Tensor, max_iter: int, eps: float,
                           *, int16: bool = True, reduce_s=_no_reduce,
                           reduce_counts=_no_reduce):
    """Split-buffer Sinkhorn (port of nle_tpu sinkhorn_vectors_split): the
    top (sampled-pixel) block Um stays a separate f32 (p, mpad) operand
    whose matvecs are exact f32, while only the rest block streams as the
    per-column-scaled int16 copy through K3. The column scale is taken
    over the rest rows alone and applied at the m-sized boundaries
    (t_q = scale * t in, scale * s_q out).

    phib_pad (npad_b, mpad) f32 with exact-zero pad rows/columns. Returns
    (r_top (p,), c_top (p,), r_b (npad_b,), c_b (npad_b,), crush (0-d)).

    On the card the top block's matvecs are cuBLAS fp32 products, whose
    order is fixed for the shapes; on the CPU they sum in float64 and
    round once (rowdot64, colsum64), as the plain K3 does, so the
    Sinkhorn vectors have the same bits at every thread count.

    The pixel-sharded trainers (parallel/sharded.py) run this loop on a
    rank's own rows of the rest block: reduce_s sums the rest block's
    (mpad,) share of s (the s0 column sum and each half-step's scale * s_q)
    over the ranks, reduce_counts the carrier's (crushed, nonzero) counts,
    so the column scale is the rank's own and s stays in true scale.
    int16=False streams phib_pad itself through K4 (the sharded carrier
    guard's f32 body; crush -1.0)."""
    p, mpad = Um_pad.shape
    npad_b = phib_pad.shape[0]
    if int16:
        Q, scale, _ = quantize_int16(phib_pad)
        counts = reduce_counts(torch.stack(crush_counts(phib_pad, scale)))
        crush = counts[0] / torch.clamp(counts[1], min=1.0)
    else:
        Q, scale = phib_pad, None
        crush = torch.tensor(-1.0, dtype=torch.float32,
                             device=phib_pad.device)
    ones_p = torch.ones((p,), dtype=torch.float32, device=Um_pad.device)
    if Um_pad.device.type == "cuda":
        def top_w(t):
            return Um_pad @ t

        def top_s(x):
            return Um_pad.T @ x
    else:
        def top_w(t):
            return rowdot64(Um_pad, t)

        def top_s(x):
            return colsum64(Um_pad, x)
    # s0 = phi^T 1: the top term plus the rest block's column sum.
    s0 = top_s(ones_p) + reduce_s(phib_pad.sum(dim=0))

    def halfstep(s):
        t = lam_pad * s
        xp = safe_reciprocal(top_w(t), eps)
        if scale is None:
            xb, s_b = sinkhorn_halfstep(Q, t, eps)
            return xp, xb, top_s(xp) + reduce_s(s_b)
        xb, s_q = sinkhorn_halfstep(Q, scale * t, eps)
        return xp, xb, top_s(xp) + reduce_s(scale * s_q)

    zb = torch.zeros((npad_b,), dtype=torch.float32, device=Um_pad.device)
    if max_iter == 0:
        return ones_p, torch.zeros_like(ones_p), zb, zb, crush
    cp, cb, s = torch.zeros_like(ones_p), zb, s0
    for _ in range(max_iter - 1):
        cp, cb, s = halfstep(s)
        _, _, s = halfstep(s)
    cp, cb, s = halfstep(s)
    rp, rb, _ = halfstep(s)
    return rp, cp, rb, cb, crush


def sinkhorn_vectors_fused(phi: torch.Tensor, lam: torch.Tensor,
                           max_iter: int, eps: float, tile: int = TILE_N,
                           n: int | None = None,
                           bf16_iters: int | None = None,
                           with_stat: bool = False,
                           int16: bool | None = None):
    """Assembled-factor Sinkhorn (port of nle_tpu sinkhorn_vectors_fused):
    returns (r, c), each (n,), for phi (rows, cols) — rows and columns
    beyond the true extent zero; n the true row count — and lam masked.
    With `with_stat`, also the carrier's crush fraction (-1.0 when no
    carrier engaged). `int16` overrides the env resolve per call (the
    guard's f32 re-dispatch passes False).

    The schedule follows the knobs: n_bf16 = resolve_bf16_iters leading
    iterations on a bf16 copy of phi (K14); the rest on the per-column
    int16 copy of all rows (K3; lam_q = lam scale^2 and the running s in
    Q-scale) when the carrier resolves, else on the f32 phi (K4, or K13
    under NLE_SINKHORN_KERNEL=auto, which forces f32 throughout)."""
    nrows, mcols = phi.shape
    n = nrows if n is None else n
    m = lam.shape[0]
    mpad = round_up(max(mcols, 1), 128)
    tile = k13_tile(mpad, tile)
    npad = round_up(max(nrows, 1), tile)
    phi_pad = phi.to(torch.float32)
    if (npad, mpad) != (nrows, mcols):
        phi_pad = torch.nn.functional.pad(phi_pad, (0, mpad - mcols,
                                                    0, npad - nrows))
    lam_pad = torch.nn.functional.pad(lam.to(torch.float32), (0, mpad - m))
    dev = phi_pad.device

    kernel_kind = resolve_sinkhorn_kernel()
    if kernel_kind == "auto":
        def halfstep(p, t):
            return sinkhorn_halfstep_tiled(p, t, eps, tile)
    else:
        def halfstep(p, t):
            return sinkhorn_halfstep(p, t, eps)
    n_bf16 = resolve_bf16_iters(max_iter, bf16_iters)
    if kernel_kind == "auto":
        n_bf16 = 0  # K13 is f32-only
    use_int16 = ((resolve_int16(n_bf16) if int16 is None else bool(int16))
                 and kernel_kind == "manual")

    r = torch.ones((npad,), dtype=torch.float32, device=dev)
    c = torch.zeros_like(r)
    # s0 = phi^T 1, summed in float64 (colsum64) on every device.
    s = colsum64(phi_pad, r)
    if n_bf16 > 0:
        phi_bf = phi_pad.to(torch.bfloat16)
        for _ in range(n_bf16):
            c, s = halfstep(phi_bf, lam_pad * s)
            r, s = halfstep(phi_bf, lam_pad * s)
        del phi_bf
    stat = torch.tensor(-1.0, dtype=torch.float32, device=dev)
    if use_int16:
        q16, scale, colmax = quantize_int16(phi_pad)
        if with_stat:
            stat = carrier_crush_frac(phi_pad, scale)
        live = colmax > 0
        zero = torch.zeros_like(scale)
        lam_q = lam_pad * torch.where(live, scale, zero) ** 2
        # The running s in Q-scale (s_q = s / scale): K3 returns Q^T x and
        # lam_q maps it back inside the next t.
        s = torch.where(live, s / scale, zero)
        phi_run, lam_run = q16, lam_q
    else:
        phi_run, lam_run = phi_pad, lam_pad
    for _ in range(n_bf16, max_iter):
        c, s = halfstep(phi_run, lam_run * s)
        r, s = halfstep(phi_run, lam_run * s)
    if with_stat:
        return r[:n], c[:n], stat
    return r[:n], c[:n]
