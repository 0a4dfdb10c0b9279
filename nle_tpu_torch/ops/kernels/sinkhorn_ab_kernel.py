"""The Sinkhorn half-step's A/B staging probes (CUDA, csrc/sinkhorn_ab.cu):
the port of the four TPU experiments under tools/ that shaped
`_kernel_manual` (K3/K4). The package's own path calls none of them;
nle_tpu_torch/tools/bench_sk_{unroll,variants,2stream}.py time them.

- K16 `sinkhorn_unroll` replaces `_kernel_unroll`
  (tools/bench_sk_unroll.py:20, call :99): x = safe_recip(phi t), chunk
  a's partial x_a^T phi_a to stripe a % 8, the stripes summed in order.
  A persistent grid with a 4-slot cp.async ring, two sub-tiles a step.
- `sinkhorn_variant` runs the five kernels of tools/bench_sk_variants.py
  (calls :106 and :133) at a row tile of 1024 or 2048:
  parts3d and mxu_row0 on K17 (tile partials, one accumulator in tile
  order), vpu and xonly on K18 (products rounded on their own and tree
  sums, 8 stripes; x only, s = 0), mxu on K13 (it is nle_tpu's `_kernel`,
  the same function at rows = tile).
- K19 `sinkhorn_2stream` replaces the probe of tools/bench_sk_2stream.py
  (:21, call :56): an (8, mpad) block whose row 0 is sum_i phi[i chunk],
  each sub-tile staged as nstreams concurrent bulk copies on an mbarrier.

Each wrapper sends a CPU tensor to its plain PyTorch twin and a CUDA tensor
to its kernel (nothing else), checks dtype, shape and contiguity, raises
ValueError where the TPU kernel would drop rows or fail to trace, and
counts one launch per call under its own name in _build.LAUNCHES. On the
card a factor wider than a kernel's shared memory holds is refused too;
the plain twins take any width.
"""

from __future__ import annotations

import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import cuda_or_cpu
from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
    K13_STRIPES,
    MAX_MPAD,
    PROBE_ROWS,
    launch_sweep,
    striped_sum,
    tile_partials,
    tiled_halfstep_launch,
)
from nle_tpu_torch.ops.linalg import safe_reciprocal

# Shared memory the rings of K16 and K19 may fill (of the H100's 227 KB a
# block).
RING_BYTES = 200 * 1024
UNROLL_SLOTS, UNROLL_ROWS = 4, 16      # K16: 4 slots of up to 16 rows
STREAM_SLOTS, STREAM_ROWS = 2, 32      # K19: 2 slots of up to 32 rows

VARIANTS = {"parts3d": 0, "mxu_row0": 0, "vpu": 1, "xonly": 2, "mxu": None}


def _check_operands(phi: torch.Tensor, t: torch.Tensor | None) -> None:
    if phi.dtype != torch.float32:
        raise TypeError(f"factor dtype {phi.dtype}: float32 only")
    if phi.dim() != 2:
        raise ValueError(f"factor shape {tuple(phi.shape)}: expected "
                         "(npad, mpad)")
    if t is not None:
        if t.dtype != torch.float32:
            raise TypeError(f"t dtype {t.dtype}, expected float32")
        if tuple(t.shape) != (phi.shape[1],):
            raise ValueError(f"t shape {tuple(t.shape)}, expected "
                             f"({phi.shape[1]},)")


# -- K16 ---------------------------------------------------------------------

def unroll_rows(mpad: int) -> int:
    """K16's ring sub-tile rows R at width mpad: up to 16, as many as four
    slots hold beside the t and two s rows; 0 when one row does not fit."""
    fixed = 4 * (3 * mpad + 2 * UNROLL_ROWS)
    return max(0, min(UNROLL_ROWS,
                      (RING_BYTES - fixed) // (4 * UNROLL_SLOTS * mpad)))


def _check_unroll(npad: int, chunk: int) -> None:
    if chunk < 1 or npad < 2 * chunk or npad % (2 * chunk):
        raise ValueError(f"unroll chunk {chunk}: npad {npad} must be a "
                         "positive multiple of 2 * chunk (the TPU kernel "
                         "runs npad // (2 chunk) pairs and drops the rest)")


def sinkhorn_unroll_plain(phi: torch.Tensor, t: torch.Tensor, eps: float,
                          chunk: int):
    """K16's plain twin: x = safe_recip(phi t); chunk a's partial to
    stripe a % 8 in order, then the stripes in order."""
    _check_operands(phi, t)
    _check_unroll(phi.shape[0], chunk)
    x = safe_reciprocal(phi @ t, eps)
    return x, striped_sum(tile_partials(phi, x, chunk), K13_STRIPES)


def sinkhorn_unroll(phi: torch.Tensor, t: torch.Tensor, eps: float,
                    chunk: int = 1024):
    """K16: the 2x-unrolled half-step of tools/bench_sk_unroll.py. phi
    (npad, mpad) float32 with npad a multiple of 2 chunk, t (mpad,)
    float32. Returns (x (npad,), s (mpad,))."""
    _check_operands(phi, t)
    npad, mpad = phi.shape
    _check_unroll(npad, chunk)
    if not cuda_or_cpu(phi, t):
        return sinkhorn_unroll_plain(phi, t, eps, chunk)
    rows = unroll_rows(mpad)
    if rows < 1:
        raise ValueError(f"K16 at mpad {mpad}: four one-row ring slots do "
                         "not fit the block's shared memory")
    lib = _build.load()
    x = torch.empty((npad,), dtype=torch.float32, device=phi.device)
    s = torch.empty((mpad,), dtype=torch.float32, device=phi.device)
    partial = torch.empty((npad // chunk, mpad), dtype=torch.float32,
                          device=phi.device)
    _build.check(launch_sweep(lib.nle_ab_unroll, phi, t, x, partial, s, npad,
                              mpad, chunk, rows, float(eps)),
                 "sinkhorn_ab_unroll")
    _build.count_launch("sinkhorn_ab_unroll")
    return x, s


# -- K17 / K18 / K13: the half-step variants ---------------------------------

def _check_variant(npad: int, variant: str, tile: int) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"half-step variant {variant!r}: expected one of "
                         f"{sorted(VARIANTS)}")
    if tile < 1 or npad % tile:
        raise ValueError(f"variant tile {tile}: npad {npad} must be a "
                         "positive multiple of it (the TPU grid would drop "
                         "rows)")


def sinkhorn_variant_plain(phi: torch.Tensor, t: torch.Tensor, eps: float,
                           variant: str, tile: int):
    """The variants' plain twins. mxu: tile partials in 8 stripes (K13's
    twin); parts3d, mxu_row0: one accumulator in tile order; vpu: w =
    (phi * t).sum(1) and each tile's (phi_tile * x_tile).sum(0), each
    product rounded on its own, in 8 stripes; xonly: x and s = 0."""
    _check_operands(phi, t)
    npad, mpad = phi.shape
    _check_variant(npad, variant, tile)
    if variant == "vpu":
        w = torch.cat([(phi[lo:lo + tile] * t).sum(1)
                       for lo in range(0, npad, tile)])
        x = safe_reciprocal(w, eps)
        parts = torch.stack([(phi[lo:lo + tile] * x[lo:lo + tile, None])
                             .sum(0) for lo in range(0, npad, tile)])
        return x, striped_sum(parts, K13_STRIPES)
    x = safe_reciprocal(phi @ t, eps)
    if variant == "xonly":
        return x, torch.zeros((mpad,), dtype=torch.float32,
                              device=phi.device)
    stripes = K13_STRIPES if variant == "mxu" else 1
    return x, striped_sum(tile_partials(phi, x, tile), stripes)


def sinkhorn_variant(phi: torch.Tensor, t: torch.Tensor, eps: float,
                     variant: str, tile: int = 1024):
    """One half-step of tools/bench_sk_variants.py's `variant` at row tile
    `tile`: K17 (parts3d, mxu_row0), K18 (vpu, xonly) or K13 (mxu). phi
    (npad, mpad) float32 with npad a multiple of tile, t (mpad,) float32.
    Returns (x (npad,), s (mpad,))."""
    _check_operands(phi, t)
    npad, mpad = phi.shape
    _check_variant(npad, variant, tile)
    if not cuda_or_cpu(phi, t):
        return sinkhorn_variant_plain(phi, t, eps, variant, tile)
    if mpad > MAX_MPAD:
        raise ValueError(f"variant at mpad {mpad}: the sweep takes at most "
                         f"MAX_MPAD = {MAX_MPAD} columns")
    if variant == "mxu":
        return tiled_halfstep_launch(phi, t, eps, tile)
    lib = _build.load()
    x = torch.empty((npad,), dtype=torch.float32, device=phi.device)
    s = torch.empty((mpad,), dtype=torch.float32, device=phi.device)
    partial = torch.empty((npad // tile, mpad), dtype=torch.float32,
                          device=phi.device)
    name = f"sinkhorn_ab_{variant}"
    _build.check(launch_sweep(lib.nle_ab_tiles, phi, t, x, partial, s, npad,
                              mpad, tile, VARIANTS[variant], float(eps)),
                 name)
    _build.count_launch(name)
    return x, s


# -- K19 ---------------------------------------------------------------------

def stream_rows(mpad: int, chunk: int, nstreams: int) -> int:
    """K19's ring sub-tile rows R: the largest power of two up to 32 that
    divides chunk, is a multiple of nstreams and lets two slots fit; 0 when
    none does."""
    rows = STREAM_ROWS
    while rows >= max(nstreams, 1):
        if (chunk % rows == 0 and rows % nstreams == 0
                and 128 + 4 * STREAM_SLOTS * rows * mpad <= RING_BYTES):
            return rows
        rows //= 2
    return 0


def _check_2stream(npad: int, chunk: int, nstreams: int) -> None:
    if nstreams < 1 or chunk < 1 or chunk % nstreams:
        raise ValueError(f"2stream chunk {chunk}: a positive multiple of "
                         f"nstreams {nstreams} (the TPU probe copies chunk "
                         "// nstreams rows a stream and would drop the rest)")
    if npad % chunk:
        raise ValueError(f"2stream chunk {chunk}: npad {npad} must be a "
                         "multiple of it (the TPU probe would drop rows)")


def sinkhorn_2stream_plain(phi: torch.Tensor, t: torch.Tensor | None,
                           nstreams: int, chunk: int) -> torch.Tensor:
    """K19's plain twin: the (8, mpad) block, row 0 = sum_i phi[i chunk]
    in chunk order, every other row 0. t is unused, as in the TPU probe."""
    _check_operands(phi, None)
    npad, mpad = phi.shape
    _check_2stream(npad, chunk, nstreams)
    out = torch.zeros((PROBE_ROWS, mpad), dtype=torch.float32,
                      device=phi.device)
    out[0] = striped_sum(phi[::chunk], 1)
    return out


def sinkhorn_2stream(phi: torch.Tensor, t: torch.Tensor | None,
                     nstreams: int, chunk: int = 1024) -> torch.Tensor:
    """K19: the staging probe of tools/bench_sk_2stream.py. phi (npad,
    mpad) float32 with npad a multiple of chunk and chunk of nstreams;
    returns (8, mpad). On the card each sub-tile arrives as nstreams bulk
    copies: mpad % 4 == 0 and a 16-byte aligned phi (16-byte copies)."""
    _check_operands(phi, None)
    npad, mpad = phi.shape
    _check_2stream(npad, chunk, nstreams)
    if not cuda_or_cpu(phi):
        return sinkhorn_2stream_plain(phi, t, nstreams, chunk)
    if mpad % 4 or phi.data_ptr() % 16:
        raise ValueError(f"K19 at mpad {mpad}: bulk copies take 16-byte "
                         "sizes and addresses (mpad % 4 == 0, an aligned "
                         "factor)")
    rows = stream_rows(mpad, chunk, nstreams)
    if rows < 1:
        raise ValueError(f"K19 at mpad {mpad}, chunk {chunk}, nstreams "
                         f"{nstreams}: no ring sub-tile fits")
    lib = _build.load()
    out = torch.empty((PROBE_ROWS, mpad), dtype=torch.float32,
                      device=phi.device)
    partial = torch.empty((npad // chunk, mpad), dtype=torch.float32,
                          device=phi.device)
    with torch.cuda.device(phi.device):
        status = lib.nle_ab_2stream(phi.data_ptr(), partial.data_ptr(),
                                    out.data_ptr(), npad, mpad, chunk, rows,
                                    nstreams, _build.stream_ptr(phi))
    _build.check(status, "sinkhorn_ab_2stream")
    _build.count_launch("sinkhorn_ab_2stream")
    return out
