"""K3/K4: the fused Sinkhorn half-step (CUDA, csrc/sinkhorn.cu), the int16
carrier around it, and the two Sinkhorn loops of stage 2a.

Replaces nle_tpu/ops/pallas/sinkhorn_kernel.py:121 `_kernel_manual` (via
`sinkhorn_halfstep_manual`, call at :312): K3 is its packed-int16 branch,
K4 its f32 branch. One read of the factor per half-step computes
    x = safe_recip(Q t, eps),   s = Q^T x.
K3 runs 2 x n_iter times per train inside `sinkhorn_vectors_split`; K4 runs
only when the carrier guard trips, inside `sinkhorn_vectors_fused`.

On the H100 the half-step is memory-bound (1.3 GB int16 / 2.6 GB f32 per
call at the 1 MP main path, 2.6 GFLOP). The CUDA kernel stages row tiles
in shared memory, forms w one warp per row, and adds the block's partial
s while the tile is on chip; partial sums go to a scratch reduced in a
fixed order (no float atomics, so training is bitwise repeatable). K3
takes exact fp32 products of the int16 values, where the TPU splits them
into bf16 pieces and drops the lo*lo term (~2^-17 relative): the port is
tight against its plain version and differs from the TPU by that class.

TPU-only machinery left behind: the int32 pair-packing of the int16 copy
(`pack_pairs_int32`, an (8,128)-tiling device) — the port stores a plain
(npad_b, mpad) int16 tensor in natural row order — and the VMEM-driven
tile shrinking. Still to port (ROADMAP): the block-pipelined K13
(`sinkhorn_halfstep_pallas`) and the bf16 preview branch.

Width: the kernel takes mpad <= MAX_MPAD factor columns (a dense sampling
grid's nearly full rank reaches mpad 2176 at p = 2112); the plain version
takes any width.
"""

from __future__ import annotations

import os

import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import cuda_or_cpu, round_up
from nle_tpu_torch.ops.linalg import safe_reciprocal

# Widest factor K3/K4 take, the port's one width limit of the dense route
# (the wrapper refuses wider, resolve_streaming streams past it): a one-row
# f32 tile plus the t and s rows still fit the kernel's shared memory.
MAX_MPAD = 16384

# Row alignment of every N-scale buffer of stage 2: a multiple of every
# kernel's row tile, and the JAX package's padded_shape rule (2 x 1024), so
# the two packages lay out the same shapes.
ROW_ALIGN = 2048


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


# Crush-fraction threshold of the carrier guard: the geometric middle of
# the measured gap (real images <= 0.09, uniform noise at small hx >= 0.32).
INT16_GUARD = 0.2


def resolve_int16_guard() -> float | None:
    """The guard's threshold: INT16_GUARD, or None under
    NLE_INT16_GUARD=off. (The JAX package's float override of the
    threshold is not ported.)"""
    raw = os.environ.get("NLE_INT16_GUARD")
    if raw is None:
        return INT16_GUARD
    if raw.lower() == "off":
        return None
    raise ValueError(f"NLE_INT16_GUARD={raw!r}: expected off (or unset)")


def resolve_int16() -> bool:
    """Whether stage 2a streams the int16 carrier (split layout): yes
    unless NLE_SINKHORN_INT16=off. (The JAX package's forced-on mode, a
    guard that warns and keeps the carrier, is not ported.)"""
    raw = os.environ.get("NLE_SINKHORN_INT16", "auto").lower()
    if raw not in ("auto", "off"):
        raise ValueError(f"NLE_SINKHORN_INT16={raw!r}: expected auto or off")
    return raw == "auto"


def carrier_guard_decision(crush: float, log, context: str,
                           action: str) -> bool:
    """Over the guard's threshold -> warn + True (the caller retrains
    through the f32 carrier)."""
    threshold = resolve_int16_guard()
    if threshold is None or not crush > threshold:
        return False
    log.warning(
        "int16 Sinkhorn carrier out of its validity domain (%s %.3f > "
        "%.3f: this input packs more dynamic range into phi columns than "
        "int16's ~4.5 decades): %s through the f32 carrier. "
        "NLE_INT16_GUARD=off disables this guard.",
        context, crush, threshold, action)
    return True


# -- K3/K4 ------------------------------------------------------------------

def sinkhorn_halfstep_plain(Q: torch.Tensor, t: torch.Tensor, eps: float):
    """Plain PyTorch half-step: (x, s) = (safe_recip(Q t), Q^T x) with Q
    cast to float32 (exact for int16)."""
    Qf = Q.float()
    x = safe_reciprocal(Qf @ t, eps)
    return x, Qf.T @ x


def sinkhorn_halfstep(Q: torch.Tensor, t: torch.Tensor, eps: float):
    """One fused half-step. Q (npad, mpad) int16 (K3) or float32 (K4),
    t (mpad,) float32. Returns (x (npad,), s (mpad,)), float32."""
    if Q.dtype not in (torch.int16, torch.float32):
        raise TypeError(f"half-step factor dtype {Q.dtype}: int16 or float32")
    if not cuda_or_cpu(Q, t):
        return sinkhorn_halfstep_plain(Q, t, eps)
    if t.dtype != torch.float32:
        raise TypeError(f"t dtype {t.dtype}, expected float32")
    npad, mpad = Q.shape
    if mpad > MAX_MPAD:
        raise ValueError(f"half-step factor of {mpad} columns: the kernel "
                         f"takes at most MAX_MPAD = {MAX_MPAD}")
    lib = _build.load()
    x = torch.empty((npad,), dtype=torch.float32, device=Q.device)
    s = torch.empty((mpad,), dtype=torch.float32, device=Q.device)
    partial = torch.empty((lib.nle_sinkhorn_nblocks(npad), mpad),
                          dtype=torch.float32, device=Q.device)
    if Q.dtype == torch.int16:
        fn, name = lib.nle_sinkhorn_halfstep_i16, "sinkhorn_halfstep_int16"
    else:
        fn, name = lib.nle_sinkhorn_halfstep_f32, "sinkhorn_halfstep_f32"
    with torch.cuda.device(Q.device):
        status = fn(Q.data_ptr(), t.data_ptr(), x.data_ptr(),
                    partial.data_ptr(), s.data_ptr(), npad, mpad, float(eps),
                    _build.stream_ptr(Q))
    _build.check(status, name)
    _build.count_launch(name)
    return x, s


# -- the Sinkhorn loops of stage 2a ----------------------------------------

def sinkhorn_vectors_split(Um_pad: torch.Tensor, lam_pad: torch.Tensor,
                           phib_pad: torch.Tensor, max_iter: int, eps: float):
    """Split-buffer Sinkhorn (port of nle_tpu sinkhorn_vectors_split): the
    top (sampled-pixel) block Um stays a separate f32 (p, mpad) operand
    whose matvecs are exact f32, while only the rest block streams as the
    per-column-scaled int16 copy through K3. The column scale is taken
    over the rest rows alone and applied at the m-sized boundaries
    (t_q = scale * t in, scale * s_q out).

    phib_pad (npad_b, mpad) f32 with exact-zero pad rows/columns. Returns
    (r_top (p,), c_top (p,), r_b (npad_b,), c_b (npad_b,), crush (0-d))."""
    p, mpad = Um_pad.shape
    npad_b = phib_pad.shape[0]
    q16, scale, _ = quantize_int16(phib_pad)
    crush = carrier_crush_frac(phib_pad, scale)
    ones_p = torch.ones((p,), dtype=torch.float32, device=Um_pad.device)
    # s0 = phi^T 1: exact f32 top term plus the rest block's column sum.
    s0 = Um_pad.T @ ones_p + phib_pad.sum(dim=0)

    def halfstep(s):
        t = lam_pad * s
        xp = safe_reciprocal(Um_pad @ t, eps)
        xb, s_q = sinkhorn_halfstep(q16, scale * t, eps)
        return xp, xb, Um_pad.T @ xp + scale * s_q

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


def sinkhorn_vectors_fused(phi_pad: torch.Tensor, lam_pad: torch.Tensor,
                           max_iter: int, eps: float, n: int):
    """Assembled-factor f32 Sinkhorn through K4 (port of nle_tpu
    sinkhorn_vectors_fused with int16=False): the guard's fallback and the
    NLE_SINKHORN_INT16=off trajectory. phi_pad (npad, mpad) f32 with zero
    pad rows/columns, lam_pad (mpad,) masked. Returns (r (n,), c (n,))."""
    npad = phi_pad.shape[0]
    r = torch.ones((npad,), dtype=torch.float32, device=phi_pad.device)
    c = torch.zeros_like(r)
    # s0 = phi^T 1 as the dot (the JAX package's order for this path).
    s = phi_pad.T @ r
    for _ in range(max_iter):
        c, s = sinkhorn_halfstep(phi_pad, lam_pad * s, eps)
        r, s = sinkhorn_halfstep(phi_pad, lam_pad * s, eps)
    return r[:n], c[:n]
