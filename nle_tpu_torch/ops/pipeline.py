"""The filter-training pipeline on PyTorch (port of nle_tpu/ops/pipeline.py,
the dense path the 1 MP enhance takes).

Composition (reference NLEFilter::trainFilter, src/filter.cpp:480-512):
  sample -> Ka (f64 host) + eigh -> Nystrom extension -> Sinkhorn
  -> orthogonalize (f64 host chain) -> eigenvectors, scattered to pixel
  order unless the caller asks for the packed one (train_filter's
  pixel_order, as in nle_tpu).

Everything on the device runs in packed [selected; rest] order. Stage 1
and the m x m chain are float64 NumPy/SciPy on the host; every N-scale
step is float32 on the device named by the caller, with every contraction
in full IEEE fp32 (no TF32 — nle_tpu_torch/config.py).

Stage 2a has three dense layouts, plus the phi-free streaming stage 2 for
frames whose phi would not fit (train_filter's `streaming`, below):
- split (the default past the small layout's limit, resolve_split_stage2):
  the affinity kernel K1 writes the zero-tailed rest block phi_b directly,
  Sinkhorn carries the top block as exact f32 matvecs beside the int16
  rest stream through K3, and the Sb gram is the top term plus K6 on the
  rest block. Stage 2b is K7 over the rest block plus a row concat with
  the host-computed top rows.
- assembled: [Um; phi_b] padded, Sinkhorn through sinkhorn_vectors_fused,
  K6 and K7 on the unscaled factor with c masked below m. Its Sinkhorn
  follows the knobs as the JAX loop does: the int16 carrier of all rows
  on K3 (NLE_STAGE2_SPLIT=off), f32 on K4 (the carrier guard's fallback,
  NLE_SINKHORN_INT16=off), K13 (NLE_SINKHORN_KERNEL=auto), or a bf16 lead
  on K14 with an f32 polish on K4 (NLE_SINKHORN_BF16).
- small (stage2_dense_small: the padded f32 phi fits in NLE_CPHI_BYTES,
  64 MiB by default): the assembled layout's Sinkhorn, then the scaled
  factor cphi = c_rest * phi materialized and freed of phi, the Sb gram and
  stage 2b's V tail as plain fp32 products on it (no K6, no K7). This is
  nle_tpu's layout for the frames of the reference's own size class; its
  VMEM clause (scaled_fits_vmem) is a TPU reason and is not ported, so
  dense grids past mpad 1408 keep the split layout.

The streaming stage 2 (K8 Sinkhorn, or K9 past 1792 samples; K12 gram;
then K1 with the small right factor W = Uinv GrT for V) keeps O(N) device
state at any sampling density; the V-free factored filter
(models/factored.py) stops before V and edits through factored_apply
(K10, K11).

m (the kept Nystrom rank) travels as a plain int; columns m..mb of the
rank bucket are exact zeros, as in the JAX package (tests/test_bucketing.py).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from nle_tpu_torch.config import EPS, check_nans, resolve_device
from nle_tpu_torch.ops.affinity import (
    affinity_block,
    affinity_matmul,
    bandwidth_weights,
    features,
)
from nle_tpu_torch.ops.kernels._common import round_up
from nle_tpu_torch.ops.kernels.affinity_kernel import affinity_matmul_plain
from nle_tpu_torch.ops.kernels.scaled_matmul_kernel import (
    MATMUL_COL_ALIGN,
    scaled_gram,
    scaled_matmul,
)
from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
    MAX_MPAD,
    carrier_guard_decision,
    padded_shape,
    resolve_split_stage2,
    sinkhorn_vectors_fused,
    sinkhorn_vectors_split,
    split_row_pad,
)
from nle_tpu_torch.ops.kernels.streaming_kernel import (
    pad_stream_operands,
    streaming_ap,
    streaming_atb,
    streaming_sample_gram,
    streaming_sinkhorn_vectors,
)
from nle_tpu_torch.ops.linalg import (
    eigh64,
    eigh_descending,
    safe_reciprocal,
    topk_eigendecomposition,
)
from nle_tpu_torch.ops.orthogonalize import (
    host_chain64,
    orthogonalize_factored,
)
from nle_tpu_torch.ops.sampling import SampleGrid, sample_grid
from nle_tpu_torch.ops.sinkhorn import balanced_top, sinkhorn_vectors
from nle_tpu_torch.ops.transform import transform_eigenvalues
from nle_tpu_torch.utils.logging import (
    carrier_log,
    logger,
    span,
    stage,
    warn_rank_deficient,
    warn_truncation,
)
from nle_tpu_torch.utils.transfer import Fetch, upload


# -- stage 1 (host f64) -----------------------------------------------------

def _build_ka64(y_sel, rows_sel, cols_sel, hx, hy) -> np.ndarray:
    """Exact float64 Ka on the host, op for op with the reference
    (src/filter.cpp:114-145)."""
    r = np.asarray(rows_sel, np.float64)
    c = np.asarray(cols_sel, np.float64)
    y = np.asarray(y_sel, np.float64)
    sw = 1.0 / (float(hx) * float(hx))
    pw = 1.0 / (float(hy) * float(hy))
    d2s = (r[:, None] - r[None, :]) ** 2 + (c[:, None] - c[None, :]) ** 2
    d2i = (y[:, None] - y[None, :]) ** 2
    return np.exp(-sw * d2s - pw * d2i)


def ka_eigh_host64(y_sel, rows_sel, cols_sel, hx, hy, eps):
    """Stage 1: float64 Ka + LAPACK eigh, descending, truncated at eps.
    Returns float64 (U (p, m), lam (m,), U * Lambda^{-1} (p, m))."""
    Ka = _build_ka64(y_sel, rows_sel, cols_sel, hx, hy)
    lam, U = eigh64(Ka)
    lam = lam[::-1]
    U = U[:, ::-1]
    m = int(np.count_nonzero(lam >= eps)) if lam.size else 0
    U_m = U[:, :m]
    lam_m = lam[:m]
    return U_m, lam_m, U_m / lam_m[None, :]


def ka_eigh_topk_host64(y_sel, rows_sel, cols_sel, hx, hy, eps,
                        k0: int = 64):
    """Stage 1 through the iterative top-k solver (the reference's
    USE_SPECTRA build, topkEigenDecomposition, src/filter.cpp:169-200):
    eig(Ka) with k doubling from k0 until the eps tail is inside the k
    pairs. Falls back to the exact solver (ka_eigh_host64) when ARPACK did
    not converge (a short unconverged result looks like a truncation) or
    when k reaches p - 1 with the tail still outside. Same returns as
    ka_eigh_host64."""
    Ka = _build_ka64(y_sel, rows_sel, cols_sel, hx, hy)
    p = Ka.shape[0]
    if p <= 2:
        return ka_eigh_host64(y_sel, rows_sel, cols_sel, hx, hy, eps)
    k = min(max(k0, 8), p - 1)
    while True:
        U, lam, converged = topk_eigendecomposition(
            Ka, k, eps, return_converged=True)
        if not converged:
            return ka_eigh_host64(y_sel, rows_sel, cols_sel, hx, hy, eps)
        if lam.size < k:
            break                    # truncated inside the k pairs
        if k >= p - 1:
            return ka_eigh_host64(y_sel, rows_sel, cols_sel, hx, hy, eps)
        k = min(2 * k, p - 1)
    if lam.size == 0:
        return U[:, :0], lam, U[:, :0]
    return U, lam, U / lam[None, :]


def ka_eigh_stage(y, rows, cols, sw, pw, *, p: int, eps: float):
    """Stage 1 on the device (stage1="device"): Ka of the p sampled pixels
    in y's dtype, then eigh_descending in that dtype on y's device (a
    float32 eigh on the float32 route, as nle_tpu's ka_eigh_stage).
    Returns (U (p, p), lam (p,)) with lam < eps masked to 0."""
    f = features(rows[:p], cols[:p], y[:p], y.dtype)
    return eigh_descending(affinity_block(f, f, sw, pw), eps)


def bucket_m(m: int, p: int) -> int:
    """Stage-2 column count for a kept rank m: m rounded up to NLE_M_BUCKET
    (default 128), capped at p; NLE_M_BUCKET <= 1 gives m itself. The zero
    columns are exact, so the bucket only fixes shapes."""
    b = int(os.environ.get("NLE_M_BUCKET", "128"))
    if b <= 1:
        return m
    return min(-(-m // b) * b, p)


def cphi_bytes_limit() -> int:
    """The small stage-2a layout's limit on the padded f32 phi, in bytes:
    NLE_CPHI_BYTES (64 MiB by default), parsed as nle_tpu parses it but
    read at call time, like the port's other stage-2 knobs."""
    return int(os.environ.get("NLE_CPHI_BYTES", str(64 << 20)))


def stage2_dense_small(n: int, mb: int, limit: int | None = None) -> bool:
    """Whether the dense stage 2a takes the small layout: the padded f32
    phi (4 npad mpad bytes) is at most `limit` (None: cphi_bytes_limit()),
    so the scaled factor c_rest * phi is materialized. nle_tpu's other
    clause, the TPU's VMEM fit of its scaled kernels (scaled_fits_vmem), is
    not ported: past mpad 1408 the split layout stays."""
    npad, mpad = padded_shape(n, mb)
    if limit is None:
        limit = cphi_bytes_limit()
    return 4 * npad * mpad <= limit


def stage2b_factor_scaled(n: int, mb: int, dtype=torch.float32,
                          limit: int | None = None) -> bool:
    """Whether stage 2a's factor comes back pre-scaled (c_rest * phi):
    _stage2b_dense_body's `scaled`. On the float32 kernel route exactly
    when stage2_dense_small(n, mb, limit) holds (any other dtype scales
    its factor itself, as nle_tpu's unfused route does). submit_dense
    takes both gates from one reading of the limit, so c is applied once,
    never twice or not at all."""
    return dtype != torch.float32 or stage2_dense_small(n, mb, limit)


def pack_channel(channel_np: np.ndarray, perm: np.ndarray):
    """Pack a channel into [selected; rest] order; returns (packed array,
    flat_u8). When the values are integers in [0, 255], flat_u8 is the
    channel in pixel order as a uint8 array of its own and the packed
    array is gathered from it (uint8 too); else flat_u8 is None and the
    packed array keeps the channel's dtype. The check is order-free, so it
    runs in pixel order, before the gather. The span "Pack channel"."""
    with span("Pack channel"):
        flat = np.asarray(channel_np).reshape(-1)
        if flat.dtype == np.uint8:
            flat_u8 = flat.copy()
        elif (flat.min() >= 0 and flat.max() <= 255
                and np.array_equal(flat, np.rint(flat))):
            flat_u8 = flat.astype(np.uint8)
        else:
            return flat[perm], None
        return flat_u8[perm], flat_u8


def pack_stage1(Um64, lam64, mb: int | None = None) -> np.ndarray:
    """(p + 1, mb) float32 [Um; lam], columns zero-padded from m to the
    bucket mb. Uinv = Um / lam is recomputed on the device
    (_unpack_stage1)."""
    p, m = Um64.shape
    mb = m if mb is None else mb
    out = np.zeros((p + 1, mb), np.float32)
    out[:p, :m] = Um64
    out[p, :m] = lam64
    return out


def pack_stage1_device(Um: torch.Tensor, lam: torch.Tensor,
                       mb: int) -> torch.Tensor:
    """Device twin of pack_stage1 (stage1="device": the eigensystem is on
    the device already): the same (p + 1, mb) float32 [Um; lam] layout."""
    pad = (0, mb - Um.shape[1])
    return torch.cat([torch.nn.functional.pad(Um, pad),
                      torch.nn.functional.pad(lam, pad)[None]]).to(
                          torch.float32)


def _rest_scaling(c: torch.Tensor, m: int) -> torch.Tensor:
    """c as a (rows, 1) column with the rows below the balanced-block
    boundary m zeroed: stage 2a's c_rest."""
    keep = torch.arange(c.shape[0], device=c.device) >= m
    return torch.where(keep, c, torch.zeros_like(c))[:, None]


def _unpack_stage1(stage1: torch.Tensor, p: int):
    """(Um (p, mb), lam (mb,), Uinv (p, mb)): Uinv = Um / lam in float32 on
    the device, zero on the padded columns."""
    Um = stage1[:p]
    lam = stage1[p]
    keep = lam > 0
    Uinv = torch.where(keep[None, :],
                       Um / torch.where(keep, lam, torch.ones_like(lam)),
                       torch.zeros_like(Um))
    return Um, lam, Uinv


# -- stage 2a (device) ------------------------------------------------------

def train_filter_stage2a(y, rows, cols, stage1, sw, pw, *, p: int, m: int,
                         mb: int, n_sinkhorn_iter: int, eps: float,
                         small: bool | None = None,
                         split: bool | None = None,
                         int16: bool | None = None):
    """Device half 1: Nystrom extension, Sinkhorn, and the Sb gram.

    Returns (rc, Sb (mb, mb), factor, c_rest). rc rows 0/1 are [r; c]
    (the full (3, p) top rows in the split layout, (3, mb) otherwise) and
    row 2 column 0 is the int16 crush statistic (-1.0 when no carrier
    engaged). factor is the TUPLE (phib_pad,) in the split layout, the
    pre-scaled cphi = c_rest * phi (npad, mpad) in the small layout, else
    the assembled padded phi; c_rest is the matching (rows, 1) scaling
    with rows < m zero.

    small: None resolves stage2_dense_small(n, mb); when small holds,
    `split` does not apply (the small layout carries every row itself, as
    nle_tpu's does). split: None resolves NLE_STAGE2_SPLIT
    (resolve_split_stage2). int16: None lets the assembled Sinkhorn
    resolve the carrier from the env; False (the guard's fallback) forces
    the f32 Sinkhorn on the assembled (or small) layout, as the JAX
    package's int16=False does."""
    n = y.shape[0]
    if small is None:
        small = stage2_dense_small(n, mb)
    if split is None:
        split = resolve_split_stage2(n_sinkhorn_iter)
    if int16 is False or small:
        # The guard's fallback cannot run the split layout without the
        # carrier; the small layout is assembled.
        split = False
    Um, lam_m, Uinv = _unpack_stage1(stage1, p)
    f = features(rows, cols, y)
    fa, fb = f[:p], f[p:]
    mpad = round_up(mb, 128)
    dev = y.device
    if split:
        nb = n - p
        npad_b = split_row_pad(nb)
        phib_pad = affinity_matmul(fa, fb, Uinv, sw, pw, out_rows=npad_b)
        Um_pad = torch.nn.functional.pad(Um, (0, mpad - mb))
        lam_pad = torch.nn.functional.pad(lam_m, (0, mpad - mb))
        rp, cp, rb, cb, crush = sinkhorn_vectors_split(
            Um_pad, lam_pad, phib_pad, n_sinkhorn_iter, float(eps))
        stat = torch.full((p,), -1.0, dtype=torch.float32, device=dev)
        stat[0] = crush
        rc = torch.stack([rp, cp, stat])
        cb_rest = cb[:, None]
        cphiu = _masked_top(cp, Um_pad, p, m)
        Sb = ((cphiu.T @ cphiu)[:mb, :mb]
              + scaled_gram(phib_pad, cb_rest)[:mb, :mb])
        return rc, Sb, (phib_pad,), cb_rest

    phi_b = affinity_matmul(fa, fb, Uinv, sw, pw)
    npad, mpad = padded_shape(n, mb)
    phi = torch.zeros((npad, mpad), dtype=torch.float32, device=dev)
    phi[:p, :mb] = Um
    phi[p:n, :mb] = phi_b
    del phi_b
    r, c, crush = sinkhorn_vectors_fused(phi, lam_m, n_sinkhorn_iter,
                                         float(eps), n=n, with_stat=True,
                                         int16=int16)
    c_rest = _rest_scaling(torch.nn.functional.pad(c, (0, npad - n)), m)
    stat = torch.full((mb,), -1.0, dtype=torch.float32, device=dev)
    stat[0] = crush
    rc = torch.stack([r[:mb], c[:mb], stat])
    if small:
        # cphi = c_rest * phi in place: no second phi-sized buffer. Rows < m
        # and columns >= mb of cphi are exact zeros, so the gram of the
        # whole padded factor holds Sb in its leading block.
        cphi = phi.mul_(c_rest)
        return rc, (cphi.T @ cphi)[:mb, :mb], cphi, c_rest
    return rc, scaled_gram(phi, c_rest)[:mb, :mb], phi, c_rest


def _masked_top(c, Um, p: int, m: int):
    """diag(c[:p]) Um with the rows below the balanced-block boundary m
    zeroed."""
    return _rest_scaling(c[:p], m) * Um


def train_filter_stage2a_streaming(y, rr, cc, sw, pw, *, p: int, m: int,
                                   n_sinkhorn_iter: int, eps: float,
                                   stage1_64):
    """phi-free device half 1 (port of nle_tpu train_filter_stage2a_
    streaming): Sinkhorn through K8 (K9 past 1792 samples) and the Sb gram
    through K12's float64 form, all recomputing the affinity from the
    features, so the (N, m) phi never exists. stage1_64 is stage 1's (Um
    (p, m), lam (m,)) in float64 on the host: the Sinkhorn loop's
    projections and Sb = Uinv^T H Uinv take these, not an fp32 rounding of
    them.

    Every sum that Wa's and Q's small eigenvalues read is float64 (K8's,
    the loop's, K12's and Sb's congruence; PERF.md): the fp32 entries stay.
    Returns (rc (2, p) = the top rows of r and c, and Sb (m, m), both
    float64 on the host, and c (N,) fp32 on the device). The span
    "Streaming Sinkhorn" holds the loop up to the host's copy of r and c,
    "Streaming gram" K12 up to the host's copy of Sb, so each lasts as long
    as its device work."""
    f = features(rr, cc, y)
    fa, fb = f[:p], f[p:]
    with span("Streaming Sinkhorn"):
        um64, lam64 = (upload(np.ascontiguousarray(a, np.float64), y.device)
                       for a in stage1_64)
        _, c, r_top, c_top = streaming_sinkhorn_vectors(
            fa, fb, um64, lam64, n_sinkhorn_iter, eps, sw, pw, top64=True)
        rc_np = Fetch(torch.stack([r_top, c_top])).result()
    with span("Streaming gram"):
        # Rows m..p of the gram come from the stored Um block (rows < m are
        # masked to exact zeros); rows p..N are streamed as H.
        cu = _masked_top(c_top, um64, p, m)
        fa_rows, fb_cols, _ = pad_stream_operands(fa, fb)
        del f, fa, fb
        q = y.shape[0] - p
        c_row = torch.nn.functional.pad(c[p:],
                                        (0, fb_cols.shape[1] - q))[None]
        H = streaming_sample_gram(fa_rows, fb_cols, c_row, sw, pw)[:p, :p]
        uinv64 = um64 / lam64[None, :]
        Sb = cu.T @ cu + uinv64.T @ H @ uinv64
        sb_np = Fetch(Sb).result()
    return rc_np, sb_np, c


def factored_pieces64(rc_np, va_np, Um64, lam64, m: int, k: int):
    """The V-free factored filter's small matrices in float64 on the host
    (p x m x k work): V_head (p, k), the sampled-pixel rows of V (diag(c)
    Um GrT with rows < m masked, plus Va on rows < m), and W = Uinv GrT
    (p, k), the tail generator: V_rest = diag(c_rest) K W. rc_np (2, p)
    holds the top rows of [r; c]; va_np (>= m, 2k) is [Va | GrT]."""
    Va, GrT = va_np[:m, :k], va_np[:m, k:2 * k]
    cu = rc_np[1][:, None] * Um64
    cu[:m] = 0.0
    V_head = cu @ GrT
    V_head[:m] += Va
    return V_head, (Um64 / lam64[None, :]) @ GrT


# -- host side between stage 2a and 2b ---------------------------------------

def host_orthogonalize(rc_np, sb, Um64, lam64, m: int, mb: int, k: int,
                       eps: float, q_solver: str | None = None):
    """Rebuild the balanced-block small matrices in f64 from stage 1's
    eigensystem, run the f64 chain, and pack [Va | GrT] zero-padded to the
    rank bucket. rc_np rows 0/1 are [r; c]; sb is the (>=m, >=m) Sb gram
    (or a zero-arg callable producing it). Returns (va_np (mb, 2k), Sq)."""
    if q_solver is None:
        q_solver = os.environ.get("NLE_Q_SOLVER", "auto")
    rt, ct = rc_np[0][:m], rc_np[1][:m]
    phi_top = Um64[:m]
    Ga = phi_top * lam64[None, :]
    RGa = rt[:, None] * Ga
    Wa = RGa @ (ct[:, None] * phi_top).T

    def sb_resolved():
        raw = sb() if callable(sb) else sb
        return np.asarray(raw, np.float64)[:m, :m]

    Va, GrT, Sq = host_chain64(Wa, RGa, sb_resolved, k, eps,
                               q_solver=q_solver)
    warn_rank_deficient("orthogonalize eig(Q)", int(np.count_nonzero(Sq)), k)
    va_np = np.zeros((mb, 2 * k))
    va_np[:m, :k] = Va
    va_np[:m, k:] = GrT
    return va_np, Sq


def pack_stage2b_upload(split: bool, va_np, rc_np, Um64, m: int, p: int,
                        k: int):
    """The stage-2b upload. Assembled layout: va_np itself. Split layout:
    the (p + mb, k) [top; GrT] block, top being the whole top-block V in
    f64 — Va rows < m plus (c[m:p] * Um[m:p]) @ GrT — so the device's
    stage 2b is one fused scaled matmul over the rest block plus a row
    concat. Needs the full (3, p) rc of the split stage 2a."""
    if not split:
        return va_np
    GrT = va_np[:m, k:]
    cp64 = np.asarray(rc_np[1], np.float64)
    top = np.concatenate(
        [va_np[:m, :k], (cp64[m:p, None] * Um64[m:]) @ GrT], axis=0)
    return np.concatenate([top, va_np[:, k:]], axis=0)


def check_carrier_guard(rc_np) -> bool:
    """Read the crush statistic off rc (row 2, column 0; -1.0 when no
    carrier engaged) and decide whether stage 2a must rerun through the
    f32 carrier (warn-and-continue; see carrier_guard_decision)."""
    if rc_np.shape[0] <= 2:
        return False
    crush = float(rc_np[2, 0])
    if crush < 0.0:
        return False
    retrain = carrier_guard_decision(crush, logger, "crush fraction",
                                     "retraining")
    carrier_log.info("int16 carrier crush fraction %.4f (retrained: %s)",
                     crush, retrain, extra={"crush": crush,
                                            "retrained": retrain})
    return retrain


# -- stage 2b (device) ------------------------------------------------------

def _stage2b_dense_body(factor, c_rest, va_grt, *, n: int, mb: int,
                        scaled: bool):
    """Device half 2: the eigenvector tail product + assembly.

    Split layout (factor is the tuple (phib_pad,)): va_grt is the
    [top (p, k); GrT (mb, k)] upload of pack_stage2b_upload; V is the top
    rows over K7 on the rest block. Otherwise va_grt is the (mb, 2k)
    [Va | GrT] block and V the tail product plus the additive Va overlay
    on rows < mb: with `scaled` (stage2b_factor_scaled: the small layout's
    pre-scaled cphi) a plain fp32 product, else K7 on the unscaled factor
    (rows < m zero through c_rest)."""
    if isinstance(factor, tuple):
        (phib_pad,) = factor
        p = va_grt.shape[0] - mb
        top = va_grt[:p]
        grt = va_grt[p:]
        k = grt.shape[1]
        grt_pad = grt.new_zeros((phib_pad.shape[1],
                                 round_up(k, MATMUL_COL_ALIGN)))
        grt_pad[:mb, :k] = grt
        vb = scaled_matmul(phib_pad, c_rest, grt_pad)[:n - p, :k]
        return torch.cat([top, vb], dim=0)
    k = va_grt.shape[1] // 2
    Va = va_grt[:, :k]
    GrT = va_grt[:, k:]
    if scaled:
        grt = GrT.new_zeros((factor.shape[1], k))
        grt[:mb] = GrT
        V = (factor @ grt)[:n]
    else:
        grt_pad = GrT.new_zeros((factor.shape[1],
                                 round_up(k, MATMUL_COL_ALIGN)))
        grt_pad[:mb, :k] = GrT
        V = scaled_matmul(factor, c_rest, grt_pad)[:n, :k]
    V[:mb] += Va
    return V


def _apply_u8_body(V, fs, y):
    """V diag(fs) V^T y with the clamp-to-u8 epilogue; y (N,) or (N, C).
    torch.round rounds half to even, like jnp.rint."""
    c = y.to(V.dtype)
    one_d = c.ndim == 1
    if one_d:
        c = c[:, None]
    filtered = V @ (fs[:, None] * (V.T @ c))
    check_nans("the edit", filtered)
    out = torch.clamp(torch.round(filtered), 0, 255).to(torch.uint8)
    return out[:, 0] if one_d else out


def apply_filter_u8(eigvecs: torch.Tensor, f_eigvals: torch.Tensor,
                    y_u8: torch.Tensor) -> torch.Tensor:
    """V diag(f(S)) V^T y, clamped and rounded to uint8 (reference
    src/filter.cpp:434-436); y_u8 (N,) or (N, C)."""
    return _apply_u8_body(eigvecs, f_eigvals, y_u8)


def apply_filter(eigvecs: torch.Tensor, f_eigvals: torch.Tensor,
                 channel: torch.Tensor) -> torch.Tensor:
    """filtered = V diag(f(S)) V^T c on a flattened channel, no clamp
    (reference NLEFilter::apply, src/filter.cpp:445-458)."""
    c = channel.reshape(-1).to(eigvecs.dtype)
    return (eigvecs @ (f_eigvals * (eigvecs.T @ c))).reshape(channel.shape)


# -- the phi-free stage 2b and the V-free factored filter --------------------

def train_filter_stage2b_streaming(y, rr, cc, sw, pw, c, V_head, W, *,
                                   p: int):
    """phi-free device half 2: V (N, k) in packed order, [V_head;
    diag(c_rest) K W], the tail one K1 call with the small right factor
    W = Uinv GrT (p, k); V_head and W are factored_pieces64's, in fp32 on
    the device. K1's padded (Qpad, 128) output is the peak of this stage
    (~512 B/pixel); the TPU's slab-chunked build, made for its lane
    padding, is not ported."""
    f = features(rr, cc, y)
    tail = affinity_matmul(f[:p], f[p:], W, sw, pw)
    return torch.cat([V_head, c[p:, None] * tail], dim=0)


def factored_apply(y, y_train, rr, cc, c, v_head, w, f_eigvals, sw, pw, *,
                   p: int):
    """filtered = V diag(f(S)) V^T y without a stored V: the tail rows of V
    are regenerated from the training features, by K10 for the projection
    V^T y and K11 for the output. y is (N,) or (C, N) packed float (the
    channels ride the same two passes as kernel rows); y_train (N,) is the
    training channel. The (p, k) algebra between the passes is float64 (W
    = Uinv GrT carries 1/lambda and cancels; K10's ap and K11's sums are
    float64 too). Returns y's shape, fp32."""
    ft = features(rr, cc, y_train)
    fa_rows, fb_cols, _ = pad_stream_operands(ft[:p], ft[p:])
    del ft
    q = y_train.shape[0] - p
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    f64 = torch.float64
    v_head, w = v_head.to(f64), w.to(f64)
    y = y.to(torch.float32)
    one_d = y.ndim == 1
    if one_d:
        y = y[None]
    cy = torch.nn.functional.pad(c[None, p:] * y[:, p:], (0, qpad - q))
    ap = streaming_ap(fa_rows, fb_cols, cy, sw, pw)[:, :p]        # (C, p)
    del cy
    t = ((y[:, :p].to(f64) @ v_head + ap.to(f64) @ w)
         * f_eigvals.to(f64)[None])                              # (C, k)
    b = torch.nn.functional.pad(t @ w.T, (0, ppad - p))
    tail = streaming_atb(fa_rows, fb_cols, b.contiguous(), sw, pw)[:, :q]
    out = torch.cat([(t @ v_head.T).to(torch.float32), c[None, p:] * tail],
                    dim=1)
    return out[0] if one_d else out


# -- the dense stage 2 in two halves (single and stream mode) ---------------

def host_stage1(channel_np, grid: SampleGrid, hx, hy, eps: float,
                stage1: str = "host64"):
    """Stage 1 of one frame on the host (stage1 "host64" or "topk"): (Um64,
    lam64, m, mb). Raises the clean ValueError on a degenerate Ka (no
    eigenvalue above eps)."""
    solver = ka_eigh_topk_host64 if stage1 == "topk" else ka_eigh_host64
    with stage("Computing kernel"):
        Um64, lam64, _ = solver(
            channel_np[grid.sel_rows, grid.sel_cols].astype(np.float64),
            grid.sel_rows, grid.sel_cols, hx, hy, float(eps))
        m = lam64.shape[0]
    if m == 0:
        raise ValueError("Affinity matrix Ka has no eigenvalues above eps.")
    warn_truncation(grid.n_samples, m, float(eps))
    return Um64, lam64, m, bucket_m(m, grid.n_samples)


def grid_coords(grid: SampleGrid, device: torch.device):
    """(rr, cc): the row and column of each packed pixel, float32 on
    `device`."""
    perm = upload(grid.perm, device)
    return ((perm // grid.ncols).to(torch.float32),
            (perm % grid.ncols).to(torch.float32))


@dataclasses.dataclass
class DenseFrame:
    """One frame between the two halves of the dense stage 2: its stage 2a
    queued on the device (submit_dense), the host copies of rc and Sb
    enqueued behind it, and what finish_dense needs besides."""

    y: torch.Tensor            # packed channel, float32
    rr: torch.Tensor
    cc: torch.Tensor
    stage1: torch.Tensor
    sw: float
    pw: float
    Um64: np.ndarray
    lam64: np.ndarray
    p: int
    m: int
    mb: int
    n_sinkhorn_iter: int
    eps: float
    rc: Fetch
    sb: Fetch
    factor: object
    c_rest: torch.Tensor
    # One reading of NLE_CPHI_BYTES for this frame gives both gates: the
    # layout of both stage-2a attempts (stage2_dense_small) and stage 2b's
    # `scaled` (stage2b_factor_scaled), so c is applied once.
    small: bool
    scaled: bool


def submit_dense(y, rr, cc, stage1, sw, pw, Um64, lam64, *, p: int, m: int,
                 mb: int, n_sinkhorn_iter: int, eps: float) -> DenseFrame:
    """Queue the dense stage 2a (the small layout when stage2_dense_small
    holds, else the split layout or the assembled one as NLE_STAGE2_SPLIT
    resolves) and the rc/Sb copies behind it; waits for no device work."""
    n, limit = y.shape[0], cphi_bytes_limit()
    small = stage2_dense_small(n, mb, limit)
    scaled = stage2b_factor_scaled(n, mb, torch.float32, limit)
    rc, sb, factor, c_rest = train_filter_stage2a(
        y, rr, cc, stage1, sw, pw, p=p, m=m, mb=mb,
        n_sinkhorn_iter=n_sinkhorn_iter, eps=float(eps), small=small,
        split=resolve_split_stage2(n_sinkhorn_iter))
    return DenseFrame(y, rr, cc, stage1, sw, pw, Um64, lam64, p, m, mb,
                      n_sinkhorn_iter, float(eps), Fetch(rc), Fetch(sb),
                      factor, c_rest, small, scaled)


def finish_dense(frame: DenseFrame, n_eig_vectors: int, *, packed_y=None,
                 edit_weights=None):
    """Wait for the frame's stage 2a, apply the carrier guard (retraining
    through the f32 Sinkhorn on the assembled layout, or the small one,
    when it trips), run the host f64 chain and queue stage 2b. Returns
    (V packed (N, k), S (k,)), plus the first edit's u8 output (packed)
    when edit_weights is given (it needs packed_y). Frees the frame's
    factor."""
    f = frame
    dev = f.y.device
    n = f.y.shape[0]
    with stage("Nystrom approximation + Sinkhorn"):
        rc_np = f.rc.result().astype(np.float64)
        if check_carrier_guard(rc_np):
            # Out-of-domain input for the int16 carrier: retrain through
            # the assembled f32 trajectory (the first factor freed first).
            f.factor = f.c_rest = None
            rc, sb, f.factor, f.c_rest = train_filter_stage2a(
                f.y, f.rr, f.cc, f.stage1, f.sw, f.pw, p=f.p, m=f.m,
                mb=f.mb, n_sinkhorn_iter=f.n_sinkhorn_iter, eps=f.eps,
                small=f.small, split=False, int16=False)
            f.rc, f.sb = Fetch(rc), Fetch(sb)
            rc_np = f.rc.result().astype(np.float64)
    k = min(n_eig_vectors, f.m)
    with stage("Orthogonalize"):
        sb_np = f.sb.result().astype(np.float64)
        check_nans("rc/Sb", rc_np, sb_np)
        va_np, Sq = host_orthogonalize(rc_np, sb_np, f.Um64, f.lam64, f.m,
                                       f.mb, k, f.eps)
        split = isinstance(f.factor, tuple)
        va_grt = upload(pack_stage2b_upload(split, va_np, rc_np, f.Um64,
                                            f.m, f.p, k).astype(np.float32),
                        dev)
        S = upload(Sq.astype(np.float32), dev)
    factor, c_rest = f.factor, f.c_rest
    f.factor = f.c_rest = None
    with stage("Stage 2b"):
        V = _stage2b_dense_body(factor, c_rest, va_grt, n=n, mb=f.mb,
                                scaled=f.scaled)
        return _stage2_outputs(V, S, edit_weights, packed_y)


# -- the host-level entry point ----------------------------------------------

STAGE1_SOLVERS = ("host64", "topk", "device")


def resolve_dtype(dtype, channel_np: np.ndarray) -> torch.dtype:
    """The route's dtype, as nle_tpu resolves it: the channel's own
    floating dtype when dtype is None, else float32. float32 (the kernel
    routes) and float64 (the whole-float64 route) are the two routes."""
    if dtype is None:
        dtype = (channel_np.dtype
                 if np.issubdtype(channel_np.dtype, np.floating)
                 else np.float32)
    if isinstance(dtype, torch.dtype):
        out = dtype
    else:
        out = {np.dtype(np.float32): torch.float32,
               np.dtype(np.float64): torch.float64}.get(np.dtype(dtype))
    if out not in (torch.float32, torch.float64):
        raise ValueError(f"dtype {dtype}: expected float32 or float64")
    return out


def resolve_kernels(use_kernels: bool | None, device: torch.device) -> bool:
    """Whether the float32 route runs its hand-written kernels: None means
    on the card (on the CPU the same routes run the kernels' plain
    versions), False the plain route (no kernel, the counterpart of
    nle_tpu's use_pallas=False), True the kernels, which the CPU cannot
    run."""
    if use_kernels and device.type != "cuda":
        raise ValueError(
            "use_kernels=True needs device='cuda': the kernels run on the "
            "card only (device='cpu' runs their plain versions).")
    return use_kernels is not False


def device_stage1(y, rr, cc, sw, pw, *, p: int, eps: float):
    """stage1="device": ka_eigh_stage, then the kept rank m and the kept
    columns (Um (p, m), lam (m,)) on the device with their float64 host
    copies."""
    with stage("Computing kernel"):
        U, lam = ka_eigh_stage(y, rr, cc, sw, pw, p=p, eps=eps)
        m = int(torch.count_nonzero(lam))
        Um, lam_m = U[:, :m], lam[:m]
        Um64 = Fetch(Um).result().astype(np.float64)
        lam64 = Fetch(lam_m).result().astype(np.float64)
    return Um, lam_m, Um64, lam64, m


def train_filter(channel, n_row_samples: int, n_col_samples: int, hx: float,
                 hy: float, n_sinkhorn_iter: int = 10, n_eig_vectors: int = 5,
                 *, device, eps: float | None = None, dtype=None,
                 grid: SampleGrid | None = None, packed_y=None,
                 edit_weights=None, streaming: bool | None = None,
                 pixel_order: bool = True, stage1: str = "host64",
                 use_kernels: bool | None = None):
    """Train the nonlocal filter on one channel (H, W) on `device`.

    Returns (eigvecs (N, k), eigvals (k,)) on the device, in the route's
    dtype. The rows of eigvecs are in pixel order (row-major over the
    channel, the reference's `m_eigvecs = P * V`, src/filter.cpp:502) by
    default, or in the packed [selected; rest] order with
    pixel_order=False, which callers that hold the SampleGrid (the model
    layer) use. edit_weights: also the first edit's filtered u8 channel
    (packed order), fused into stage 2b where there is one; it requires
    pixel_order=False, as in nle_tpu. packed_y: the packed channel already
    on the device (skips the upload).

    The options are nle_tpu's (ops/pipeline.py train_filter):
    - stage1: the Ka eigensolver, "host64" (float64 LAPACK on the host),
      "topk" (the reference's USE_SPECTRA solver, k doubling) or "device"
      (Ka and its eigh in the route's dtype on the device);
    - dtype: float32 (None, for a non-float channel) runs the float32
      routes with the host float64 chain; float64 the whole-float64 route
      (train_filter_stage2: plain PyTorch, eigh on the device), which
      takes no streaming;
    - use_kernels: see resolve_kernels; False runs the float32 route in
      plain PyTorch (_train_plain), which takes no streaming either;
    - streaming: True/False forces the phi-free or the dense stage 2;
      None applies resolve_streaming's rule.
    The dense kernel route is submit_dense then finish_dense, the two
    halves stream mode (models/batch.py) overlaps."""
    if edit_weights is not None and pixel_order:
        raise ValueError(
            "edit_weights requires pixel_order=False (the caller holds "
            "the SampleGrid and unscatters the u8 result on the host).")
    dev = resolve_device(device)
    channel_np = np.asarray(channel)
    dtype = resolve_dtype(dtype, channel_np)
    if stage1 not in STAGE1_SOLVERS:
        raise ValueError(f"stage1={stage1!r}: expected host64|topk|device")
    kernels = resolve_kernels(use_kernels, dev)
    f64 = dtype == torch.float64
    if f64:
        if streaming:
            raise ValueError(
                "streaming stage 2 requires the float32 route; got "
                "dtype=float64.")
        if use_kernels:
            raise ValueError("use_kernels=True: the float64 route runs no "
                             "kernel (the kernels compute in float32).")
    elif not kernels and streaming:
        raise ValueError(
            "use_kernels=False runs the dense stage 2 in plain PyTorch; the "
            "streaming stage 2 runs on its kernels (K8-K12).")
    if eps is None:
        eps = EPS
    eps = float(eps)
    nrows, ncols = channel_np.shape
    if grid is None:
        grid = sample_grid(nrows, ncols, n_row_samples, n_col_samples)
    if packed_y is None:
        packed_y = upload(pack_channel(channel_np, grid.perm)[0], dev)
    y = packed_y.to(dtype)
    rr, cc = grid_coords(grid, dev)
    rr, cc = rr.to(dtype), cc.to(dtype)
    sw, pw = bandwidth_weights(hx, hy, dtype)
    p = grid.n_samples
    n = grid.n_pixels

    Um_d = lam_d = None
    if stage1 == "device":
        Um_d, lam_d, Um64, lam64, m = device_stage1(
            y, rr, cc, sw, pw, p=p, eps=eps)
        if m == 0:
            raise ValueError(
                "Affinity matrix Ka has no eigenvalues above eps.")
        warn_truncation(p, m, eps)
        mb = bucket_m(m, p)
    else:
        Um64, lam64, m, mb = host_stage1(channel_np, grid, hx, hy, eps,
                                         stage1=stage1)

    if f64:
        out = _train_float64(y, rr, cc, sw, pw, Um_d, lam_d, Um64, lam64,
                             p=p, m=m, n_sinkhorn_iter=n_sinkhorn_iter,
                             n_eig_vectors=n_eig_vectors, eps=eps,
                             edit_weights=edit_weights)
    elif kernels and resolve_streaming(streaming, dev, n, mb):
        out = _train_streaming(y, rr, cc, sw, pw, Um64, lam64, p=p, m=m,
                               mb=mb, n_sinkhorn_iter=n_sinkhorn_iter,
                               n_eig_vectors=n_eig_vectors, eps=eps,
                               edit_weights=edit_weights)
    else:
        stage1_dev = (pack_stage1_device(Um_d, lam_d, mb) if Um_d is not None
                      else upload(pack_stage1(Um64, lam64, mb=mb), dev))
        if not kernels:
            out = _train_plain(y, rr, cc, stage1_dev, sw, pw, Um64, lam64,
                               p=p, m=m, mb=mb,
                               n_sinkhorn_iter=n_sinkhorn_iter,
                               n_eig_vectors=n_eig_vectors, eps=eps,
                               packed_y=packed_y, edit_weights=edit_weights)
        else:
            with stage("Nystrom approximation + Sinkhorn"):
                frame = submit_dense(y, rr, cc, stage1_dev, sw, pw, Um64,
                                     lam64, p=p, m=m, mb=mb,
                                     n_sinkhorn_iter=n_sinkhorn_iter,
                                     eps=eps)
            out = finish_dense(frame, n_eig_vectors, packed_y=packed_y,
                               edit_weights=edit_weights)
    if pixel_order:
        return (_pixel_rows(out[0], grid),) + tuple(out[1:])
    return out


def _stage2_outputs(V, S, edit_weights, y):
    """(V, S), or with edit_weights (V, S, the first edit's u8 output on
    the packed channel y), queued right behind stage 2b."""
    check_nans("V", V)
    check_nans("S", S)
    if edit_weights is None:
        return V, S
    return V, S, _apply_u8_body(V, transform_eigenvalues(S, edit_weights), y)


# -- the routes that run no kernel (use_kernels=False, dtype=float64) --------

def plain_phi(y, rr, cc, Um, Uinv, sw, pw, *, p: int):
    """The Nystrom factor phi = [Um; K(rest, samples) Uinv] (N, m') in plain
    PyTorch in y's dtype on its device (rr, cc, y: the packed pixels' rows,
    columns and intensities)."""
    f = features(rr, cc, y, y.dtype)
    return torch.cat([Um, affinity_matmul_plain(f[:p], f[p:], Uinv, sw, pw)])


def plain_phi_balance(y, rr, cc, Um, lam_m, Uinv, sw, pw, *, p: int,
                      n_sinkhorn_iter: int, eps: float):
    """The plain routes' shared prologue: plain_phi and its Sinkhorn
    vectors (r, c)."""
    phi = plain_phi(y, rr, cc, Um, Uinv, sw, pw, p=p)
    return (phi, *sinkhorn_vectors(phi, lam_m, n_sinkhorn_iter, eps))


def train_filter_stage2a_plain(y, rr, cc, stage1, sw, pw, *, p: int, m: int,
                               mb: int, n_sinkhorn_iter: int, eps: float):
    """Stage 2a in plain PyTorch on the assembled (N, mb) factor, as
    nle_tpu's stage 2a runs without Pallas: phi = [Um; K Uinv] (row tiles),
    the float32 Sinkhorn matvecs, and the gram of cphi = diag(c_rest) phi.
    Returns (rc (3, mb) with row 2 the -1.0 "no carrier" mark, Sb (mb, mb),
    cphi (N, mb))."""
    phi, r, c = plain_phi_balance(y, rr, cc, *_unpack_stage1(stage1, p), sw,
                                  pw, p=p, n_sinkhorn_iter=n_sinkhorn_iter,
                                  eps=eps)
    cphi = _rest_scaling(c, m) * phi
    del phi
    Sb = (cphi.T @ cphi)[:mb, :mb]
    rc = torch.stack([r[:mb], c[:mb], torch.full_like(r[:mb], -1.0)])
    return rc, Sb, cphi


def _train_plain(y, rr, cc, stage1, sw, pw, Um64, lam64, *, p: int, m: int,
                 mb: int, n_sinkhorn_iter: int, n_eig_vectors: int,
                 eps: float, packed_y, edit_weights):
    """train_filter's plain float32 route: train_filter_stage2a_plain, the
    host f64 chain, and V = cphi GrT with the host Va on rows < mb."""
    with stage("Nystrom approximation + Sinkhorn"):
        rc, sb, cphi = train_filter_stage2a_plain(
            y, rr, cc, stage1, sw, pw, p=p, m=m, mb=mb,
            n_sinkhorn_iter=n_sinkhorn_iter, eps=eps)
        check_nans("rc/Sb", rc, sb)
        rc_np = Fetch(rc).result().astype(np.float64)
    k = min(n_eig_vectors, m)
    with stage("Orthogonalize"):
        va_np, Sq = host_orthogonalize(
            rc_np, Fetch(sb).result().astype(np.float64), Um64, lam64, m,
            mb, k, eps)
        va_grt = upload(va_np.astype(np.float32), y.device)
        S = upload(Sq.astype(np.float32), y.device)
    with stage("Stage 2b"):
        V = cphi @ va_grt[:, k:]
        del cphi
        V[:mb] += va_grt[:, :k]
        return _stage2_outputs(V, S, edit_weights, packed_y)


def train_filter_stage2(y, rr, cc, Um, lam_m, Uinv, sw, pw, *, p: int, m: int,
                        n_sinkhorn_iter: int, n_eig_vectors: int, eps: float):
    """Nystrom extension, Sinkhorn and the one-shot orthogonalization in the
    operands' dtype on their device (plain PyTorch; nle_tpu's
    train_filter_stage2, whose Pallas kernels serve float32 only). Returns
    (V packed (N, k), S (k,)), k = min(n_eig_vectors, m)."""
    phi, r, c = plain_phi_balance(y, rr, cc, Um, lam_m, Uinv, sw, pw, p=p,
                                  n_sinkhorn_iter=n_sinkhorn_iter, eps=eps)
    Ga, RGa, Wa = balanced_top(phi, lam_m, r, c, m)
    check_nans("r/c", r, c)
    return orthogonalize_factored(Wa, RGa, phi[m:], c[m:], r[:m], Ga,
                                  min(n_eig_vectors, m), eps)


def _train_float64(y, rr, cc, sw, pw, Um_d, lam_d, Um64, lam64, *, p: int,
                   m: int, n_sinkhorn_iter: int, n_eig_vectors: int,
                   eps: float, edit_weights):
    """train_filter's float64 route: stage 1's eigensystem in float64 on
    the device (Uinv = Um / lam), train_filter_stage2, and the standalone
    apply for the first edit (the route has no stage 2b to fuse it in)."""
    dev, f64 = y.device, torch.float64
    if Um_d is not None:
        Um, lam_m = Um_d, lam_d
        Uinv = Um * safe_reciprocal(lam_m, eps)[None, :]
    else:
        Um = upload(Um64, dev)
        lam_m = upload(lam64, dev)
        Uinv = upload(Um64 / lam64[None, :], dev)
    with stage("Nystrom approximation + Sinkhorn + Orthogonalize"):
        V, S = train_filter_stage2(
            y, rr, cc, Um.to(f64), lam_m.to(f64), Uinv.to(f64), sw, pw, p=p,
            m=m, n_sinkhorn_iter=n_sinkhorn_iter,
            n_eig_vectors=n_eig_vectors, eps=eps)
    return _stage2_outputs(V, S, edit_weights, y)


def _pixel_rows(V, grid: SampleGrid):
    """Packed rows -> pixel order: a gather by the inverse permutation,
    out[i] = V[inv_perm[i]] (nle_tpu's _scatter_rows)."""
    return V[upload(grid.unpack_indices(), V.device)]


# Peak device bytes of the dense stage 2 per byte of the padded f32 phi, on
# its worse layout: the assembled layout holds K1's phi_b and the assembled
# phi at once (2 x phi) on every one of its Sinkhorn routes — f32 (the
# carrier guard's fallback, NLE_SINKHORN_INT16=off), K13, and the int16
# (NLE_STAGE2_SPLIT=off) and bf16-lead (NLE_SINKHORN_BF16) routes, whose
# half-size copies are made after phi_b is freed; the small layout is the
# assembled one up to its Sinkhorn and then scales phi in place, so it
# holds no more; the split layout holds phi_b and its int16 copy (1.5 x
# phi); all add the O(N) vectors. The carrier's prep also holds the f32
# and bool temporaries of one PREP_CHUNK_ROWS-row chunk (~8.5 B an entry
# of it) beside phi and its int16 copy: within the slack from about four
# chunks of rows up, and over it below, where phi is small (the 64 MiB
# phi of the small layout's largest default frame reads 2.566 x phi). The
# rule leaves those fixed bytes out.
# chip_smoke.py measures the ratio on the card ([5] and [10b] at 1 MP, [8d]
# on every route just under the limit, [17a] on the small layout under a
# raised NLE_CPHI_BYTES) and fails if a run exceeds it; [17a]'s 64 MiB
# frame is held to the ratio plus the prep's chunk. PERF.md records the
# readings.
DENSE_PEAK_PER_PHI_BYTE = 2.1


def stream_bytes_limit(device: torch.device) -> int:
    """phi bytes past which train_filter streams: NLE_STREAM_BYTES when
    set, else the largest phi whose dense stage 2 (DENSE_PEAK_PER_PHI_BYTE
    times phi at its peak) fits in what this process can still allocate on
    the card: its free memory (mem_get_info) plus the allocator's unused
    cache."""
    raw = os.environ.get("NLE_STREAM_BYTES")
    if raw is not None:
        return int(raw)
    free, _ = torch.cuda.mem_get_info(device)
    available = (free + torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))
    return int(available / DENSE_PEAK_PER_PHI_BYTE)


def resolve_streaming(streaming: bool | None, device: torch.device, n: int,
                      mb: int) -> bool:
    """Whether stage 2 runs phi-free. Auto: on the card, when the padded
    f32 phi (4 npad mpad bytes) exceeds stream_bytes_limit, or when its
    mpad exceeds the widest factor K3/K4 take (MAX_MPAD); on the CPU never
    (as the JAX package streams only where its Pallas kernels run). An
    explicit True wins; an explicit False on the card past MAX_MPAD raises
    ValueError. The JAX rule's second half (VMEM fit of the scaled
    kernels) is a TPU reason and is not ported."""
    if streaming is True or device.type != "cuda":
        return bool(streaming)
    npad, mpad = padded_shape(n, mb)
    if mpad > MAX_MPAD:
        if streaming is False:
            raise ValueError(
                f"the dense stage 2 on the card takes at most MAX_MPAD = "
                f"{MAX_MPAD} factor columns (the K3/K4 Sinkhorn kernel's "
                f"shared-memory tile); this frame's rank bucket mb = {mb} "
                f"pads to {mpad}: train with streaming=True or None")
        return True
    if streaming is False:
        return False
    return 4 * npad * mpad > stream_bytes_limit(device)


def _train_streaming(y, rr, cc, sw, pw, Um64, lam64, *,
                     p: int, m: int, mb: int, n_sinkhorn_iter: int,
                     n_eig_vectors: int, eps: float, edit_weights):
    """train_filter's phi-free branch: streaming stage 2a (K8, K12), the
    host f64 chain and pieces (factored_pieces64), and the streaming stage
    2b (K1 with W = Uinv GrT)."""
    logger.info("using the phi-free streaming stage 2 (%d pixels, m = %d)",
                y.shape[0], m)
    with stage("Nystrom approximation + Sinkhorn"):
        rc_np, sb_np, c = train_filter_stage2a_streaming(
            y, rr, cc, sw, pw, p=p, m=m, n_sinkhorn_iter=n_sinkhorn_iter,
            eps=eps, stage1_64=(Um64, lam64))
    k = min(n_eig_vectors, m)
    with stage("Orthogonalize"):
        check_nans("rc/Sb", rc_np, sb_np)
        va_np, Sq = host_orthogonalize(rc_np, sb_np, Um64, lam64, m, mb, k,
                                       eps)
        V_head, W = (upload(a.astype(np.float32), y.device)
                     for a in factored_pieces64(rc_np, va_np, Um64, lam64, m,
                                                k))
        S = upload(Sq.astype(np.float32), y.device)
    with stage("Stage 2b"):
        V = train_filter_stage2b_streaming(y, rr, cc, sw, pw, c, V_head, W,
                                           p=p)
        return _stage2_outputs(V, S, edit_weights, y)
