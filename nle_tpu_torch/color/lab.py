"""BGR <-> CIE Lab in OpenCV's 8-bit convention (port of
nle_tpu/color/lab.py, tables and arithmetic unchanged).

The reference trains and edits in OpenCV's 8-bit Lab space
(cv::COLOR_BGR2Lab on CV_8U): L is scaled to [0, 255] and a, b are offset
by +128. Both directions reimplement OpenCV's fixed-point integer
pipelines and are bit-exact against cv2 (see nle_tpu/color/lab.py for the
validation record). Bit-exactness is load-bearing: training is
chaotically sensitive to the L channel (+-1 LSB on ~15% of pixels costs
~25 dB of golden PSNR).

Two forms of each conversion:
- the host pair `bgr_to_lab_u8_np` / `lab_to_bgr_u8_np`, which the model
  layer calls: the C kernels of nle_tpu_torch/native when a compiler
  built them, else NumPy (with one warning naming that path);
- the device twins `bgr_to_lab_u8`, `lab_to_bgr_u8` (the same integer
  LUT pipelines in plain torch: int32 gathers and arithmetic shifts, on
  the tensor's own device), `bgr_to_lab_u8_float` (the float formula,
  fp32, within 1-2 LSB of OpenCV), `luminance_channel` and `y_channel`.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nle_tpu_torch import native
from nle_tpu_torch.utils.logging import logger

# D65 reference white (OpenCV's constants).
_XN = 0.950456
_ZN = 1.088754
# sRGB <-> linear
_SRGB_T = 0.04045
_SRGB_INV_T = 0.0031308
# CIE Lab
_T0 = 0.008856
_CBRT_T = 6.0 / 29.0
_KAPPA = 903.3

# ---- OpenCV 8-bit fixed-point tables (computed once at import) ----
_GAMMA_SHIFT = 3
_LAB_SHIFT = 12
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT  # 15
_GSCALE = 255 * (1 << _GAMMA_SHIFT)      # 2040


def _build_tables():
    i = np.arange(256, dtype=np.float64) / 255.0
    lin = np.where(i > _SRGB_T, ((i + 0.055) / 1.055) ** 2.4, i / 12.92)
    gamma_tab = np.round(_GSCALE * lin).astype(np.int32)

    # OpenCV builds this table in float32; reproducing that is required for
    # bit-exactness at a handful of rounding boundaries.
    j = np.arange(3072, dtype=np.float32) / np.float32(_GSCALE)
    f = np.where(
        j < np.float32(_T0),
        j * np.float32(7.787) + np.float32(16.0 / 116.0),
        np.cbrt(j),
    )
    cbrt_tab = np.round(np.float32(1 << _LAB_SHIFT2) * f).astype(np.int32)

    D65 = np.array([_XN, 1.0, _ZN])
    M = np.array(
        [
            [0.412453, 0.357580, 0.180423],
            [0.212671, 0.715160, 0.072169],
            [0.019334, 0.119193, 0.950227],
        ]
    )
    coeffs = np.round((1 << _LAB_SHIFT) * M / D65[:, None]).astype(np.int32)
    return gamma_tab, cbrt_tab, coeffs


_GAMMA_TAB, _CBRT_TAB, _XYZ_COEFFS = _build_tables()
_L_SCALE = (116 * 255 + 50) // 100
_L_SHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


def _native_lib():
    """The C library, or None; the first miss logs which path runs."""
    lib = native.load()
    if lib is None:
        _warn_numpy_path()
    return lib


@functools.cache
def _warn_numpy_path() -> None:
    logger.warning(
        "host Lab: no C compiler built %s; BGR<->Lab runs on the NumPy path "
        "(nle_tpu_torch/color/lab.py, several times slower)", native.SOURCE)


def bgr_to_lab_u8_np(bgr_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H, W, 3) uint8 Lab, bit-exact vs OpenCV: the
    C kernel when it built, else `bgr_to_lab_u8_numpy`."""
    lib = _native_lib() if bgr_u8.ndim == 3 and bgr_u8.shape[2] == 3 else None
    if lib is not None:
        return native.bgr2lab_u8(lib, bgr_u8, _GAMMA_TAB, _CBRT_TAB,
                                 _XYZ_COEFFS, _L_SCALE, _L_SHIFT)
    return bgr_to_lab_u8_numpy(bgr_u8)


def bgr_to_lab_u8_numpy(bgr_u8: np.ndarray) -> np.ndarray:
    """The NumPy path of bgr_to_lab_u8_np. int32 throughout — every
    intermediate fits (max |value| < 2^25) and int64 temps double the
    conversion time at megapixel sizes."""
    b = np.take(_GAMMA_TAB, bgr_u8[..., 0])
    g = np.take(_GAMMA_TAB, bgr_u8[..., 1])
    r = np.take(_GAMMA_TAB, bgr_u8[..., 2])
    C = _XYZ_COEFFS
    half = np.int32(1 << (_LAB_SHIFT - 1))
    half2 = np.int32(1 << (_LAB_SHIFT2 - 1))

    ix = (r * C[0, 0] + g * C[0, 1] + b * C[0, 2] + half) >> _LAB_SHIFT
    fX = np.take(_CBRT_TAB, np.clip(ix, 0, 3071))
    ix = (r * C[1, 0] + g * C[1, 1] + b * C[1, 2] + half) >> _LAB_SHIFT
    fY = np.take(_CBRT_TAB, np.clip(ix, 0, 3071))
    ix = (r * C[2, 0] + g * C[2, 1] + b * C[2, 2] + half) >> _LAB_SHIFT
    fZ = np.take(_CBRT_TAB, np.clip(ix, 0, 3071))
    out = np.empty(bgr_u8.shape, np.uint8)
    L = (np.int32(_L_SCALE) * fY + np.int32(_L_SHIFT) + half2) >> _LAB_SHIFT2
    np.clip(L, 0, 255, out=L)
    out[..., 0] = L
    a = (np.int32(500) * (fX - fY) + np.int32(128 << _LAB_SHIFT2) + half2) >> _LAB_SHIFT2
    np.clip(a, 0, 255, out=a)
    out[..., 1] = a
    bb = (np.int32(200) * (fY - fZ) + np.int32(128 << _LAB_SHIFT2) + half2) >> _LAB_SHIFT2
    np.clip(bb, 0, 255, out=bb)
    out[..., 2] = bb
    return out


# ---- Inverse (Lab -> BGR) fixed-point tables ----
# OpenCV's Lab2RGBinteger pipeline at BASE = 2^14, bit-exact vs cv2 on the
# full 256^3 Lab cube (verified exhaustively; reconstructed empirically by
# coordinate-descent fitting of each table against cv2 5.0 outputs — every
# table reduced to the closed forms below). ~10x faster on the host than
# pow()-based float math.
_IBASE = 1 << 14
_IMIN_AB = -8145          # == min(ify - bdiv): offset 0 lands EXACTLY on
                          # the table start (zero margin — keep clamps)
_IGAMMA_BITS = 12         # inverse-gamma LUT index width
_ISHIFT = 14              # descale: (BASE * 2^12 matrix) -> 2^12 index


def _build_inverse_tables():
    # L -> (y, f(y)) at BASE scale. Constructed in float32 (like OpenCV's
    # softfloat tables) — the rounding domain matters for a few entries.
    f32 = np.float32
    li = (f32(np.arange(256)) * f32(100) / f32(255)).astype(f32)
    kappa = f32(np.float32(24389) / np.float32(27))  # 903.3 (exact CIE)
    y_lin = li / kappa
    ify_lin = f32(f32(841) / f32(108)) * y_lin + f32(f32(16) / f32(116))
    ify_cub = (li + f32(16)) / f32(116)
    y_cub = ify_cub * ify_cub * ify_cub
    lin = li <= f32(8.0)  # L* threshold: kappa * (6/29)^3 == 8 exactly
    y_tab = np.rint(np.where(lin, y_lin, y_cub) * f32(_IBASE)).astype(np.int32)
    ify_tab = np.rint(np.where(lin, ify_lin, ify_cub) * f32(_IBASE)).astype(np.int32)

    # f-inverse table over the full reachable f-value range, pure integer
    # construction with C-style truncation toward zero (matches OpenCV):
    # linear branch (f <= 6/29): (v - 16/116) * 108/841; else v^3.
    idx = np.arange(_IMIN_AB, _IBASE * 9 // 4 + _IMIN_AB, dtype=np.int64)
    c2 = (_IBASE * 16 // 116) * 108 // 841
    q = np.abs(idx * 108) // 841
    lin_v = np.where(idx < 0, -q, q) - c2
    cube_v = ((idx * idx) // _IBASE) * idx // _IBASE
    ab_tab = np.where(idx <= 3389, lin_v, cube_v).astype(np.int32)

    inv_m = np.array(
        [
            [3.240479, -1.537150, -0.498535],
            [-0.969256, 1.875992, 0.041556],
            [0.055648, -0.204043, 1.057311],
        ],
        dtype=np.float32,
    )
    white = np.array([_XN, 1.0, _ZN], dtype=np.float32)
    coeffs = np.rint(
        np.float64(inv_m * white[None, :]) * (1 << _LAB_SHIFT)
    ).astype(np.int64)

    g = np.arange(1 << _IGAMMA_BITS, dtype=np.float64) / (1 << _IGAMMA_BITS)
    srgb = np.where(g > _SRGB_INV_T, 1.055 * g ** (1.0 / 2.4) - 0.055, 12.92 * g)
    gamma_tab = np.clip(np.rint(srgb * 255.0), 0, 255).astype(np.uint8)

    # a/b (raw uint8) -> fixed-point a*BASE/500 - 128*BASE/500 (resp. /200);
    # OpenCV's mult-shift approximations, reproduced exactly.
    u = np.arange(256, dtype=np.int64)
    adiv_tab = (((5 * u * 53687 + (1 << 7)) >> 13) - 128 * _IBASE // 500).astype(np.int32)
    bdiv_tab = (((u * 41943 + (1 << 4)) >> 9) - 128 * _IBASE // 200 + 1).astype(np.int32)
    return y_tab, ify_tab, ab_tab, coeffs, gamma_tab, adiv_tab, bdiv_tab


(_IY_TAB, _IFY_TAB, _IAB_TAB, _ICOEFFS, _IGAMMA_TAB,
 _IADIV_TAB, _IBDIV_TAB) = _build_inverse_tables()


def lab_to_bgr_u8_np(lab_u8: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 Lab -> (H, W, 3) uint8 BGR (bit-exact vs cv2): the C
    kernel when it built, else `lab_to_bgr_u8_numpy`."""
    lib = _native_lib() if lab_u8.ndim == 3 and lab_u8.shape[2] == 3 else None
    if lib is not None:
        return native.lab2bgr_u8(lib, lab_u8, _IY_TAB, _IFY_TAB, _IAB_TAB,
                                 _IMIN_AB, _ICOEFFS, _IGAMMA_TAB, _IADIV_TAB,
                                 _IBDIV_TAB)
    return lab_to_bgr_u8_numpy(lab_u8)


def lab_to_bgr_u8_numpy(lab_u8: np.ndarray) -> np.ndarray:
    """The NumPy path of lab_to_bgr_u8_np."""
    L = lab_u8[..., 0].astype(np.int32)
    y = _IY_TAB[L].astype(np.int64)
    ify = _IFY_TAB[L]
    adiv = _IADIV_TAB[lab_u8[..., 1]]
    bdiv = _IBDIV_TAB[lab_u8[..., 2]]
    # Same index clamps as the C twin (labcolor.c): the table has ZERO
    # margin at offset 0 (_IMIN_AB note), so without the clamp a future
    # 1-LSB table-rounding change would wrap -1 to the LAST entry silently.
    top = len(_IAB_TAB) - 1
    x = _IAB_TAB[np.clip(ify + adiv - _IMIN_AB, 0, top)].astype(np.int64)
    z = _IAB_TAB[np.clip(ify - bdiv - _IMIN_AB, 0, top)].astype(np.int64)
    C = _ICOEFFS
    half = 1 << (_ISHIFT - 1)
    hi = (1 << _IGAMMA_BITS) - 1
    ro = np.clip((C[0, 0] * x + C[0, 1] * y + C[0, 2] * z + half) >> _ISHIFT, 0, hi)
    go = np.clip((C[1, 0] * x + C[1, 1] * y + C[1, 2] * z + half) >> _ISHIFT, 0, hi)
    bo = np.clip((C[2, 0] * x + C[2, 1] * y + C[2, 2] * z + half) >> _ISHIFT, 0, hi)
    return np.stack(
        [_IGAMMA_TAB[bo], _IGAMMA_TAB[go], _IGAMMA_TAB[ro]], axis=-1
    )


# ---- The device twins (plain torch on the tensor's device) ----

@functools.lru_cache(maxsize=None)
def _tables(device: torch.device) -> dict:
    """Every LUT as an int32 tensor on `device`, uploaded once per device
    (so a conversion never waits on a blocking table copy)."""
    from nle_tpu_torch.utils.transfer import upload

    host = dict(gamma=_GAMMA_TAB, cbrt=_CBRT_TAB, iy=_IY_TAB, ify=_IFY_TAB,
                iadiv=_IADIV_TAB, ibdiv=_IBDIV_TAB, iab=_IAB_TAB,
                igamma=_IGAMMA_TAB.astype(np.int32))
    return {k: upload(v.astype(np.int32), device) for k, v in host.items()}


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def bgr_to_lab_u8(bgr_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 BGR -> (..., 3) uint8 Lab on the tensor's device, the
    integer pipeline of bgr_to_lab_u8_np (bit-exact vs OpenCV)."""
    t = _tables(bgr_u8.device)
    C = _XYZ_COEFFS.tolist()
    idx = bgr_u8.to(torch.int32)
    b, g, r = (t["gamma"][idx[..., i]] for i in range(3))

    def f(row):
        ix = _descale(r * C[row][0] + g * C[row][1] + b * C[row][2],
                      _LAB_SHIFT)
        return t["cbrt"][ix.clamp(0, 3071)]

    fX, fY, fZ = f(0), f(1), f(2)
    L = _descale(_L_SCALE * fY + _L_SHIFT, _LAB_SHIFT2)
    a = _descale(500 * (fX - fY) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    bb = _descale(200 * (fY - fZ) + 128 * (1 << _LAB_SHIFT2), _LAB_SHIFT2)
    return torch.stack([L, a, bb], dim=-1).clamp(0, 255).to(torch.uint8)


def _srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    return torch.where(c > _SRGB_T, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    # torch has no cbrt: x^(1/3) of |x| with x's sign (within an ulp).
    return torch.sign(x) * x.abs() ** (1.0 / 3.0)


def _f(t: torch.Tensor) -> torch.Tensor:
    return torch.where(t > _T0, _cbrt(t), 7.787 * t + 16.0 / 116.0)


def bgr_to_lab_u8_float(bgr_u8: torch.Tensor) -> torch.Tensor:
    """Float-formula forward conversion in fp32 (within 1-2 LSB of OpenCV;
    the cross-check of the LUT constants, not the training path)."""
    x = bgr_u8.to(torch.float32) / 255.0
    b, g, r = (_srgb_to_linear(x[..., i]) for i in range(3))
    X = 0.412453 * r + 0.357580 * g + 0.180423 * b
    Y = 0.212671 * r + 0.715160 * g + 0.072169 * b
    Z = 0.019334 * r + 0.119193 * g + 0.950227 * b
    fX, fY, fZ = _f(X / _XN), _f(Y), _f(Z / _ZN)
    L = torch.where(Y > _T0, 116.0 * _cbrt(Y) - 16.0, _KAPPA * Y)
    lab = torch.stack([L * (255.0 / 100.0), 500.0 * (fX - fY) + 128.0,
                       200.0 * (fY - fZ) + 128.0], dim=-1)
    return torch.round(lab).clamp(0, 255).to(torch.uint8)


def lab_to_bgr_u8(lab_u8: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 Lab -> (..., 3) uint8 BGR on the tensor's device, the
    integer pipeline of lab_to_bgr_u8_np (bit-exact vs cv2). int32 as in
    nle_tpu's twin: the largest |C @ (x, y, z)| is ~2^30.4, under one bit
    below the int32 limit."""
    t = _tables(lab_u8.device)
    idx = lab_u8.to(torch.int32)
    y = t["iy"][idx[..., 0]]
    ify = t["ify"][idx[..., 0]]
    adiv = t["iadiv"][idx[..., 1]]
    bdiv = t["ibdiv"][idx[..., 2]]
    top = len(_IAB_TAB) - 1
    x = t["iab"][(ify + adiv - _IMIN_AB).clamp(0, top)]
    z = t["iab"][(ify - bdiv - _IMIN_AB).clamp(0, top)]
    C = _ICOEFFS.tolist()
    half = 1 << (_ISHIFT - 1)
    hi = (1 << _IGAMMA_BITS) - 1

    def out(row):
        v = (C[row][0] * x + C[row][1] * y + C[row][2] * z + half) >> _ISHIFT
        return t["igamma"][v.clamp(0, hi)]

    return torch.stack([out(2), out(1), out(0)], dim=-1).to(torch.uint8)


def luminance_channel(bgr_u8: torch.Tensor) -> torch.Tensor:
    """8-bit Lab L as float32 (the training signal; reference
    getLuminanceChannel, src/filter.cpp:460-469)."""
    return bgr_to_lab_u8(bgr_u8)[..., 0].to(torch.float32)


def y_channel(bgr_u8: torch.Tensor) -> torch.Tensor:
    """BGR -> YUV Y as uint8 with OpenCV's BT.601 fixed-point weights
    (reference getYChannel, src/filter.cpp:471-478)."""
    x = bgr_u8.to(torch.int32)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    y = (r * 4899 + g * 9617 + b * 1868 + (1 << 13)) >> 14
    return y.clamp(0, 255).to(torch.uint8)
