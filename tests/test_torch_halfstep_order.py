"""w = K u's sum order in the one-build half-step (K8's kernel, serving K9
to Ppad 4096) against the two-pass K9's, in a float64-emulated fp32 model
on the CPU.

The streaming loop divides by eigenvalues down to 1e-10, so u = Uinv t
carries weights up to 1e10 and w cancels: each order's rounding reaches
x = 1 / w amplified. On the card, in nle_tpu's fp32 loop, the one-build
kernel's c ended up to 2.1x further from float64 than the two-pass K9's
on three of four [9c]-like frames (PERF.md). The model holds each order
(the one-build kernel's: pairs, an aligned tree up to HS_SEGMENT
samples, the segments added in order with Kahan's compensation; a
32-sample segment; the two-pass K9's: 32-sample fmaf chains added with
compensation) to the kernel's contract, the fp32 chain bound, one
half-step at a time on a small dense-grid operand with the rank cut at
1e-10. Each fp32 operation is emulated exactly: a sum or product of two
fp32 values rounded once, an fmaf as the float64 product-sum rounded
once."""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
from nle_tpu_torch.ops.affinity import (
    affinity_block,
    bandwidth_weights,
    features,
)
from nle_tpu_torch.ops.kernels import streaming_kernel as tsk
from nle_tpu_torch.ops.linalg import safe_reciprocal
from nle_tpu_torch.ops.pipeline import ka_eigh_host64
from nle_tpu_torch.ops.sampling import sample_grid

CSRC = os.path.join(os.path.dirname(tsk.__file__), "..", "..", "csrc",
                    "streaming.cu")
U = 2.0 ** -24
K9_GRAIN = 32              # the two-pass K9's pass 1: ST_ROW_GRAIN chains
STEPS = 6                  # half-steps of the float64 loop modelled


def _fmaf(a, b, c):
    return (a.double() * b.double() + c.double()).float()


def _kahan(parts: torch.Tensor) -> torch.Tensor:
    """Each row's parts (rows, n) added in order with Kahan's compensation,
    zero parts skipped (nle::kahan_add), then sum - comp."""
    s = torch.zeros(parts.shape[0])
    comp = torch.zeros(parts.shape[0])
    for k in range(parts.shape[1]):
        v = parts[:, k]
        y = v - comp
        t = s + y
        live = v != 0
        comp = torch.where(live, (t - s) - y, comp)
        s = torch.where(live, t, s)
    return s - comp


def onebuild_w(K: torch.Tensor, u: torch.Tensor, segment: int):
    """The one-build kernel's order: fmaf(K[2k+1], u[2k+1], K[2k] u[2k]),
    aligned pairs of nodes up to `segment` samples, the segments in
    order with compensation."""
    nodes = _fmaf(K[:, 1::2], u[1::2], K[:, 0::2] * u[0::2])
    nodes = torch.nn.functional.pad(nodes,
                                    (0, -nodes.shape[1] % (segment // 2)))
    width = 2
    while width < segment:
        nodes = nodes[:, 0::2] + nodes[:, 1::2]
        width *= 2
    return _kahan(nodes)


def two_pass_w(K: torch.Tensor, u: torch.Tensor):
    """The two-pass K9's order: K9_GRAIN-sample fmaf chains in increasing
    sample index, the chains in order with compensation."""
    groups = K.shape[1] // K9_GRAIN
    Kg = K.view(K.shape[0], groups, K9_GRAIN)
    ug = u.view(groups, K9_GRAIN)
    part = torch.zeros(K.shape[0], groups)
    for j in range(K9_GRAIN):
        part = _fmaf(Kg[:, :, j], ug[:, j], part)
    return _kahan(part)


def _frame(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth, photo-like BGR frame: low-frequency shading, a few soft
    discs and mild texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 110 + 50 * np.sin(xx / (w / 5.0)) * np.cos(yy / (h / 3.0))
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad = rng.uniform(0.05, 0.2) * min(h, w)
        base += rng.uniform(-40, 40) / (1 + np.exp(np.minimum(
            ((yy - cy) ** 2 + (xx - cx) ** 2) ** 0.5 / 8 - rad / 8, 700.0)))
    base += rng.normal(0, 2.0, (h, w))
    img = np.stack([base * 0.9 + 10, base, base * 1.05 - 5], axis=-1)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _operand(seed: int):
    """A 64 x 64 frame (_frame) sampled on a 24 x 22 grid (p = 575, Ppad
    640), rank cut at eigenvalues of 1e-10: the fp32 rest-by-sample
    affinity (Ppad columns, pad samples zero) and the float64 loop's
    (Um, lam, Uinv)."""
    h = w = 64
    hx, hy = 500.0, 10.0
    L = bgr_to_lab_u8_np(_frame(h, w, seed))[..., 0]
    L = L.astype(np.float32)
    grid = sample_grid(h, w, 24, 22)
    p = grid.n_samples
    Um, lam, _ = ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, hx, hy, 1e-10)
    Um = torch.from_numpy(np.ascontiguousarray(Um))
    lam = torch.from_numpy(np.ascontiguousarray(lam))
    perm = torch.from_numpy(grid.perm)
    f = features((perm // w).float(), (perm % w).float(),
                 torch.from_numpy(L.reshape(-1)[grid.perm]))
    sw, pw = bandwidth_weights(hx, hy)
    ppad = -(-p // tsk.P_ALIGN) * tsk.P_ALIGN
    K = torch.nn.functional.pad(affinity_block(f[p:], f[:p], sw, pw),
                                (0, ppad - p))
    return K, Um, lam, Um / lam


def test_the_model_reads_the_kernels_segment():
    with open(CSRC) as fh:
        src = fh.read()
    seg = int(re.search(r"constexpr int HS_SEGMENT = (\d+);", src).group(1))
    assert seg == tsk.HS_SEGMENT


@pytest.mark.parametrize("seed", (9, 1, 2, 3))
def test_every_w_order_is_within_the_fp32_chain_bound(seed):
    """On the float64 loop's first STEPS half-steps (u rounded to fp32, u
    carrying 1/lambda up to 1e10): the one-build order at the kernel's
    HS_SEGMENT and at 32 samples, and the two-pass order, each within
    (2 Ppad + 4) u (K |u|) of w in float64 on every row."""
    K, Um, lam, Uinv = _operand(seed)
    assert float(lam.min()) < 2e-10
    K64 = K.double()
    p, ppad = Um.shape[0], K.shape[1]
    s = Um.sum(0) + Uinv.T @ K64.sum(0)[:p]
    for _ in range(STEPS):
        t = lam * s
        u = torch.nn.functional.pad(Uinv @ t, (0, ppad - p))
        u32 = u.float()
        w64 = K64 @ u32.double()
        bound = (2 * ppad + 4) * U * (K64.abs() @ u32.double().abs())
        for name, w in (("onebuild", onebuild_w(K, u32, tsk.HS_SEGMENT)),
                        ("segment32", onebuild_w(K, u32, 32)),
                        ("two_pass", two_pass_w(K, u32))):
            assert bool(((w.double() - w64).abs() <= bound).all()), name
        x = safe_reciprocal(w64, 1e-10)
        s = (Um.T @ safe_reciprocal(Um @ t, 1e-10)
             + Uinv.T @ (K64.T @ x)[:p])
