"""Where the streaming route's fp32 error comes from on a dense sampling
grid, on one NVIDIA GPU.

    python -m nle_tpu_torch.tools.stream_precision [--base-csrc DIR]
        [--seeds N [N ...]]

A frame is chip_smoke.py's [9c] frame (structured 2000x2000, seed 9; other
seeds with --seeds) with 48 44 500 10 50 50: p = 2112 samples, and a rank
cut at eigenvalues of 1e-10 (m = 1768 at seed 9), so the streaming route's
s carries 1/lambda up to 1e10. The streaming Sinkhorn loop runs once per
variant of its half-step and of its p-row projections (u = Uinv t, x_top
= 1 / (Um t), s = Um^T x_top + Uinv^T ap), and each run's balancing
vector c is held against the same loop in float64 (c64, on halfstep64:
the plain twins' entries, each built once a half-step); the dense f32
route's c (K1, then K4) is held too. Printed per variant: the median, 99th percentile and max over the rest pixels of
|c - c64| / c64, the signed mean of (c - c64) / c64, and seconds.
Variants:

- kernel: the package's loop (streaming_kernel.streaming_loop: float64
  projections) around the half-step at p = 2112 (K8's one-build kernel,
  serving K9), K10 for s0;
- kernel, f32 projections: the same kernels in nle_tpu's loop, every
  projection in fp32 (the JAX package's order);
- plain float64 half-steps with f32 projections, and with the package's
  float64 projections: half-steps with no rounding of their own, so the
  loop's c where no summation order inside a kernel could do better (how
  much of the loop's error the projections and the f32 stage-1 values
  carry);
- on the first frame only: plain f32 (the plain twins, cuBLAS sums, f32
  projections); kernel w + plain ap / plain w + kernel ap, one pass each
  (K11 and K10, f32 projections: which pass carries the two-pass
  kernel's error);
- one half-step alone, on the float64 loop's u at half-steps 1, 20 and
  100 (rounded to f32): x and ap against the float64 twin on the same u
  (median, 99th percentile and max of the relative error, and its signed
  mean over the rows: (x - x64) / x64 and (ap - ap64) / |ap64|);

each kernel variant once per kernel library: the package's own csrc and,
with --base-csrc, another checkout's with the same C interface (an A/B of
two kernel versions in one call), on every frame (the loop amplifies
rounding at lambda down to 1e-10, so one frame does not tell a kernel's
accuracy from chance).
Then, for each library in turn, twice (A, B, A, B), CUDA-event times of
the half-step, K10 and K11 (R = 1) on the first frame's operands (p =
2112) and at the 1 MP main path's sizes (1,011,200 rest pixels against
640 samples). Prints one JSON line last. Imports no JAX."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
PKG = os.path.dirname(HERE)
ROOT = os.path.dirname(PKG)
ARGS = (48, 44, 500.0, 10.0, 50, 50)
EPS = 1e-10
# Half-steps of the float64 loop (1 is the first after the s0 pass) whose
# input u the one-half-step table gives every library.
ONE_STEP = (1, 20, 100)


def build(csrc: str, out: str):
    """The kernel library built from csrc into out (ctypes handle)."""
    from nle_tpu_torch.ops.kernels import _build

    saved = (_build.CSRC_DIR, _build.BUILD_DIR, _build._lib)
    _build.CSRC_DIR, _build.BUILD_DIR, _build._lib = csrc, out, None
    try:
        return _build.load()
    finally:
        _build.CSRC_DIR, _build.BUILD_DIR, _build._lib = saved


def use(lib) -> None:
    from nle_tpu_torch.ops.kernels import _build

    _build._lib = lib


def frame_operands(torch, dev, seed: int):
    """The frame of this seed: f32 operands as train_filter builds them,
    and their float64 twins (stage 1 straight from the host eigensystem)."""
    from types import SimpleNamespace

    sys.path.insert(0, ROOT)
    from chip_smoke import structured_frame

    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.affinity import bandwidth_weights, features
    from nle_tpu_torch.ops.kernels.streaming_kernel import pad_stream_operands
    from nle_tpu_torch.ops.pipeline import (
        _unpack_stage1,
        bucket_m,
        ka_eigh_host64,
        pack_stage1,
    )
    from nle_tpu_torch.ops.sampling import sample_grid

    img = structured_frame(2000, 2000, seed=seed)
    L = bgr_to_lab_u8_np(img)[..., 0].astype(np.float32)
    h, w = L.shape
    rows_s, cols_s, hx, hy = ARGS[:4]
    grid = sample_grid(h, w, rows_s, cols_s)
    p, n = grid.n_samples, grid.n_pixels
    Um64, lam64, _ = ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, hx, hy, EPS)
    m = lam64.shape[0]
    mb = bucket_m(m, p)
    Um, lam, Uinv = _unpack_stage1(
        torch.from_numpy(pack_stage1(Um64, lam64, mb=mb)).to(dev), p)
    perm = torch.from_numpy(grid.perm).to(dev)
    y = torch.from_numpy(L.reshape(-1)[grid.perm]).to(dev)
    f = features((perm // w).float(), (perm % w).float(), y)
    sw, pw = bandwidth_weights(hx, hy)
    fa_rows, fb_cols, mask = pad_stream_operands(f[:p], f[p:])
    f64 = torch.float64
    Um64_t = torch.from_numpy(np.ascontiguousarray(Um64)).to(dev)
    lam64_t = torch.from_numpy(np.ascontiguousarray(lam64)).to(dev)
    return SimpleNamespace(
        L=L, w=w, grid=grid, p=p, n=n, q=n - p, m=m, mb=mb, sw=sw, pw=pw, y=y,
        perm=perm, Um=Um, lam=lam, Uinv=Uinv, fa_rows=fa_rows,
        fb_cols=fb_cols, mask=mask,
        Um64=Um64_t, lam64=lam64_t, Uinv64=Um64_t / lam64_t[None],
        fa64=fa_rows.to(f64), fb64=fb_cols.to(f64), mask64=mask.to(f64))


def affinity64_rows(torch, fa_rows, fb_cols, lo: int, hi: int, sw, pw):
    """(hi - lo, Ppad) float64 affinity of pixels lo..hi against every
    sample: bitwise streaming_kernel._affinity_rows on float64 operands
    whose features are integers, in fewer passes over the block. The
    squared distances come exact from two small matmuls (products and sums
    of integers below 2^53 are exact in any order); then the plain
    version's roundings: sw and pw scale them, the two add, the exp
    follows (negating is exact)."""
    b, a = fb_cols[:, lo:hi], fa_rows
    one_b, one_a = b.new_ones(b.shape[1]), a.new_ones(a.shape[1])
    # (rb - ra)^2 + (cb - ca)^2 and (yb - ya)^2, expanded.
    d2s = torch.stack([b[0], b[1], b[0] * b[0] + b[1] * b[1], one_b], 1) @ \
        torch.stack([-2 * a[0], -2 * a[1], one_a, a[0] * a[0] + a[1] * a[1]])
    dy2 = torch.stack([b[2], b[2] * b[2], one_b], 1) @ \
        torch.stack([-2 * a[2], one_a, a[2] * a[2]])
    return d2s.mul_(-sw).add_(dy2.mul_(-pw)).exp_()


def halfstep64(torch, fa_rows, fb_cols, mask, sw, pw, eps):
    """The streaming half-step in float64 on integer features (3, Ppad),
    (3, Qpad) and mask (1, Qpad), one sweep of row chunks, each entry
    built once (affinity64_rows): returns u (Ppad,) -> (x (Qpad,), ap
    (Ppad,)), x = mask * safe_recip(K u, eps) and ap = K^T x; u None gives
    the s0 pass (x = mask). A float64 twin of the kernels' half-step at a
    fraction of the plain version's passes over device memory."""
    from nle_tpu_torch.ops.linalg import safe_reciprocal

    for f in (fa_rows, fb_cols):
        if f.dtype != torch.float64 or not torch.equal(f, f.round()):
            raise ValueError("halfstep64 takes integer float64 features")
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    step = 8192

    def run(u):
        x = mask[0].clone() if u is None else fb_cols.new_empty(qpad)
        ap = fa_rows.new_zeros(ppad)
        for lo in range(0, qpad, step):
            hi = min(lo + step, qpad)
            A = affinity64_rows(torch, fa_rows, fb_cols, lo, hi, sw, pw)
            if u is not None:
                x[lo:hi] = safe_reciprocal(A @ u, eps) * mask[0, lo:hi]
            ap += x[lo:hi] @ A
        return x, ap

    return run


def sinkhorn_loop(torch, halfstep, s0_ap, Um, lam, Uinv, q, ppad, iters,
                  eps=EPS):
    """nle_tpu's streaming Sinkhorn loop, every projection in the operands'
    dtype, with a given half-step (u_pad -> (x_rest, ap)) and s0 pass (->
    ap); returns (r_top (p,), c (N,)) in packed order. On float64 operands
    it is the float64 twin's loop."""
    from nle_tpu_torch.ops.linalg import safe_reciprocal

    p = Um.shape[0]

    def half(t):
        u = torch.nn.functional.pad(Uinv @ t, (0, ppad - p)).contiguous()
        x_top = safe_reciprocal(Um @ t, eps)
        x_rest, ap = halfstep(u)
        return x_top, x_rest, Um.T @ x_top + Uinv.T @ ap[:p]

    s = Um.sum(dim=0) + Uinv.T @ s0_ap()[:p]
    for _ in range(iters):
        c_top, c_rest, s = half(lam * s)
        r_top, _, s = half(lam * s)
    return r_top, torch.cat([c_top, c_rest[:q]])


def tapped(halfstep, taps: dict):
    """halfstep, recording into taps its input u rounded to f32 at each
    ONE_STEP half-step (1 is the first after the s0 pass): the inputs of
    the one-half-step table."""
    count = [0]

    def half(u):
        count[0] += 1
        if count[0] in ONE_STEP:
            taps[count[0]] = u.float().contiguous()
        return halfstep(u)

    return half


def streaming_edit_f64(torch, L: np.ndarray, grid, args, weights, device,
                       eps: float = EPS, taps=None):
    """The float64 plain twin of train_filter(streaming=True)'s first
    edit: the same streaming Sinkhorn loop (on halfstep64), Sb gram, host
    chain and V = [V_head; c K W] on the plain PyTorch twins, every step in
    float64 (stage 1 straight from the host eigensystem, no f32 packing):
    what the streaming route computes with its fp32 rounding taken away.
    L (H, W) float channel of integer values, args (rows, cols, hx, hy,
    iters, k); taps: as tapped's. Returns (the packed u8 edit, c (N,)
    float64)."""
    from nle_tpu_torch.ops.affinity import bandwidth_weights
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        pad_stream_operands,
        streaming_atb_plain,
        streaming_scaled_gram_plain,
    )
    from nle_tpu_torch.ops.pipeline import (
        _apply_u8_body,
        _masked_top,
        host_orthogonalize,
        ka_eigh_host64,
    )
    from nle_tpu_torch.ops.transform import transform_eigenvalues

    f64 = torch.float64
    _, _, hx, hy, iters, k = args
    p, n, w = grid.n_samples, grid.n_pixels, L.shape[1]
    q = n - p
    Um64, lam64, _ = ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, hx, hy, eps)
    m = lam64.shape[0]
    k = min(k, m)
    Um = torch.from_numpy(np.ascontiguousarray(Um64)).to(device)
    lam = torch.from_numpy(np.ascontiguousarray(lam64)).to(device)
    Uinv = Um / lam[None]
    perm = torch.from_numpy(grid.perm).to(device)
    y = torch.from_numpy(np.asarray(L, np.float64).reshape(-1)[grid.perm]).to(
        device)
    f = torch.stack([(perm // w).to(f64), (perm % w).to(f64), y], dim=-1)
    sw, pw = bandwidth_weights(hx, hy)
    fa_rows, fb_cols, mask = pad_stream_operands(f[:p], f[p:])
    mask = mask.to(f64)
    ppad = fa_rows.shape[1]
    half = halfstep64(torch, fa_rows, fb_cols, mask, sw, pw, eps)
    r_top, c = sinkhorn_loop(torch, tapped(half, {} if taps is None else
                                           taps),
                             lambda: half(None)[1], Um, lam, Uinv, q, ppad,
                             iters, eps)
    cu = _masked_top(c, Um, p, m)
    uinv_pad = torch.nn.functional.pad(Uinv, (0, 0, 0, ppad - p))
    c_row = torch.nn.functional.pad(c[p:], (0, fb_cols.shape[1] - q))[None]
    Sb = cu.T @ cu + streaming_scaled_gram_plain(fa_rows, fb_cols, c_row,
                                                 uinv_pad, sw, pw)
    rc = torch.stack([r_top[:m], c[:m]]).cpu().numpy()
    va, Sq = host_orthogonalize(rc, Sb.cpu().numpy(), Um64, lam64, m, m, k,
                                eps)
    kk = va.shape[1] // 2
    va = torch.from_numpy(va).to(device)
    V_head = cu @ va[:, kk:]
    V_head[:m] += va[:, :kk]
    W = torch.nn.functional.pad(Uinv @ va[:, kk:], (0, 0, 0, ppad - p))
    tail = streaming_atb_plain(fa_rows, fb_cols, W.T.contiguous(), sw,
                               pw)[:, :q].T
    V = torch.cat([V_head, c[p:, None] * tail])
    fs = transform_eigenvalues(torch.from_numpy(Sq).to(device), weights)
    return _apply_u8_body(V, fs, y), c


def frame_precision(torch, dev, libs: dict, seed: int, full: bool):
    """One frame's table (see the module docstring); full adds the plain
    f32 and one-pass variants. Returns (the frame's rows, its f32
    operands)."""
    from nle_tpu_torch.ops.kernels import streaming_kernel as stk
    from nle_tpu_torch.ops.linalg import safe_reciprocal
    from nle_tpu_torch.ops.pipeline import train_filter_stage2a

    op = frame_operands(torch, dev, seed)
    p, q, iters = op.p, op.q, ARGS[4]
    ppad = op.fa_rows.shape[1]
    sw, pw = op.sw, op.pw
    print(f"seed {seed}: p={p} m={op.m} mb={op.mb} q={q} Ppad={ppad}; lam "
          f"min {float(op.lam64.min()):.3e}")
    result = {"p": p, "m": op.m, "q": q, "ppad": ppad}
    fa, fb, mask = op.fa_rows, op.fb_cols, op.mask
    fa64, fb64, mask64 = op.fa64, op.fb64, op.mask64

    def run(halfstep, s0_ap, dtype=torch.float32):
        """nle_tpu's loop (projections in dtype) around the half-step."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if dtype == torch.float64:
            _, c = sinkhorn_loop(torch, halfstep, s0_ap, op.Um64, op.lam64,
                                 op.Uinv64, q, ppad, iters)
        else:
            _, c = sinkhorn_loop(torch, halfstep, s0_ap, op.Um, op.lam,
                                 op.Uinv, q, ppad, iters)
        torch.cuda.synchronize()
        return c[p:], time.perf_counter() - t0

    def run_package(halfstep, s0_ap):
        """The package's loop (streaming_loop: float64 projections on the
        f32 stage-1 values); the half-step's x and ap rounded to f32."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, c_rest = stk.streaming_loop(
            lambda u: tuple(v.float() for v in halfstep(u)),
            s0_ap().float(), op.Um, op.lam, ppad, iters, EPS)
        torch.cuda.synchronize()
        return c_rest[:q], time.perf_counter() - t0

    half64 = halfstep64(torch, fa64, fb64, mask64, sw, pw, EPS)
    taps = {}
    c64, secs = run(tapped(half64, taps), lambda: half64(None)[1],
                    torch.float64)
    print(f"float64 plain twin: {secs:.1f} s")

    def stats(label, c, secs):
        rel = ((c.double() - c64) / c64).abs()
        qs = torch.quantile(rel.float(), torch.tensor(
            [0.5, 0.99], device=rel.device)).tolist()
        mean = float(((c.double() - c64) / c64).mean())
        row = {"median": qs[0], "p99": qs[1], "max": float(rel.max()),
               "mean": mean, "seconds": secs}
        result[label] = row
        print(f"{label:40s} vs float64: median {qs[0]:.3e} p99 {qs[1]:.3e} "
              f"max {row['max']:.3e} mean {mean:+.3e} ({secs:.1f} s)",
              flush=True)

    def kernel_halfstep(u):
        return stk.streaming_halfstep(fa, fb, mask, u, sw, pw, EPS)

    kernel_s0 = lambda: stk.streaming_ap(fa, fb, mask, sw, pw)[0]  # noqa: E731
    # Dense f32 route (K1 then K4): its c over the rest rows.
    rr = (op.perm // op.w).float()
    cc = (op.perm % op.w).float()
    stage1 = torch.cat([op.Um, op.lam[None]])
    _, _, phi, c_rest = train_filter_stage2a(
        op.y, rr, cc, stage1, sw, pw, p=p, m=op.m, mb=op.mb,
        n_sinkhorn_iter=iters, eps=EPS, split=False, int16=False)
    c_dense = c_rest[p:op.n, 0].clone()
    del phi, c_rest
    torch.cuda.empty_cache()
    stats("dense f32 (K1, K4)", c_dense, float("nan"))
    del c_dense
    if full:
        def plain_w(u):
            return safe_reciprocal(
                stk.streaming_atb_plain(fa, fb, u, sw, pw)[0], EPS) * mask[0]

        def kernel_w(u):
            return safe_reciprocal(
                stk.streaming_atb(fa, fb, u, sw, pw)[0], EPS) * mask[0]

        def plain_ap(x):
            return stk.streaming_ap_plain(fa, fb, x[None], sw, pw)[0]

        def kernel_ap(x):
            return stk.streaming_ap(fa, fb, x[None].contiguous(), sw, pw)[0]

        plain_s0 = lambda: stk.streaming_ap_plain(fa, fb, mask, sw, pw)[0]  # noqa: E731
        stats("plain f32", *run(lambda u: stk.streaming_halfstep_ptiled_plain(
            fa, fb, mask, u, sw, pw, EPS), plain_s0))

    # Half-steps without their fp32 rounding (x and ap in float64, rounded
    # once to f32): where any summation order inside the kernel could at
    # best bring the loop's c.
    def plain64(u):
        return half64(u.double())

    s0_64 = lambda: half64(None)[1]  # noqa: E731
    stats("plain float64 half-steps, f32 projections",
          *run(lambda u: tuple(v.float() for v in plain64(u)),
               lambda: s0_64().float()))
    stats("plain float64 half-steps, package loop",
          *run_package(plain64, s0_64))
    for name, lib in libs.items():
        use(lib)
        stats(f"kernel [{name}]", *run_package(kernel_halfstep, kernel_s0))
        stats(f"kernel [{name}], f32 projections",
              *run(kernel_halfstep, kernel_s0))
        if full:
            stats(f"kernel w + plain ap [{name}]", *run(
                lambda u: (lambda x: (x, plain_ap(x)))(kernel_w(u)),
                plain_s0))
            stats(f"plain w + kernel ap [{name}]", *run(
                lambda u: (lambda x: (x, kernel_ap(x)))(plain_w(u)),
                kernel_s0))
    # One half-step on the same f32 u (the float64 loop's inputs at the
    # ONE_STEP-th half-steps) against the float64 twin on that u: each
    # library's own rounding of x and ap, apart from the loop.
    result["one_step"] = {}
    for k, u32 in sorted(taps.items()):
        x64, ap64 = half64(u32.double())
        for name, lib in libs.items():
            use(lib)
            x, ap = kernel_halfstep(u32)
            row = {}
            for what, got, want in (("x", x[:q], x64[:q]),
                                    ("ap", ap[:p], ap64[:p])):
                live = want != 0
                signed = (got.double()[live] - want[live]) / want[live].abs()
                rel = signed.abs()
                qs = torch.quantile(rel.float(), torch.tensor(
                    [0.5, 0.99], device=rel.device)).tolist()
                row[what] = {"median": qs[0], "p99": qs[1],
                             "max": float(rel.max()),
                             "mean": float(signed.mean())}
            result["one_step"].setdefault(f"half-step {k}", {})[name] = row
            print(f"one half-step {k:3d} [{name}] vs float64: x median "
                  f"{row['x']['median']:.3e} p99 {row['x']['p99']:.3e} max "
                  f"{row['x']['max']:.3e} mean {row['x']['mean']:+.3e}; ap "
                  f"median {row['ap']['median']:.3e} p99 "
                  f"{row['ap']['p99']:.3e} max {row['ap']['max']:.3e} mean "
                  f"{row['ap']['mean']:+.3e}", flush=True)
        del x64, ap64
    use(libs["this"])
    op.fa64 = op.fb64 = op.mask64 = None
    torch.cuda.empty_cache()
    return result, op


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--base-csrc", default=None,
                        help="csrc of another checkout to A/B against")
    parser.add_argument("--seeds", type=int, nargs="+", default=[9],
                        help="structured_frame seeds of the frames")
    opts = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("stream_precision: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    import nle_tpu_torch  # noqa: F401  (pins fp32 precision)
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.ops.kernels import streaming_kernel as stk

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    out_dir = os.path.join(PKG, "_build", "stream_precision")
    os.makedirs(out_dir, exist_ok=True)
    libs = {"this": build(os.path.join(PKG, "csrc"),
                          os.path.join(out_dir, "this"))}
    if opts.base_csrc:
        libs["base"] = build(opts.base_csrc, os.path.join(out_dir, "base"))
    use(libs["this"])

    result = {"card": card, "frames": {}}
    op = None
    for k, seed in enumerate(opts.seeds):
        rows, frame = frame_precision(torch, dev, libs, seed, full=k == 0)
        result["frames"][f"seed {seed}"] = rows
        if op is None:
            op = frame
    # Per library: the kernel loop's median over the frames.
    for name in libs:
        for label in (f"kernel [{name}]", f"kernel [{name}], f32 projections"):
            medians = [f"{r[label]['median']:.3e}"
                       for r in result["frames"].values()]
            print(f"{label} median by frame: {', '.join(medians)}")

    fa, fb, mask, p = op.fa_rows, op.fb_cols, op.mask, op.p
    ppad, sw, pw = fa.shape[1], op.sw, op.pw

    def ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / reps

    # Times on the first frame's operands (p = 2112) and at the 1 MP main
    # path's sizes: its first 1,011,200 rest pixels against 640 of its
    # samples (the entry count, not the data, sets these kernels' time).
    x1 = torch.rand((1, fb.shape[1]), device=dev) * mask
    b1 = torch.zeros((1, ppad), device=dev)
    b1[0, :p] = torch.rand(p, device=dev) * 1e-3
    qs1, p1 = 1011200, 640
    fa1 = fa[:, :p1].contiguous()
    fb1 = fb[:, :qs1].contiguous()
    x1s = x1[:, :qs1].contiguous()
    b1s = b1[:, :p1].contiguous()
    mask1 = mask[:, :qs1].contiguous()
    u1 = b1[0, :p1].contiguous()
    times = {}
    for rep in range(2):   # A, B, A, B
        for name, lib in libs.items():
            use(lib)
            row = times.setdefault(name, {})
            for key, fn in (
                    ("K10 R=1 p=2112", lambda: stk.streaming_ap(fa, fb, x1, sw, pw)),
                    ("K11 R=1 p=2112", lambda: stk.streaming_atb(fa, fb, b1, sw, pw)),
                    ("K9 p=2112", lambda: stk.streaming_halfstep(
                        fa, fb, mask, b1[0].contiguous(), sw, pw, EPS)),
                    ("K8 1MP", lambda: stk.streaming_halfstep(
                        fa1, fb1, mask1, u1, sw, pw, EPS)),
                    ("K10 R=1 1MP", lambda: stk.streaming_ap(fa1, fb1, x1s, sw, pw)),
                    ("K11 R=1 1MP", lambda: stk.streaming_atb(fa1, fb1, b1s, sw, pw))):
                row.setdefault(key, []).append(ms(fn))
    use(libs["this"])
    for name, row in times.items():
        for key, vals in row.items():
            print(f"[{name}] {key}: " + ", ".join(f"{v:.3f}" for v in vals)
                  + " ms")
    result["ms"] = times
    _build.reset_launches()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
