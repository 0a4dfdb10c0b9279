#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from nle_tpu_torch/csrc and prints the build
   time and ptxas' register/spill lines;
3. checks each kernel against its plain PyTorch version on the card at the
   1 MP main path's shapes (real data: the rock2-parameter frame below)
   and times both with CUDA events;
4. runs a small frame on device="cuda" and device="cpu" (>= 45 dB between
   them) and twice on the card (bitwise equal), and edits on the card with
   the filter the CPU trained;
5. drives the main path: NLEFilter(device="cuda").train_and_enhance on a
   structured 832x1216 frame with the rock2 parameters 20 30 500 10 50 50
   (p = 600, 50 Sinkhorn iterations, k = 50), weights [4, 3, 4, 1], cold
   then warm. The launch counts of the cold run alone prove which kernels
   the path went through (K1, K3 >= 2 x 50, K6, K7). Then one
   uniform-noise frame, whose int16 carrier guard trips, drives the f32
   fallback; its own counts (guard_launches) prove K4 ran;
6. profiles one more warm 1 MP call (torch.profiler): wall, device time and
   busy share, host time per pipeline stage, and the device time per kernel.

Any failure raises and the exit code is nonzero. The last two lines are
the per-kernel JSON and {"ok": true, "device": {...}}. Imports no JAX.
Frames are made with numpy from fixed seeds; no file is read.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

MAIN_SHAPE = (832, 1216)
MAIN_ARGS = (20, 30, 500.0, 10.0, 50, 50)   # rows, cols, hx, hy, iters, k
WEIGHTS = [4, 3, 4, 1]
U = 2.0 ** -24                                # fp32 unit roundoff
# Tolerance of K6's Sb, a sum over N ~ 1 M rows, relative to the sum of
# absolute terms. The kernel sums rows in fixed chunks and then the chunks in
# order; plain cuBLAS blocks differently. Rounding puts both within ~1e-5 of
# the exact sum; a dropped row tile or wrong index is O(1e-3) or more.
GRAM_SUM_TOL = 2.5e-4
# Tolerance of s = Q^T x (K3/K4), relative to |Q|^T |x|. The kernel sums each
# column over a 1024-row block, then ~1000 block partials in order; cuBLAS
# blocks differently. Rounding of such sums grows like sqrt(terms) u: a few
# 1e-6 at most here. A dropped 32-row tile moves s by ~3e-5 of the sum.
S_SUM_TOL = 1e-5
GUARD_ITERS = 10                              # Sinkhorn iterations, noise frame


def structured_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """A smooth, photo-like BGR frame: low-frequency shading, a few soft
    discs and mild texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    base = 110 + 50 * np.sin(xx / (w / 5.0)) * np.cos(yy / (h / 3.0))
    for _ in range(6):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        rad = rng.uniform(0.05, 0.2) * min(h, w)
        base += rng.uniform(-40, 40) / (
            1 + np.exp(((yy - cy) ** 2 + (xx - cx) ** 2) ** 0.5 / 8 - rad / 8))
    base += rng.normal(0, 2.0, (h, w))
    img = np.stack([base * 0.9 + 10, base, base * 1.05 - 5], axis=-1)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def noise_frame(h: int = 120, w: int = 120, seed: int = 0) -> np.ndarray:
    """Uniform gray noise: the int16 carrier's documented failure domain
    at small hx, so its guard retrains through the f32 layout (K4)."""
    v = np.random.default_rng(seed).uniform(0, 255, (h, w))
    return np.repeat(np.rint(v).astype(np.uint8)[..., None], 3, axis=-1)


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def cuda_ms(torch, fn, reps: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def check(name: str, diff, bound) -> float:
    """Assert |diff| <= bound elementwise; returns max |diff|."""
    ratio = float((diff.abs() / bound.clamp(min=1e-30)).max())
    worst = float(diff.abs().max())
    print(f"  {name}: max_abs_err {worst:.3e}, max err/bound {ratio:.3e}")
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: error exceeds its bound ({ratio})")
    return worst


# Host-side stages of one train_and_enhance call (utils.logging.stage
# names, each a torch.profiler range).
STAGES = ("BGR to Lab", "Computing kernel", "Nystrom approximation + Sinkhorn",
          "Orthogonalize", "Stage 2b", "Fetch edit", "Lab to BGR")


def profile_main(torch, NLEFilter, img, mp: float) -> None:
    """Profile one warm 1 MP call: wall, device time (the sum of the
    device-side events; one stream, so they do not overlap), busy share,
    host ms per stage and the device ms per kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        NLEFilter(device="cuda").train_and_enhance(img, *MAIN_ARGS,
                                                   weights=WEIGHTS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    cpu_type = torch.autograd.DeviceType.CPU

    def dev_ms(e):
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        return us / 1e3

    # A stage that queued device work also shows as a device-side range of
    # the same name (its span on the device timeline): the host ranges are
    # the CPU entries, the device time the device entries that are not
    # stage ranges.
    stages = {e.key: e.cpu_time_total / 1e3 for e in avgs
              if e.key in STAGES and e.device_type == cpu_type}
    kernels = sorted(((dev_ms(e), e.count, e.key) for e in avgs
                      if e.device_type != cpu_type and e.key not in STAGES
                      and dev_ms(e) > 0), reverse=True)
    device_ms = sum(k[0] for k in kernels)
    print(f"[6] profiled warm 1 MP call: wall {wall_ms:.1f} ms "
          f"({mp / wall_ms * 1e3:.3f} MP/s under the profiler)")
    if device_ms > 0:
        print(f"  device time {device_ms:.1f} ms, busy share "
              f"{device_ms / wall_ms:.3f}")
    else:
        print("  device time not measured (the profiler saw no device events)")
    for name in STAGES:
        print(f"  stage {name!r}: {stages.get(name, 0.0):.1f} ms (host)")
    print(f"  outside the stages: {wall_ms - sum(stages.values()):.1f} ms")
    for ms, count, key in kernels[:10]:
        print(f"  device {ms:9.3f} ms  x{count:<4d} {key[:70]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 2
    import nle_tpu_torch  # noqa: F401  (pins fp32 precision)
    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.affinity import bandwidth_weights, features
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.ops.kernels.affinity_kernel import (
        affinity_matmul_kernel,
        affinity_matmul_plain,
    )
    from nle_tpu_torch.ops.kernels.scaled_matmul_kernel import (
        scaled_gram,
        scaled_gram_plain,
        scaled_matmul,
        scaled_matmul_plain,
    )
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        carrier_crush_frac,
        padded_shape,
        quantize_int16,
        sinkhorn_halfstep,
        sinkhorn_halfstep_plain,
        split_row_pad,
    )
    from nle_tpu_torch.ops.pipeline import (
        _unpack_stage1,
        bucket_m,
        ka_eigh_host64,
        pack_stage1,
    )
    from nle_tpu_torch.ops.sampling import sample_grid

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f"[1] card: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    print(card)

    t0 = time.perf_counter()
    _build.load()
    print(f"[2] kernels built from nle_tpu_torch/csrc in "
          f"{time.perf_counter() - t0:.2f} s "
          f"(nvcc alone: {_build.build_seconds} s)")
    for line in (_build.build_log or "").splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("  ptxas:", line.strip())

    # -- [3] each kernel against its plain version at main-path shapes ----
    h, w = MAIN_SHAPE
    rows_s, cols_s, hx, hy, iters, kvec = MAIN_ARGS
    img = structured_frame(h, w)
    L = bgr_to_lab_u8_np(img)[..., 0].astype(np.float32)
    grid = sample_grid(h, w, rows_s, cols_s)
    p, n = grid.n_samples, grid.n_pixels
    Um64, lam64, _ = ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, hx, hy, 1e-10)
    m = lam64.shape[0]
    mb = bucket_m(m, p)
    mpad = -(-mb // 128) * 128
    stage1 = torch.from_numpy(pack_stage1(Um64, lam64, mb=mb)).to(dev)
    Um, lam, Uinv = _unpack_stage1(stage1, p)
    perm = torch.from_numpy(grid.perm).to(dev)
    y = torch.from_numpy(L.reshape(-1)[grid.perm]).to(dev)
    f = features((perm // w).float(), (perm % w).float(), y)
    fa, fb = f[:p], f[p:]
    sw, pw = bandwidth_weights(hx, hy)
    nb = n - p
    npad_b = split_row_pad(nb)
    print(f"[3] kernels vs plain at the main path: n={n}, p={p}, m={m}, "
          f"mb={mb}, npad_b={npad_b}, mpad={mpad}")
    rows = []

    def record(name, src, repl, err, ms, plain_ms):
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        rows.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         max_abs_err=err, ms=ms, plain_ms=plain_ms))

    eps = 1e-10
    phib = affinity_matmul_kernel(fa, fb, Uinv, sw, pw, out_rows=npad_b)
    want = affinity_matmul_plain(fa, fb, Uinv, sw, pw, out_rows=npad_b)
    absb = affinity_matmul_plain(fa, fb, Uinv.abs(), sw, pw, out_rows=npad_b)
    torch.cuda.synchronize()
    if bool((phib[nb:] != 0).any()):
        raise AssertionError("K1: out_rows tail is not exact zero")
    # |a - b| <= (2p + 4) u (|K| |B|): fp32 p-term contraction, both sides,
    # plus expf's few-ulp error.
    err = check("K1 affinity_matmul", phib - want,
                (2 * p + 4) * U * absb + 1e-30)
    del want, absb
    record("affinity_matmul", "nle_tpu_torch/csrc/affinity.cu",
           "nle_tpu/ops/pallas/affinity_kernel.py:113", err,
           cuda_ms(torch, lambda: affinity_matmul_kernel(
               fa, fb, Uinv, sw, pw, out_rows=npad_b)),
           cuda_ms(torch, lambda: affinity_matmul_plain(
               fa, fb, Uinv, sw, pw, out_rows=npad_b)))

    Um_pad = torch.nn.functional.pad(Um, (0, mpad - mb))
    lam_pad = torch.nn.functional.pad(lam, (0, mpad - mb))
    q16, scale, _ = quantize_int16(phib)
    crush = float(carrier_crush_frac(phib, scale))
    print(f"  int16 carrier crush statistic at 1 MP: {crush:.4f} "
          f"(guard trips above 0.2: {'yes' if crush > 0.2 else 'no'})")
    s0 = Um_pad.T @ torch.ones(p, device=dev) + phib.sum(dim=0)
    tq = (scale * (lam_pad * s0)).contiguous()

    def halfstep_check(label, Q, t):
        xk, sk = sinkhorn_halfstep(Q, t, eps)
        xp, sp = sinkhorn_halfstep_plain(Q, t, eps)
        Qa = Q.float().abs()
        # x = 1/w: |dx| ~ |dw| x^2 with |dw| <= (2 mpad + 4) u (|Q| |t|);
        # x2 for the two sides.
        bx = 2 * (2 * mpad + 4) * U * (Qa @ t.abs()) * xp * xp + 1e-30
        ex = check(f"{label} x", xk - xp, bx)
        es = check(f"{label} s", sk - sp, S_SUM_TOL * (Qa.T @ xp.abs()) + 1e-30)
        return xk, max(ex, es)

    xk, err = halfstep_check("K3 sinkhorn int16", q16, tq)
    record("sinkhorn_halfstep_int16", "nle_tpu_torch/csrc/sinkhorn.cu",
           "nle_tpu/ops/pallas/sinkhorn_kernel.py:121", err,
           cuda_ms(torch, lambda: sinkhorn_halfstep(q16, tq, eps), reps=10),
           cuda_ms(torch, lambda: sinkhorn_halfstep_plain(q16, tq, eps)))
    del q16

    npad, _ = padded_shape(n, mb)
    phi = torch.zeros((npad, mpad), device=dev)
    phi[:p] = Um_pad
    phi[p:n] = phib[:nb]
    t32 = (lam_pad * (phi.T @ torch.ones(npad, device=dev))).contiguous()
    _, err = halfstep_check("K4 sinkhorn f32", phi, t32)
    record("sinkhorn_halfstep_f32", "nle_tpu_torch/csrc/sinkhorn.cu",
           "nle_tpu/ops/pallas/sinkhorn_kernel.py:121", err,
           cuda_ms(torch, lambda: sinkhorn_halfstep(phi, t32, eps), reps=10),
           cuda_ms(torch, lambda: sinkhorn_halfstep_plain(phi, t32, eps)))
    del phi

    c = xk[:, None].contiguous()          # a real balancing vector
    gk = scaled_gram(phib, c)
    gp = scaled_gram_plain(phib, c)
    err = check("K6 scaled_gram", gk - gp,
                GRAM_SUM_TOL * scaled_gram_plain(phib.abs(), c.abs()) + 1e-30)
    record("scaled_gram", "nle_tpu_torch/csrc/scaled_matmul.cu",
           "nle_tpu/ops/pallas/scaled_matmul_kernel.py:56", err,
           cuda_ms(torch, lambda: scaled_gram(phib, c)),
           cuda_ms(torch, lambda: scaled_gram_plain(phib, c)))

    rng = np.random.default_rng(3)
    B = np.zeros((mpad, 128), np.float32)
    B[:mb, :kvec] = rng.standard_normal((mb, kvec)) * 1e-3
    B = torch.from_numpy(B).to(dev)
    vk = scaled_matmul(phib, c, B)
    vp = scaled_matmul_plain(phib, c, B)
    err = check("K7 scaled_matmul", vk - vp,
                (2 * mpad + 4) * U * scaled_matmul_plain(
                    phib.abs(), c.abs(), B.abs()) + 1e-30)
    record("scaled_matmul", "nle_tpu_torch/csrc/scaled_matmul.cu",
           "nle_tpu/ops/pallas/scaled_matmul_kernel.py:111", err,
           cuda_ms(torch, lambda: scaled_matmul(phib, c, B)),
           cuda_ms(torch, lambda: scaled_matmul_plain(phib, c, B)))
    del phib, gk, gp, vk, vp, c, xk
    torch.cuda.empty_cache()

    # -- [4] small frame: card against CPU, and repeatability ------------
    small = structured_frame(128, 192, seed=5)
    sargs = (10, 10, 100.0, 30.0, 10, 10)
    g1 = NLEFilter(device="cuda").train_and_enhance(small, *sargs,
                                                    weights=WEIGHTS)
    g2 = NLEFilter(device="cuda").train_and_enhance(small, *sargs,
                                                    weights=WEIGHTS)
    cpu_filter = NLEFilter(device="cpu")
    cpu = cpu_filter.train_and_enhance(small, *sargs, weights=WEIGHTS)
    db = psnr(g1, cpu)
    print(f"[4] small frame 128x192: cuda vs cpu {db:.2f} dB, two cuda runs "
          f"bitwise equal: {bool(np.array_equal(g1, g2))}")
    if not db >= 45.0:
        raise AssertionError(f"small frame cuda vs cpu {db:.2f} dB < 45")
    if not np.array_equal(g1, g2):
        raise AssertionError("small frame: two cuda runs differ")
    # A filter trained on the CPU, handed to a cuda NLEFilter, edits on the
    # card: the same V and f(S), the apply in another summation order.
    moved = NLEFilter(cpu_filter.trained, device="cuda")
    if moved.trained.eigvecs.device.type != "cuda":
        raise AssertionError("a CPU filter given to NLEFilter(cuda) stayed "
                             "on the CPU")
    db = psnr(moved.enhance(small, WEIGHTS), cpu_filter.enhance(small, WEIGHTS))
    print(f"  CPU-trained filter edited on the card vs on the CPU: {db:.2f} dB")
    if not db >= 45.0:
        raise AssertionError(f"moved filter edit {db:.2f} dB < 45")

    # -- [5] the main path ------------------------------------------------
    mp = n / 1e6
    _build.reset_launches()
    t0 = time.perf_counter()
    cold = NLEFilter(device="cuda").train_and_enhance(img, *MAIN_ARGS,
                                                      weights=WEIGHTS)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    main_counts = dict(_build.LAUNCHES)
    print(f"[5] 1 MP train_and_enhance ({h}x{w}, {' '.join(map(str, MAIN_ARGS))})"
          f" cold {cold_s:.3f} s; launches {main_counts}; guard tripped: "
          f"{'yes' if main_counts['sinkhorn_halfstep_f32'] else 'no'}")
    if main_counts["sinkhorn_halfstep_int16"] < 2 * iters:
        raise AssertionError(
            f"K3 ran {main_counts['sinkhorn_halfstep_int16']} times at 1 MP")
    for name in ("affinity_matmul", "scaled_gram", "scaled_matmul"):
        if main_counts[name] < 1:
            raise AssertionError(f"{name} never launched on the 1 MP path")
    t0 = time.perf_counter()
    warm = NLEFilter(device="cuda").train_and_enhance(img, *MAIN_ARGS,
                                                      weights=WEIGHTS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    print(f"  warm {warm_s:.3f} s = {mp / warm_s:.3f} MP/s; cold == warm "
          f"bitwise: {bool(np.array_equal(cold, warm))}; "
          f"PSNR(output, input) {psnr(warm, img):.2f} dB")
    if cold.shape != img.shape or cold.dtype != np.uint8:
        raise AssertionError(f"output {cold.shape} {cold.dtype}")
    if not np.array_equal(cold, warm):
        raise AssertionError("1 MP: cold and warm runs differ")

    _build.reset_launches()
    guard = NLEFilter(device="cuda").train_and_enhance(
        noise_frame(), 10, 10, 5.0, 30.0, GUARD_ITERS, 5, weights=WEIGHTS)
    torch.cuda.synchronize()
    guard_counts = dict(_build.LAUNCHES)
    print(f"  noise frame 120x120 (guard fallback): launches {guard_counts}")
    if guard.shape != (120, 120, 3) or guard.dtype != np.uint8:
        raise AssertionError(f"guard output {guard.shape} {guard.dtype}")
    if guard_counts["sinkhorn_halfstep_f32"] < 2 * GUARD_ITERS:
        raise AssertionError(
            f"K4 ran {guard_counts['sinkhorn_halfstep_f32']} times on the "
            "guard-tripping frame")
    for row in rows:
        row["launches"] = main_counts[row["name"]]
        row["guard_launches"] = guard_counts[row["name"]]

    # -- [6] where the time goes: one profiled warm call ------------------
    profile_main(torch, NLEFilter, img, mp)

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
