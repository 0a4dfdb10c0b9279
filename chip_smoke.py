#!/usr/bin/env python3
"""Smoke run of the PyTorch port (nle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. requires CUDA and prints the card's name and power limit (nvidia-smi);
2. builds the CUDA kernels from nle_tpu_torch/csrc (one nvcc per source,
   all started together) and prints the build time and ptxas'
   register/spill lines, and the SASS instructions of each streaming
   kernel's entry loop per entry (every needle of SASS_KEYS and CORE_KEYS
   must find its loop); K8's one-build kernel must hold one
   MUFU.EX2 per entry its row groups build (one barrier a group), and the
   affinity core (csrc/affinity_core.cuh: K1, K2's contract, the fp32
   K12's phi step) one per entry a column panel in its main loop, whose FFMA share
   it prints;
3. checks each kernel against its plain PyTorch version on the card at the
   1 MP main path's shapes (real data: the rock2-parameter frame below),
   each within a stated error bound (the streaming kernels K8, K10 and
   K11 at R = 1, 2, 3, and K12 against their plain versions evaluated in
   float64), and times the kernel, the plain version and, where one
   PyTorch call computes the same function, that call, with CUDA events;
   each kernel's bound (the least time the card could take: bytes over
   3.35 TB/s or fp32 operations over 67 TFLOP/s) is computed from the same
   inputs. K6's Sb must also be bitwise symmetric, K6 and K7 bitwise
   repeatable; K7 is held and timed on the 64-wide B the path passes (and
   beside the TPU's 128-lane B), and K6's plan and scratch bytes printed;
   the half-step (K8, and K9 in [9a]) and K3/K4/K14 must be bitwise
   repeatable, K4 is timed beside torch.mv on the same factor; K12 (its
   float64 form, the sample-basis gram H = (c K)^T (c K), the only K12 a
   route runs) must be bitwise symmetric and repeatable, and within
   GRAM64 of its plain version on the same fp32 entries, a bound that the
   same H summed in fp32 must fail on the same operands; K1's builds an
   entry and MUFU.EX2 an entry are read from a profiled call;
4. runs a small frame on device="cuda" and device="cpu" (>= 45 dB between
   them) and twice on the card (bitwise equal), and edits on the card with
   the filter the CPU trained;
5. drives the dense main path: NLEFilter(device="cuda").train_and_enhance
   on a structured 832x1216 frame with the rock2 parameters
   20 30 500 10 50 50 (p = 600, 50 Sinkhorn iterations, k = 50), weights
   [4, 3, 4, 1], cold then warm. The launch counts of the cold run alone
   prove which kernels the path went through (K1, K3 >= 2 x 50, K6, K7);
   its peak device memory over the padded phi must stay within the
   streaming rule's DENSE_PEAK_PER_PHI_BYTE. Then one 120x120
   uniform-noise frame, whose int16 carrier guard trips, drives the f32
   fallback from each layout it can take (guard_paths): the small layout,
   its default (retrained on the small layout: K4, no K6/K7), and under
   NLE_CPHI_BYTES=0 the split layout (retrained on the assembled f32
   layout: K4, K6, K7); the stage-2a calls in order and the counts of each
   run gate its route;
6. profiles one more warm 1 MP call (torch.profiler): wall, device time and
   busy share, host time per pipeline stage, and the device time per kernel
   ([7] profiles one more 32 MP call the same way);
7. drives the phi-free capacity path at full size:
   NLEFilter(factored=True, device="cuda").train_and_enhance on a
   structured 5656x5656 frame (31,990,336 px) with 24 25 5000 30 50 50
   (p = 600), cold then warm (bitwise equal). The cold run's own counts
   prove K8 >= 101, K12, K10, K11 ran and K3, K4, K6, K7 did not (no phi);
   its peak device memory must stay below 256 B/pixel; the warm run prints
   train and apply seconds. Then K8 (unit_x and a real half-step), K10,
   K11 and K12 are held against their float64 plain versions on this
   frame's own operands (q ~ 32 M rest pixels, mpad 384), and K8, K10,
   K11 and K12 timed there; the profiled warm call must launch K8's
   one-build kernel once per half-step, the reduction of its partials, no
   two-pass K9, K10's kernel twice (the s0 pass and the apply) and K11's
   once (also in [9a]; a profile without device events fails);
8. cross-path checks: (a) the factored path on the card vs the CPU
   (>= 45 dB) and twice on the card (bitwise) on a 128x192 frame; (b) the
   factored path vs the dense main path at 1 MP (>= 45 dB); (c)
   train_filter(streaming=True) vs streaming=False on a 2000x2000 frame
   with the rock2 parameters (>= 45 dB on the edit), the streaming run's
   counts proving it took K8, K12 and K1 and no dense kernel, and K8 and
   K12 held against their float64 plain versions on that frame's
   operands; (d) the
   streaming auto rule: a frame at ~92% of the phi limit it computes on
   this card runs dense through NLEFilter's default (no K8), on the split
   int16 route and on the assembled f32 route, without running out of
   memory and within DENSE_PEAK_PER_PHI_BYTE x phi, and 15% more pixels
   would stream;
9. dense sampling grids (more than 1792 samples; p > 1024 on the dense
   route): (a) the capacity run of [7] on a structured 4000x4000 (16 MP)
   frame with 48 44 5000 30 50 50 (p = 2112, Ppad 2176), cold then warm
   (bitwise equal), its own counts proving K9 >= 100, K10 >= 2 (the s0
   pass and the apply), K11, K12 and no dense kernel and no K8, peak below
   256 B/pixel; K9, K10, K11 and K12 held against their float64 plain
   versions on that frame's own operands and timed there (rows for K9 and
   for K10-K12 at that Ppad); K9's two passes, which serve Ppad past
   4096, held the same way on its first 2^20 rest pixels with the samples
   zero-padded to Ppad 4224 (bitwise repeatable, each launch counted),
   timed, and their entry loops counted into K9's row; (b) NLEFilter(device="cuda") at 1 MP with
   40 30 500 10 50 50 (p = 1200): K1 at K2's contract, K3, K6, K7, its
   edit >= 45 dB from the assembled f32 route's (K4), and K1 held and
   timed at p = 1200 (the K2 row), and K12 held at p = 1200 as in [3];
   (c) train_filter(streaming=True), the
   default dense route (K3) and the f32 dense route (K4) on the 2000x2000
   frame with 48 44 500 10 50 50, whose rank is cut at eigenvalues of
   1e-10, and the streaming route's float64 plain twin on the same frame,
   each pair >= 45 dB: streaming vs dense f32, dense vs dense f32, the
   twin vs dense f32 (the streaming algebra without its rounding lands on
   the dense route), and the streaming kernels vs the twin (>= TWIN_DB);
   the streaming loop's c against the twin's (median over the rest
   pixels <= LOOP_C_TOL, the two-pass K9's reading there), and nle_tpu's
   fp32 loop's c around the same kernels (a reading); and K8's gate: on
   the frames of GATE_SEEDS, at each of stream_precision.ONE_STEP's
   half-steps of the float64 loop, one half-step's x and ap by K8's
   one-build kernel and by K9's two passes at the same Ppad against
   float64 on the same u, K8's median over the half-steps (of the median
   relative error) at or below K9's, for x and for ap; (d) the dense
   route past 2048 factor columns on a real train: the same frame with
   48 44 500 5 50 50 (m = 2078, mb 2112, mpad 2176) through the auto rule
   on the int16 route (K3) and the f32 route (K4), >= 45 dB apart, then K1
   at p = 2112 and K3/K4 (and K13/K14 for [10a]) and K6/K7 at mpad 2176
   held and timed on 2^20 of its rest pixels, K13 there also bit for bit
   its earlier sweep (k13_bitwise);
10. the Sinkhorn modes: (a) K13 (NLE_SINKHORN_KERNEL=auto), K14 (the bf16
   preview branch) and K15's three probe variants (the TPU probe's (8,
   max(mpad, chunk)) block at chunk 1024; dmaonly exact) held against
   their plain versions and timed at the 1 MP assembled shape (npad
   1,011,712, mpad 640), K13 and K14 also at mpad 2176 ([9d]); K13 also
   bit for bit its earlier sweep, rebuilt in this process from the
   unchanged tiled_sweep_kernel (k13_by_old_sweep: x and the tile partials
   from nle_ab_tiles variant 0, s striped over them on the card), max |dx|
   and |ds| printed, both must be 0; (b) the 1 MP
   main frame through NLEFilter(device="cuda").train_and_enhance under
   each mode, cold then warm (bitwise equal), with the counts and the
   stage-2a layouts that prove the route: =auto K13 x 100 and no K3/K4;
   NLE_SINKHORN_BF16=auto K14 x 96 and K4 x 4; NLE_STAGE2_SPLIT=off K3 x
   100 on the assembled layout; NLE_SINKHORN_INT16=off K4 x 100;
   NLE_SINKHORN_INT16=on K3 x 100, and on the noise frame that trips the
   guard no re-dispatch, on the small layout and (NLE_CPHI_BYTES=0) on the
   split layout, with K6 and K7 there. Gates: K13 vs K4 route and
   assembled int16 vs the split route >= 45 dB, card vs CPU >= 45 dB per
   mode on a small frame,
   peak <= DENSE_PEAK_PER_PHI_BYTE x phi; the bf16 route's PSNR against
   the K4 route is printed, ungated (not golden-safe); (c) K15's table
   through the port's probe tool (nle_tpu_torch/tools/bench_sk_dmaonly.py):
   dmaonly / wonly / wpart at chunks 512 and 1024 (on K4's bulk-copy
   sweep) and the half-step kernels' ms and GB/s at the same shape, each
   against K4 and against dmaonly at chunk 1024;
11. the A/B staging probes of tools/ at [10c]'s shape (npad 1,011,712,
   mpad 640, phi normal x 0.05 + 0.1 from seed 0): K16 (bench_sk_unroll,
   chunks 512 and 1024), K17 (parts3d, mxu_row0), K18 (vpu, xonly) and
   K13 as the mxu variant (bench_sk_variants, tiles 1024 and 2048), K19
   (bench_sk_2stream, 1/2/4 streams at chunks 1024 and 2048): one cold
   call each, whose own launch counts must be exactly one per
   configuration, held against the plain twins (x and s bounds as K3/K4's,
   K19 exact), K13's mxu calls also bit for bit its earlier sweep at both
   tiles, timed beside their bounds and torch.mv on the same factor;
   then each tool's table through its own table function, whose launch
   counts are the rows' `launches`;
12. stream mode, host Lab and the port bench: (a) four exposure-jittered
   copies of [5]'s structured frame, an aliased-lines frame (fourth: its
   finish runs with two frames in flight at lookahead 2) and a
   uniform-noise frame (832x1216, MAIN_ARGS) through
   NLEFilter(device="cuda").train_and_enhance one by one (each frame's
   crush statistic and guard decision printed: the jittered frames must
   pass, the aliased one trip) and through train_filters_iter at
   lookahead 1 and 2, each yielded filter edited through
   NLEFilter(trained=...) + seed_lab_cache + enhance: every edit bitwise
   single mode's, and each frame's own K4 launches (those between its
   yield and the one before: its finish) equal to single mode's, the
   aliased frame's >= 2 x 50; (b) frame 2's submit
   under torch.cuda.set_sync_debug_mode("error") (lookahead 4: no finish
   in that window); (c) the lookahead-2 stream's peak device bytes over
   one frame's padded phi, held to fits_pipeline's bound (lookahead +
   DENSE_PEAK_PER_PHI_BYTE); (d) one frame's stage 2a: the host's time to
   queue it and the device's to run it (queued behind a blocker); then 8
   jittered frames, warm, in stream mode (the bench's flow: edits on a
   4-thread pool) and in single mode: wall a frame and, from a profile as
   in [6], the device busy share (readings, not gates); (e) the C Lab kernels (they must build) bitwise the NumPy
   pair on a 1 MP random frame and the Lab cube's extremes, the device
   twins bitwise the host pair on the whole 256^3 cube both ways, and
   NumPy, C and the device twin (with its upload and fetch) timed at 1,
   16 and 32 MP; (f) `python3 -m nle_tpu_torch.tools.bench` in both modes
   with NLE_BENCH_REPEATS=4 (its JSON line printed; a nonzero exit fails);
13. the command line: `python -m nle_tpu_torch.cli.enhance|denoise|apply`
   as subprocesses on the card (each run through runpy, its launch counts
   written at its exit) on [5]'s frame written to PNG, with the rock2
   parameters: (a) cli.enhance --save-filter bitwise [5]'s
   train_and_enhance, launching K1, K3, K6, K7; (b) cli.denoise `10 10 2`
   dense (K1, K3, K6, K7) and --factored (K8 >= 101, K12, K10 and K11 once
   each, at R = 2: the two chroma planes, no dense kernel), >= 45 dB
   apart, each with 50 `eig i val` lines (K10 and K11 at R = 2 are held
   against their float64 plain versions and timed at [3], on this frame's
   shapes: the rows' r2_* fields); the bilateral's ms at 1 MP; then side
   by side cli.apply on the three saved filters (>= 45 dB from their
   direct runs, bitwise printed), (c) --stage1=topk, --precision=float64
   and --no-pallas >= 45 dB from the default route (the last two
   launching no kernel) and --stage1=device read (its float32 eigh of Ka
   puts it as far from the default route as nle_tpu's own device route,
   PERF.md), its eigensolve held in-process at the frame's sample set,
   card against CPU (hold_device_stage1: eigenvalues, eps mask, residual
   and orthogonality), and (d) the usage and missing-file probes (rc 0,
   the reference's messages);
14. serving and the batch CLI on [5]'s frame and its exposure-jittered
   copies, rock2 parameters (serving_phase): (a) the HTTP service
   in-process: the load check (nle_tpu_torch.tools.check_serving: four
   concurrent /enhance, each bitwise a direct train_and_enhance, a
   byte-copy pair byte-equal, coalesced; wall alone and four at once),
   then /enhance, /train + /apply and /denoise bitwise the library (each
   request's launches counted: K1, K6, K7 once and K3 x100 a dense train,
   no kernel in a dense apply), /enhance?factored=1 and a factored
   /train?mode=denoise + /apply?op=denoise (K10/K11 once each, R = 2)
   >= 45 dB from the dense routes, a byte budget (SERVE_BUDGET) that
   evicts and spills a kept 1 MP filter and reloads it bitwise, /metrics'
   device memory; (b) the pool as a subprocess, two workers sharing card
   0: named traffic on the worker its name hashes to, a worker killed
   after its filter spilled and restarted by the supervisor, serving it
   bitwise; (c) python -m nle_tpu_torch.cli.batch on four 1 MP PNGs and
   on two (--op=denoise), each output bitwise the per-image CLIs;
15. multi-GPU (sharded_phase): the pixel-sharded trainers of
   nle_tpu_torch/parallel as worker processes, one a rank
   (nle_tpu_torch/tools/sharded_scaling.py's `run`; every worker timed
   out, and all killed when one fails): (a) train_filter_sharded + apply_filter_sharded on [5]'s frame
   at (data, pixel) = (1, 2), run twice (bitwise equal), and at (2, 2) on
   two exposure-jittered copies, over gloo with the ranks sharing the
   card: each edit >= 45 dB from the single-card NLEFilter edit of its
   frame, each rank's own counts K1, K3 >= 2 x 50, K6, K7, its wall and
   the guard's crush statistic printed; (b) [7]'s 32 MP frame and
   parameters, streaming and factored at (1, 2) over gloo, then
   apply_filter_factored_sharded: >= 45 dB from [7]'s edit, each rank K8
   >= 101, K12, K10, K11 and no K3/K4/K6/K7, each rank's peak device bytes
   at most SHARD_PEAK_SHARE of [7]'s run, train and apply s a rank; (c)
   (a)'s 1 MP run over NCCL at world size device_count, >= 45 dB from
   (a); (d) python3 -m nle_tpu_torch.tools.check_sharded ends ok. The
   kernels line's rows gain each rank's counts of (a) at (1, 2) and (b)
   (launches_sharded_dense_1mp, launches_sharded_factored_32mp). Ranks
   that share one card measure the sharding code, not multi-card scaling.
16. the reference's dense free functions (free_api_phase): sinkhorn and
   orthogonalize on [5]'s frame at the rock2 parameters, plain PyTorch on
   the card: (a) in float64 (phi built as the plain routes build it):
   Wa (m, m) and Wab (m, N - m) on the card, the edit >= 45 dB from the
   port's float64 route (train_filter(dtype=torch.float64)); max |Sq - S|
   / S, the largest |row sum - 1| of [Wa Wab], wall s and peak GiB
   printed; (b) the chain in float32 with eigh_method="host64": its
   edit's dB from (a), a reading.
17. the small stage-2a layout and the reference's configurations: (a) the
   denoise configuration's sampler 10 10 200 30 10 10 (p = 100, mpad 128)
   enhancing the largest square structured frame that stage2_dense_small
   admits (362x362 at NLE_CPHI_BYTES' 64 MiB), cold then warm (bitwise
   equal): its one stage-2a call on the small layout, its own launches
   exactly K1 once and K3 twice an iteration (no K4, K6, K7: the gram and
   the V tail are plain fp32 products), K1, K3 and K4 held against their
   plain versions and timed on its own tensors (the frame's features, the
   assembled 131,072 x 128 factor and its int16 carrier), its peak bytes
   within DENSE_PEAK_PER_PHI_BYTE x phi plus the carrier prep's chunk
   (PREP_BYTES_PER_ENTRY), and its edit >= 45 dB from the same frame
   through the split layout (NLE_CPHI_BYTES=0) and from the port's float64
   route on the card; then a frame of 1.5 GiB of phi under a raised
   NLE_CPHI_BYTES on the small layout, its peak within
   DENSE_PEAK_PER_PHI_BYTE x phi, >= 45 dB from its split layout; (b)
   each configuration of the port's golden_configs whose input shape
   SURVEY.md records (the ten README enhance configurations, the denoise
   configuration, and the links.md recipes snow-mountain-links,
   red-cherries-links and brickwall-links) on a structured frame of that
   shape through NLEFilter on the card, cold then warm: the layout taken,
   m, mpad, the guard's trips and the warm wall printed, cold == warm bit
   for bit and >= 45 dB from the float64 route on the card;
18. the u8 edit's gather and scatter by perm (pixel_order_phase): both
   kernels bit for bit their plain versions at C = 1, 2, 3 on the 8 MP
   frame's sample grid (3264x2448 at 10 x 10 samples) and on a ragged
   random permutation, with exactly one launch each and a synchronize
   after each launch; their ms beside the plain versions' and the byte
   bound N (4 + 2C) B over 3.35 TB/s; then a denoise of [5]'s frame at
   the denoise recipe launches each once, bit for bit the same filter's
   edit through host fancy indexing.

Any failure raises and the exit code is nonzero. The last two lines are
the per-kernel JSON and {"ok": true, "device": {...}}. Imports no JAX.
Frames are made with numpy from fixed seeds; no file is read.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np

# The frame generator, shared with the serving load check: a smooth,
# photo-like BGR frame (low-frequency shading, soft discs, mild texture).
from nle_tpu_torch.tools.check_serving import structured_frame  # noqa: E402

MAIN_SHAPE = (832, 1216)
MAIN_ARGS = (20, 30, 500.0, 10.0, 50, 50)   # rows, cols, hx, hy, iters, k
WEIGHTS = [4, 3, 4, 1]
U = 2.0 ** -24                                # fp32 unit roundoff
# Tolerance of K6's Sb, a sum over N ~ 1 M rows, relative to the sum of
# absolute terms. The kernel sums rows in 2,048-row register chains, then
# the chains and the splits in order: within ~1e-5 of float64 at 1 MP and
# at mpad 2176. Plain cuBLAS sums each entry in one long chain: ~1e-4 off at
# 1 MP, ~4e-4 at mpad 2176 on 2^20 rows, so the float64 plain version is the
# reference there. A dropped row tile or wrong index is O(1e-3) or more.
GRAM_SUM_TOL = 2.5e-4
# Tolerance of s = Q^T x (K3/K4), relative to |Q|^T |x|. The kernel sums each
# column over a 1024-row block, then ~1000 block partials in order; cuBLAS
# blocks differently. Rounding of such sums grows like sqrt(terms) u: a few
# 1e-6 at most here. A dropped 32-row tile moves s by ~3e-5 of the sum.
S_SUM_TOL = 1e-5
# Tolerance of K12's H = (c K)^T (c K) against its plain version on the
# same fp32 entries, relative to the gram of absolute terms, for Qpad rest
# rows: each product of two entries is exact in float64 but for one
# rounding, and each side sums an element's q products in float64 chains of
# at most Qpad adds (the kernel: a row split's rows in order, then the
# splits in order; the plain version: cuBLAS blocks and one add a chunk),
# so each is within (Qpad + 1) 2^-53 of the exact sum and the two within
# GRAM64 = 2 (Qpad + 1) 2^-53: 7e-9 at 32 MP. An H summed in fp32 is off by
# its fp32 roundings, about 2^-24 = 6e-8 of an element at the least, and
# fails it; a dropped 32-row step moves H by 1e-6 of its sum or more.
def gram64(qpad: int) -> float:
    return 2 * (qpad + 1) * 2.0 ** -53


# [9c]: the streaming loop's c against its float64 twin's, median over the
# rest pixels, at most the two-pass K9's reading on this frame
# (tools/stream_precision.py, seed 9); the streaming edit against the
# twin's edit.
LOOP_C_TOL = 1.362e-4
TWIN_DB = 52.5
GUARD_ITERS = 10                              # Sinkhorn iterations, noise frame
# [17a] the int16 carrier's prep (quantize_int16, carrier_crush_frac) works
# on PREP_CHUNK_ROWS rows at a time: its f32 and bool temporaries, bytes an
# entry of one chunk (|phi| or phi / scale 4, three bool masks or the int16
# cast, the allocator's rounding), over phi and its int16 copy. Measured
# 8.5 with the O(N) vectors on [17a]'s 64 MiB phi (its peak 2.566 x phi).
PREP_BYTES_PER_ENTRY = 10
# [17a] phi bytes of the frame run under a raised NLE_CPHI_BYTES (twice this).
RAISED_PHI = 3 << 29                          # 1.5 GiB
CAP_SHAPE = (5656, 5656)                      # 31,990,336 px
CAP_ARGS = (24, 25, 5000.0, 30.0, 50, 50)     # p = 600 samples
CAP_BYTES_PER_PIXEL = 256                     # phi would be 2,560, V 200
STREAM_SHAPE = (2000, 2000)
# [9] dense sampling grids: a 48 x 44 grid samples p = 2112 (Ppad 2176).
GRID_CAP_SHAPE = (4000, 4000)                 # 16 MP
GRID_CAP_ARGS = (48, 44, 5000.0, 30.0, 50, 50)
GRID_ARGS = (48, 44, 500.0, 10.0, 50, 50)     # on STREAM_SHAPE
P1200_ARGS = (40, 30, 500.0, 10.0, 50, 50)    # p = 1200 on MAIN_SHAPE
# [9d] a rank of 2078 of 2112 on STREAM_SHAPE: mb 2112, mpad 2176, so the
# dense route's K3/K4 run past 2048 factor columns.
WIDE_ARGS = (48, 44, 500.0, 5.0, 50, 50)
WIDE_MPAD = 2176
# The H100 SXM's published peaks (NVIDIA data sheet): HBM bytes/s and fp32
# FLOP/s outside the tensor cores (TF32 is barred by the fidelity contract).
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# float64 FLOP/s outside the tensor cores: K12's float64 form runs its
# products there; bounds weigh them PEAK_FP32 / PEAK_FP64 fp32 operations.
PEAK_FP64 = 34e12
# fp32 operations of one affinity entry's argument: three differences, five
# multiplies, two adds (the IEEE expf is not counted, so the bound is low).
ENTRY_FLOPS = 10


@contextlib.contextmanager
def knobs(**env):
    """The named environment variables set for the block (None: unset),
    restored after it."""
    saved = {name: os.environ.get(name) for name in env}
    for name, value in env.items():
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


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


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the fp32 operations over the peak rate."""
    tb, tf = nbytes / PEAK_BYTES * 1e3, flops / PEAK_FP32 * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def check(name: str, diff, bound) -> tuple[float, float]:
    """Assert |diff| <= bound elementwise; returns (max |diff|, max
    |diff| / bound)."""
    return check_parts(name, [(diff, bound)])


def check_parts(name: str, parts) -> tuple[float, float]:
    """check() over (diff, bound) pairs taken in pieces (row chunks of one
    comparison), a pair at a time."""
    worst = ratio = 0.0
    for diff, bound in parts:
        ratio = max(ratio, float((diff.abs() / bound.clamp(min=1e-30)).max()))
        worst = max(worst, float(diff.abs().max()))
    print(f"  {name}: max_abs_err {worst:.3e}, max err/bound {ratio:.3e}")
    if not ratio <= 1.0:
        raise AssertionError(f"{name}: error exceeds its bound ({ratio})")
    return worst, ratio


def hold_halfstep(torch, label: str, Q, t, eps: float, kernel=None,
                  plain=None):
    """A half-step kernel (K3/K4/K14 by Q's dtype unless `kernel` is given)
    against its plain version on (Q, t), and two launches bitwise equal.
    Returns (the kernel's x, (max_abs_err, max err/bound))."""
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        sinkhorn_halfstep,
        sinkhorn_halfstep_plain,
    )

    xk, sk = (kernel or sinkhorn_halfstep)(Q, t, eps)
    xk2, sk2 = (kernel or sinkhorn_halfstep)(Q, t, eps)
    if not (torch.equal(xk, xk2) and torch.equal(sk, sk2)):
        raise AssertionError(f"{label}: two launches differ")
    del xk2, sk2
    xp, sp = (plain or sinkhorn_halfstep_plain)(Q, t, eps)
    Qa = Q.float().abs()
    # x = 1/w: |dx| ~ |dw| x^2 with |dw| <= (2 mpad + 4) u (|Q| |t|) for the
    # factor's own width; x2 for the two sides.
    bx = 2 * (2 * Q.shape[1] + 4) * U * (Qa @ t.abs()) * xp * xp + 1e-30
    ex = check(f"{label} x", xk - xp, bx)
    es = check(f"{label} s", sk - sp, S_SUM_TOL * (Qa.T @ xp.abs()) + 1e-30)
    return xk, (max(ex[0], es[0]), max(ex[1], es[1]))


def k13_by_old_sweep(torch, phi, t, eps: float, tile: int):
    """K13's (x, s) as its earlier sweep gives them, rebuilt in this process
    from the unchanged tiled_sweep_kernel<kHalfstep> (csrc/
    sinkhorn_sweep.cuh): x and the per-tile partials from nle_ab_tiles
    variant 0 (K17's launch of that kernel) at the same tile, into this
    function's own partial tensor; s = striped_sum(partial, 8) on the card,
    the 8-stripe reduce's fp32 adds in its order. Not counted: it is a
    reference for K13's bits, on no path."""
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        K13_STRIPES,
        launch_sweep,
        striped_sum,
    )

    npad, mpad = phi.shape
    x = torch.empty((npad,), dtype=torch.float32, device=phi.device)
    s_tile_order = torch.empty((mpad,), dtype=torch.float32,
                               device=phi.device)
    partial = torch.empty((npad // tile, mpad), dtype=torch.float32,
                          device=phi.device)
    _build.check(launch_sweep(_build.load().nle_ab_tiles, phi, t, x, partial,
                              s_tile_order, npad, mpad, tile, 0, float(eps)),
                 "K13's earlier sweep (nle_ab_tiles variant 0)")
    return x, striped_sum(partial, K13_STRIPES)


def k13_bitwise(torch, label: str, got, phi, t, eps: float,
                tile: int) -> float:
    """K13's (x, s) `got` on (phi, t) at `tile` against its earlier sweep's
    (k13_by_old_sweep): prints max |x - x_old| and |s - s_old| and fails
    unless both are 0 and the tensors equal. Returns the max |diff| (0)."""
    xo, so = k13_by_old_sweep(torch, phi, t, eps, tile)
    dx = float((got[0] - xo).abs().max())
    ds = float((got[1] - so).abs().max())
    print(f"  {label}: K13 vs its earlier sweep at tile {tile}: max |dx| "
          f"{dx:.3e}, max |ds| {ds:.3e} (bit for bit: must be 0)")
    if not (dx == 0 and ds == 0 and torch.equal(got[0], xo)
            and torch.equal(got[1], so)):
        raise AssertionError(f"{label}: K13 is not bitwise its earlier sweep "
                             f"(max |dx| {dx}, max |ds| {ds})")
    return max(dx, ds)


def path_operands(torch, L: np.ndarray, args, dev):
    """The device operands the path builds from a Lab luminance frame L
    (H, W) and its args: stage 1 on the host, then the packed channel, the
    features (rest pixels fb, samples fa) and Um, lam, Uinv."""
    from types import SimpleNamespace

    from nle_tpu_torch.ops.affinity import bandwidth_weights, features
    from nle_tpu_torch.ops.pipeline import (
        _unpack_stage1,
        bucket_m,
        ka_eigh_host64,
        pack_stage1,
    )
    from nle_tpu_torch.ops.sampling import sample_grid

    h, w = L.shape
    rows_s, cols_s, hx, hy = args[:4]
    grid = sample_grid(h, w, rows_s, cols_s)
    p, n = grid.n_samples, grid.n_pixels
    Um64, lam64, _ = ka_eigh_host64(
        L[grid.sel_rows, grid.sel_cols].astype(np.float64), grid.sel_rows,
        grid.sel_cols, hx, hy, 1e-10)
    m = lam64.shape[0]
    mb = bucket_m(m, p)
    stage1 = torch.from_numpy(pack_stage1(Um64, lam64, mb=mb)).to(dev)
    Um, lam, Uinv = _unpack_stage1(stage1, p)
    perm = torch.from_numpy(grid.perm).to(dev)
    y = torch.from_numpy(L.reshape(-1)[grid.perm]).to(dev)
    f = features((perm // w).float(), (perm % w).float(), y)
    sw, pw = bandwidth_weights(hx, hy)
    return SimpleNamespace(p=p, n=n, m=m, mb=mb, mpad=-(-mb // 128) * 128,
                           Um=Um, lam=lam, Uinv=Uinv, y=y, fa=f[:p],
                           fb=f[p:], sw=sw, pw=pw)


def hold_streaming(torch, op, eps: float, label: str,
                   halfstep_only: bool = False):
    """The half-step (K8, or past Ppad 1792 K9, whose unit_x pass is K10
    with x = mask), K10 and K11 (R = 1, 2, 3) and K12 on the path's own
    operands `op`, each held against its plain version evaluated in float64
    on the same inputs, so each bound covers the kernel's own rounding.
    The half-step must also be bitwise repeatable (two launches on the
    same inputs). halfstep_only: the half-step alone. Returns ({kernel:
    (max_abs_err, max err/bound)}, with K10/K11 also by R under
    "<kernel> R=<R>", the f32 operands for timing; with halfstep_only, the
    padded features and the half-step's x)."""
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        MAX_STREAM_P_FUSED,
        halfstep_plan,
        pad_stream_operands,
        streaming_ap,
        streaming_ap_plain,
        streaming_atb,
        streaming_atb_plain,
        streaming_halfstep,
        streaming_halfstep_plain,
    )

    pad = torch.nn.functional.pad
    p, q, sw, pw = op.p, op.n - op.p, op.sw, op.pw
    fa_rows, fb_cols, mask = pad_stream_operands(op.fa, op.fb)
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    print(f"  {label}: streaming kernels at q={q}, Qpad={qpad}, p={p}, "
          f"Ppad={ppad}, mpad={op.mpad}; float64 references")
    wide = ppad > MAX_STREAM_P_FUSED
    half, kh = (("streaming_halfstep_ptiled", "K9") if wide
                else ("streaming_halfstep", "K8"))
    unit, ku = ("streaming_ap", "K10") if wide else (half, kh)
    f64 = torch.float64
    fa64, fb64 = fa_rows.to(f64), fb_cols.to(f64)
    out = {}

    def hold(kernel, name, diff, bound):
        e, r = check(f"{label} {name}", diff, bound)
        e0, r0 = out.get(kernel, (0.0, 0.0))
        out[kernel] = (max(e, e0), max(r, r0))
        return e, r

    x0, ap0 = streaming_halfstep(fa_rows, fb_cols, mask, fa_rows.new_zeros(
        ppad), sw, pw, eps, unit_x=True)
    if not torch.equal(x0, mask[0]):
        raise AssertionError(f"{ku} unit_x: x is not the mask")
    # A real half-step input: u = Uinv t for t = lam s0, s0 = phi^T 1.
    u = pad(op.Uinv @ (op.lam * (op.Um.sum(dim=0)
                                 + op.Uinv.T @ ap0[:p].to(op.Uinv.dtype))),
            (0, ppad - p)).contiguous()
    xk, apk = streaming_halfstep(fa_rows, fb_cols, mask, u, sw, pw, eps)
    xk2, apk2 = streaming_halfstep(fa_rows, fb_cols, mask, u, sw, pw, eps)
    if not (torch.equal(xk, xk2) and torch.equal(apk, apk2)):
        raise AssertionError(f"{label} {kh}: two launches differ")
    del xk2, apk2
    print(f"  {label} {kh}: {halfstep_plan(qpad, ppad)}; two launches "
          "bitwise equal")
    xp, _ = streaming_halfstep_plain(fa64, fb64, mask.to(f64), u.to(f64), sw,
                                     pw, eps)
    # Rows for K10: the factored projection's input (x y here), x itself,
    # and the mask. One float64 pass gives K^T of them and of |them|, which
    # also hold the half-step's ap (K^T x for the kernel's own x) and its
    # unit_x pass.
    X = torch.stack([xk * pad(op.y[p:], (0, qpad - q)), xk, mask[0]])
    ref = streaming_ap_plain(fa64, fb64, torch.cat([X, X.abs()]).to(f64),
                             sw, pw)[:, :p]
    rng = np.random.default_rng(4)
    B = torch.zeros((3, ppad), device=u.device)
    B[:, :p] = torch.from_numpy(rng.standard_normal((3, p)).astype(np.float32)
                                * 1e-3).to(u.device)
    # K B, K |B| and K |u| (the half-step's x bound) in one float64 pass.
    kref = streaming_atb_plain(fa64, fb64, torch.cat(
        [B, B.abs(), u.abs()[None]]).to(f64), sw, pw)
    # ap sums q positive-weighted terms per sample: S_SUM_TOL of the sum of
    # absolute terms (the kernel's per-block chains are two-level).
    hold(unit, f"{ku} unit_x ap", ap0[:p] - ref[2], S_SUM_TOL * ref[5])
    # x = 1/w: |dx| ~ |dw| x^2, |dw| <= (2 Ppad + 4) u (K |u|) for the p-term
    # chain and the entries' rounding; x2 for the second order.
    hold(half, f"{kh} x", xk - xp, 2 * (2 * ppad + 4) * U * kref[6] * xp * xp)
    hold(half, f"{kh} ap", apk[:p] - ref[1], S_SUM_TOL * ref[4])
    if halfstep_only:
        return out, dict(fa_rows=fa_rows, fb_cols=fb_cols, x=xk)
    for R in (1, 2, 3):
        out[f"streaming_ap R={R}"] = hold(
            "streaming_ap", f"K10 R={R}",
            streaming_ap(fa_rows, fb_cols, X[:R].contiguous(), sw, pw)[:, :p]
            - ref[:R], S_SUM_TOL * ref[3:3 + R])
        # Ppad-term fp32 sums: (2 Ppad + 4) u (K |b|).
        out[f"streaming_atb R={R}"] = hold(
            "streaming_atb", f"K11 R={R}",
            streaming_atb(fa_rows, fb_cols, B[:R].contiguous(), sw, pw)
            - kref[:R], (2 * ppad + 4) * U * kref[3:3 + R])
    del ref, kref, xp, fa64, fb64
    c_row = xk[None].contiguous()               # zero on the pad rows
    out["streaming_gram"] = hold_gram(torch, op, label, fa_rows, fb_cols,
                                      c_row)
    timing = dict(fa_rows=fa_rows, fb_cols=fb_cols, mask=mask, u=u,
                  X=X[:1].contiguous(), b=B[:1].contiguous(),
                  X2=X[:2].contiguous(), b2=B[:2].contiguous(), c_row=c_row,
                  q=q, qpad=qpad, ppad=ppad)
    return out, timing


def gram_fp32_sums(torch, fa_rows, fb_cols, c_row, sw, pw):
    """K12's H on the plain version's fp32 entries, summed in fp32 (fp32
    products a chunk, the chunks added in fp32): what the float64 form
    replaced, to show that GRAM64 tells the two apart."""
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        _affinity_rows,
        _chunks,
    )

    ppad = fa_rows.shape[1]
    H = fa_rows.new_zeros((ppad, ppad))
    for lo, hi in _chunks(fa_rows, fb_cols):
        ck = c_row[0, lo:hi, None] * _affinity_rows(fa_rows, fb_cols, lo, hi,
                                                    sw, pw)
        H += ck.T @ ck
    return H


def gram_bound(p: int, q: int, qpad: int, ppad: int) -> tuple:
    """(bytes, fp32-rate operations) of K12's float64 form: the rest rows'
    features and c, the samples' features, H written in float64; the
    entries' arguments in fp32, their products with c and H's lower
    triangle in float64, weighed at the fp32 over the float64 peak."""
    f64_ops = q * p + q * p * (p + 1)
    return (4 * (4 * qpad + 3 * ppad) + 8 * p * p,
            ENTRY_FLOPS * q * p + f64_ops * PEAK_FP32 / PEAK_FP64)


def hold_gram(torch, op, label: str, fa_rows, fb_cols, c_row):
    """K12 (its float64 form, H = (c K)^T (c K), Sb = Uinv^T H Uinv by the
    caller) on the path's own operands: bitwise symmetric, two launches
    bitwise equal, and H within GRAM64 of the gram of absolute terms from
    its plain version on the same fp32 entries, a bound that the same H
    summed in fp32 (gram_fp32_sums) must fail. Returns (max_abs_err, max
    err/bound) over the p samples' block."""
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        stream_sample_gram_plan,
        streaming_sample_gram,
        streaming_sample_gram_plain,
    )

    sw, pw, p = op.sw, op.pw, op.p
    qpad, ppad = fb_cols.shape[1], fa_rows.shape[1]
    plan = stream_sample_gram_plan(qpad, ppad)
    H = streaming_sample_gram(fa_rows, fb_cols, c_row, sw, pw)
    H2 = streaming_sample_gram(fa_rows, fb_cols, c_row, sw, pw)
    if not torch.equal(H, H2):
        raise AssertionError(f"{label} K12: two launches differ")
    if not torch.equal(H, H.T):
        raise AssertionError(f"{label} K12: H is not bitwise symmetric")
    del H2
    print(f"  {label} K12: {plan.tiles} lower tiles x {plan.nsplit} row "
          f"splits of {plan.split_rows} rows; H bitwise symmetric, two "
          "launches bitwise equal")
    ref = streaming_sample_gram_plain(fa_rows, fb_cols, c_row, sw, pw)
    habs = (ref if bool((c_row >= 0).all()) else
            streaming_sample_gram_plain(fa_rows, fb_cols, c_row.abs(), sw, pw))
    ref, bound = ref[:p, :p], gram64(qpad) * habs[:p, :p]
    del habs
    h32 = gram_fp32_sums(torch, fa_rows, fb_cols, c_row, sw, pw)[:p, :p]
    live = bound > 0
    r32 = float(((h32.double() - ref).abs()[live] / bound[live]).max())
    print(f"  {label} K12: H summed in fp32 reads {r32:.4g} of GRAM64 "
          f"({gram64(qpad):.3g} of the gram of absolute terms)")
    if not r32 > 1.0:
        raise AssertionError(f"{label} K12: H summed in fp32 is within "
                             "GRAM64: the bound does not tell float64 sums")
    del h32
    return check(f"{label} K12 H", H[:p, :p] - ref, bound)


# K9's two passes: past the one-build kernel's Ppad 4096 the wrapper runs
# them (streaming_kernel.halfstep_route). Held on [9a]'s first 2^20 rest
# pixels against its samples zero-padded to this Ppad.
TWO_PASS_PPAD = 4224
TWO_PASS_ROWS = 1 << 20


def hold_two_pass(torch, _build, t, eps: float, sass: dict,
                  issue_rate: float) -> dict:
    """K9's two passes on [9a]'s operands `t` (the pad samples have u = 0,
    so x and ap[:p] are the half-step of the real ones): x and ap held
    against the float64 plain version at hold_streaming's bounds, two
    launches bitwise equal and each counted once, then timed. Returns the
    K9 row's two-pass fields."""
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        halfstep_route,
        streaming_ap_plain,
        streaming_atb_plain,
        streaming_halfstep_ptiled,
        streaming_halfstep_ptiled_plain,
    )

    pad = torch.nn.functional.pad
    ppad, p, sw, pw = TWO_PASS_PPAD, t["p"], t["sw"], t["pw"]
    if halfstep_route(ppad) != "two_pass":
        raise AssertionError(f"Ppad {ppad} does not route to two passes")
    fa = pad(t["fa_rows"], (0, ppad - t["ppad"])).contiguous()
    fb = t["fb_cols"][:, :TWO_PASS_ROWS].contiguous()
    mask = t["mask"][:, :TWO_PASS_ROWS].contiguous()
    u = pad(t["u"], (0, ppad - t["ppad"])).contiguous()
    q = int(mask.sum())
    _build.reset_launches()
    x, ap = streaming_halfstep_ptiled(fa, fb, mask, u, sw, pw, eps)
    x2, ap2 = streaming_halfstep_ptiled(fa, fb, mask, u, sw, pw, eps)
    torch.cuda.synchronize()
    counts = {k: v for k, v in _build.LAUNCHES.items() if v}
    print(f"  K9 two passes at Ppad {ppad} on {TWO_PASS_ROWS} rows: launches "
          f"{counts}; two launches bitwise equal: "
          f"{bool(torch.equal(x, x2) and torch.equal(ap, ap2))}")
    if counts != {"streaming_halfstep_ptiled": 2}:
        raise AssertionError(f"K9 two passes: launches {counts}")
    if not (torch.equal(x, x2) and torch.equal(ap, ap2)):
        raise AssertionError("K9 two passes: two launches differ")
    del x2, ap2
    f64 = torch.float64
    fa64, fb64 = fa.to(f64), fb.to(f64)
    xp, _ = streaming_halfstep_ptiled_plain(fa64, fb64, mask.to(f64),
                                            u.to(f64), sw, pw, eps)
    kabs = streaming_atb_plain(fa64, fb64, u.abs()[None].to(f64), sw, pw)[0]
    ref = streaming_ap_plain(fa64, fb64, torch.stack([x, x.abs()]).to(f64),
                             sw, pw)[:, :p]
    ex = check(f"K9 two passes x (Ppad {ppad})", x - xp,
               2 * (2 * ppad + 4) * U * kabs * xp * xp)
    eap = check(f"K9 two passes ap (Ppad {ppad})", ap[:p] - ref[0],
                S_SUM_TOL * ref[1])
    del fa64, fb64, xp, kabs, ref
    entries = q * p
    out = {
        "max_abs_err_two_pass": max(ex[0], eap[0]),
        "err_over_bound_two_pass": max(ex[1], eap[1]),
        "launches_two_pass": counts["streaming_halfstep_ptiled"],
        "ms_two_pass": cuda_ms(torch, lambda: streaming_halfstep_ptiled(
            fa, fb, mask, u, sw, pw, eps)),
        "plain_ms_two_pass": cuda_ms(
            torch, lambda: streaming_halfstep_ptiled_plain(
                fa, fb, mask, u, sw, pw, eps), reps=1)}
    out["bound_ms_two_pass"], out["bound_by_two_pass"] = bound_ms(
        4 * (5 * TWO_PASS_ROWS + 5 * ppad), (ENTRY_FLOPS + 4) * entries)
    # Its entry loops: pass 1 (K11's kernel with the reciprocal) and pass 2
    # (K10's), one expf each: two builds of every entry.
    keys = ("stream_atb_kernelILi1ELb1E", "stream_ap_kernelILi1E")
    if all(k in sass for k in keys):
        per = sum(sass[k][0] / sass[k][1] for k in keys)
        out["sass_per_entry_two_pass"] = per
        out["expf_per_entry_two_pass"] = len(keys)
        out["issue_ms_two_pass"] = entries * per / issue_rate * 1e3
    print(f"  K9 two passes: kernel {out['ms_two_pass']:.3f} ms, plain "
          f"{out['plain_ms_two_pass']:.3f} ms, bound "
          f"{out['bound_ms_two_pass']:.4f} ms ({out['bound_by_two_pass']}); "
          f"entry loops {out.get('sass_per_entry_two_pass', float('nan')):.1f}"
          " instructions per entry (two expf)")
    return out


# [9c] K8's gate: one half-step on the float64 loop's u,
# on these frames (structured 2000 x 2000, GRID_ARGS, as
# tools/stream_precision.py runs them).
GATE_SEEDS = (9, 1, 2, 3)
GATE_ROUTES = ("K8 one build", "K9 two passes")


def one_step_errors(torch, fa_rows, fb_cols, mask, taps: dict, p: int, sw,
                    pw, eps: float) -> dict:
    """One half-step on each tapped u (f32, the float64 loop's input at
    stream_precision.ONE_STEP's half-steps): x and ap[:p] by K8's one-build
    kernel and by K9's two passes at the same Ppad, each against halfstep64
    (the half-step in float64) on the same u. Returns {route: {"x": [...],
    "ap": [...]}}, per tapped half-step in order the median over the rows
    (samples) with a nonzero float64 value of |got - want| / |want|."""
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        _affinity_rows,
        streaming_halfstep_ptiled,
        two_pass_halfstep,
    )
    from nle_tpu_torch.tools.stream_precision import (
        affinity64_rows,
        halfstep64,
    )

    f64 = torch.float64
    fa64, fb64 = fa_rows.to(f64), fb_cols.to(f64)
    # halfstep64's entries are the plain version's bits on these integer
    # features (its matmuls exact): checked here on the card.
    rows = min(4096, fb64.shape[1])
    if not torch.equal(affinity64_rows(torch, fa64, fb64, 0, rows, sw, pw),
                       _affinity_rows(fa64, fb64, 0, rows, sw, pw)):
        raise AssertionError("halfstep64's entries differ from the plain "
                             "version's in float64")
    half = halfstep64(torch, fa64, fb64, mask.to(f64), sw, pw, eps)
    routes = dict(zip(GATE_ROUTES, (streaming_halfstep_ptiled,
                                    two_pass_halfstep)))
    out = {r: {"x": [], "ap": []} for r in routes}
    for _, u in sorted(taps.items()):
        x64, ap64 = half(u.to(f64))
        for route, fn in routes.items():
            x, ap = fn(fa_rows, fb_cols, mask, u, sw, pw, eps)
            for what, got, want in (("x", x, x64), ("ap", ap[:p], ap64[:p])):
                live = want != 0
                rel = ((got.to(f64)[live] - want[live]) / want[live]).abs()
                out[route][what].append(float(rel.median()))
        del x64, ap64
    return out


def gate_frame(torch, dev, seed: int) -> dict:
    """one_step_errors on seed's frame: its float64 loop (halfstep64 in
    stream_precision.sinkhorn_loop) tapped at the ONE_STEP half-steps."""
    from nle_tpu_torch.tools.stream_precision import (
        ARGS,
        frame_operands,
        halfstep64,
        sinkhorn_loop,
        tapped,
    )

    op = frame_operands(torch, dev, seed)
    half = halfstep64(torch, op.fa64, op.fb64, op.mask64, op.sw, op.pw, 1e-10)
    taps = {}
    sinkhorn_loop(torch, tapped(half, taps), lambda: half(None)[1], op.Um64,
                  op.lam64, op.Uinv64, op.q, op.fa_rows.shape[1], ARGS[4])
    del half
    return one_step_errors(torch, op.fa_rows, op.fb_cols, op.mask, taps,
                           op.p, op.sw, op.pw, 1e-10)


def halfstep_gate(frames: dict) -> dict:
    """K8's gate on {seed: one_step_errors}: on every frame the median over
    the tapped half-steps of K8's relative error to float64 is at or below
    the two-pass K9's, for x and for ap. Prints each frame's readings;
    raises on a frame that fails. Returns the readings."""
    k8, k9 = GATE_ROUTES
    failed = []
    rows = {}
    for seed, errs in frames.items():
        row = rows[f"seed {seed}"] = {}
        for what in ("x", "ap"):
            a = float(np.median(errs[k8][what]))
            b = float(np.median(errs[k9][what]))
            row[what] = {"k8": a, "k9": b,
                         "k8_by_step": errs[k8][what],
                         "k9_by_step": errs[k9][what]}
            print(f"  K8 gate, seed {seed}, {what}: one build {a:.4e}, two "
                  f"passes {b:.4e} (median over half-steps of the median "
                  f"relative error; by step "
                  f"{', '.join(f'{v:.3e}' for v in errs[k8][what])} / "
                  f"{', '.join(f'{v:.3e}' for v in errs[k9][what])})")
            if not a <= b:
                failed.append(f"seed {seed} {what}: {a:.4e} > {b:.4e}")
    if failed:
        raise AssertionError("[9c] K8's one half-step is further from "
                             "float64 than the two-pass K9's: "
                             + "; ".join(failed))
    return rows


# Host-side stages of one train_and_enhance call (utils.logging.stage
# names, each a torch.profiler range).
STAGES = ("BGR to Lab", "Computing kernel", "Nystrom approximation + Sinkhorn",
          "Orthogonalize", "Stage 2b", "Fetch edit", "Lab to BGR")


def kernel_grids(prof, needles) -> list:
    """[(kernel name, grid (x, y, z))] of the device kernels of a finished
    profile whose names hold one of needles, in launch order: read from
    the profiler's trace, which carries each launch's grid."""
    import json

    from nle_tpu_torch.ops.kernels import _build

    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "profile_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    found = []
    for e in events:
        name = e.get("name", "")
        if e.get("cat") != "kernel" or not any(k in name for k in needles):
            continue
        grid = e.get("args", {}).get("grid")
        if grid is None:
            raise AssertionError(f"the profile's trace holds no grid for "
                                 f"{name[:60]}")
        found.append((float(e["ts"]), name, tuple(grid)))
    return [(name, grid) for _, name, grid in sorted(found)]


# K1's launches in a profile: one launch of the affinity core,
# affinity_panel_kernel<TN>, for each panel width the call takes, grid
# (rows / rows a block, panels).
CORE_TRACE = ("affinity_panel_kernel",)


def core_builds(grids, ex2_build: dict) -> tuple:
    """(builds an entry, MUFU.EX2 an entry) of K1 from its profiled
    launches [(name, grid)]: a block builds each entry of its rows once
    for every panel of its grid, so the launches' panels summed are the
    builds an entry, each times the MUFU.EX2 its instantiation's SASS
    issues for one build (ex2_build, by TN; the EX2 count is None without
    cuobjdump). Every launch must cover the same rows."""
    launches = [(int(re.search(r"affinity_panel_kernel<(\d+)>",
                               name).group(1)), gx, gy)
                for name, (gx, gy, _) in grids]
    if not launches or len({gx for _, gx, _ in launches}) != 1:
        raise AssertionError(f"K1's core launches cover different rows or "
                             f"none: {grids}")
    builds = sum(gy for _, _, gy in launches)
    ex2 = (sum(gy * ex2_build[tn] for tn, _, gy in launches)
           if all(tn in ex2_build for tn, _, _ in launches) else None)
    return builds, ex2


def core_expf(row: dict, grids, ex2_build: dict, mpad: int,
              where: str) -> None:
    """Put K1's measured builds an entry and MUFU.EX2 an entry
    (core_builds) into its kernels-line row; fail where Mpad fits one
    panel (AFF_PANEL_COLS) and an entry was built more than once, or where
    a build issued other than one MUFU.EX2."""
    from nle_tpu_torch.ops.kernels.affinity_kernel import AFF_PANEL_COLS

    builds, ex2 = core_builds(grids, ex2_build)
    row["builds_per_entry"] = builds
    row["expf_per_entry"] = ex2
    print(f"  {row['name']} in {where}: {builds} build(s) of each entry at "
          f"mpad {mpad}, "
          f"{'not measured (no cuobjdump)' if ex2 is None else ex2} "
          "MUFU.EX2 an entry")
    if mpad <= AFF_PANEL_COLS and builds != 1:
        raise AssertionError(f"{row['name']} in {where}: {builds} builds "
                             f"an entry at mpad {mpad}")
    if ex2 is not None and ex2 != builds:
        raise AssertionError(f"{row['name']} in {where}: {ex2} MUFU.EX2 an "
                             f"entry for {builds} build(s)")


def profile_grids(torch, fn, needles) -> list:
    """kernel_grids of one call of fn under the profiler."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return kernel_grids(prof, needles)


def profile_call(torch, label: str, fn, mp: float, needles=(),
                 readings: dict | None = None) -> tuple:
    """Profile one warm call of fn: wall, device time (the sum of the
    device-side events; one stream, so they do not overlap), busy share,
    host ms per stage and the device ms per kernel. Returns ([(device ms,
    launches, kernel name)], the largest first; kernel_grids of the
    kernels named by needles); `readings`, when given, receives wall_ms
    and device_ms."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    if readings is not None:
        readings.update(wall_ms=wall_ms, device_ms=device_ms)
    print(f"{label}: wall {wall_ms:.1f} ms "
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
    return kernels, (kernel_grids(prof, needles) if needles else [])


# The u8 edit's gather and scatter by perm: one of each an edit, but the
# scatter alone for a fused first edit or a cached training channel.
PERM_KERNELS = ("perm_gather_u8", "perm_scatter_u8")
STREAMING_KERNELS = ("streaming_halfstep", "streaming_halfstep_ptiled",
                     "streaming_ap", "streaming_atb", "streaming_gram")
DENSE_KERNELS = ("sinkhorn_halfstep_int16", "sinkhorn_halfstep_f32",
                 "sinkhorn_halfstep_bf16", "sinkhorn_halfstep_tiled",
                 "scaled_gram", "scaled_matmul")
SINKHORN_KERNELS = ("sinkhorn_halfstep_int16", "sinkhorn_halfstep_f32",
                    "sinkhorn_halfstep_bf16", "sinkhorn_halfstep_tiled")


def recompose(lab, edit_packed, perm):
    """BGR output from the Lab frame and a packed u8 L edit."""
    from nle_tpu_torch.color.lab import lab_to_bgr_u8_np

    edit = edit_packed.cpu().numpy()
    unpacked = np.empty_like(edit)
    unpacked[perm] = edit
    out = lab.copy()
    out[..., 0] = unpacked.reshape(lab.shape[:2])
    return lab_to_bgr_u8_np(out)


# Mangled-name pieces of the kernels whose entry loop chip_smoke counts
# (each must be found, or [2] fails): K8's one-build kernel in each of its
# instantiations (cols, rows; the csrc's HS_TILES), K10 (R = 1: a step of
# 4 rows x 5 columns a thread, AP_TILES), K11 (R = 1: 16 samples x 4 rows
# a thread, AT_TILES) and the two-pass K9's first pass (K11's kernel with
# the reciprocal; its second pass is K10's); and the affinity core (K1,
# K2's contract, the fp32 K12's phi step) in its three column-panel widths (8 x TN
# outputs a thread, TN = 12, 8, 4), whose main loop builds AFF_BUILD
# entries a thread a step, one MUFU.EX2 each.
SASS_KEYS = ("stream_halfstep_kernelILi4ELi4E",
             "stream_halfstep_kernelILi8ELi4E",
             "stream_halfstep_kernelILi8ELi2E", "stream_ap_kernelILi1E",
             "stream_atb_kernelILi1ELb0E", "stream_atb_kernelILi1ELb1E")
CORE_KEYS = tuple(f"affinity_panel_kernelILi{tn}E" for tn in (12, 8, 4))


def sass_per_entry(lib_path: str) -> dict:
    """fp32-pipe issue cost of one affinity entry in each streaming
    kernel's inner loop: the SASS instructions of the innermost loop that
    holds the exp (MUFU.EX2), over the number of exps in it. Returns
    {kernel: (instructions, exps, barriers, instructions of the finalizing
    warp's branch, FFMAs)}; empty when cuobjdump is missing."""
    import re
    import shutil

    from nle_tpu_torch.ops.kernels import _build

    tool = next((t for t in (
        os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
        shutil.which("cuobjdump")) if t and os.path.exists(t)), None)
    if tool is None:
        return {}
    out = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                         text=True, timeout=120).stdout
    found = {}
    keys = SASS_KEYS + CORE_KEYS
    for chunk in out.split("Function : ")[1:]:
        name = chunk.split("\n", 1)[0].strip()
        key = next((k for k in keys if k in name), None)
        if key is None:
            continue
        # Instructions read "/*addr*/ [@P] OP args ;"; a branch names its
        # target address ("BRA 0x12e0"). A backward branch closes a loop.
        addrs, insts, branches = {}, [], []
        for line in chunk.splitlines():
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
            if not m:
                continue
            addrs[int(m.group(1), 16)] = len(insts)
            insts.append(m.group(2))
            b = re.search(r"\bBRA\s+(0x[0-9a-f]+)", m.group(2))
            if b:
                branches.append((len(insts) - 1, int(b.group(1), 16)))
        loops = [(addrs[t], i) for i, t in branches
                 if t in addrs and addrs[t] < i]
        loops = [(a, b) for a, b in loops
                 if any("MUFU.EX2" in x for x in insts[a:b + 1])]
        if not loops:
            continue
        a, b = min(loops, key=lambda ab: ab[1] - ab[0])
        # The finalizing warp's branch (K8: x = 1 / w, MUFU.RCP, for one
        # warp of the block): what a forward branch inside the loop skips
        # when that holds the reciprocal and no exp.
        final = set()
        for i, t in branches:
            if a <= i <= b and t in addrs and i < addrs[t] <= b + 1:
                skipped = insts[i + 1:addrs[t]]
                if (any("MUFU.RCP" in x for x in skipped)
                        and not any("MUFU.EX2" in x for x in skipped)):
                    final.update(range(i + 1, addrs[t]))
        body = [k for k in range(a, b + 1) if insts[k].split()[0] != "NOP"]
        found[key] = (len(body),
                      sum("MUFU.EX2" in insts[k] for k in body),
                      sum("BAR.SYNC" in insts[k] for k in body),
                      sum(k in final for k in body),
                      sum(insts[k].split()[0].startswith("FFMA")
                          for k in body))
    return found


def onebuild_key(qpad: int, ppad: int) -> str:
    """SASS_KEYS' name of K8's one-build kernel as halfstep_plan launches
    it at (qpad, ppad)."""
    from nle_tpu_torch.ops.kernels.streaming_kernel import halfstep_plan

    plan = halfstep_plan(qpad, ppad)
    return f"stream_halfstep_kernelILi{plan.cols}ELi{plan.rows}E"


def onebuild_entries(key: str, nbar: int) -> int | None:
    """Entries K8's one-build kernel builds in a loop that holds nbar
    barriers: each row group (one barrier) builds rows x cols entries, the
    template arguments in the mangled name ("...kernelILi4ELi4E"). None
    for the other kernels."""
    import re

    m = re.search(r"stream_halfstep_kernelILi(\d+)ELi(\d+)E", key)
    return None if m is None else nbar * int(m.group(1)) * int(m.group(2))


def capacity_path(torch, NLEFilter, _build, tag: str, shape, args,
                  seed: int):
    """NLEFilter(factored=True).train_and_enhance on a structured frame,
    cold then warm (bitwise equal), a profiled warm call, then the
    streaming kernels held against their float64 plain versions on this
    frame's own operands. The cold run's own counts must show the phi-free
    route alone: the half-step (K8, or K9 past Ppad 1792 with the s0 pass
    on K10) at least 2 x iters times, K10, K11 and K12, and no dense kernel.
    Returns (the cold run's launch counts, {kernel: (max_abs_err, max
    err/bound)}, the f32 operands for timing)."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        MAX_STREAM_P_FUSED,
        P_ALIGN,
    )
    from nle_tpu_torch.ops.pipeline import bucket_m, ka_eigh_host64
    from nle_tpu_torch.ops.sampling import sample_grid

    h, w = shape
    n = h * w
    t0 = time.perf_counter()
    big = structured_frame(h, w, seed=seed)
    # The sampled pixels' Lab values alone give stage 1's rank (Lab is per
    # pixel), so p, m and the bucket mb print without converting the frame.
    grid = sample_grid(h, w, args[0], args[1])
    p = grid.n_samples
    Ls = bgr_to_lab_u8_np(big[grid.sel_rows, grid.sel_cols][None])[0, :, 0]
    m = ka_eigh_host64(Ls.astype(np.float64), grid.sel_rows, grid.sel_cols,
                       args[2], args[3], 1e-10)[1].shape[0]
    ppad = -(-p // P_ALIGN) * P_ALIGN
    print(f"{tag} capacity path: {h}x{w} ({n} px) frame made in "
          f"{time.perf_counter() - t0:.1f} s; args "
          f"{' '.join(map(str, args))}: p={p}, m={m}, mb={bucket_m(m, p)}, "
          f"Ppad={ppad}")
    del grid
    wide = ppad > MAX_STREAM_P_FUSED
    half = "streaming_halfstep_ptiled" if wide else "streaming_halfstep"
    iters = args[4]
    need = {half: 2 * iters + (0 if wide else 1), "streaming_ap": 2 if wide
            else 1, "streaming_atb": 1, "streaming_gram": 1}
    barred = DENSE_KERNELS + ("affinity_matmul", "streaming_halfstep_ptiled"
                              if not wide else "streaming_halfstep")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    _build.reset_launches()
    t0 = time.perf_counter()
    cold = NLEFilter(device="cuda", factored=True).train_and_enhance(
        big, *args, weights=WEIGHTS)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    counts = dict(_build.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"  cold {cold_s:.3f} s; launches {counts}")
    print(f"  peak device memory {peak / 2**30:.3f} GiB = {peak / n:.1f} "
          f"B/pixel ({before / 2**20:.1f} MiB held before the run; phi would "
          f"be {4 * -(-m // 128) * 128} B/pixel, V 200)")
    for name, least in need.items():
        if counts[name] < least:
            raise AssertionError(f"{tag}: {name} ran {counts[name]} times, "
                                 f"fewer than {least}")
    for name in barred:
        if counts[name]:
            raise AssertionError(f"{tag}: {name} launched on the phi-free "
                                 "path")
    if not peak / n < CAP_BYTES_PER_PIXEL:
        raise AssertionError(f"peak {peak / n:.1f} B/pixel >= "
                             f"{CAP_BYTES_PER_PIXEL}")
    f = NLEFilter(device="cuda", factored=True)
    t0 = time.perf_counter()
    f.train_for_enhancement(big, *args)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = f.enhance(big, WEIGHTS)
    torch.cuda.synchronize()
    apply_s = time.perf_counter() - t0
    mp = n / 1e6
    print(f"  warm: train {train_s:.3f} s, apply {apply_s:.3f} s, total "
          f"{train_s + apply_s:.3f} s = {mp / (train_s + apply_s):.3f} MP/s; "
          f"cold == warm bitwise: {bool(np.array_equal(cold, warm))}; "
          f"PSNR(output, input) {psnr(warm, big):.2f} dB")
    if cold.shape != big.shape or cold.dtype != np.uint8:
        raise AssertionError(f"{tag} output {cold.shape} {cold.dtype}")
    if not np.array_equal(cold, warm):
        raise AssertionError(f"{tag}: cold and warm runs differ")
    del f, cold
    kernels, _ = profile_call(
        torch, f"  profiled warm {mp:.0f} MP train_and_enhance",
        lambda: NLEFilter(device="cuda", factored=True).train_and_enhance(
            big, *args, weights=WEIGHTS), mp)
    # K12 once a train, in its float64 form (its tiles, then their reduce).
    grams = {k: sum(n for _, n, name in kernels
                    if re.search(rf"\b{k}\b", name))
             for k in ("stream_sample_gram_kernel",
                       "stream_sample_gram_reduce_kernel")}
    print(f"  K12's kernels in the profiled call: {grams}")
    if set(grams.values()) != {1}:
        raise AssertionError(f"{tag}: K12's float64 form launched {grams}")
    # One entry-building launch per half-step: K8's one-build kernel once
    # for each of the 2 x iters half-steps (K9 included), each followed by
    # the fixed-order reduction of its partials, and no two-pass K9 (K11's
    # kernel with the reciprocal epilogue). A profile with no device
    # events fails here.
    built = sum(n for _, n, k in kernels if "stream_halfstep_kernel" in k)
    reduced = sum(n for _, n, k in kernels if "reduce_partials" in k)
    two_pass = sum(n for _, n, k in kernels
                   if "stream_atb_kernel<1, true>" in k)
    print(f"  {built} launches of K8's one-build kernel for {2 * iters} "
          f"half-steps, {reduced} of the partials' reduction (all kernels); "
          f"{two_pass} of the two-pass K9's first pass")
    if built != 2 * iters or reduced < built or two_pass:
        raise AssertionError(f"{tag}: {built} one-build launches for "
                             f"{2 * iters} half-steps, {reduced} reductions, "
                             f"{two_pass} two-pass")
    # K10's kernel runs twice a call, the s0 pass (counted as K8's launch
    # up to Ppad 1792) and the apply's projection; K11's once, the apply.
    profiled = {"streaming_ap": sum(n for _, n, k in kernels
                                    if "stream_ap_kernel" in k),
                "streaming_atb": sum(n for _, n, k in kernels
                                     if "stream_atb_kernel<1, false>" in k)}
    print(f"  K10's kernel x{profiled['streaming_ap']}, K11's "
          f"x{profiled['streaming_atb']} in the profiled call")
    if profiled != {"streaming_ap": 2, "streaming_atb": 1}:
        raise AssertionError(f"{tag}: K10/K11 kernel launches {profiled}")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    L = bgr_to_lab_u8_np(big)[..., 0].astype(np.float32)
    del big
    op = path_operands(torch, L, args, torch.device("cuda"))
    del L
    errs, timing = hold_streaming(torch, op, 1e-10, f"{mp:.0f} MP")
    timing.update(p=op.p, mb=op.mb, mpad=op.mpad, sw=op.sw, pw=op.pw,
                  profiled=profiled, edit=warm,
                  peak_bytes=peak - before)
    del op
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"  {mp:.0f} MP kernel checks: {time.perf_counter() - t0:.1f} s")
    return counts, errs, timing


def cross_paths(torch, NLEFilter, _build, img, dense_out) -> dict:
    """[8] the factored path on card vs CPU and vs the dense path, and the
    streaming train vs the dense train; returns the streaming run's
    launch counts."""
    small = structured_frame(128, 192, seed=5)
    sargs = (10, 10, 100.0, 30.0, 10, 10)
    g1 = NLEFilter(device="cuda", factored=True).train_and_enhance(
        small, *sargs, weights=WEIGHTS)
    g2 = NLEFilter(device="cuda", factored=True).train_and_enhance(
        small, *sargs, weights=WEIGHTS)
    cpu = NLEFilter(device="cpu", factored=True).train_and_enhance(
        small, *sargs, weights=WEIGHTS)
    db = psnr(g1, cpu)
    print(f"[8a] factored, 128x192: cuda vs cpu {db:.2f} dB, two cuda runs "
          f"bitwise equal: {bool(np.array_equal(g1, g2))}")
    if not db >= 45.0:
        raise AssertionError(f"factored cuda vs cpu {db:.2f} dB < 45")
    if not np.array_equal(g1, g2):
        raise AssertionError("factored: two cuda runs differ")

    fac = NLEFilter(device="cuda", factored=True).train_and_enhance(
        img, *MAIN_ARGS, weights=WEIGHTS)
    db = psnr(fac, dense_out)
    print(f"[8b] factored vs dense split path at 1 MP: {db:.2f} dB")
    if not db >= 45.0:
        raise AssertionError(f"factored vs dense {db:.2f} dB < 45")

    outs, counts, (_, L, _) = train_routes(
        torch, _build, "[8c]", structured_frame(*STREAM_SHAPE, seed=9),
        MAIN_ARGS, (("streaming", True, None), ("dense", False, None)))
    db = psnr(outs["streaming"], outs["dense"])
    print(f"  streaming vs dense edit: {db:.2f} dB")
    if not db >= 45.0:
        raise AssertionError(f"[8c] streaming vs dense {db:.2f} dB < 45")
    # K8 and K12 on this frame's own operands, held to float64.
    op = path_operands(torch, L, MAIN_ARGS, torch.device("cuda"))
    _, t = hold_streaming(torch, op, 1e-10, "[8c] 4 MP", halfstep_only=True)
    hold_gram(torch, op, "[8c] 4 MP", t["fa_rows"], t["fb_cols"],
              t["x"][None].contiguous())
    del op, t
    torch.cuda.empty_cache()
    return counts["streaming"]


def train_routes(torch, _build, tag: str, frame: np.ndarray, args, routes):
    """train_filter on the card along each route (label, streaming,
    NLE_SINKHORN_INT16), each with the first edit fused and its own launch
    counts, which must show the route: a streaming run the half-step (K8,
    or K9 past Ppad 1792), K12 and K1 and no dense kernel; a dense run
    (streaming False, or None: the auto rule) K3 on the default int16
    carrier or K4 under NLE_SINKHORN_INT16=off, and no streaming kernel.
    Returns ({label: BGR output}, {label: counts}, (lab, L, grid))."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        MAX_STREAM_P_FUSED,
        P_ALIGN,
    )
    from nle_tpu_torch.ops.pipeline import pack_channel, train_filter
    from nle_tpu_torch.ops.sampling import sample_grid

    h, w = frame.shape[:2]
    lab = bgr_to_lab_u8_np(frame)
    L = lab[..., 0].astype(np.float32)
    grid = sample_grid(h, w, args[0], args[1])
    wide = -(-grid.n_samples // P_ALIGN) * P_ALIGN > MAX_STREAM_P_FUSED
    half = "streaming_halfstep_ptiled" if wide else "streaming_halfstep"
    iters = args[4]
    outs, counts = {}, {}
    for label, mode, env in routes:
        packed = torch.from_numpy(np.ascontiguousarray(
            pack_channel(L, grid.perm)[0])).cuda()
        _build.reset_launches()
        t0 = time.perf_counter()
        with knobs(NLE_SINKHORN_INT16=env):
            _, _, edit = train_filter(L, *args, device="cuda", grid=grid,
                                      packed_y=packed, edit_weights=WEIGHTS,
                                      streaming=mode, pixel_order=False)
        outs[label] = recompose(lab, edit, grid.perm)
        torch.cuda.synchronize()
        st = counts[label] = dict(_build.LAUNCHES)
        print(f"{tag} {h}x{w} {' '.join(map(str, args))} (p="
              f"{grid.n_samples}) {label} train_filter(streaming={mode}): "
              f"{time.perf_counter() - t0:.3f} s; launches {st}")
        del edit, packed
        torch.cuda.empty_cache()
        if mode:
            took = (st[half] >= 2 * iters + (0 if wide else 1)
                    and st["streaming_gram"] >= 1
                    and st["affinity_matmul"] >= 1
                    and not any(st[k] for k in DENSE_KERNELS))
        else:
            kernel = ("sinkhorn_halfstep_f32" if env == "off"
                      else "sinkhorn_halfstep_int16")
            took = (st[kernel] >= 2 * iters
                    and not any(st[k] for k in STREAMING_KERNELS))
        if not took:
            raise AssertionError(f"{tag}: the {label} train did not take its "
                                 f"route: {st}")
    return outs, counts, (lab, L, grid)


def free_api_chain(torch, L: np.ndarray, dtype, dev,
                   eigh_method: str = "xla"):
    """The reference's dense free functions on a luminance frame L (H, W
    u8) at the rock2 parameters, in `dtype` on `dev`: host stage 1, phi
    (N, m) as the plain routes build it (`plain_phi`: the features, then
    affinity_matmul_plain), `sinkhorn` and `orthogonalize`. Returns (Wa's
    and Wab's shapes, the largest |row sum - 1| of [Wa Wab], V in pixel
    order, S, m)."""
    from nle_tpu_torch.ops.affinity import bandwidth_weights
    from nle_tpu_torch.ops.orthogonalize import orthogonalize
    from nle_tpu_torch.ops.pipeline import (
        grid_coords,
        host_stage1,
        pack_channel,
        plain_phi,
    )
    from nle_tpu_torch.ops.sampling import sample_grid
    from nle_tpu_torch.ops.sinkhorn import sinkhorn

    rows_s, cols_s, hx, hy, iters, k = MAIN_ARGS
    grid = sample_grid(*L.shape, rows_s, cols_s)
    Um64, lam64, m, _ = host_stage1(L, grid, hx, hy, 1e-10)

    def card(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    y = card(pack_channel(L, grid.perm)[0])
    rr, cc = (t.to(dtype) for t in grid_coords(grid, dev))
    sw, pw = bandwidth_weights(hx, hy, dtype)
    phi = plain_phi(y, rr, cc, card(Um64), card(Um64 / lam64[None, :]), sw,
                    pw, p=grid.n_samples)
    Wa, Wab = sinkhorn(phi, card(lam64), iters)
    del phi
    V, S = orthogonalize(Wa, Wab, k, eigh_method=eigh_method)
    devices = {t.device.type for t in (Wa, Wab, V, S)}
    if devices != {dev.type}:
        raise AssertionError(f"[16] the free functions left {dev}: "
                             f"{devices}")
    rows = float((Wa.sum(1) + Wab.sum(1) - 1).abs().max())
    order = torch.from_numpy(grid.unpack_indices()).to(dev)
    return tuple(Wa.shape), tuple(Wab.shape), rows, V[order], S, m


def free_api_phase(torch, img, card: str, dev) -> None:
    """[16] the reference's dense free functions (ops/sinkhorn.sinkhorn,
    ops/orthogonalize.orthogonalize) on the card, on [5]'s frame at the
    rock2 parameters: (a) in float64, gated >= 45 dB from the port's own
    float64 route (train_filter(dtype=torch.float64)) on the same L
    channel; (b) in float32 with eigh_method="host64" (the f32 chain is the
    known chaos case of host_chain64's docstring): its dB from (a), a
    reading."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.ops.pipeline import apply_filter_u8, train_filter
    from nle_tpu_torch.ops.transform import transform_eigenvalues

    t16 = time.perf_counter()
    L = bgr_to_lab_u8_np(img)[..., 0]
    n = L.size
    y_u8 = torch.from_numpy(L.reshape(-1)).to(dev)

    def edit(V, S):
        return apply_filter_u8(V, transform_eigenvalues(S, WEIGHTS),
                               y_u8).cpu().numpy()

    peak = PeakMeter(torch)
    _build.reset_launches()
    t0 = time.perf_counter()
    wa_shape, wab_shape, rows, V, S, m = free_api_chain(torch, L,
                                                        torch.float64, dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sum(_build.LAUNCHES.values())
    gib = (torch.cuda.max_memory_allocated() - peak.base) / 2**30
    edit_a = edit(V, S)
    print(f"[16a] sinkhorn + orthogonalize in float64 on the card, [5]'s "
          f"frame ({n} px, m = {m}): Wa {wa_shape}, Wab {wab_shape}; "
          f"wall {wall:.3f} s, peak {gib:.3f} GiB above the "
          f"{peak.base / 2**30:.3f} held before ({card}); largest |row sum "
          f"- 1| of [Wa Wab] {rows:.3e}; kernel launches {launches}")
    if wa_shape != (m, m) or wab_shape != (m, n - m):
        raise AssertionError(f"[16a] Wa {wa_shape}, Wab {wab_shape} at m = "
                             f"{m}, N = {n}")
    del V
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    V64, S64 = train_filter(L, *MAIN_ARGS, device=dev, dtype=torch.float64)
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    nz = S64 > 0
    rel = float(((S - S64).abs()[nz] / S64[nz]).max())
    db = psnr(edit_a, edit(V64, S64))
    del V64
    print(f"  the float64 route (train_filter(dtype=torch.float64)): wall "
          f"{wall64:.3f} s ({card}); max |Sq - S| / S {rel:.3e}; edit "
          f"{db:.2f} dB from it")
    if not db >= 45.0:
        raise AssertionError(f"[16a] {db:.2f} dB from the float64 route")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    *_, V32, S32, _ = free_api_chain(torch, L, torch.float32, dev,
                                     "host64")
    torch.cuda.synchronize()
    wall32 = time.perf_counter() - t0
    db32 = psnr(edit(V32, S32), edit_a)
    print(f"[16b] the same chain in float32, eigh_method='host64': wall "
          f"{wall32:.3f} s ({card}); {S32.dtype}, on {V32.device.type}; "
          f"edit {db32:.2f} dB from [16a]'s (a reading)")
    del V32
    torch.cuda.empty_cache()
    print(f"[16] the free-function API: {time.perf_counter() - t16:.1f} s "
          f"({card})")


# [17b] the input shapes (width, height) of the reference's data files,
# as SURVEY.md:117-121 records them; the files themselves are not read.
GOLDEN_SHAPES = {
    "flower-50.bmp": (400, 267), "bird.bmp": (365, 501),
    "canyon-dawn-20.bmp": (667, 1000), "brickwall-20.bmp": (600, 406),
    "conifer-10.bmp": (400, 600), "forest-10.bmp": (491, 736),
    "snow-mountain-15.bmp": (691, 389), "paper.jpg": (460, 463),
    "rock2.jpg": (876, 584), "red-cherries-10.bmp": (416, 624),
    "taj-rgb-noise.jpg": (300, 300)}


def cphi_limit(limit: int | None):
    """NLE_CPHI_BYTES for the calls inside (the port reads it per frame):
    0 sends every frame to the split layout; None leaves the default."""
    return knobs() if limit is None else knobs(NLE_CPHI_BYTES=str(limit))


def noise_train(torch, NLEFilter, _build, limit: int | None, **env):
    """The 120x120 uniform-noise frame, whose int16 carrier guard trips,
    through train_and_enhance under NLE_CPHI_BYTES = limit and the knobs
    in env. Returns (output, launches, stage-2a calls)."""
    seen = []
    _build.reset_launches()
    with cphi_limit(limit), knobs(**env), stage2a_layouts(seen):
        out = NLEFilter(device="cuda").train_and_enhance(
            noise_frame(), 10, 10, 5.0, 30.0, GUARD_ITERS, 5, weights=WEIGHTS)
    torch.cuda.synchronize()
    if out.shape != (120, 120, 3) or out.dtype != np.uint8:
        raise AssertionError(f"noise frame output {out.shape} {out.dtype}")
    return out, dict(_build.LAUNCHES), seen


def guard_paths(torch, NLEFilter, _build) -> dict:
    """[5]'s guard fallback on each layout the noise frame can take: the
    small layout (its default: a trip retrains the small layout's f32
    Sinkhorn on K4; no K6 or K7) and, under NLE_CPHI_BYTES=0, the split
    layout of the frames past it (a trip retrains the assembled f32
    layout: K4, then K6 and K7). Gates the stage-2a calls in order, the
    trip, K4 >= 2 x GUARD_ITERS, K6 once a stage-2a call on the split
    and assembled layouts (none on the small one) and K7 once on the
    assembled factor. Returns {path: launch counts}."""
    paths = {}
    for path, limit, want, (gram, matmul) in (
            ("guard_frame", None, ["small", "small"], (0, 0)),
            ("guard_frame_split", 0, ["split", "assembled"], (2, 1))):
        _, counts, seen = noise_train(torch, NLEFilter, _build, limit)
        print(f"  noise frame 120x120 (guard fallback) from the {want[0]} "
              f"layout: stage 2a {seen}; launches {counts}")
        if ([c["layout"] for c in seen] != want
                or not seen[0]["crush"] > 0.2 or seen[1]["crush"] != -1.0
                or counts["sinkhorn_halfstep_f32"] < 2 * GUARD_ITERS
                or counts["scaled_gram"] != gram
                or counts["scaled_matmul"] != matmul):
            raise AssertionError(f"[5] {path}: not the guard's route from "
                                 f"the {want[0]} layout")
        paths[path] = counts
    return paths


def small_launches(counts: dict, iters: int) -> None:
    """[17a]'s route: K1 once, K3 twice an iteration, and no K4, K6, K7
    or streaming kernel (the gram and V tail are plain products); the
    fused first edit's scatter to pixel order once."""
    want = {"affinity_matmul": 1, "sinkhorn_halfstep_int16": 2 * iters,
            "perm_scatter_u8": 1}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise AssertionError(f"[17a] not the small layout's route: "
                             f"launches {got}, expected {want}")


def run_config(torch, NLEFilter, frame, params, weights, denoise=None,
               **train):
    """One configuration through NLEFilter on the card: train_and_enhance,
    or train_for_denoise + denoise when `denoise` is (sigma_color,
    sigma_space, shrink). Returns (output, wall s)."""
    t0 = time.perf_counter()
    f = NLEFilter(device="cuda", **train)
    if denoise is None:
        out = f.train_and_enhance(frame, *params, weights=weights)
    else:
        sigma_color, sigma_space, shrink = denoise
        f.train_for_denoise(frame, *params, sigma_color, sigma_space)
        out = f.denoise(frame, shrink, sigma_color, sigma_space)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hold_small_kernels(torch, frame, params) -> dict:
    """[17a]'s kernels on its own card tensors, each against its plain
    version within [3]'s bounds: K1 on the frame's rest pixels against
    the p samples (the assembled layout's call, no out_rows), then K3 on
    the int16 carrier of every row of the assembled (npad, mpad) factor
    and K4 on the f32 factor (the guard's retrain on this layout). Returns
    {kernel name: {field + "_small_17a": value}} for the kernels line."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.kernels.affinity_kernel import (
        affinity_matmul_kernel,
        affinity_matmul_plain,
    )
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        padded_shape,
        quantize_int16,
        sinkhorn_halfstep,
        sinkhorn_halfstep_plain,
    )

    dev = torch.device("cuda")
    L = bgr_to_lab_u8_np(frame)[..., 0].astype(np.float32)
    op = path_operands(torch, L, params, dev)
    p, n, mb = op.p, op.n, op.mb
    npad, mpad = padded_shape(n, mb)
    eps = 1e-10
    out = {}

    def keep(name, err, fn, plain, nbytes, flops):
        ms, plain_ms = cuda_ms(torch, fn, reps=10), cuda_ms(torch, plain)
        bms, by = bound_ms(nbytes, flops)
        out[name] = {"max_abs_err_small_17a": err[0],
                     "err_over_bound_small_17a": err[1],
                     "ms_small_17a": ms, "plain_ms_small_17a": plain_ms,
                     "bound_ms_small_17a": bms, "bound_by_small_17a": by}
        print(f"  {name} at [17a]'s shapes (n {n}, p {p}, mb {mb}, npad "
              f"{npad}, mpad {mpad}): kernel {ms:.3f} ms, plain "
              f"{plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")

    args = (op.fa, op.fb, op.Uinv, op.sw, op.pw)
    phib = affinity_matmul_kernel(*args)
    want = affinity_matmul_plain(*args)
    absb = affinity_matmul_plain(op.fa, op.fb, op.Uinv.abs(), op.sw, op.pw)
    err = check("[17a] K1 affinity_matmul", phib - want,
                (2 * p + 4) * U * absb + 1e-30)
    del want, absb
    nb = n - p
    keep("affinity_matmul", err, lambda: affinity_matmul_kernel(*args),
         lambda: affinity_matmul_plain(*args),
         4 * (3 * nb + p * mb + nb * mb),
         2 * nb * p * mb + ENTRY_FLOPS * nb * p)
    phi = torch.zeros((npad, mpad), device=dev)
    phi[:p, :mb] = op.Um
    phi[p:n, :mb] = phib
    del phib
    lam_pad = torch.nn.functional.pad(op.lam, (0, mpad - mb))
    s0 = phi.T @ torch.ones(npad, device=dev)
    q16, scale, _ = quantize_int16(phi)
    tq = (scale * (lam_pad * s0)).contiguous()
    _, err = hold_halfstep(torch, "[17a] K3 sinkhorn int16", q16, tq, eps)
    keep("sinkhorn_halfstep_int16", err,
         lambda: sinkhorn_halfstep(q16, tq, eps),
         lambda: sinkhorn_halfstep_plain(q16, tq, eps),
         2 * npad * mpad + 4 * (npad + 2 * mpad), 4 * n * mb)
    del q16
    t32 = (lam_pad * s0).contiguous()
    _, err = hold_halfstep(torch, "[17a] K4 sinkhorn f32", phi, t32, eps)
    keep("sinkhorn_halfstep_f32", err,
         lambda: sinkhorn_halfstep(phi, t32, eps),
         lambda: sinkhorn_halfstep_plain(phi, t32, eps),
         4 * (npad * mpad + npad + 2 * mpad), 4 * n * mb)
    del phi
    torch.cuda.empty_cache()
    return out


def small_layout_phase(torch, NLEFilter, _build, card: str):
    """[17a] the small layout at its full width: the denoise
    configuration's sampler on the largest square structured frame that
    stage2_dense_small admits, cold then warm (bitwise equal), its
    launches (small_launches), its kernels held on its own tensors
    (hold_small_kernels), its peak bytes within the streaming rule's
    DENSE_PEAK_PER_PHI_BYTE x phi plus the carrier prep's temporaries
    (PREP_BYTES_PER_ENTRY), >= 45 dB from the same frame through the split
    layout and from the port's float64 route on the card. Then a frame of
    ~RAISED_PHI bytes of phi under a raised NLE_CPHI_BYTES: the small
    layout, its peak within DENSE_PEAK_PER_PHI_BYTE x phi (the rule's own
    gate), >= 45 dB from its split layout. Returns ({path: launch counts},
    {kernel name: readings at [17a]'s shapes})."""
    from nle_tpu_torch.golden_configs import DENOISE_CONFIG
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import PREP_CHUNK_ROWS
    from nle_tpu_torch.ops.pipeline import (
        DENSE_PEAK_PER_PHI_BYTE,
        cphi_bytes_limit,
        padded_shape,
        stage2_dense_small,
    )

    params = DENOISE_CONFIG[2]
    iters, p = params[4], params[0] * params[1]
    side = 1
    while stage2_dense_small((side + 1) ** 2, p):
        side += 1
    frame = structured_frame(side, side, seed=17)
    n = side * side
    npad, mpad = padded_shape(n, p)
    phi = 4 * npad * mpad
    print(f"[17a] the small layout: {side}x{side} ({n} px), the denoise "
          f"sampler {' '.join(map(str, params))}; phi {phi} B at mpad "
          f"{mpad}, NLE_CPHI_BYTES {cphi_bytes_limit()} ({side + 1}x"
          f"{side + 1} would take the split layout)")
    seen = []
    peak = PeakMeter(torch)
    _build.reset_launches()
    with stage2a_layouts(seen):
        cold, cold_s = run_config(torch, NLEFilter, frame, params, WEIGHTS)
    counts = dict(_build.LAUNCHES)
    call = seen[0]
    peak_b = torch.cuda.max_memory_allocated() - peak.base
    # Below ~4 prep chunks of rows the carrier prep's temporaries pass the
    # ratio's slack (pipeline.py, DENSE_PEAK_PER_PHI_BYTE).
    allowed = (DENSE_PEAK_PER_PHI_BYTE * phi
               + PREP_BYTES_PER_ENTRY * min(npad, PREP_CHUNK_ROWS) * mpad)
    warm, warm_s = run_config(torch, NLEFilter, frame, params, WEIGHTS)
    same = bool(np.array_equal(cold, warm))
    print(f"  stage 2a {call}; launches {counts}; cold {cold_s:.3f} s, "
          f"warm {warm_s:.3f} s ({card}); peak {peak_b} B above the "
          f"{peak.base} held before = {peak_b / phi:.3f} x phi (allowed "
          f"{allowed / phi:.3f}: {DENSE_PEAK_PER_PHI_BYTE} and the prep's "
          f"{PREP_BYTES_PER_ENTRY} B an entry of a {PREP_CHUNK_ROWS}-row "
          f"chunk); cold == warm bitwise: {same}")
    if (len(seen) != 1 or call["layout"] != "small"
            or padded_shape(n, call["mb"])[1] != mpad):
        raise AssertionError(f"[17a] took {seen}")
    small_launches(counts, iters)
    if not same or cold.shape != frame.shape or cold.dtype != np.uint8:
        raise AssertionError("[17a] two trains differ, or a bad output")
    if not peak_b <= allowed:
        raise AssertionError(f"[17a] peak {peak_b} B > {allowed:.0f}")
    errs = hold_small_kernels(torch, frame, params)
    with cphi_limit(0), stage2a_layouts(seen):
        split, split_s = run_config(torch, NLEFilter, frame, params, WEIGHTS)
    f64, f64_s = run_config(torch, NLEFilter, frame, params, WEIGHTS,
                            dtype=torch.float64)
    for label, ref, wall in (("the split layout", split, split_s),
                             ("the float64 route", f64, f64_s)):
        db = psnr(warm, ref)
        print(f"  vs {label} (wall {wall:.3f} s): {db:.2f} dB")
        if not db >= 45.0:
            raise AssertionError(f"[17a] {db:.2f} dB from {label}")
    if seen[-1]["layout"] != "split":
        raise AssertionError(f"[17a] NLE_CPHI_BYTES=0 took {seen[-1]}")
    del cold, warm, split, f64

    big_side = int((RAISED_PHI / (4 * mpad)) ** 0.5)
    big = structured_frame(big_side, big_side, seed=171)
    big_n = big_side * big_side
    seen = []
    with cphi_limit(2 * RAISED_PHI):
        peak = PeakMeter(torch)
        _build.reset_launches()
        with stage2a_layouts(seen):
            out, big_s = run_config(torch, NLEFilter, big, params, WEIGHTS)
        big_counts = dict(_build.LAUNCHES)
        ratio = peak.dense_ratio(
            f"  {big_side}x{big_side} under NLE_CPHI_BYTES {2 * RAISED_PHI}",
            big_n, seen[0]["mb"])
    with cphi_limit(0), stage2a_layouts(seen):
        ref, _ = run_config(torch, NLEFilter, big, params, WEIGHTS)
    db = psnr(out, ref)
    print(f"  {big_side}x{big_side}: stage 2a {seen}; launches {big_counts}; "
          f"cold {big_s:.3f} s; {ratio:.3f} x phi; {db:.2f} dB from its "
          "split layout")
    small_launches(big_counts, iters)
    if [c["layout"] for c in seen] != ["small", "split"] or not db >= 45.0:
        raise AssertionError(f"[17a] raised NLE_CPHI_BYTES: {seen}, "
                             f"{db:.2f} dB")
    return {"small_17a": counts, "small_raised_17a": big_counts}, errs


# [18] the denoise recipe's sampler (the benchmark cell's), the 8 MP
# frame's shape and a ragged row count past two of the kernel's tiles.
DENOISE_ARGS = (10, 10, 200.0, 30.0, 10, 10)
PHOTO8MP_SHAPE = (2448, 3264)
RAGGED_ROWS = 2 * 4096 + 77


def pixel_order_phase(torch, NLEFilter, _build, card: str):
    """[18] the edit's gather and scatter by perm. Returns (paths, the
    kernels' readings at 8 MP: {name: {c: (ms, plain_ms, nbytes)}})."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.kernels.pixel_order_kernel import (
        device_index,
        perm_gather,
        perm_gather_plain,
        perm_scatter,
        perm_scatter_plain,
    )
    from nle_tpu_torch.ops.pipeline import apply_filter_u8
    from nle_tpu_torch.ops.sampling import sample_grid
    from nle_tpu_torch.ops.transform import shrink_eigenvalues

    dev = torch.device("cuda")
    t18 = time.perf_counter()
    grid_perm = sample_grid(*PHOTO8MP_SHAPE, *DENOISE_ARGS[:2]).perm
    ragged = np.random.default_rng(18).permutation(RAGGED_ROWS)
    modes = (("perm_gather_u8", perm_gather, perm_gather_plain),
             ("perm_scatter_u8", perm_scatter, perm_scatter_plain))
    readings = {name: {} for name, _, _ in modes}
    for label, perm in (("8mp", grid_perm), ("ragged", ragged)):
        n = perm.size
        idx = device_index(perm, dev)
        for c in (1, 2, 3):
            rng = np.random.default_rng(c)
            x = torch.from_numpy(rng.integers(0, 256, (n, c), np.uint8)).to(
                dev)
            if c == 1:
                x = x[:, 0].contiguous()
            for name, kernel, plain in modes:
                _build.reset_launches()
                got = kernel(x, idx)
                torch.cuda.synchronize()
                counts = {k: v for k, v in _build.LAUNCHES.items() if v}
                want = plain(x, idx)
                if counts != {name: 1} or not torch.equal(got, want):
                    raise AssertionError(
                        f"[18] {name} C = {c} on {label} ({n} rows): "
                        f"launches {counts}, bitwise the plain version: "
                        f"{bool(torch.equal(got, want))}")
                if label != "8mp":
                    continue
                nbytes = n * (4 + 2 * c)
                ms = cuda_ms(torch, lambda: kernel(x, idx), reps=50)
                plain_ms = cuda_ms(torch, lambda: plain(x, idx), reps=20)
                bms = nbytes / PEAK_BYTES * 1e3
                readings[name][c] = (ms, plain_ms, nbytes)
                print(f"[18] {name} C = {c}, {n} rows: kernel {ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, bound {bms:.4f} ms (bytes: "
                      f"{nbytes} B), {ms / bms:.2f} x the bound ({card})")
        print(f"[18] {label}: both modes at C = 1, 2, 3 bitwise their plain "
              f"versions, one launch each")

    # A denoise frame at the cell's recipe: its edit's launches and bits.
    img = structured_frame(*MAIN_SHAPE)
    f = NLEFilter(device="cuda")
    f.train_for_denoise(img, *DENOISE_ARGS, 10, 10)
    torch.cuda.synchronize()
    _build.reset_launches()
    got = f.denoise(img, 2.0, 10, 10)
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    t = f.trained
    lab = bgr_to_lab_u8_np(img)
    flat = np.ascontiguousarray(lab[..., 1:]).reshape(t.n_pixels, 2)[t.perm]
    edit = apply_filter_u8(t.eigvecs, shrink_eigenvalues(t.eigvals, 2.0),
                           torch.from_numpy(flat).to(dev)).cpu().numpy()
    unpacked = np.empty_like(edit)
    unpacked[t.perm] = edit
    same = bool(np.array_equal(f._apply_edit_u8(
        np.ascontiguousarray(lab[..., 1:]),
        shrink_eigenvalues(t.eigvals, 2.0)),
        unpacked.reshape(lab.shape[:2] + (2,))))
    perm_counts = {k: counts[k] for k in PERM_KERNELS}
    print(f"[18] denoise of [5]'s frame at {' '.join(map(str, DENOISE_ARGS))}:"
          f" output {got.shape} {got.dtype}, launches {launches_of(counts)};"
          f" its edit bitwise the host route's: {same}; "
          f"{time.perf_counter() - t18:.1f} s")
    if perm_counts != {"perm_gather_u8": 1, "perm_scatter_u8": 1} or not same:
        raise AssertionError(f"[18] denoise: launches {perm_counts}, edit "
                             f"bitwise the host route's: {same}")
    return {"denoise_1mp": counts}, readings


def golden_phase(torch, NLEFilter, card: str) -> None:
    """[17b] every configuration of the port's golden_configs whose input
    shape is recorded (GOLDEN_SHAPES): a structured seeded BGR frame of
    that shape through NLEFilter on the card, cold then warm, the layout
    each stage-2a call took and the guard's trips, the warm wall, and the
    edit's dB from the port's float64 route on the card (>= 45), and cold
    == warm bit for bit."""
    from nle_tpu_torch.golden_configs import (
        DENOISE_CONFIG,
        ENHANCE_CONFIGS,
        EXTENDED_RECIPES,
    )

    jobs = [(name, inp, params, weights, None)
            for name, inp, _, params, weights in ENHANCE_CONFIGS]
    name, inp, params, dparams = DENOISE_CONFIG
    jobs.append((name, inp, params, None, dparams))
    jobs += [(name, inp, params, weights, None)
             for name, inp, params, weights in EXTENDED_RECIPES
             if inp in GOLDEN_SHAPES]
    print(f"[17b] the reference's configurations at their recorded shapes "
          f"({len(jobs)}; {card}):")
    worst = None
    for seed, (name, inp, params, weights, dparams) in enumerate(jobs):
        w, h = GOLDEN_SHAPES[inp]
        frame = structured_frame(h, w, seed=170 + seed)
        seen = []
        with stage2a_layouts(seen):
            cold, _ = run_config(torch, NLEFilter, frame, params, weights,
                                 dparams)
            warm, wall = run_config(torch, NLEFilter, frame, params,
                                    weights, dparams)
        f64, wall64 = run_config(torch, NLEFilter, frame, params, weights,
                                 dparams, dtype=torch.float64)
        db = psnr(warm, f64)
        first = seen[0]
        trips = len(seen) // 2 - 1
        mpad = -(-first["mb"] // 128) * 128
        same = bool(np.array_equal(cold, warm))
        print(f"  {name}: {h}x{w}, p {params[0] * params[1]}, m "
              f"{first['m']}, mpad {mpad}, layout {first['layout']}, guard "
              f"trips {trips}, warm {wall:.3f} s (float64 route "
              f"{wall64:.3f} s), {db:.2f} dB from the float64 route, cold "
              f"== warm bitwise: {same}")
        if not db >= 45.0:
            raise AssertionError(f"[17b] {name}: {db:.2f} dB < 45")
        if not same:
            raise AssertionError(f"[17b] {name}: cold and warm differ")
        if len(seen) % 2 or seen[:len(seen) // 2] != seen[len(seen) // 2:]:
            raise AssertionError(f"[17b] {name}: the two trains took "
                                 f"different stage-2a calls: {seen}")
        worst = db if worst is None else min(worst, db)
    print(f"  worst {worst:.2f} dB from the float64 route")


class PeakMeter:
    """Peak device bytes of one dense run over the padded f32 phi that
    resolve_streaming weighs, against the rule's DENSE_PEAK_PER_PHI_BYTE.
    Starts at construction (peak statistics reset, the cache emptied)."""

    def __init__(self, torch):
        self.torch = torch
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        self.base = torch.cuda.memory_allocated()

    def dense_ratio(self, label: str, n: int, mb: int) -> float:
        from nle_tpu_torch.ops.pipeline import (
            DENSE_PEAK_PER_PHI_BYTE,
            padded_shape,
        )

        peak = self.torch.cuda.max_memory_allocated() - self.base
        npad, mpad = padded_shape(n, mb)
        ratio = peak / (4 * npad * mpad)
        print(f"{label}: peak device memory {peak / 1e9:.3f} GB above the "
              f"{self.base / 1e6:.1f} MB held before = {ratio:.3f} x phi "
              f"({4 * npad * mpad / 1e9:.3f} GB); the auto rule assumes "
              f"{DENSE_PEAK_PER_PHI_BYTE}")
        if not ratio <= DENSE_PEAK_PER_PHI_BYTE:
            raise AssertionError(f"{label}: dense peak {ratio:.3f} x phi > "
                                 f"{DENSE_PEAK_PER_PHI_BYTE}")
        return ratio


def near_threshold(torch, NLEFilter, _build) -> None:
    """[8d] the streaming auto rule on this card: a frame sized to ~92% of
    the phi limit the rule computes here runs dense through NLEFilter's
    default streaming=None on every dense route (the split int16 layout;
    the assembled f32 layout of the carrier guard's fallback, forced with
    NLE_SINKHORN_INT16=off; and the assembled int16, bf16-lead and K13
    routes of the Sinkhorn knobs), without running out of memory and
    within DENSE_PEAK_PER_PHI_BYTE x phi; a frame 15% larger would
    stream."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.pipeline import (
        bucket_m,
        ka_eigh_host64,
        padded_shape,
        resolve_streaming,
        stream_bytes_limit,
    )
    from nle_tpu_torch.ops.sampling import sample_grid

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    limit = stream_bytes_limit(dev)
    t0 = time.perf_counter()
    mpad = 640
    for _ in range(2):
        # A 4:3 frame whose phi is ~92% of the limit at this mpad; the
        # second pass resizes for the mpad the frame's own rank gives.
        n_target = 0.92 * limit / (4 * mpad)
        h = int((n_target * 3 / 4) ** 0.5)
        w = int(n_target / h)
        frame = structured_frame(h, w, seed=11)
        grid = sample_grid(h, w, MAIN_ARGS[0], MAIN_ARGS[1])
        Ls = bgr_to_lab_u8_np(frame[grid.sel_rows, grid.sel_cols][None])[0, :, 0]
        m = ka_eigh_host64(Ls.astype(np.float64), grid.sel_rows,
                           grid.sel_cols, MAIN_ARGS[2], MAIN_ARGS[3],
                           1e-10)[1].shape[0]
        mb = bucket_m(m, grid.n_samples)
        if padded_shape(h * w, mb)[1] == mpad:
            break
        mpad = padded_shape(h * w, mb)[1]
    n = h * w
    phi = 4 * padded_shape(n, mb)[0] * mpad
    above = resolve_streaming(None, dev, int(n * 1.15), mb)
    print(f"[8d] auto rule: phi limit {limit / 1e9:.3f} GB on this card; "
          f"{h}x{w} frame ({n} px, mb={mb}) has phi {phi / 1e9:.3f} GB = "
          f"{phi / limit:.3f} of it (made in {time.perf_counter() - t0:.1f} "
          f"s); 15% more pixels would stream: {above}")
    if resolve_streaming(None, dev, n, mb) or not above:
        raise AssertionError("the auto rule does not switch near its limit")
    iters = MAIN_ARGS[4]
    routes = (
        ("split int16", {}, "sinkhorn_halfstep_int16", 2 * iters),
        ("assembled f32", dict(NLE_SINKHORN_INT16="off"),
         "sinkhorn_halfstep_f32", 2 * iters),
        ("assembled int16", dict(NLE_STAGE2_SPLIT="off"),
         "sinkhorn_halfstep_int16", 2 * iters),
        ("bf16 lead", dict(NLE_SINKHORN_BF16="auto"),
         "sinkhorn_halfstep_bf16", 2 * (iters - 2)),
        ("K13", dict(NLE_SINKHORN_KERNEL="auto"), "sinkhorn_halfstep_tiled",
         2 * iters))
    ratios = {}
    for label, env, kernel, least in routes:
        peak = PeakMeter(torch)
        _build.reset_launches()
        t0 = time.perf_counter()
        with knobs(**env):
            out = NLEFilter(device="cuda").train_and_enhance(
                frame, *MAIN_ARGS, weights=WEIGHTS)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        print(f"  {label}: dense train_and_enhance "
              f"{time.perf_counter() - t0:.3f} s; launches {counts}")
        if (counts[kernel] < least
                or any(counts[k] for k in STREAMING_KERNELS)):
            raise AssertionError(f"{label}: the frame under the limit did "
                                 f"not run that dense route: {counts}")
        if out.shape != frame.shape or out.dtype != np.uint8:
            raise AssertionError(f"output {out.shape} {out.dtype}")
        ratios[label] = peak.dense_ratio(f"  {label} near the limit", n, mb)
        del out
    del frame
    torch.cuda.empty_cache()
    return ratios


@contextlib.contextmanager
def stage2a_layouts(seen: list):
    """Records each stage-2a call of train_filter as a dict: its layout
    ("small", "split" or "assembled"), m, mb and the crush statistic
    rc[2, 0]."""
    from nle_tpu_torch.ops import pipeline

    real = pipeline.train_filter_stage2a

    def spy(*args, **kw):
        out = real(*args, **kw)
        layout = ("small" if kw.get("small") else
                  "split" if isinstance(out[2], tuple) else "assembled")
        seen.append(dict(layout=layout, m=kw["m"], mb=kw["mb"],
                         crush=float(out[0][2, 0])))
        return out

    pipeline.train_filter_stage2a = spy
    try:
        yield seen
    finally:
        pipeline.train_filter_stage2a = real


# [10b] the Sinkhorn modes on the 1 MP main frame: (label, knobs, the exact
# launch counts that prove the route, the stage-2a layouts in call order).
def mode_routes(iters: int):
    return (
        ("auto", dict(NLE_SINKHORN_KERNEL="auto"),
         {"sinkhorn_halfstep_tiled": 2 * iters}, [False]),
        ("bf16", dict(NLE_SINKHORN_BF16="auto"),
         {"sinkhorn_halfstep_bf16": 2 * (iters - 2),
          "sinkhorn_halfstep_f32": 4}, [False]),
        ("split off", dict(NLE_STAGE2_SPLIT="off"),
         {"sinkhorn_halfstep_int16": 2 * iters}, [False]),
        ("int16 off", dict(NLE_SINKHORN_INT16="off"),
         {"sinkhorn_halfstep_f32": 2 * iters}, [False]),
        ("int16 on", dict(NLE_SINKHORN_INT16="on"),
         {"sinkhorn_halfstep_int16": 2 * iters}, [True]))


def assembled_factor(torch, L: np.ndarray, dev):
    """The assembled f32 factor [Um; phi_b] (npad, mpad) of the Lab
    frame L at MAIN_ARGS (phi_b by K1) and the first half-step's t = lam
    phi^T 1, the operands of the assembled route's half-steps at 1 MP.
    Returns (phi, t, n, mb)."""
    from nle_tpu_torch.ops.kernels.affinity_kernel import (
        affinity_matmul_kernel,
    )
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        colsum64,
        padded_shape,
        split_row_pad,
    )

    op = path_operands(torch, L, MAIN_ARGS, dev)
    n, p, mb, mpad = op.n, op.p, op.mb, op.mpad
    nb = n - p
    npad, _ = padded_shape(n, mb)
    phib = affinity_matmul_kernel(op.fa, op.fb, op.Uinv, op.sw, op.pw,
                                  out_rows=split_row_pad(nb))
    phi = torch.zeros((npad, mpad), device=dev)
    phi[:p, :mb] = op.Um
    phi[p:n] = phib[:nb]
    lam_pad = torch.nn.functional.pad(op.lam, (0, mpad - mb))
    del phib, op
    t = (lam_pad * colsum64(phi, torch.ones(npad, device=dev))).contiguous()
    return phi, t, n, mb


def sinkhorn_modes(torch, NLEFilter, _build, record, img, L, split_out,
                   wide10) -> dict:
    """[10] K13, K14 and K15 against their plain versions at the 1 MP
    assembled shape; the main frame through every Sinkhorn mode; K15's
    table through the probe tool. split_out is the default (split) route's
    1 MP output; wide10 the mpad 2176 readings [9d] took for K13/K14.
    Returns {path: launch counts} for the rows' `launches`."""
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        PROBE_VARIANTS,
        PROBE_WONLY_COLS,
        k13_tile,
        sinkhorn_halfstep,
        sinkhorn_halfstep_plain,
        sinkhorn_halfstep_tiled,
        sinkhorn_halfstep_tiled_plain,
        sinkhorn_probe,
        sinkhorn_probe_plain,
    )
    from nle_tpu_torch.ops.pipeline import DENSE_PEAK_PER_PHI_BYTE
    from nle_tpu_torch.tools._sk_bench import FLOOR_CHUNK
    from nle_tpu_torch.tools.bench_sk_dmaonly import format_rows, probe_table

    t10 = time.perf_counter()
    dev = torch.device("cuda")
    eps = 1e-10
    iters = MAIN_ARGS[4]
    phi, t32, n, mb = assembled_factor(torch, L, dev)
    npad, mpad = phi.shape
    tile = k13_tile(mpad)
    print(f"[10a] K13, K14, K15 vs plain at the 1 MP assembled shape: npad "
          f"{npad}, mpad {mpad}, K13 tile {tile} ({npad // tile} tiles)")
    f32_bytes = 4 * (npad * mpad + npad + 2 * mpad)
    bf16_bytes = 2 * npad * mpad + 4 * (npad + 2 * mpad)
    src, sk_py = "nle_tpu_torch/csrc/sinkhorn.cu", "nle_tpu/ops/pallas/"

    def tiled_plain(Q, t, e):
        return sinkhorn_halfstep_tiled_plain(Q, t, e, tile)

    _, err = hold_halfstep(torch, "K13 sinkhorn tiled f32", phi, t32, eps,
                           sinkhorn_halfstep_tiled, tiled_plain)
    same = k13_bitwise(torch, "[10a]", sinkhorn_halfstep_tiled(phi, t32, eps),
                       phi, t32, eps, tile)
    row = record(
        "sinkhorn_halfstep_tiled", src, sk_py + "sinkhorn_kernel.py:45", err,
        cuda_ms(torch, lambda: sinkhorn_halfstep_tiled(phi, t32, eps),
                reps=10),
        cuda_ms(torch, lambda: tiled_plain(phi, t32, eps)), f32_bytes,
        4 * n * mb, launch=("mode_auto_1mp", "sinkhorn_halfstep_tiled"))
    row.update(earlier_sweep_max_abs_diff=same,
               torch_mv_ms=cuda_ms(torch, lambda: torch.mv(phi, t32), reps=10))
    print(f"  torch.mv on the same factor: {row['torch_mv_ms']:.3f} ms")
    phi_bf = phi.to(torch.bfloat16)
    _, err = hold_halfstep(torch, "K14 sinkhorn bf16", phi_bf, t32, eps)
    record("sinkhorn_halfstep_bf16", src, sk_py + "sinkhorn_kernel.py:121",
           err, cuda_ms(torch, lambda: sinkhorn_halfstep(phi_bf, t32, eps),
                        reps=10),
           cuda_ms(torch, lambda: sinkhorn_halfstep_plain(phi_bf, t32, eps)),
           bf16_bytes, 4 * n * mb,
           launch=("mode_bf16_1mp", "sinkhorn_halfstep_bf16"))
    del phi_bf
    phia = phi.abs()
    chunk = FLOOR_CHUNK
    nchunks = npad // chunk
    fold = min(PROBE_WONLY_COLS, chunk)
    for variant in PROBE_VARIANTS:
        name = f"sinkhorn_probe_{variant}"
        got = sinkhorn_probe(phi, t32, variant, chunk)
        want = sinkhorn_probe_plain(phi, t32, variant, chunk)
        # dmaonly adds the same rows in the same order: exact. wonly folds
        # w: its mpad-term sums, (2 mpad + 4) u (|phi| |t|) both sides,
        # plus nchunks rounded adds. wpart: a sum over rows, S_SUM_TOL of
        # the sum of absolute terms.
        bound = torch.zeros_like(want)
        if variant == "wonly":
            w_abs = phia @ t32.abs()
            bound[0, :fold] = ((2 * mpad + 4) * U * w_abs + 2 * nchunks * U
                               * w_abs).view(nchunks, chunk)[:, :fold].sum(0)
        elif variant == "wpart":
            bound[0, :mpad] = S_SUM_TOL * (phia.T @ (phi @ t32).abs())
        err = check(f"K15 {variant} chunk {chunk}", got - want, bound + 1e-30)
        width = want.shape[1]
        nbytes = 4 * (npad * mpad + 8 * width
                      + (0 if variant == "dmaonly" else mpad))
        flops = {"dmaonly": nchunks * mpad,
                 "wonly": 2 * npad * mpad + nchunks * fold,
                 "wpart": 4 * npad * mpad + nchunks * mpad}[variant]
        lib = (cuda_ms(torch, lambda: torch.mv(phi, t32), reps=10)
               if variant == "wonly" else None)
        record(name, src, "tools/bench_sk_dmaonly.py:68", err,
               cuda_ms(torch, lambda: sinkhorn_probe(phi, t32, variant,
                                                     chunk), reps=10),
               cuda_ms(torch, lambda: sinkhorn_probe_plain(phi, t32, variant,
                                                           chunk)),
               nbytes, flops, library_ms=lib,
               launch=("probe_1mp", name))["chunk"] = chunk
    del phi, phia, t32, got, want, bound
    torch.cuda.empty_cache()

    # [10b] the modes on the main frame, then the noise frame under =on.
    outs, paths, warm_s, ratio = {}, {}, {}, {}
    for label, env, need, layouts in mode_routes(iters):
        seen = []
        peak = PeakMeter(torch)
        _build.reset_launches()
        t0 = time.perf_counter()
        with knobs(**env), stage2a_layouts(seen):
            cold = NLEFilter(device="cuda").train_and_enhance(
                img, *MAIN_ARGS, weights=WEIGHTS)
            torch.cuda.synchronize()
            cold_s = time.perf_counter() - t0
            counts = dict(_build.LAUNCHES)
            seen = list(seen)          # the cold run's stage-2a calls
            ratio[label] = peak.dense_ratio(f"  [10b] {label}", n, mb)
            t0 = time.perf_counter()
            warm = NLEFilter(device="cuda").train_and_enhance(
                img, *MAIN_ARGS, weights=WEIGHTS)
            torch.cuda.synchronize()
            warm_s[label] = time.perf_counter() - t0
        same = bool(np.array_equal(cold, warm))
        print(f"[10b] {label} ({env}): cold {cold_s:.3f} s, warm "
              f"{warm_s[label]:.3f} s, two trains bitwise equal: {same}; "
              f"stage 2a {seen[:1]}; launches {counts}")
        got = {k: counts[k] for k in SINKHORN_KERNELS if counts[k]}
        if got != need or [c["layout"] == "split" for c in seen] != layouts:
            raise AssertionError(f"[10b] {label}: not its route: Sinkhorn "
                                 f"launches {got}, layouts {seen}")
        if any(counts[k] for k in STREAMING_KERNELS) or not same:
            raise AssertionError(f"[10b] {label}: streamed, or two trains "
                                 "differ")
        if cold.shape != img.shape or cold.dtype != np.uint8:
            raise AssertionError(f"[10b] {label} output {cold.shape}")
        outs[label], paths[f"mode_{label.replace(' ', '_')}_1mp"] = cold, counts
    for a, b, gate in (("auto", "int16 off", True),
                       ("split off", None, True),
                       ("bf16", "int16 off", False)):
        ref = split_out if b is None else outs[b]
        db = psnr(outs[a], ref)
        print(f"  {a} vs {b or 'the split route'}: {db:.2f} dB"
              + ("" if gate else " (bf16 preview mode: no gate)"))
        if gate and not db >= 45.0:
            raise AssertionError(f"[10b] {a} vs {b} {db:.2f} dB < 45")
    del outs
    # The noise frame's default is the small layout; NLE_CPHI_BYTES=0
    # gives it the split layout of the frames past that (K6 and K7).
    for path, limit, layout, gram in (
            ("mode_int16_on_noise", None, "small", 0),
            ("mode_int16_on_noise_split", 0, "split", 1)):
        _, counts, seen = noise_train(torch, NLEFilter, _build, limit,
                                      NLE_SINKHORN_INT16="on")
        paths[path] = counts
        print(f"  int16 on, noise frame, {layout} layout: stage 2a {seen}; "
              f"launches {counts}")
        if (len(seen) != 1 or seen[0]["layout"] != layout
                or not seen[0]["crush"] > 0.2
                or counts["sinkhorn_halfstep_f32"]
                or counts["sinkhorn_halfstep_int16"] != 2 * GUARD_ITERS
                or counts["scaled_gram"] != gram
                or counts["scaled_matmul"] != gram):
            raise AssertionError(f"[10b] NLE_SINKHORN_INT16=on on the "
                                 f"{layout} layout re-dispatched, or the "
                                 "noise frame no longer trips the guard")
    small = structured_frame(128, 192, seed=5)
    sargs = (10, 10, 100.0, 30.0, 10, 10)
    for label, env, _, _ in mode_routes(sargs[4]):
        with knobs(**env):
            g = NLEFilter(device="cuda").train_and_enhance(small, *sargs,
                                                           weights=WEIGHTS)
            c = NLEFilter(device="cpu").train_and_enhance(small, *sargs,
                                                          weights=WEIGHTS)
        db = psnr(g, c)
        print(f"  {label}, 128x192: cuda vs cpu {db:.2f} dB")
        if not db >= 45.0:
            raise AssertionError(f"[10b] {label} cuda vs cpu {db:.2f} dB < 45")
    print(f"  peak / phi per mode {ratio} (rule {DENSE_PEAK_PER_PHI_BYTE}); "
          f"warm s {warm_s}")

    # [10c] K15's table through the probe tool.
    _build.reset_launches()
    table = probe_table(torch, npad, mpad)
    torch.cuda.synchronize()
    paths["probe_1mp"] = dict(_build.LAUNCHES)
    floor = next(r["ms"] for r in table
                 if r["what"] == f"dmaonly chunk={FLOOR_CHUNK}")
    print(f"[10c] the streaming probe at npad {npad}, mpad {mpad} "
          f"(nle_tpu_torch/tools/bench_sk_dmaonly.py):")
    for line, r in zip(format_rows(table), table):
        ratio = "" if r["ms"] is None else f"  {r['ms'] / floor:6.2f} x dmaonly"
        print(f"  {line}{ratio}")
    print(f"[10] Sinkhorn modes: {time.perf_counter() - t10:.1f} s")
    return paths


def ab_probes(torch, _build, record, npad: int, mpad: int) -> dict:
    """[11] K16-K19 (and K13 as the mxu variant) against their plain twins
    at [10c]'s shape, each cold call counted; then each tool's table
    through its own table function, whose launch counts are the rows'.
    Returns {path: launch counts}."""
    from nle_tpu_torch.ops.kernels import sinkhorn_ab_kernel as ab
    from nle_tpu_torch.tools import (
        bench_sk_2stream,
        bench_sk_unroll,
        bench_sk_variants,
    )
    from nle_tpu_torch.tools._sk_bench import format_rows, make_factor

    # Every configuration of each tool's own grid.
    unroll_chunks = bench_sk_unroll.CHUNKS
    tiles = bench_sk_variants.TILES
    stream_configs = [(ns, c) for ns in bench_sk_2stream.STREAMS
                      for c in bench_sk_2stream.CHUNKS]
    t11 = time.perf_counter()
    eps = 1e-10
    src, tools = "nle_tpu_torch/csrc/sinkhorn_ab.cu", "tools/"
    phi, t = make_factor(torch, npad, mpad, 0, 0.1)
    phia = phi.abs()
    print(f"[11] the A/B staging probes at npad {npad}, mpad {mpad} (seed 0, "
          "phi normal x 0.05 + 0.1)")

    # The cold calls: every kernel at every configuration of its tool, once.
    _build.reset_launches()
    cold = {("unroll", c): ab.sinkhorn_unroll(phi, t, eps, c)
            for c in unroll_chunks}
    cold.update({(v, r): ab.sinkhorn_variant(phi, t, eps, v, r)
                 for v in ab.VARIANTS for r in tiles})
    cold.update({("2stream", ns, c): ab.sinkhorn_2stream(phi, t, ns, c)
                 for ns, c in stream_configs})
    torch.cuda.synchronize()
    cold_counts = dict(_build.LAUNCHES)
    print(f"  cold calls: launches "
          f"{({k: v for k, v in cold_counts.items() if v})}")
    need = {"sinkhorn_ab_unroll": len(unroll_chunks),
            "sinkhorn_ab_2stream": len(stream_configs)}
    need.update({bench_sk_variants.launch_key(v): len(tiles)
                 for v in ab.VARIANTS})
    if {k: v for k, v in cold_counts.items() if v} != need:
        raise AssertionError(f"[11] cold calls did not launch each kernel "
                             f"once per configuration: {cold_counts}")

    # Each against its plain twin: x as the half-steps' x, s to S_SUM_TOL of
    # the sum of absolute terms (the TPU orders differ only in where the
    # tile partials are summed), the staging probe exactly (the same rows
    # added in the same order).
    bx = None
    errs = {}
    for key, got in cold.items():
        if key[0] == "2stream":
            want = ab.sinkhorn_2stream_plain(phi, t, key[1], key[2])
            errs[key] = check(f"K19 streams={key[1]} chunk={key[2]}",
                              got - want, torch.zeros_like(want) + 1e-30)
            continue
        if key[0] == "unroll":
            xp, sp = ab.sinkhorn_unroll_plain(phi, t, eps, key[1])
        else:
            xp, sp = ab.sinkhorn_variant_plain(phi, t, eps, *key)
        if bx is None:
            bx = 2 * (2 * mpad + 4) * U * (phia @ t.abs()) * xp * xp + 1e-30
            bs = S_SUM_TOL * (phia.T @ xp.abs()) + 1e-30
        label = f"{key[0]} {'chunk' if key[0] == 'unroll' else 'tile'} {key[1]}"
        ex = check(f"{label} x", got[0] - xp, bx)
        es = check(f"{label} s", got[1] - sp,
                   torch.full_like(sp, 1e-30) if key[0] == "xonly" else bs)
        errs[key] = (max(ex[0], es[0]), max(ex[1], es[1]))
    # K13 as the mxu variant: bit for bit its earlier sweep at each tile.
    k13_same = {r: k13_bitwise(torch, "[11] mxu", cold[("mxu", r)], phi, t,
                               eps, r) for r in tiles}
    del cold

    # Time each kernel, its plain twin and torch.mv beside them. One row a
    # configuration; tool_config is the row's label in its tool's table.
    mv_ms = cuda_ms(torch, lambda: torch.mv(phi, t), reps=10)
    f32 = 4 * (npad * mpad + npad + 2 * mpad)
    halfstep_flops = 4 * npad * mpad
    rows_of = []
    for c in unroll_chunks:
        rows_of.append((
            "sinkhorn_ab_unroll" + ("" if c == 1024 else f"_chunk{c}"),
            "K16", "bench_sk_unroll.py:99", ("unroll", c),
            f"unroll2 chunk={c}", f32, halfstep_flops,
            lambda c=c: ab.sinkhorn_unroll(phi, t, eps, c),
            lambda c=c: ab.sinkhorn_unroll_plain(phi, t, eps, c)))
    for v, kid, repl in (("parts3d", "K17", "bench_sk_variants.py:106"),
                         ("mxu_row0", "K17", "bench_sk_variants.py:133"),
                         ("vpu", "K18", "bench_sk_variants.py:133"),
                         ("xonly", "K18", "bench_sk_variants.py:133"),
                         ("mxu", "K13", "bench_sk_variants.py:133")):
        base = ("sinkhorn_halfstep_tiled_mxu" if v == "mxu"
                else f"sinkhorn_ab_{v}")
        for r in tiles:
            rows_of.append((
                base + ("" if r == 2048 else f"_tile{r}"), kid, repl, (v, r),
                f"{v} tile={r}", f32,
                halfstep_flops if v != "xonly" else 2 * npad * mpad,
                lambda v=v, r=r: ab.sinkhorn_variant(phi, t, eps, v, r),
                lambda v=v, r=r: ab.sinkhorn_variant_plain(phi, t, eps, v,
                                                           r)))
    for ns, c in stream_configs:
        rows_of.append((
            "sinkhorn_ab_2stream" + ("" if (ns, c) == (2, 2048)
                                     else f"_s{ns}_chunk{c}"),
            "K19", "bench_sk_2stream.py:56", ("2stream", ns, c),
            f"streams={ns} chunk={c}", 4 * (npad * mpad + 8 * mpad),
            npad // c * mpad,
            lambda ns=ns, c=c: ab.sinkhorn_2stream(phi, t, ns, c),
            lambda ns=ns, c=c: ab.sinkhorn_2stream_plain(phi, t, ns, c)))
    launch_key = {"unroll": "sinkhorn_ab_unroll",
                  "2stream": "sinkhorn_ab_2stream"}
    by_config = {}
    for name, kid, repl, key, label, nbytes, flops, kern, plain in rows_of:
        row = record(name, "nle_tpu_torch/csrc/sinkhorn.cu" if kid == "K13"
                     else src, tools + repl, errs[key],
                     cuda_ms(torch, kern, reps=10), cuda_ms(torch, plain),
                     nbytes, flops, launch=(
                         "ab_tools", launch_key.get(
                             key[0], bench_sk_variants.launch_key(key[0]))))
        row.update(kernel_id=kid, tool_config=label, mv_ms=mv_ms,
                   x_mv=row["ms"] / mv_ms)
        if key[0] == "mxu":
            row["earlier_sweep_max_abs_diff"] = k13_same[key[1]]
        by_config[label] = row
    print(f"  torch.mv(phi, t) on the same factor: {mv_ms:.3f} ms")
    del phi, phia, t, bx, bs
    torch.cuda.empty_cache()

    # Each tool's table through its own table function at this shape; the
    # counts of these runs are the rows' launches, and each row gets its
    # tool's reading beside its own.
    _build.reset_launches()
    tables = [
        ("bench_sk_unroll", bench_sk_unroll.unroll_table(torch, npad, mpad)),
        ("bench_sk_variants", bench_sk_variants.variants_table(
            torch, npad, mpad, variants=tuple(ab.VARIANTS))),
        ("bench_sk_2stream", bench_sk_2stream.stream_table(torch, npad,
                                                           mpad)),
    ]
    torch.cuda.synchronize()
    tool_counts = dict(_build.LAUNCHES)
    for tool, table in tables:
        print(f"  nle_tpu_torch/tools/{tool}.py:")
        for line in format_rows(table):
            print(f"    {line}")
        for r in table:
            if r["config"] in by_config:
                by_config[r["config"]].update(
                    tool=tool, tool_ms=r["ms"], tool_gb_s=r["gb_s"],
                    tool_x_dmaonly=r["x_dmaonly"], tool_x_mv=r["x_mv"])
    print(f"  the tools' launches "
          f"{({k: v for k, v in tool_counts.items() if v})}")
    print(f"[11] A/B staging probes: {time.perf_counter() - t11:.1f} s")
    return {"ab_cold": cold_counts, "ab_tools": tool_counts}


def hold_scaled(torch, record, tag: str, phi, c, nb: int, mb: int,
                kvec: int) -> dict:
    """K6 and K7 on (phi, c) against their plain versions, timed beside
    one PyTorch call of the same function: K6 within GRAM_SUM_TOL of
    |c phi|^T |c phi| from its plain version evaluated in float64 (and, at
    the 1 MP shapes, in fp32), its Sb bitwise symmetric, and both kernels
    bitwise repeatable; K7 on the round_up(kvec, 32)-wide B the path passes, and
    for continuity beside the TPU's 128-lane B. nb and mb are the rows
    and columns that carry data (the bounds count their work). tag ""
    records the rows (the 1 MP main path's shapes); any other tag returns
    its readings as {kernel name: {key + tag: value}} for those rows."""
    from nle_tpu_torch.ops.kernels.scaled_matmul_kernel import (
        MATMUL_COL_ALIGN,
        gram_plan,
        scaled_gram,
        scaled_gram_plain,
        scaled_matmul,
        scaled_matmul_plain,
    )

    npad, mpad = phi.shape
    label = f" at mpad {mpad}" if tag else ""
    plan = gram_plan(npad, mpad)
    print(f"  K6 plan{label}: {plan.tiles} lower-triangle tiles x "
          f"{plan.nsplit} splits of {plan.split_rows} rows, chains of "
          f"{plan.chain_rows} rows; scratch {plan.scratch_bytes} B "
          f"({plan.scratch_bytes / 1e6:.1f} MB; one mpad^2 partial per "
          f"16,384 rows would be {-(-npad // 16384) * mpad * mpad * 4 / 1e6:.1f}"
          f" MB)")
    gk = scaled_gram(phi, c)
    gk2 = scaled_gram(phi, c)
    torch.cuda.synchronize()
    if not torch.equal(gk, gk.T):
        raise AssertionError(f"K6{label}: Sb is not bitwise symmetric")
    if not torch.equal(gk, gk2):
        raise AssertionError(f"K6{label}: two calls differ")
    del gk2
    # Against the plain version evaluated in float64 everywhere and, at the
    # 1 MP shapes, also in fp32 as before: at 2^20 rows and mpad 2176 the
    # fp32 plain version (one long cuBLAS chain) is itself 1.7x the
    # tolerance away from float64, the kernel 0.04x.
    p64, c64 = phi.double(), c.double()
    g64 = scaled_gram_plain(p64, c64)
    tol = GRAM_SUM_TOL * scaled_gram_plain(p64.abs(), c64.abs()) + 1e-30
    del p64, c64
    torch.cuda.empty_cache()
    gp = scaled_gram_plain(phi, c)
    parts = [(gk.double() - g64, tol)]
    if not tag:
        parts.append(((gk - gp).double(), tol))
    err6 = check_parts(f"K6 scaled_gram{label} (float64 plain"
                       f"{'' if tag else '; fp32 plain'})", parts)
    print(f"  the fp32 plain version{label} against float64: "
          f"max err/bound {float(((gp - g64).abs() / tol).max()):.3e}")
    del gk, gp, g64, tol, parts
    torch.cuda.empty_cache()
    cphi = phi * c                        # pre-scaled, for the library call
    nbytes6 = 4 * (npad * mpad + npad + mpad * mpad)
    flops6 = nb * mb * (mb + 1)
    k6 = (cuda_ms(torch, lambda: scaled_gram(phi, c)),
          cuda_ms(torch, lambda: scaled_gram_plain(phi, c)), nbytes6, flops6,
          cuda_ms(torch, lambda: torch.matmul(cphi.T, cphi)))

    rng = np.random.default_rng(3)
    kw = -(-kvec // MATMUL_COL_ALIGN) * MATMUL_COL_ALIGN
    B128 = np.zeros((mpad, 128), np.float32)
    B128[:mb, :kvec] = rng.standard_normal((mb, kvec)) * 1e-3
    B128 = torch.from_numpy(B128).to(phi.device)
    B = B128[:, :kw].contiguous()
    errs = []
    for b in (B, B128):
        vk = scaled_matmul(phi, c, b)
        vk2 = scaled_matmul(phi, c, b)
        torch.cuda.synchronize()
        if not torch.equal(vk, vk2):
            raise AssertionError(f"K7{label}: two calls differ")
        del vk2
        errs.append(check(
            f"K7 scaled_matmul{label} (B {b.shape[1]} wide)",
            vk - scaled_matmul_plain(phi, c, b),
            (2 * mpad + 4) * U * scaled_matmul_plain(
                phi.abs(), c.abs(), b.abs()) + 1e-30))
        del vk
        torch.cuda.empty_cache()
    err7 = (max(e[0] for e in errs), max(e[1] for e in errs))
    nbytes7 = 4 * (npad * mpad + npad + mpad * kw + npad * kw)
    k7 = (cuda_ms(torch, lambda: scaled_matmul(phi, c, B)),
          cuda_ms(torch, lambda: scaled_matmul_plain(phi, c, B)), nbytes7,
          2 * nb * mb * kvec, cuda_ms(torch, lambda: torch.matmul(cphi, B)))
    ms128 = cuda_ms(torch, lambda: scaled_matmul(phi, c, B128))
    lib128 = cuda_ms(torch, lambda: torch.matmul(cphi, B128))
    print(f"  K7{label} on the TPU's 128-lane B: kernel {ms128:.3f} ms, "
          f"library {lib128:.3f} ms")
    del cphi
    torch.cuda.empty_cache()
    extras = {}
    for name, repl, err, (ms, plain_ms, nbytes, flops, lib) in (
            ("scaled_gram", "nle_tpu/ops/pallas/scaled_matmul_kernel.py:56",
             err6, k6),
            ("scaled_matmul",
             "nle_tpu/ops/pallas/scaled_matmul_kernel.py:111", err7, k7)):
        if not tag:
            row = record(name, "nle_tpu_torch/csrc/scaled_matmul.cu", repl,
                         err, ms, plain_ms, nbytes, flops, lib)
        else:
            bms, by = bound_ms(nbytes, flops)
            print(f"  {name}{label}: kernel {ms:.3f} ms, plain {plain_ms:.3f}"
                  f" ms, library {lib:.3f} ms, bound {bms:.4f} ms ({by})")
            row = {f"max_abs_err{tag}": err[0],
                   f"err_over_bound{tag}": err[1], f"ms{tag}": ms,
                   f"plain_ms{tag}": plain_ms, f"library_ms{tag}": lib,
                   f"bound_ms{tag}": bms, f"bound_by{tag}": by}
            extras[name] = row
            continue
        if name == "scaled_gram":
            row["scratch_bytes"] = plan.scratch_bytes
        else:
            row["b_cols"] = kw
            row["ms_b128"], row["library_ms_b128"] = ms128, lib128
    return extras


# -- [12] stream mode, host Lab and the port bench ---------------------------

def aliased_frame(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Dark lines on the rows MAIN_ARGS's sample grid takes (a line pattern
    whose period is the grid's row step, as a fence or a screen aliases
    with it), mid-gray noise between them: most rest pixels lie 50-90 L
    levels from every sample, so their phi rows are 1e-10 to 1e-35 of the
    columns' largest, outside the int16 carrier's validity domain at the
    main path's parameters (crush ~0.98), where uniform noise stays
    inside it (hy 10 finds a sample of every intensity)."""
    from nle_tpu_torch.ops.sampling import sample_grid

    rng = np.random.default_rng(seed)
    v = rng.uniform(60, 100, (h, w))
    lines = np.isin(np.arange(h), sample_grid(h, w, *MAIN_ARGS[:2]).sel_rows)
    v[lines] = rng.uniform(0, 16, (int(lines.sum()), w))
    return np.repeat(np.rint(v).astype(np.uint8)[..., None], 3, axis=-1)


def stream_edits(torch, NLEFilter, _build, frames, lookahead: int):
    """The bench's stream flow on the main thread, in order: each frame's
    Lab L into train_filters_iter, each yielded filter edited through
    NLEFilter(trained=...) with the producer's Lab seeded. Returns (the
    edits, K4's launch count at each yield)."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.models.batch import train_filters_iter

    labs = [None] * len(frames)

    def channels():
        for i, bgr in enumerate(frames):
            labs[i] = bgr_to_lab_u8_np(bgr)
            yield labs[i][..., 0].astype(np.float32)

    outs, k4 = [], []
    for i, flt in enumerate(train_filters_iter(
            channels(), *MAIN_ARGS, device="cuda", lookahead=lookahead)):
        k4.append(_build.LAUNCHES["sinkhorn_halfstep_f32"])
        f = NLEFilter(trained=flt, device="cuda")
        f.seed_lab_cache(frames[i], labs[i])
        outs.append(f.enhance(frames[i], WEIGHTS))
    return outs, k4


def stream_phase(torch, NLEFilter, _build, img) -> dict:
    """[12] (a) stream mode against single mode, bit for bit, at lookahead
    1 and 2, the guard of the last frame tripping inside finish; (b) a
    submit with no host sync; (c) the lookahead-2 stream's peak against
    fits_pipeline's bound; (d) the overlap, read; (e) the host Lab (C
    against NumPy, the device twins on the whole cube) and its timings;
    (f) the port bench in both modes. Returns the bench's MP/s by mode."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.models.batch import fits_pipeline, train_filters_iter
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import padded_shape
    from nle_tpu_torch.ops.pipeline import DENSE_PEAK_PER_PHI_BYTE
    from nle_tpu_torch.tools import bench

    t12 = time.perf_counter()
    h, w = MAIN_SHAPE
    n, p = h * w, MAIN_ARGS[0] * MAIN_ARGS[1]
    iters = MAIN_ARGS[4]
    # The guard-tripping frame fourth: at lookahead 2 its finish (and its
    # f32 retrain) runs with two frames in flight, the rule's worst case.
    names = ["jittered 1", "jittered 2", "jittered 3", "aliased lines",
             "jittered 4", "uniform noise"]
    jit = bench.jittered_frames(img, 4)
    frames = jit[:3] + [aliased_frame(h, w), jit[3], noise_frame(h, w)]
    trips = names.index("aliased lines")
    singles, single_k4 = [], []
    with bench.CarrierRecords() as rec:
        for frame in frames:
            _build.reset_launches()
            singles.append(NLEFilter(device="cuda").train_and_enhance(
                frame, *MAIN_ARGS, weights=WEIGHTS))
            single_k4.append(_build.LAUNCHES["sinkhorn_halfstep_f32"])
    if len(rec.seen) != len(frames):
        raise AssertionError(f"[12a] {len(rec.seen)} carrier records for "
                             f"{len(frames)} single-mode trains")
    print(f"[12a] single mode, {h}x{w}, {' '.join(map(str, MAIN_ARGS))}: "
          + "; ".join(f"{nm} crush {c:.4f} retrained {r} (K4 x {k})"
                      for nm, (c, r), k in zip(names, rec.seen, single_k4)))
    if any(r != (i == trips) for i, (_, r) in enumerate(rec.seen[:5])):
        raise AssertionError("[12a] the guard must pass the jittered frames "
                             "and trip on the aliased one")
    _, mpad = padded_shape(n, p)
    phi = 4 * padded_shape(n, p)[0] * mpad
    if not (fits_pipeline(n, *MAIN_ARGS[:2], 2, device="cuda")
            and fits_pipeline(n, *MAIN_ARGS[:2], 4, device="cuda")):
        raise AssertionError("[12] lookahead 2 and 4 must fit at 1 MP")
    for look in (1, 2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        _build.reset_launches()
        outs, k4 = stream_edits(torch, NLEFilter, _build, frames, look)
        torch.cuda.synchronize()
        counts = dict(_build.LAUNCHES)
        ratio = (torch.cuda.max_memory_allocated() - base) / phi
        same = [bool(np.array_equal(a, b)) for a, b in zip(outs, singles)]
        # K4's launches between two yields are the finish of the frame
        # yielded second (the submits between them run the split layout,
        # K3 alone): each frame's own guard retrain, inside finish.
        own = [b - a for a, b in zip([0] + k4[:-1], k4)]
        print(f"  stream, lookahead {look}: each frame bitwise single "
              f"mode's: {same}; K3 x {counts['sinkhorn_halfstep_int16']}; "
              f"K4 in each frame's finish {own} (single mode {single_k4}); "
              f"peak {ratio:.3f} x phi ({phi / 1e9:.3f} GB)")
        if not all(same):
            raise AssertionError(f"[12a] lookahead {look}: stream edits "
                                 f"differ from single mode: {same}")
        if (own != single_k4 or own[trips] < 2 * iters
                or counts["sinkhorn_halfstep_int16"] < 2 * iters * len(frames)):
            raise AssertionError(f"[12a] lookahead {look}: the guard did not "
                                 f"retrain the aliased frame inside its "
                                 f"finish alone: {own}, {counts}")
        if look == 2:
            # [12c] fits_pipeline's bound: L in flight + one stage 2a (here
            # the aliased frame's f32 retrain beside two frames in flight).
            bound = look + DENSE_PEAK_PER_PHI_BYTE
            print(f"[12c] lookahead-2 peak {ratio:.3f} x phi, bound "
                  f"{bound} (fits_pipeline)")
            if not ratio <= bound:
                raise AssertionError(f"[12c] peak {ratio:.3f} x phi > {bound}")
        del outs

    # [12b] no host sync in submit: frame 2's submit (lookahead 4, so no
    # finish runs until the producer is resumed) under sync debug "error".
    def channels():
        for i, frame in enumerate(frames[:3]):
            lab = bgr_to_lab_u8_np(frame)
            if i == 2:
                torch.cuda.set_sync_debug_mode("error")
            yield lab[..., 0].astype(np.float32)
            torch.cuda.set_sync_debug_mode(0)

    try:
        flts = list(train_filters_iter(channels(), *MAIN_ARGS,
                                       device="cuda", lookahead=4))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print(f"[12b] frame 2's submit ran under set_sync_debug_mode('error') "
          f"without a host sync ({len(flts)} filters)")
    del flts

    # [12d] the overlap, read: first one frame's stage 2a, the host's time
    # to queue it beside the device's time to run it (queued behind a
    # blocker, so no launch gap counts), then 8 jittered frames warm,
    # stream and single.
    launch_reading(torch, frames[0])
    frames8 = bench.jittered_frames(img, 8)
    bench.run_stream(frames8[:2])                  # warm the stream path
    readings = {}
    for label, fn in (
            ("stream", lambda: bench.run_stream(frames8)),
            ("single", lambda: [bench.run_single(f) for f in frames8])):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        r = {}
        profile_call(torch, f"[12d] profiled 8-frame {label} mode", fn,
                     8 * n / 1e6, readings=r)
        readings[label] = (wall, r)
        print(f"[12d] {label} mode: wall {wall / 8 * 1e3:.1f} ms a frame "
              f"({8 * n / 1e6 / wall:.3f} MP/s); device busy share "
              f"{r['device_ms'] / r['wall_ms']:.3f} under the profiler "
              f"(wall {r['wall_ms'] / 8:.1f} ms a frame there)")
    print(f"  stream over single, wall a frame: "
          f"{readings['stream'][0] / readings['single'][0]:.3f}")
    lab_phase(torch)

    # [12f] the port bench, both modes, as a user runs it.
    root = os.path.dirname(os.path.abspath(__file__))
    bench = {}
    for mode in ("stream", "single"):
        t0 = time.perf_counter()
        out = subprocess.run(
            [sys.executable, "-m", "nle_tpu_torch.tools.bench"], cwd=root,
            env={**os.environ, "NLE_BENCH_MODE": mode,
                 "NLE_BENCH_REPEATS": "4"},
            capture_output=True, text=True, timeout=600)
        line = (out.stdout.strip().splitlines() or [""])[-1]
        print(f"[12f] bench {mode} ({time.perf_counter() - t0:.1f} s): {line}")
        if out.returncode != 0:
            raise AssertionError(f"[12f] bench {mode} exited "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        got = json.loads(line)
        if got["mode"] != mode or got["device"]["platform"] != "gpu":
            raise AssertionError(f"[12f] bench line {got}")
        bench[mode] = got["value"]
    print(f"[12] stream mode, Lab and the bench: "
          f"{time.perf_counter() - t12:.1f} s")
    return bench


def launch_reading(torch, frame) -> None:
    """[12d] one frame's dense stage 2a (submit_dense): the host's time to
    queue it and the wall until its rc is back, on an idle device; and its
    device time when queued behind 16 fp32 8192^2 matmuls (CUDA events
    around it alone). The overlap of stream mode can hide only the device
    time that outlasts the queueing."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops import pipeline as pl
    from nle_tpu_torch.ops.affinity import bandwidth_weights
    from nle_tpu_torch.ops.sampling import sample_grid
    from nle_tpu_torch.utils.transfer import upload

    dev = torch.device("cuda")
    h, w = frame.shape[:2]
    L0 = bgr_to_lab_u8_np(frame)[..., 0].astype(np.float32)
    grid = sample_grid(h, w, *MAIN_ARGS[:2])
    Um64, lam64, m, mb = pl.host_stage1(L0, grid, *MAIN_ARGS[2:4], 1e-10)
    args = (upload(pl.pack_channel(L0, grid.perm)[0], dev).to(torch.float32),
            *pl.grid_coords(grid, dev),
            upload(pl.pack_stage1(Um64, lam64, mb=mb), dev),
            *bandwidth_weights(*MAIN_ARGS[2:4]), Um64, lam64)
    kw = dict(p=grid.n_samples, m=m, mb=mb, n_sinkhorn_iter=MAIN_ARGS[4],
              eps=1e-10)
    blocker = torch.randn(8192, 8192, device=dev)
    best = {}
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frame2a = pl.submit_dense(*args, **kw)
        queued = time.perf_counter() - t0
        frame2a.rc.result()
        done = time.perf_counter() - t0
        for _ in range(16):
            torch.mm(blocker, blocker)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        t0 = time.perf_counter()
        frame2a = pl.submit_dense(*args, **kw)
        queued_busy = time.perf_counter() - t0
        e1.record()
        torch.cuda.synchronize()
        for key, val in (("queue", queued * 1e3), ("done", done * 1e3),
                         ("queue_busy", queued_busy * 1e3),
                         ("device", e0.elapsed_time(e1))):
            best[key] = min(best.get(key, float("inf")), val)
        del frame2a
    print(f"[12d] one frame's stage 2a (submit_dense, 1 MP): the host queues "
          f"it in {best['queue']:.1f} ms and has its rc {best['done']:.1f} ms "
          f"after the first launch (idle device); queued behind a blocker "
          f"it takes the host {best['queue_busy']:.1f} ms to queue and the "
          f"device {best['device']:.1f} ms to run (minima of 3)")


def lab_phase(torch) -> None:
    """[12e] the C Lab loader against the NumPy pair (bitwise: a 1 MP
    random frame and the Lab cube's extremes), the device twins against
    the host pair on the whole 256^3 cube, both directions; then the three
    forms timed at 1, 16 and 32 MP (the device twin with its upload and
    fetch)."""
    from nle_tpu_torch import native
    from nle_tpu_torch.color import lab as tlab
    from nle_tpu_torch.utils.transfer import Fetch, upload

    if native.load() is None:
        raise AssertionError("[12e] the C Lab kernels did not build")
    rng = np.random.default_rng(0)
    corners = np.stack(np.meshgrid([0, 255], [0, 255], [0, 255],
                                   indexing="ij"), -1).reshape(-1, 3)
    axes = np.stack([np.arange(256)] * 3, -1)
    edges = np.concatenate([corners, axes]).astype(np.uint8)[:, None]
    for label, px in (("1 MP random", rng.integers(0, 256, MAIN_SHAPE + (3,),
                                                   np.uint8)),
                      ("the cube's extremes", edges)):
        for fwd, (c, numpy_) in (("BGR to Lab", (tlab.bgr_to_lab_u8_np,
                                                 tlab.bgr_to_lab_u8_numpy)),
                                 ("Lab to BGR", (tlab.lab_to_bgr_u8_np,
                                                 tlab.lab_to_bgr_u8_numpy))):
            if not np.array_equal(c(px), numpy_(px)):
                raise AssertionError(f"[12e] C {fwd} differs from NumPy on "
                                     f"{label}")
    L, A, B = np.meshgrid(*[np.arange(256, dtype=np.uint8)] * 3,
                          indexing="ij")
    cube = np.stack([L, A, B], axis=-1).reshape(4096, 4096, 3)
    dev = torch.device("cuda")
    for fwd, twin, host in (("BGR to Lab", tlab.bgr_to_lab_u8,
                             tlab.bgr_to_lab_u8_np),
                            ("Lab to BGR", tlab.lab_to_bgr_u8,
                             tlab.lab_to_bgr_u8_np)):
        got = Fetch(twin(upload(cube, dev))).result()
        if not np.array_equal(got, host(cube)):
            raise AssertionError(f"[12e] device {fwd} differs from the host "
                                 "pair on the 256^3 cube")
    print("[12e] C Lab bitwise the NumPy pair (1 MP random, the cube's "
          "extremes); the device twins bitwise the host pair on all "
          "16,777,216 cube pixels, both directions")
    for mp_label, shape in (("1 MP", MAIN_SHAPE), ("16 MP", GRID_CAP_SHAPE),
                            ("32 MP", CAP_SHAPE)):
        px = rng.integers(0, 256, shape + (3,), np.uint8)
        reps = 3 if shape == MAIN_SHAPE else 1
        for fwd, fns in (
                ("BGR to Lab", (tlab.bgr_to_lab_u8_numpy,
                                tlab.bgr_to_lab_u8_np, tlab.bgr_to_lab_u8)),
                ("Lab to BGR", (tlab.lab_to_bgr_u8_numpy,
                                tlab.lab_to_bgr_u8_np, tlab.lab_to_bgr_u8))):
            numpy_, c, twin = fns
            ms = []
            for fn in (numpy_, c,
                       lambda x: Fetch(twin(upload(x, dev))).result()):
                if fn not in (numpy_, c):
                    fn(px)                    # the allocator's first call
                best = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    fn(px)
                    best = min(best, time.perf_counter() - t0)
                ms.append(best * 1e3)
            print(f"  {fwd} at {mp_label} ({shape[0]}x{shape[1]}): NumPy "
                  f"{ms[0]:.1f} ms, C {ms[1]:.1f} ms, device twin with "
                  f"upload and fetch {ms[2]:.1f} ms")
        del px


# [13] the command line: rock2's parameters, the denoise run's bilateral
# and shrink (sigma color 10, sigma space 10, shrink 2).
CLI_DENOISE = ("10", "10", "2")
CLI_OPTIONS = ("--stage1=topk", "--stage1=device", "--precision=float64",
               "--no-pallas")
ROOT = os.path.dirname(os.path.abspath(__file__))


def run_cli(tool: str, args, counts_path: str | None = None):
    """Start `python -m nle_tpu_torch.cli.<tool> args` in a subprocess from
    the repo root: the module run as -m runs it (runpy), with the kernels'
    launch counts of that process written to counts_path at its exit.
    Returns a zero-arg function that waits for it and gives (rc, stdout,
    stderr, wall s from its start, launch counts or None)."""
    code = ("import atexit, json, runpy; "
            "from nle_tpu_torch.ops.kernels import _build; "
            + (f"atexit.register(lambda: open({counts_path!r}, 'w').write("
               "json.dumps(_build.LAUNCHES))); " if counts_path else "")
            + f"runpy.run_module('nle_tpu_torch.cli.{tool}', "
            "run_name='__main__', alter_sys=True)")
    import threading

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-c", code, *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    done = {}

    def reap():
        # Its own thread, so a run's wall ends when it exits, not when the
        # caller gets to it.
        try:
            done["io"] = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            done["wall"] = time.perf_counter() - t0

    reaper = threading.Thread(target=reap)
    reaper.start()

    def wait():
        reaper.join()
        if "io" not in done:
            raise AssertionError(f"[13] cli.{tool} {args}: no exit in 600 s")
        counts = None
        if counts_path and os.path.exists(counts_path):
            with open(counts_path) as fh:
                counts = json.load(fh)
        return (proc.returncode, *done["io"], done["wall"], counts)

    return wait


def cli_ok(label: str, res, stdout_tail: str = "Done."):
    rc, out, err, wall, counts = res
    print(f"  {label}: rc {rc}, {wall:.2f} s wall; launches "
          f"{ {k: v for k, v in (counts or {}).items() if v} }")
    if rc != 0 or not out.strip().endswith(stdout_tail):
        raise AssertionError(f"[13] {label}: rc {rc}\n{out[-2000:]}\n"
                             f"{err[-4000:]}")
    return counts


def hold_device_stage1(torch, img) -> None:
    """[13c] stage1="device"'s eigensolve on the card at the 1 MP frame's
    sample set: ka_eigh_stage (Ka and its float32 eigh on the card)
    against eigh_descending of the same Ka on the CPU (LAPACK). Gates: the
    eigenvalues within rtol 1e-4 and atol 1e-5 lam_max (the CPU tests'
    tolerance against nle_tpu's device route); the eps mask (lam[:m] >=
    eps, lam[m:] zero); the kept pairs within p u lam_max of Ka U = U lam
    and orthonormal within p u. The kept rank m is printed beside the
    CPU's and the count of eigenvalues inside the atol band, where a
    float32 eigh cannot tell a kept eigenvalue from a dropped one."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.affinity import (
        affinity_block,
        bandwidth_weights,
        features,
    )
    from nle_tpu_torch.ops.linalg import eigh_descending
    from nle_tpu_torch.ops.pipeline import ka_eigh_stage
    from nle_tpu_torch.ops.sampling import sample_grid

    eps = 1e-10
    h, w = img.shape[:2]
    grid = sample_grid(h, w, MAIN_ARGS[0], MAIN_ARGS[1])
    p = grid.n_samples
    sel = grid.perm[:p]
    y, rr, cc = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (
        bgr_to_lab_u8_np(img)[..., 0].reshape(-1)[sel], sel // w, sel % w))
    sw, pw = bandwidth_weights(MAIN_ARGS[2], MAIN_ARGS[3])
    V, lam = (a.cpu() for a in ka_eigh_stage(y, rr, cc, sw, pw, p=p,
                                              eps=eps))
    f = features(rr, cc, y)
    Ka = affinity_block(f, f, sw, pw).cpu()
    _, lam_cpu = eigh_descending(Ka, eps)
    top = float(lam_cpu.max())
    check(f"[13c] device stage 1 (p = {p}): card eigenvalues vs the CPU's",
          lam - lam_cpu, 1e-4 * lam_cpu.abs() + 1e-5 * top)
    m = int(torch.count_nonzero(lam))
    if not (bool((lam[:m] >= eps).all()) and not bool(lam[m:].any())):
        raise AssertionError("[13c] device stage 1: the eps mask is broken")
    f64 = torch.float64
    Um, lm, K64 = V[:, :m].to(f64), lam[:m].to(f64), Ka.to(f64)
    check("[13c] device stage 1: |Ka U - U lam| of the kept pairs",
          K64 @ Um - Um * lm, torch.full_like(Um, p * U * top))
    check("[13c] device stage 1: |U^T U - I| of the kept pairs",
          Um.T @ Um - torch.eye(m, dtype=f64),
          torch.full((m, m), p * U, dtype=f64))
    band = int((torch.linalg.eigvalsh(Ka).abs() < 1e-5 * top).sum())
    print(f"  device stage 1: kept rank m {m} on the card, "
          f"{int(torch.count_nonzero(lam_cpu))} on the CPU; {band} of {p} "
          "eigenvalues inside the atol band")


def cli_phase(torch, img, dense_out) -> dict:
    """[13] the CLIs as subprocesses on the card, on the 1 MP frame written
    to PNG. One at a time, so their walls are their own: (a) cli.enhance,
    bitwise NLEFilter's train_and_enhance ([5]'s output); (b) cli.denoise
    dense and --factored (>= 45 dB apart; K10/K11 once each, at R = 2, in
    the factored run: [3] holds and times them at R = 2 on this frame's
    shapes), and the bilateral's ms at 1 MP. Then side by side: cli.apply
    on each saved filter (>= 45 dB from its direct run), (c) each of
    CLI_OPTIONS against the default route (>= 45 dB, but --stage1=device:
    a reading, see PERF.md; its eigensolve is held in-process by
    hold_device_stage1), and (d) the usage and missing-file probes.
    Returns the counted runs' launch counts by path."""
    import tempfile

    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.color.bilateral import bilateral_filter_u8
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.utils.imageio import imread_bgr, imwrite_bgr

    t13 = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    params = [str(a) for a in MAIN_ARGS]
    weights = [str(x) for x in WEIGHTS]
    paths = {}
    with tempfile.TemporaryDirectory() as tmp:
        def f(name):
            return os.path.join(tmp, name)

        src = f("frame.png")
        imwrite_bgr(src, img)
        print(f"[13] the CLIs as subprocesses on {smi}: "
              f"{img.shape[0]}x{img.shape[1]} structured frame (seed 0) as "
              f"PNG, {' '.join(params)}; walls include ~8 s of process "
              "start and, with --save-filter, the npz's compression")

        # (a) enhance
        counts = cli_ok("cli.enhance --save-filter", run_cli(
            "enhance", [src, f("enh.png"), *params, *weights,
                        f"--save-filter={f('enh.npz')}"], f("c1.json"))())
        paths["cli_enhance"] = counts
        for name in ("affinity_matmul", "scaled_gram", "scaled_matmul"):
            if counts[name] < 1:
                raise AssertionError(f"[13a] {name} not launched")
        if counts["sinkhorn_halfstep_int16"] < 2 * MAIN_ARGS[4]:
            raise AssertionError("[13a] K3 not launched 2 x iters times")
        enh = imread_bgr(f("enh.png"))
        same = bool(np.array_equal(enh, dense_out))
        print(f"  cli.enhance bitwise NLEFilter().train_and_enhance: {same}")
        if not same:
            raise AssertionError("[13a] cli.enhance differs from "
                                 "train_and_enhance")

        # (b) denoise, dense and factored
        outs = {}
        for tag, extra in (("dense", []), ("factored", ["--factored"])):
            res = run_cli("denoise", [src, f(f"dn_{tag}.png"), *params,
                                      *CLI_DENOISE,
                                      f"--save-filter={f(f'dn_{tag}.npz')}",
                                      *extra], f(f"cd_{tag}.json"))()
            counts = cli_ok(f"cli.denoise {tag} --save-filter", res)
            paths[f"cli_denoise_{tag}"] = counts
            eig = [ln for ln in res[1].splitlines() if ln.startswith("eig ")]
            if (len(eig) != MAIN_ARGS[5]
                    or not all(float(ln.rsplit(" ", 1)[1]) <= 1.0
                               for ln in eig)):
                raise AssertionError(f"[13b] {tag}: eig lines {eig[:3]}...")
            outs[tag] = imread_bgr(f(f"dn_{tag}.png"))
        dense_c, fac_c = paths["cli_denoise_dense"], paths[
            "cli_denoise_factored"]
        if (dense_c["scaled_matmul"] < 1 or dense_c["affinity_matmul"] < 1
                or dense_c["scaled_gram"] < 1):
            raise AssertionError(f"[13b] dense denoise launches {dense_c}")
        if (fac_c["streaming_halfstep"] < 2 * MAIN_ARGS[4] + 1
                or fac_c["streaming_gram"] < 1
                or fac_c["streaming_ap"] != 1 or fac_c["streaming_atb"] != 1
                or any(fac_c[k] for k in DENSE_KERNELS)):
            raise AssertionError(f"[13b] factored denoise launches {fac_c}: "
                                 "K10/K11 must run once each (the R = 2 "
                                 "chroma apply) and no dense kernel")
        db = psnr(outs["dense"], outs["factored"])
        print(f"  cli.denoise dense vs --factored: {db:.2f} dB; "
              f"PSNR(denoised, input) {psnr(outs['dense'], img):.2f} dB")
        if not db >= 45.0:
            raise AssertionError(f"[13b] dense vs factored {db:.2f} dB")
        # The denoise flow in-process, warm (no process start, no npz):
        # train_for_denoise + denoise, each route once untimed, once timed.
        for tag, fac in (("dense", False), ("factored", True)):
            walls = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                flt = NLEFilter(device="cuda", factored=fac)
                flt.train_for_denoise(img, *MAIN_ARGS,
                                      *map(float, CLI_DENOISE[:2]))
                got = flt.denoise(img, float(CLI_DENOISE[2]),
                                  *map(float, CLI_DENOISE[:2]))
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                del flt
            print(f"  NLEFilter denoise {tag} in-process: {walls[0]:.3f} s, "
                  f"warm {walls[1]:.3f} s; bitwise the CLI's: "
                  f"{bool(np.array_equal(got, outs[tag]))}")
        L = torch.from_numpy(bgr_to_lab_u8_np(img)[..., 0]).cuda()
        bil_ms = cuda_ms(torch, lambda: bilateral_filter_u8(
            L, -1, float(CLI_DENOISE[0]), float(CLI_DENOISE[1])))
        print(f"  bilateral_filter_u8 at 1 MP (sigmas {CLI_DENOISE[0]}, "
              f"{CLI_DENOISE[1]}; plain PyTorch): {bil_ms:.3f} ms")
        del L
        torch.cuda.empty_cache()
        hold_device_stage1(torch, img)

        # Side by side: the applies, (c) the options and (d) the probes.
        t_side = time.perf_counter()
        applies = {"enhance": run_cli("apply", [f("enh.npz"), src,
                                                f("app.png"), *weights])}
        for tag in outs:
            applies[tag] = run_cli("apply", [
                f(f"dn_{tag}.npz"), src, f(f"ap_{tag}.png"), "--op=denoise",
                f"--shrink={CLI_DENOISE[2]}"])
        options = {}
        for flag in CLI_OPTIONS:
            tag = flag.strip("-").replace("=", "_")
            options[flag] = (tag, run_cli(
                "enhance", [src, f(f"{tag}.png"), *params, *weights, flag],
                f(f"co_{tag}.json")))
        probes = {
            "enhance usage": (run_cli("enhance", ["a", "b", "1"]),
                              "Usage: enhance <image> <output>"),
            "denoise usage": (run_cli("denoise", ["a"] * 5),
                              "Usage: denoise <image> <output>"),
            "apply usage": (run_cli("apply", []),
                            "Usage: nle-apply <filter.npz> <image>"),
            "enhance missing file": (run_cli(
                "enhance", ["/nonexistent.png", f("x.png"), *params,
                            *weights]),
                "Failed to read file from /nonexistent.png"),
            "apply missing filter": (run_cli(
                "apply", ["/nope.npz", src, f("x.png"), "1"]),
                "Failed to read filter from /nope.npz"),
        }
        print(f"  side by side: {len(applies) + len(options)} runs on the "
              f"card and {len(probes)} probes at once")
        for tag, wait in applies.items():
            label = ("cli.apply" if tag == "enhance"
                     else f"cli.apply --op=denoise ({tag} filter)")
            cli_ok(label, wait())
            want = dense_out if tag == "enhance" else outs[tag]
            got = imread_bgr(f("app.png") if tag == "enhance"
                             else f(f"ap_{tag}.png"))
            db = psnr(got, want)
            print(f"  {label} vs its direct run: {db:.2f} dB, bitwise "
                  f"{bool(np.array_equal(got, want))}")
            if not db >= 45.0:
                raise AssertionError(f"[13] {label}: {db:.2f} dB")
        for flag, (tag, wait) in options.items():
            counts = cli_ok(f"cli.enhance {flag}", wait())
            paths[f"cli_enhance_{tag}"] = counts
            if flag in ("--precision=float64", "--no-pallas"):
                if any(counts.values()):
                    raise AssertionError(f"[13c] {flag} launched a kernel: "
                                         f"{counts}")
            elif (counts["affinity_matmul"] < 1 or counts["scaled_matmul"] < 1
                  or counts["sinkhorn_halfstep_int16"] < 2 * MAIN_ARGS[4]):
                raise AssertionError(f"[13c] {flag} launches {counts}")
            out = imread_bgr(f(f"{tag}.png"))
            if out.shape != img.shape or out.dtype != np.uint8:
                raise AssertionError(f"[13c] {flag}: {out.shape} {out.dtype}")
            db = psnr(out, dense_out)
            # The device route's float32 eigh of Ka keeps noise eigenvalues
            # (nle_tpu's own device route is as far from its default route,
            # PERF.md): a reading, held on the CPU to nle_tpu's same route.
            gated = flag != "--stage1=device"
            print(f"  {flag} vs the default route: {db:.2f} dB"
                  + ("" if gated else " (a reading, ungated)"))
            if gated and not db >= 45.0:
                raise AssertionError(f"[13c] {flag}: {db:.2f} dB")
        for label, (wait, needle) in probes.items():
            rc, _, err, wall, _ = wait()
            ok = rc == 0 and needle in err
            print(f"  probe {label}: rc {rc}, {wall:.2f} s, "
                  f"{'the reference message' if ok else repr(err[:200])}")
            if not ok:
                raise AssertionError(f"[13d] {label}: {err[-2000:]}")
        print(f"  side by side: {time.perf_counter() - t_side:.1f} s")
    print(f"[13] the CLIs: {time.perf_counter() - t13:.1f} s")
    return paths


SERVE_BUDGET = 300_000_000   # [14] --max-filter-bytes: one 1 MP filter fits
SERVE_WORKERS = 2


def _post(base: str, path: str, body: bytes | None, timeout: float = 900):
    req = urllib.request.Request(f"{base}{path}", data=body)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def _get_json(url: str, timeout: float = 60):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_healthy(base: str, workers: int, deadline_s: float,
                  proc=None) -> dict:
    """Poll the pool's /healthz until every worker answers ok."""
    t_end = time.perf_counter() + deadline_s
    while time.perf_counter() < t_end:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"[14b] the pool exited rc {proc.returncode}")
        try:
            meta = _get_json(f"{base}/healthz", timeout=10)
            if meta.get("ok") and meta.get("workers") == workers:
                return meta
        except OSError:
            pass
        time.sleep(0.25)
    raise AssertionError(f"[14b] pool not healthy in {deadline_s} s")


def _pids_serving(port: int) -> list:
    """PIDs of the HTTP service processes started with --port=port."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as fh:
                argv = fh.read().split(b"\0")
        except OSError:
            continue
        if (b"nle_tpu_torch.serving.http" in argv
                and f"--port={port}".encode() in argv):
            out.append(int(pid))
    return out


def serve_counted(torch, _build, paths: dict, label: str, base: str,
                  path: str, body: bytes) -> bytes:
    """One request with the launch counts set to 0 just before it (the
    device idle) and read just after; kept in paths["serve_<label>"]."""
    torch.cuda.synchronize()
    _build.reset_launches()
    out = _post(base, path, body)
    torch.cuda.synchronize()
    paths[f"serve_{label}"] = dict(_build.LAUNCHES)
    return out


def launches_of(counts: dict) -> dict:
    return {k: v for k, v in counts.items() if v}


def serving_phase(torch, img, dense_out, bench_mps: dict) -> dict:
    """[14] serving and the batch CLI on the card, on [5]'s frame and its
    exposure-jittered copies (check_serving.frames), rock2 parameters:
    (a) the HTTP service in-process: the load check (4 concurrent /enhance,
    each bitwise a direct train_and_enhance, a byte-copy pair byte-equal,
    coalesced), then one server with --max-filter-bytes=SERVE_BUDGET and a
    spill dir: /enhance and /train + /apply bitwise [5]'s output (K1, K3
    x100, K6, K7 once a dense train, no kernel in a dense apply), /denoise
    and a factored /train?mode=denoise + /apply?op=denoise (K10/K11 once
    each, R = 2) and /enhance?factored=1 >= 45 dB from the dense routes, a
    second kept filter evicting and spilling the first, DELETE of the
    second and /apply reloading the first bitwise, /metrics' device
    memory; (b) the pool as a
    subprocess, SERVE_WORKERS workers sharing card 0: named traffic on the
    worker its name hashes to, a worker killed (SIGKILL) after its filter
    spilled, restarted by the supervisor and serving it bitwise, /healthz
    and /metrics over both; (c) python -m nle_tpu_torch.cli.batch on four
    1 MP PNGs (enhance) and two (denoise 10 10 2), each output bitwise the
    port's cli.enhance / cli.denoise on that image (one process running
    their main per image). Returns the counted requests' launches."""
    import signal
    import tempfile
    import threading

    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.serving.http import make_server
    from nle_tpu_torch.serving.pool import WorkerPool, _free_port
    from nle_tpu_torch.tools import check_serving
    from nle_tpu_torch.utils.imageio import (
        imdecode_bgr,
        imencode_png,
        imread_bgr,
        imwrite_bgr,
    )

    t14 = time.perf_counter()
    mp = img.shape[0] * img.shape[1] / 1e6
    q = check_serving.query(MAIN_ARGS, WEIGHTS)
    qtrain = q.rsplit("&w=", 1)[0]
    wq = q.rsplit("&w=", 1)[1]
    dn = (f"shrink={CLI_DENOISE[2]}&sigma_color={CLI_DENOISE[0]}"
          f"&sigma_space={CLI_DENOISE[1]}")
    png = imencode_png(img)
    paths = {}

    # -- (a) the HTTP service in-process -------------------------------
    ta = time.perf_counter()
    res = check_serving.run(check_serving.frames(img, 4), "cuda", MAIN_ARGS,
                            WEIGHTS)
    print(f"[14a] the load check (nle_tpu_torch.tools.check_serving, "
          f"{img.shape[0]}x{img.shape[1]}, {' '.join(map(str, MAIN_ARGS))}):"
          f" {json.dumps(res)}")
    print(f"  /enhance alone {res['alone_s']:.3f} s of wall; four at once "
          f"{res['concurrent_wall_s']:.3f} s: {res['requests_per_s']:.3f} "
          f"requests/s, {res['mp_per_s']:.3f} MP/s")
    if not res["ok"]:
        raise AssertionError(f"[14a] the load check failed: {res}")
    flt = NLEFilter(device="cuda")
    flt.train_for_denoise(img, *MAIN_ARGS, *map(float, CLI_DENOISE[:2]))
    ref_dn = flt.denoise(img, float(CLI_DENOISE[2]),
                         *map(float, CLI_DENOISE[:2]))
    del flt
    with tempfile.TemporaryDirectory() as spill:
        srv = make_server(device="cuda", spill_dir=spill,
                          max_filter_bytes=SERVE_BUDGET)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            def counted(label, path, body=png):
                return serve_counted(torch, _build, paths, label, base, path,
                                     body)

            outs = {}
            for label, path in (("enhance", f"/enhance?{q}"),
                                ("enhance_factored",
                                 f"/enhance?{q}&factored=1"),
                                ("denoise", f"/denoise?{qtrain}&{dn}")):
                t0 = time.perf_counter()
                outs[label] = imdecode_bgr(counted(label, path))
                print(f"  {path.split('?')[0]}{'?factored=1' if 'fact' in label else ''}: "
                      f"{time.perf_counter() - t0:.3f} s; launches "
                      f"{launches_of(paths['serve_' + label])}")
            meta = json.loads(counted("train", f"/train?name=a&{qtrain}"))
            if meta != {"name": "a", "k": MAIN_ARGS[5], "mode": "enhance",
                        "shape": list(img.shape[:2])}:
                raise AssertionError(f"[14a] /train answered {meta}")
            t0 = time.perf_counter()
            out_a = imdecode_bgr(counted("apply", f"/apply?name=a&w={wq}"))
            apply_s = time.perf_counter() - t0
            counted("train_denoise_factored",
                    f"/train?name=fd&mode=denoise&factored=1&{qtrain}&{dn}")
            outs["apply_denoise_factored"] = imdecode_bgr(counted(
                "apply_denoise_factored", f"/apply?name=fd&op=denoise&{dn}"))
            # /enhance edits the training channel: its cached buffer
            # serves, so the edit launches the scatter alone.
            c = paths["serve_enhance"]
            train_c = {k: 0 if k in PERM_KERNELS else v for k, v in c.items()}
            dense_ok = (c["affinity_matmul"] == 1 and c["scaled_gram"] == 1
                        and c["scaled_matmul"] == 1
                        and c["sinkhorn_halfstep_int16"] == 2 * MAIN_ARGS[4]
                        and sum(train_c.values()) == 2 * MAIN_ARGS[4] + 3
                        and c["perm_gather_u8"] == 0
                        and c["perm_scatter_u8"] == 1)
            if not dense_ok or paths["serve_train"] != train_c:
                raise AssertionError(f"[14a] a dense train must launch K1, "
                                     f"K6, K7 once and K3 x100, its edit the "
                                     f"scatter alone: {c}, "
                                     f"{paths['serve_train']}")
            if launches_of(paths["serve_apply"]) != {"perm_scatter_u8": 1}:
                raise AssertionError(f"[14a] a dense apply launched "
                                     f"{launches_of(paths['serve_apply'])}")
            cf = paths["serve_enhance_factored"]
            cd = paths["serve_apply_denoise_factored"]
            if (cf["streaming_halfstep"] < 2 * MAIN_ARGS[4] + 1
                    or cf["streaming_gram"] < 1 or cf["streaming_ap"] < 1
                    or cf["streaming_atb"] < 1
                    or any(cf[k] for k in DENSE_KERNELS)
                    or launches_of(cd) != {"streaming_ap": 1,
                                           "streaming_atb": 1}):
                raise AssertionError(f"[14a] factored launches {cf}, {cd}")
            same = {"/enhance": np.array_equal(outs["enhance"], dense_out),
                    "/train + /apply": np.array_equal(out_a, dense_out),
                    "/denoise": np.array_equal(outs["denoise"], ref_dn)}
            print(f"  bitwise the library: {same}; /apply {apply_s:.3f} s")
            if not all(same.values()):
                raise AssertionError(f"[14a] not bitwise the library: {same}")
            for label, ref in (("enhance_factored", dense_out),
                               ("apply_denoise_factored", ref_dn)):
                db = psnr(outs[label], ref)
                print(f"  {label} vs the dense route: {db:.2f} dB")
                if not db >= 45.0:
                    raise AssertionError(f"[14a] {label}: {db:.2f} dB")
            # A second kept dense filter passes the byte budget: the LRU
            # one (a) is evicted and spilled, then reloaded by /apply.
            t0 = time.perf_counter()
            _post(base, f"/train?name=b&{qtrain}", png)
            evict_s = time.perf_counter() - t0
            fs = _get_json(f"{base}/metrics")["filters"]
            # Drop b (memory, no checkpoint), so a's reload fits beside fd.
            urllib.request.urlopen(urllib.request.Request(
                f"{base}/filters?name=b", method="DELETE"), timeout=60).read()
            t0 = time.perf_counter()
            out_a2 = imdecode_bgr(_post(base, f"/apply?name=a&w={wq}", png))
            reload_s = time.perf_counter() - t0
            m = _get_json(f"{base}/metrics")
            mem = m["device_memory"]
            print(f"  budget {SERVE_BUDGET} B: /train b {evict_s:.3f} s "
                  f"(evicting a: its spill save included), then /apply a "
                  f"{reload_s:.3f} s (reload); filters {fs}; reload bitwise "
                  f"{bool(np.array_equal(out_a2, out_a))}")
            print(f"  /metrics device_memory {mem}; filters {m['filters']}; "
                  f"trains {m['trains']}, edits {m['edits']}, errors "
                  f"{m['errors']}")
            if not (fs["evictions"] >= 1 and fs["spilled"] >= 1
                    and fs["resident_bytes"] <= SERVE_BUDGET
                    and np.array_equal(out_a2, out_a)):
                raise AssertionError(f"[14a] eviction/reload: {fs}")
            row = mem.get("0", {})
            if not (row.get("bytes_in_use", 0) > 0
                    and row["peak_bytes_in_use"] >= row["bytes_in_use"]
                    and row["bytes_limit"] > row["peak_bytes_in_use"]
                    and m["errors"] == 0):
                raise AssertionError(f"[14a] /metrics: {mem}, {m['errors']}")
        finally:
            srv.shutdown()
            srv.server_close()
    torch.cuda.empty_cache()
    print(f"  [14a] {time.perf_counter() - ta:.1f} s")

    # -- (b) the pool, two workers on card 0 ---------------------------
    tb = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        port = _free_port()
        pbase = f"http://127.0.0.1:{port}"
        log = open(os.path.join(tmp, "pool.log"), "w+")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "nle_tpu_torch.serving.pool",
             f"--workers={SERVE_WORKERS}", "--device=cuda",
             "--worker-env=CUDA_VISIBLE_DEVICES=0", f"--port={port}",
             f"--spill-root={os.path.join(tmp, 'spill')}",
             f"--max-filter-bytes={SERVE_BUDGET}"],
            cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
            start_new_session=True)
        try:
            _wait_healthy(pbase, SERVE_WORKERS, 300, proc)
            start_s = time.perf_counter() - t0
            log.seek(0)
            line = next(ln for ln in log if "serving pool on" in ln)
            ports = [int(x) for x in line.rsplit(":", 1)[1].strip(" )\n")
                     .split(", ")]
            pick = WorkerPool(SERVE_WORKERS, [])
            names = [f"scene-{i}" for i in range(32)]
            idx = {n: pick.pick("/train", f"name={n}").idx for n in names}
            a, b = [n for n in names if idx[n] == 0][:2]
            other = next(n for n in names if idx[n] == 1)
            print(f"[14b] the pool: {SERVE_WORKERS} workers on card 0 "
                  f"(ports {ports}) healthy {start_s:.2f} s after its start; "
                  f"{a!r} and {b!r} hash to worker 0, {other!r} to 1")
            t0 = time.perf_counter()
            _post(pbase, f"/train?name={a}&{qtrain}", png)
            out_a = imdecode_bgr(_post(pbase, f"/apply?name={a}&w={wq}",
                                       png))
            first_s = time.perf_counter() - t0
            _post(pbase, f"/train?name={other}&{qtrain}&factored=1", png)
            t0 = time.perf_counter()
            _post(pbase, f"/train?name={b}&{qtrain}", png)   # spills a
            spill_s = time.perf_counter() - t0
            held = [set(_get_json(f"http://127.0.0.1:{p}/healthz")["filters"])
                    for p in ports]
            w0 = _get_json(f"http://127.0.0.1:{ports[0]}/metrics")["filters"]
            print(f"  worker 0 holds {sorted(held[0])} (filters {w0}), "
                  f"worker 1 {sorted(held[1])}; /train + /apply "
                  f"{first_s:.2f} s, /train {b!r} {spill_s:.2f} s")
            if not ({a, b} <= held[0] and held[1] == {other}
                    and w0["spilled"] >= 1
                    and np.array_equal(out_a, dense_out)):
                raise AssertionError(f"[14b] named traffic: {held}, {w0}, "
                                     "or /apply not bitwise the library")
            pids = _pids_serving(ports[0])
            if len(pids) != 1:
                raise AssertionError(f"[14b] worker 0 processes: {pids}")
            t0 = time.perf_counter()
            os.kill(pids[0], signal.SIGKILL)
            while _pids_serving(ports[0]) == pids:
                time.sleep(0.1)
            meta = _wait_healthy(pbase, SERVE_WORKERS, 300, proc)
            restart_s = time.perf_counter() - t0
            out_a3 = imdecode_bgr(_post(pbase, f"/apply?name={a}&w={wq}",
                                        png))
            pm = _get_json(f"{pbase}/metrics")
            print(f"  worker 0 killed (SIGKILL): healthy again after "
                  f"{restart_s:.2f} s; restarts {pm['restarts']}; /healthz "
                  f"workers {meta['workers']}, filters {meta['filters']}; "
                  f"{a!r} served again bitwise: "
                  f"{bool(np.array_equal(out_a3, out_a))}; trains "
                  f"{pm['trains']}, edits {pm['edits']}, errors "
                  f"{pm['errors']}")
            if not (pm["restarts"] >= 1 and a in meta["filters"]
                    and other in meta["filters"]
                    and np.array_equal(out_a3, out_a)):
                raise AssertionError(f"[14b] restart: {meta}, {pm}")
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
            log.close()
        for p in ports:
            if _pids_serving(p):
                raise AssertionError(f"[14b] a worker outlived the pool")
    print(f"  [14b] {time.perf_counter() - tb:.1f} s")

    # -- (c) the batch CLI ------------------------------------------------
    tc = time.perf_counter()
    jit = check_serving.frames(img, 5)
    enh_imgs = [jit[0], *jit[2:]]
    with tempfile.TemporaryDirectory() as tmp:
        srcs = []
        for i, frame in enumerate(enh_imgs):
            srcs.append(os.path.join(tmp, f"f{i}.png"))
            imwrite_bgr(srcs[-1], frame)
        params = [str(x) for x in MAIN_ARGS]
        # Both batch runs in one process (their main one after the other,
        # each timed; the first pays the imports and the first use).
        info = os.path.join(tmp, "batch.json")
        ops = {"enhance": (srcs, ",".join(map(str, WEIGHTS))),
               "denoise": (srcs[:2], ",".join(CLI_DENOISE))}
        argvs = {op: [f"--op={op}", os.path.join(tmp, f"out_{op}"), *params,
                      wts, *files] for op, (files, wts) in ops.items()}
        timing = ("import json, sys, time; "
                  "from nle_tpu_torch.cli import batch; "
                  "from nle_tpu_torch.ops.kernels import _build; "
                  f"argvs = {argvs!r}; runs = {{}}\n"
                  "for op, argv in argvs.items():\n"
                  "    _build.reset_launches(); t = time.perf_counter()\n"
                  "    rc = batch.main(argv)\n"
                  "    runs[op] = {'rc': rc, 's': time.perf_counter() - t, "
                  "'launches': dict(_build.LAUNCHES)}\n"
                  "json.dump(runs, open(sys.argv[1], 'w'))")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", timing, info], cwd=ROOT,
                           capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0 or r.stdout.split() != ["Done.", "Done."]:
            raise AssertionError(f"[14c] cli.batch: rc {r.returncode}\n"
                                 f"{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        with open(info) as fh:
            runs = json.load(fh)
        print(f"[14c] cli.batch in one process, {wall:.2f} s of wall:")
        for op, (files, _) in ops.items():
            n, run = len(files), runs[op]
            paths[f"batch_{op}"] = run["launches"]
            if run["rc"] != 0:
                raise AssertionError(f"[14c] cli.batch --op={op}: rc "
                                     f"{run['rc']}")
            print(f"  --op={op}, {n} x {mp:.3f} MP: {run['s']:.2f} s in main"
                  f"{' (its first use included)' if op == 'enhance' else ''}"
                  f": {n * mp / run['s']:.3f} MP/s; launches "
                  f"{launches_of(run['launches'])}")
        print(f"  the port bench's stream mode ([12f], warm, in-process): "
              f"{bench_mps.get('stream')} MP/s")
        # The per-image CLIs in one process: each main on each image.
        single = ("import sys; from nle_tpu_torch.cli import denoise, "
                  "enhance; d = sys.argv[1]; p = sys.argv[2:8]; "
                  f"w = {[str(x) for x in WEIGHTS]!r}; "
                  f"dn = {list(CLI_DENOISE)!r}; srcs = sys.argv[8:]; "
                  "[enhance.main([s, f'{d}/e{i}.png', *p, *w]) "
                  "for i, s in enumerate(srcs)]; "
                  "[denoise.main([s, f'{d}/d{i}.png', *p, *dn]) "
                  "for i, s in enumerate(srcs[:2])]")
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-c", single, tmp, *params,
                            *srcs], cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"[14c] per-image CLIs: {r.stderr[-4000:]}")
        same = []
        for i in range(len(srcs)):
            same.append(np.array_equal(
                imread_bgr(os.path.join(tmp, "out_enhance",
                                        f"f{i}-enhanced.png")),
                imread_bgr(os.path.join(tmp, f"e{i}.png"))))
        for i in range(2):
            same.append(np.array_equal(
                imread_bgr(os.path.join(tmp, "out_denoise",
                                        f"f{i}-denoised.png")),
                imread_bgr(os.path.join(tmp, f"d{i}.png"))))
        print(f"  bitwise the per-image cli.enhance (4) and cli.denoise (2), "
              f"run in one process ({time.perf_counter() - t0:.2f} s): "
              f"{same}")
        if not all(same):
            raise AssertionError(f"[14c] batch outputs differ: {same}")
        le = runs["enhance"]["launches"]
        if (le["affinity_matmul"] != 4 or le["scaled_gram"] != 4
                or le["scaled_matmul"] != 4
                or le["sinkhorn_halfstep_int16"] != 4 * 2 * MAIN_ARGS[4]):
            raise AssertionError(f"[14c] batch enhance launches {le}")
    print(f"  [14c] {time.perf_counter() - tc:.1f} s")
    print(f"[14] serving and the batch CLI: {time.perf_counter() - t14:.1f} s")
    return paths


# -- [15] multi-GPU: the pixel-sharded trainers over torch.distributed -----

SHARD_TIMEOUT = 300          # seconds [15d]'s check tool may take
SHARD_PEAK_SHARE = 0.6       # [15b] each rank's peak against [7]'s


def sharded_phase(torch, img, dense_out, cap_edit, cap_peak: int) -> dict:
    """[15] the pixel-sharded trainers on the card, as worker processes
    (one a rank, every worker timed out and killed with the others if one
    fails): (a) the 1 MP dense main path at (data, pixel) = (1, 2), run
    twice, and (2, 2) on two exposure-jittered copies, over gloo with the
    ranks sharing the card; (b) the 32 MP factored path at (1, 2); (c) the
    1 MP dense run over NCCL at world size device_count; (d) the one-rank
    check tool. Returns each rank's cold launch counts of (a) at (1, 2)
    and of (b)."""
    import tempfile

    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np
    from nle_tpu_torch.parallel.distributed import launch, worker_env
    from nle_tpu_torch.tools.check_serving import frames as jittered
    from nle_tpu_torch.tools.sharded_scaling import run as run_sharded

    t15 = time.perf_counter()
    torch.cuda.empty_cache()

    def recompose(lab, plane):
        out = lab.copy()
        out[..., 0] = plane
        return lab_to_bgr_u8_np(out)

    lab = bgr_to_lab_u8_np(img)
    jit = jittered(img, 4)[2:4]
    jit_labs = [bgr_to_lab_u8_np(f) for f in jit]
    jit_single = [NLEFilter(device="cuda").train_and_enhance(
        f, *MAIN_ARGS, weights=WEIGHTS) for f in jit]
    big = structured_frame(*CAP_SHAPE, seed=7)
    lab_big = bgr_to_lab_u8_np(big)
    del big
    ndev = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, arr in (("dense1", lab[None, ..., 0]),
                          ("dense2", np.stack([x[..., 0] for x in jit_labs])),
                          ("cap", lab_big[..., 0])):
            paths[name] = os.path.join(tmp, f"{name}.npy")
            np.save(paths[name], arr)
        t0 = time.perf_counter()
        paths["noise"] = os.path.join(tmp, "noise.npy")
        np.save(paths["noise"],
                bgr_to_lab_u8_np(noise_frame())[None, ..., 0])
        a12 = run_sharded(tmp, "a12", (1, 2), "gloo", [
            dict(tag="dense", kind="dense", frames=paths["dense1"],
                 args=MAIN_ARGS, reps=2),
            dict(tag="guard", kind="dense", frames=paths["noise"], reps=1,
                 args=(10, 10, 5.0, 30.0, GUARD_ITERS, 5)),
            dict(tag="cap", kind="factored", frames=paths["cap"],
                 args=CAP_ARGS, reps=1)])
        a12_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        a22 = run_sharded(tmp, "a22", (2, 2), "gloo", [
            dict(tag="dense", kind="dense", frames=paths["dense2"],
                 args=MAIN_ARGS, reps=1)])
        a22_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        c1 = run_sharded(tmp, "nccl", (1, ndev), "nccl", [
            dict(tag="dense", kind="dense", frames=paths["dense1"],
                 args=MAIN_ARGS, reps=1)])
        c_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tool = launch([[sys.executable, "-m", "nle_tpu_torch.tools.check_sharded"]],
                  timeout=SHARD_TIMEOUT, env=worker_env())[0]
    d_s = time.perf_counter() - t0

    dense_need = {"affinity_matmul": 1,
                  "sinkhorn_halfstep_int16": 2 * MAIN_ARGS[4],
                  "scaled_gram": 1, "scaled_matmul": 1}

    def hold_dense(label, ranks, singles, labs, spent):
        print(f"[15a] {label}: launch {spent:.1f} s (process starts "
              "included)")
        for r, res in enumerate(ranks):
            c = res["counts"][0]
            crush = res["extra"][0][:-1]
            print(f"  rank {r}: wall {', '.join(f'{w:.3f}' for w in res['walls'])}"
                  f" s a train+apply of {len(labs)} frame(s); crush "
                  f"{', '.join(f'{x:.4f}' for x in crush)}; guard tripped: "
                  f"{'yes' if res['extra'][0][-1] else 'no'}; peak "
                  f"{res['peak'] / 2**30:.3f} GiB; K1 {c['affinity_matmul']}, "
                  f"K3 {c['sinkhorn_halfstep_int16']}, K4 "
                  f"{c['sinkhorn_halfstep_f32']}, K6 {c['scaled_gram']}, K7 "
                  f"{c['scaled_matmul']}")
            for name, least in dense_need.items():
                if c[name] < least:
                    raise AssertionError(f"[15a] {label} rank {r}: {name} "
                                         f"ran {c[name]} times (< {least})")
            if not np.array_equal(res["edits"][0], ranks[0]["edits"][0]):
                raise AssertionError(f"[15a] {label}: ranks' edits differ")
        outs = []
        for i, (single, lab_i) in enumerate(zip(singles, labs)):
            out = recompose(lab_i, ranks[0]["edits"][0][i])
            db = psnr(out, single)
            print(f"  frame {i}: {db:.2f} dB from the single-card edit")
            if not db >= 45.0:
                raise AssertionError(f"[15a] {label} frame {i}: {db:.2f} dB")
            outs.append(out)
        return outs

    a_out = hold_dense("(1, 2) over gloo, 1 MP", a12["dense"], [dense_out],
                       [lab], a12_s)[0]
    same = all(np.array_equal(r["edits"][0], r["edits"][1])
               for r in a12["dense"])
    print(f"  two runs at (1, 2) bitwise equal: {same}")
    if not same:
        raise AssertionError("[15a] two runs at (1, 2) differ")
    hold_dense("(2, 2) over gloo, two jittered 1 MP frames", a22["dense"],
               jit_single, jit_labs, a22_s)
    # The carrier guard on the pixel axis: the noise frame trips it on the
    # all-reduced crush statistic, and every rank retrains through K4.
    for r, res in enumerate(a12["guard"]):
        c = res["counts"][0]
        print(f"  noise frame 120x120 at (1, 2): rank {r} crush "
              f"{res['extra'][0][0]:.4f}, retrained: "
              f"{'yes' if res['extra'][0][-1] else 'no'}; K3 "
              f"{c['sinkhorn_halfstep_int16']}, K4 "
              f"{c['sinkhorn_halfstep_f32']}")
        if not (res["extra"][0][-1]
                and c["sinkhorn_halfstep_f32"] >= 2 * GUARD_ITERS):
            raise AssertionError(f"[15a] the guard did not retrain rank {r}")

    need = {"streaming_halfstep": 2 * CAP_ARGS[4] + 1, "streaming_gram": 1,
            "streaming_ap": 1, "streaming_atb": 1}
    print(f"[15b] 32 MP factored at (1, 2) over gloo: launch {a12_s:.1f} s "
          f"with [15a]'s (1, 2) runs; [7]'s single-card peak "
          f"{cap_peak / 2**30:.3f} GiB")
    for r, res in enumerate(a12["cap"]):
        c = res["counts"][0]
        print(f"  rank {r}: train {res['extra'][0][0]:.3f} s, apply "
              f"{res['walls'][0]:.3f} s; peak {res['peak'] / 2**30:.3f} GiB "
              f"= {res['peak'] / cap_peak:.3f} x [7]'s; K8 "
              f"{c['streaming_halfstep']}, K12 {c['streaming_gram']}, K10 "
              f"{c['streaming_ap']}, K11 {c['streaming_atb']}")
        for name, least in need.items():
            if c[name] < least:
                raise AssertionError(f"[15b] rank {r}: {name} ran {c[name]} "
                                     f"times (< {least})")
        for name in DENSE_KERNELS:
            if c[name]:
                raise AssertionError(f"[15b] rank {r}: {name} launched")
        if not res["peak"] <= SHARD_PEAK_SHARE * cap_peak:
            raise AssertionError(f"[15b] rank {r}: peak {res['peak']} > "
                                 f"{SHARD_PEAK_SHARE} x {cap_peak}")
    db = psnr(recompose(lab_big, a12["cap"][0]["edits"][0][0]), cap_edit)
    print(f"  {db:.2f} dB from [7]'s single-card factored edit")
    if not db >= 45.0:
        raise AssertionError(f"[15b] {db:.2f} dB from [7]")

    res = c1["dense"][0]
    db = psnr(recompose(lab, res["edits"][0][0]), a_out)
    print(f"[15c] 1 MP dense over NCCL at world size {ndev}: launch "
          f"{c_s:.1f} s, wall {res['walls'][0]:.3f} s; {db:.2f} dB from "
          f"[15a]'s (1, 2) edit")
    if not db >= 45.0:
        raise AssertionError(f"[15c] {db:.2f} dB from (a)")
    line = tool.strip().splitlines()[-1]
    print(f"[15d] nle_tpu_torch.tools.check_sharded ({d_s:.1f} s): {line}")
    if not json.loads(line).get("ok"):
        raise AssertionError(f"[15d] the check failed: {line}")
    print(f"[15] multi-GPU: {time.perf_counter() - t15:.1f} s (ranks "
          "sharing one card over gloo measure the sharding code, not "
          "multi-card scaling)")
    return {"sharded_dense_1mp": [r["counts"][0] for r in a12["dense"]],
            "sharded_factored_32mp": [r["counts"][0] for r in a12["cap"]]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run "
              "needs an NVIDIA GPU.", file=sys.stderr)
        return 2
    import nle_tpu_torch  # noqa: F401  (pins fp32 precision)
    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.ops.kernels import _build
    from nle_tpu_torch.ops.kernels.affinity_kernel import (
        affinity_matmul_kernel,
        affinity_matmul_plain,
    )
    from nle_tpu_torch.ops.kernels.sinkhorn_kernel import (
        carrier_crush_frac,
        k13_tile,
        padded_shape,
        quantize_int16,
        sinkhorn_halfstep,
        sinkhorn_halfstep_plain,
        sinkhorn_halfstep_tiled,
        sinkhorn_halfstep_tiled_plain,
        split_row_pad,
    )

    def tiled_plain(Q, t, e):
        return sinkhorn_halfstep_tiled_plain(Q, t, e, k13_tile(Q.shape[1]))
    from nle_tpu_torch.ops.kernels.streaming_kernel import (
        streaming_ap,
        streaming_ap_plain,
        streaming_atb,
        streaming_atb_plain,
        streaming_halfstep,
        streaming_halfstep_plain,
        streaming_halfstep_ptiled_plain,
        streaming_sample_gram,
        streaming_sample_gram_plain,
        streaming_sinkhorn_vectors,
    )
    from nle_tpu_torch.tools.stream_precision import streaming_edit_f64

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
    sass = sass_per_entry(_build.library_path())
    missing = [k for k in SASS_KEYS + CORE_KEYS if k not in sass]
    if missing:
        raise AssertionError(f"[2] no entry loop found for {missing} (no "
                             "cuobjdump, or a needle matches no kernel)")
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, timeout=60,
        check=True).stdout.split()[0]
    # Thread instructions the card issues per second: 132 SMs x 4
    # schedulers x 32 lanes x the maximum SM clock.
    issue_rate = 132 * 128 * float(clock) * 1e6
    from nle_tpu_torch.ops.kernels.affinity_kernel import AFF_BUILD
    ex2_build = {}    # the affinity core: MUFU.EX2 a build of an entry, by TN
    core_sass = {}    # its main loop: (instructions, FFMAs), by TN
    for key in CORE_KEYS:
        if key not in sass:
            continue
        ninst, nexp, nbar, _, nffma = sass.pop(key)
        tn = int(key.split("ILi")[1].split("E")[0])
        ex2_build[tn] = nexp / AFF_BUILD
        core_sass[tn] = (ninst, nffma)
        print(f"  sass: {key} (the affinity core: K1, K2's contract, the "
              f"fp32 K12's phi step) main loop {ninst} instructions, {nffma} FFMA "
              f"({nffma / ninst:.3f} of them), {nbar} barrier a step; "
              f"{nexp} MUFU.EX2 for the {AFF_BUILD} entries a thread builds "
              f"a step = {nexp / AFF_BUILD:.2f} per entry a panel")
        if nexp != AFF_BUILD:
            raise AssertionError(f"{key}: {nexp} MUFU.EX2 for {AFF_BUILD} "
                                 "entries: not one a build")
    for key, (ninst, nexp, nbar, nfinal, _) in sass.items():
        print(f"  sass: {key} inner loop {ninst} instructions for {nexp} "
              f"affinity entries = {ninst / nexp:.1f} per entry "
              f"(max SM clock {clock} MHz)")
        entries = onebuild_entries(key, nbar)
        if entries is not None:
            print(f"  sass: {key}: {(ninst - nfinal) / nexp:.1f} per entry "
                  f"outside the finalizing warp's branch ({nfinal} "
                  "instructions, one warp of the block)")
            # One build per entry: the loop's row groups (one barrier
            # each) build `entries` entries with one MUFU.EX2 apiece.
            print(f"  sass: {key}: {nbar} row groups = {entries} entries, "
                  f"{nexp} MUFU.EX2 = {nexp / max(entries, 1):.2f} per entry")
            if nexp != entries:
                raise AssertionError(f"{key}: {nexp} MUFU.EX2 for {entries} "
                                     "entries: not one build per entry")

    # -- [3] each kernel against its plain version at main-path shapes ----
    h, w = MAIN_SHAPE
    iters, kvec = MAIN_ARGS[4:]
    img = structured_frame(h, w)
    L = bgr_to_lab_u8_np(img)[..., 0].astype(np.float32)
    op = path_operands(torch, L, MAIN_ARGS, dev)
    p, n, m, mb, mpad = op.p, op.n, op.m, op.mb, op.mpad
    Um, lam, Uinv, fa, fb, sw, pw = (op.Um, op.lam, op.Uinv, op.fa, op.fb,
                                     op.sw, op.pw)
    nb = n - p
    npad_b = split_row_pad(nb)
    print(f"[3] kernels vs plain at the main path: n={n}, p={p}, m={m}, "
          f"mb={mb}, npad_b={npad_b}, mpad={mpad}")
    rows = []

    def record(name, src, repl, err, ms, plain_ms, nbytes, flops,
               library_ms=None, sass_key=(), entries=0, launch=None):
        """err: (max_abs_err, max err/bound) of the kernel's checks.
        sass_key: the SASS_KEYS of the kernel's entry loops (K9 has two).
        launch: (path, LAUNCHES key) whose count is the row's launches;
        by default the kernel's own name on the 1 MP dense path (K1-K7)
        or the 32 MP factored path (K8-K12)."""
        bms, by = bound_ms(nbytes, flops)
        lib = "" if library_ms is None else f", library {library_ms:.3f} ms"
        print(f"  {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms{lib}, "
              f"bound {bms:.4f} ms ({by}: {nbytes:.4g} B, {flops:.4g} flop)")
        if launch is None:
            launch = ("factored_32mp" if name in STREAMING_KERNELS
                      else "dense_1mp", name)
        rows.append(dict(name=name, route="cuda", source=src, replaces=repl,
                         max_abs_err=err[0], err_over_bound=err[1], ms=ms,
                         plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                         library_ms=library_ms, _launch=launch))
        keys = (sass_key,) if isinstance(sass_key, str) else sass_key
        if keys and all(k in sass for k in keys):
            per = sum(sass[k][0] / sass[k][1] for k in keys)
            # Issue time of the entry-building loops alone: a floor under
            # the kernel's instruction-issue time.
            issue_ms = entries * per / issue_rate * 1e3
            # Each loop builds an entry once, with one MUFU.EX2 (expf).
            rows[-1]["expf_per_entry"] = len(keys)
            rows[-1]["sass_per_entry"] = per
            # K8: the same loop outside the finalizing warp's branch, what
            # every other warp of the block issues.
            rows[-1]["sass_per_entry_other_warps"] = sum(
                (sass[k][0] - sass[k][3]) / sass[k][1] for k in keys)
            rows[-1]["issue_ms_entry_loop"] = issue_ms
            print(f"  {name}: entry loops {per:.1f} instructions and "
                  f"{len(keys)} expf per entry -> issue time {issue_ms:.3f} ms")
        return rows[-1]

    def k1_core(row, fn, mpad_, where):
        """K1's builds an entry and MUFU.EX2 an entry (the launch grids of
        one profiled call times the SASS's MUFU.EX2 a build), and the
        core's main-loop FFMA share (TN = 12, the full panel's
        instantiation)."""
        core_expf(row, profile_grids(torch, fn, CORE_TRACE), ex2_build,
                  mpad_, where)
        if 12 in core_sass:
            ninst, nffma = core_sass[12]
            row["core_main_loop_sass"] = ninst
            row["core_main_loop_ffma_share"] = nffma / ninst

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
               fa, fb, Uinv, sw, pw, out_rows=npad_b)),
           4 * (3 * nb + p * mb + npad_b * mpad),
           2 * nb * p * mb + ENTRY_FLOPS * nb * p)
    k1_core(rows[-1], lambda: affinity_matmul_kernel(
        fa, fb, Uinv, sw, pw, out_rows=npad_b), mpad, "[3] 1 MP")
    # K1 at [9b]'s p = 1200 operands profiled here, before the long
    # profiled calls of [6]-[9a]: a profile taken after them saw no device
    # events on the H100 machine (why is not known: PERF.md section 7).
    # [9b] puts these fields into the K2 row, which says where they came
    # from in builds_measured_at.
    op12 = path_operands(torch, L, P1200_ARGS, dev)
    k2_core = {"name": "affinity_matmul_ptiled"}
    k1_core(k2_core, lambda: affinity_matmul_kernel(
        op12.fa, op12.fb, op12.Uinv, op12.sw, op12.pw,
        out_rows=split_row_pad(op12.n - op12.p)), op12.mpad, "[9b] p = 1200")
    del op12, k2_core["name"]
    k2_core["builds_measured_at"] = "[3]: the p = 1200 operands, profiled"

    Um_pad = torch.nn.functional.pad(Um, (0, mpad - mb))
    lam_pad = torch.nn.functional.pad(lam, (0, mpad - mb))
    q16, scale, _ = quantize_int16(phib)
    crush = float(carrier_crush_frac(phib, scale))
    print(f"  int16 carrier crush statistic at 1 MP: {crush:.4f} "
          f"(guard trips above 0.2: {'yes' if crush > 0.2 else 'no'})")
    s0 = Um_pad.T @ torch.ones(p, device=dev) + phib.sum(dim=0)
    tq = (scale * (lam_pad * s0)).contiguous()

    def halfstep_check(label, Q, t):
        return hold_halfstep(torch, label, Q, t, eps)

    xk, err = halfstep_check("K3 sinkhorn int16", q16, tq)
    record("sinkhorn_halfstep_int16", "nle_tpu_torch/csrc/sinkhorn.cu",
           "nle_tpu/ops/pallas/sinkhorn_kernel.py:121", err,
           cuda_ms(torch, lambda: sinkhorn_halfstep(q16, tq, eps), reps=10),
           cuda_ms(torch, lambda: sinkhorn_halfstep_plain(q16, tq, eps)),
           2 * npad_b * mpad + 4 * (npad_b + 2 * mpad), 4 * nb * mb)
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
           cuda_ms(torch, lambda: sinkhorn_halfstep_plain(phi, t32, eps)),
           4 * (npad * mpad + npad + 2 * mpad), 4 * n * mb)
    # torch.mv on the same f32 factor: a yardstick of one read of it, not
    # the same function (K16-K19's bracketed number).
    rows[-1]["torch_mv_ms"] = cuda_ms(torch, lambda: torch.mv(phi, t32),
                                      reps=10)
    print(f"  torch.mv on the same f32 factor: "
          f"{rows[-1]['torch_mv_ms']:.3f} ms")
    del phi

    c = xk[:, None].contiguous()          # a real balancing vector
    hold_scaled(torch, record, "", phib, c, nb, mb, kvec)
    del phib, c, xk
    torch.cuda.empty_cache()

    # The streaming kernels at the same frame's shapes: the rest pixels
    # against the p samples, R = 1 row for the timed K10/K11 calls.
    errs, t = hold_streaming(torch, op, eps, "1 MP")
    fa_rows, fb_cols, mask, u = t["fa_rows"], t["fb_cols"], t["mask"], t["u"]
    X, b, c_row = t["X"], t["b"], t["c_row"]
    qpad, ppad = t["qpad"], t["ppad"]
    unit_ms = cuda_ms(torch, lambda: streaming_halfstep(
        fa_rows, fb_cols, mask, u, sw, pw, eps, unit_x=True), reps=10)
    entries = nb * p
    record("streaming_halfstep", "nle_tpu_torch/csrc/streaming.cu",
           "nle_tpu/ops/pallas/streaming_kernel.py:105",
           errs["streaming_halfstep"],
           cuda_ms(torch, lambda: streaming_halfstep(
               fa_rows, fb_cols, mask, u, sw, pw, eps), reps=10),
           cuda_ms(torch, lambda: streaming_halfstep_plain(
               fa_rows, fb_cols, mask, u, sw, pw, eps)),
           4 * (3 * qpad + 2 * qpad + 5 * ppad), (ENTRY_FLOPS + 4) * entries,
           sass_key=onebuild_key(qpad, ppad), entries=entries)
    rows[-1]["unit_x_ms"] = unit_ms
    print(f"  streaming_halfstep unit_x: kernel {unit_ms:.3f} ms")
    record("streaming_ap", "nle_tpu_torch/csrc/streaming.cu",
           "nle_tpu/ops/pallas/streaming_kernel.py:299", errs["streaming_ap"],
           cuda_ms(torch, lambda: streaming_ap(fa_rows, fb_cols, X, sw, pw),
                   reps=10),
           cuda_ms(torch, lambda: streaming_ap_plain(fa_rows, fb_cols, X,
                                                     sw, pw)),
           4 * (4 * qpad + 4 * ppad), (ENTRY_FLOPS + 2) * entries,
           sass_key="stream_ap_kernelILi1E", entries=entries)
    record("streaming_atb", "nle_tpu_torch/csrc/streaming.cu",
           "nle_tpu/ops/pallas/streaming_kernel.py:369", errs["streaming_atb"],
           cuda_ms(torch, lambda: streaming_atb(fa_rows, fb_cols, b, sw, pw),
                   reps=10),
           cuda_ms(torch, lambda: streaming_atb_plain(fa_rows, fb_cols, b,
                                                      sw, pw)),
           4 * (4 * qpad + 4 * ppad), (ENTRY_FLOPS + 2) * entries,
           sass_key="stream_atb_kernelILi1ELb0E", entries=entries)
    # R = 2, the factored denoise's apply (its two chroma planes as kernel
    # rows, [13b]): held above, timed here into the rows' r2_* fields.
    X2, b2 = t["X2"], t["b2"]
    for name, fn, plain in (
            ("streaming_ap",
             lambda: streaming_ap(fa_rows, fb_cols, X2, sw, pw),
             lambda: streaming_ap_plain(fa_rows, fb_cols, X2, sw, pw)),
            ("streaming_atb",
             lambda: streaming_atb(fa_rows, fb_cols, b2, sw, pw),
             lambda: streaming_atb_plain(fa_rows, fb_cols, b2, sw, pw))):
        bms, by = bound_ms(4 * (5 * qpad + 5 * ppad),
                           (ENTRY_FLOPS + 4) * entries)
        row = next(r for r in rows if r["name"] == name)
        err = errs[f"{name} R=2"]
        row.update({"r2_max_abs_err": err[0], "r2_err_over_bound": err[1],
                    "r2_ms": cuda_ms(torch, fn, reps=10),
                    "r2_plain_ms": cuda_ms(torch, plain),
                    "r2_bound_ms": bms, "r2_bound_by": by})
        print(f"  {name} R=2: kernel {row['r2_ms']:.3f} ms, plain "
              f"{row['r2_plain_ms']:.3f} ms, bound {bms:.4f} ms ({by})")
    record("streaming_gram", "nle_tpu_torch/csrc/streaming.cu",
           "nle_tpu/ops/pallas/streaming_kernel.py:453",
           errs["streaming_gram"],
           cuda_ms(torch, lambda: streaming_sample_gram(
               fa_rows, fb_cols, c_row, sw, pw)),
           cuda_ms(torch, lambda: streaming_sample_gram_plain(
               fa_rows, fb_cols, c_row, sw, pw)),
           *gram_bound(p, nb, qpad, ppad))
    del fa_rows, fb_cols, mask, u, X, b, X2, b2, c_row, t, op
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
    peak = PeakMeter(torch)
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
    peak.dense_ratio("  1 MP dense", n, mb)
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
    import hashlib

    print(f"  warm {warm_s:.3f} s = {mp / warm_s:.3f} MP/s; cold == warm "
          f"bitwise: {bool(np.array_equal(cold, warm))}; "
          f"PSNR(output, input) {psnr(warm, img):.2f} dB; output sha256 "
          f"{hashlib.sha256(warm.tobytes()).hexdigest()[:16]} (the bits, "
          "to compare across versions)")
    if cold.shape != img.shape or cold.dtype != np.uint8:
        raise AssertionError(f"output {cold.shape} {cold.dtype}")
    if not np.array_equal(cold, warm):
        raise AssertionError("1 MP: cold and warm runs differ")

    guard_counts = guard_paths(torch, NLEFilter, _build)
    # -- [6] where the time goes: one profiled warm call ------------------
    profile_call(torch, "[6] profiled warm 1 MP call",
                 lambda: NLEFilter(device="cuda").train_and_enhance(
                     img, *MAIN_ARGS, weights=WEIGHTS), mp)

    # -- [7] the capacity path at 32 MP; [8] cross-path checks ------------
    cap_counts, cap_errs, t = capacity_path(torch, NLEFilter, _build, "[7]",
                                            CAP_SHAPE, CAP_ARGS, seed=7)
    cap_edit, cap_peak = t.pop("edit"), t["peak_bytes"]
    # K8 at 32 MP, its busiest path (2 x iters launches a train).
    fa_rows, fb_cols, mask, u = t["fa_rows"], t["fb_cols"], t["mask"], t["u"]
    qpad, ppad = t["qpad"], t["ppad"]
    entries = t["q"] * t["p"]
    k8 = next(r for r in rows if r["name"] == "streaming_halfstep")
    sw7, pw7 = t["sw"], t["pw"]
    k8["ms_32mp"] = cuda_ms(torch, lambda: streaming_halfstep(
        fa_rows, fb_cols, mask, u, sw7, pw7, eps), reps=10)
    k8["plain_ms_32mp"] = cuda_ms(torch, lambda: streaming_halfstep_plain(
        fa_rows, fb_cols, mask, u, sw7, pw7, eps), reps=1)
    k8["bound_ms_32mp"], k8["bound_by_32mp"] = bound_ms(
        4 * (3 * qpad + 2 * qpad + 5 * ppad), (ENTRY_FLOPS + 4) * entries)
    key = onebuild_key(qpad, ppad)
    if key in sass:
        k8["issue_ms_32mp"] = (entries * sass[key][0] / sass[key][1]
                               / issue_rate * 1e3)
    print(f"[7] K8 at 32 MP (q={t['q']}, Ppad={ppad}): kernel "
          f"{k8['ms_32mp']:.3f} ms, plain {k8['plain_ms_32mp']:.3f} ms, "
          f"bound {k8['bound_ms_32mp']:.4f} ms ({k8['bound_by_32mp']}), "
          f"entry-loop issue {k8.get('issue_ms_32mp', float('nan')):.3f} ms")
    # K10 and K11 at 32 MP, the apply's two kernels (K10's also the s0
    # pass): launches are the profiled call's.
    X7, b7 = t["X"], t["b"]
    for name, fn, plain in (
            ("streaming_ap",
             lambda: streaming_ap(fa_rows, fb_cols, X7, sw7, pw7),
             lambda: streaming_ap_plain(fa_rows, fb_cols, X7, sw7, pw7)),
            ("streaming_atb",
             lambda: streaming_atb(fa_rows, fb_cols, b7, sw7, pw7),
             lambda: streaming_atb_plain(fa_rows, fb_cols, b7, sw7, pw7))):
        row = next(r for r in rows if r["name"] == name)
        row["ms_32mp"] = cuda_ms(torch, fn, reps=10)
        row["plain_ms_32mp"] = cuda_ms(torch, plain, reps=1)
        row["bound_ms_32mp"], row["bound_by_32mp"] = bound_ms(
            4 * (4 * qpad + 4 * ppad), (ENTRY_FLOPS + 2) * entries)
        row["launches_profiled_32mp"] = t["profiled"][name]
        key = ("stream_ap_kernelILi1E" if name == "streaming_ap"
               else "stream_atb_kernelILi1ELb0E")
        row["issue_ms_32mp"] = (entries * sass[key][0] / sass[key][1]
                                / issue_rate * 1e3)
        print(f"[7] {name} at 32 MP: kernel {row['ms_32mp']:.3f} ms, plain "
              f"{row['plain_ms_32mp']:.3f} ms, bound "
              f"{row['bound_ms_32mp']:.4f} ms ({row['bound_by_32mp']}), "
              f"entry-loop issue {row['issue_ms_32mp']:.3f} ms, launches of "
              f"its kernel in the profiled call "
              f"{row['launches_profiled_32mp']}")
    # K12 at 32 MP, once a train.
    k12 = next(r for r in rows if r["name"] == "streaming_gram")
    c_row = t["c_row"]
    k12["ms_32mp"] = cuda_ms(torch, lambda: streaming_sample_gram(
        fa_rows, fb_cols, c_row, sw7, pw7), reps=1)
    k12["plain_ms_32mp"] = cuda_ms(torch, lambda: streaming_sample_gram_plain(
        fa_rows, fb_cols, c_row, sw7, pw7), reps=1)
    k12["bound_ms_32mp"], k12["bound_by_32mp"] = bound_ms(
        *gram_bound(t["p"], t["q"], qpad, ppad))
    print(f"[7] K12 at 32 MP (Ppad={ppad}): kernel {k12['ms_32mp']:.3f} ms, "
          f"plain {k12['plain_ms_32mp']:.3f} ms, bound "
          f"{k12['bound_ms_32mp']:.4f} ms ({k12['bound_by_32mp']})")
    del t, fa_rows, fb_cols, mask, u, c_row, X7, b7
    torch.cuda.empty_cache()
    stream_counts = cross_paths(torch, NLEFilter, _build, img, warm)
    near_threshold(torch, NLEFilter, _build)

    # -- [9] dense sampling grids ------------------------------------------
    t9 = time.perf_counter()
    grid_counts, grid_errs, t = capacity_path(
        torch, NLEFilter, _build, "[9a]", GRID_CAP_SHAPE, GRID_CAP_ARGS, seed=7)
    print(f"[9a] kernels vs plain at the 16 MP frame's shapes (q={t['q']}, "
          f"p={t['p']}, Ppad={t['ppad']}, mpad={t['mpad']})")
    fa_rows, fb_cols, mask, u = t["fa_rows"], t["fb_cols"], t["mask"], t["u"]
    qg, qpad, ppad, pg = t["q"], t["qpad"], t["ppad"], t["p"]
    sw, pw = t["sw"], t["pw"]      # the 16 MP frame's bandwidths
    entries = qg * pg
    grid_launch = "dense_grid_16mp"
    record("streaming_halfstep_ptiled", "nle_tpu_torch/csrc/streaming.cu",
           "nle_tpu/ops/pallas/streaming_kernel.py:189",
           grid_errs["streaming_halfstep_ptiled"],
           cuda_ms(torch, lambda: streaming_halfstep(
               fa_rows, fb_cols, mask, u, sw, pw, eps)),
           cuda_ms(torch, lambda: streaming_halfstep_ptiled_plain(
               fa_rows, fb_cols, mask, u, sw, pw, eps), reps=1),
           4 * (3 * qpad + 2 * qpad + 5 * ppad), (ENTRY_FLOPS + 4) * entries,
           sass_key=onebuild_key(qpad, ppad),
           entries=entries,
           launch=(grid_launch, "streaming_halfstep_ptiled"))
    rows[-1].update(hold_two_pass(torch, _build, t, eps, sass, issue_rate))
    Xg, bg = t["X"], t["b"]
    record(f"streaming_ap@ppad{ppad}", "nle_tpu_torch/csrc/streaming.cu",
           "nle_tpu/ops/pallas/streaming_kernel.py:299",
           grid_errs["streaming_ap"],
           cuda_ms(torch, lambda: streaming_ap(fa_rows, fb_cols, Xg, sw, pw)),
           cuda_ms(torch, lambda: streaming_ap_plain(fa_rows, fb_cols, Xg,
                                                     sw, pw), reps=1),
           4 * (4 * qpad + 4 * ppad), (ENTRY_FLOPS + 2) * entries,
           sass_key="stream_ap_kernelILi1E", entries=entries,
           launch=(grid_launch, "streaming_ap"))
    rows[-1]["launches_profiled"] = t["profiled"]["streaming_ap"]
    record(f"streaming_atb@ppad{ppad}", "nle_tpu_torch/csrc/streaming.cu",
           "nle_tpu/ops/pallas/streaming_kernel.py:369",
           grid_errs["streaming_atb"],
           cuda_ms(torch, lambda: streaming_atb(fa_rows, fb_cols, bg, sw, pw)),
           cuda_ms(torch, lambda: streaming_atb_plain(fa_rows, fb_cols, bg,
                                                      sw, pw), reps=1),
           4 * (4 * qpad + 4 * ppad), (ENTRY_FLOPS + 2) * entries,
           sass_key="stream_atb_kernelILi1ELb0E", entries=entries,
           launch=(grid_launch, "streaming_atb"))
    rows[-1]["launches_profiled"] = t["profiled"]["streaming_atb"]
    c_row = t["c_row"]
    record(f"streaming_gram@ppad{ppad}", "nle_tpu_torch/csrc/streaming.cu",
           "nle_tpu/ops/pallas/streaming_kernel.py:453",
           grid_errs["streaming_gram"],
           cuda_ms(torch, lambda: streaming_sample_gram(
               fa_rows, fb_cols, c_row, sw, pw), reps=1),
           cuda_ms(torch, lambda: streaming_sample_gram_plain(
               fa_rows, fb_cols, c_row, sw, pw), reps=1),
           *gram_bound(pg, qg, qpad, ppad),
           launch=(grid_launch, "streaming_gram"))
    del t, fa_rows, fb_cols, mask, u, Xg, bg, c_row
    torch.cuda.empty_cache()

    # [9b] the dense route past p = 1024 at 1 MP: K1 at K2's contract.
    _build.reset_launches()
    t0 = time.perf_counter()
    out = NLEFilter(device="cuda").train_and_enhance(img, *P1200_ARGS,
                                                     weights=WEIGHTS)
    torch.cuda.synchronize()
    p1200_counts = dict(_build.LAUNCHES)
    print(f"[9b] 1 MP dense train_and_enhance "
          f"({' '.join(map(str, P1200_ARGS))}): {time.perf_counter() - t0:.3f}"
          f" s; launches {p1200_counts}; PSNR(output, input) "
          f"{psnr(out, img):.2f} dB")
    if out.shape != img.shape or out.dtype != np.uint8:
        raise AssertionError(f"[9b] output {out.shape} {out.dtype}")
    _build.reset_launches()
    with knobs(NLE_SINKHORN_INT16="off"):
        out32 = NLEFilter(device="cuda").train_and_enhance(img, *P1200_ARGS,
                                                           weights=WEIGHTS)
    db = psnr(out, out32)
    print(f"  vs the assembled f32 route (K4 x "
          f"{_build.LAUNCHES['sinkhorn_halfstep_f32']}): {db:.2f} dB")
    if not db >= 45.0 or _build.LAUNCHES["sinkhorn_halfstep_f32"] < 100:
        raise AssertionError(f"[9b] int16 vs f32 route {db:.2f} dB < 45")
    del out32
    if (p1200_counts["affinity_matmul"] < 1
            or p1200_counts["sinkhorn_halfstep_int16"] < 2 * P1200_ARGS[4]
            or p1200_counts["scaled_gram"] < 1
            or p1200_counts["scaled_matmul"] < 1
            or any(p1200_counts[k] for k in STREAMING_KERNELS)):
        raise AssertionError(f"[9b] not the dense route: {p1200_counts}")
    op = path_operands(torch, L, P1200_ARGS, dev)
    nb1 = op.n - op.p
    npad1 = split_row_pad(nb1)
    print(f"  K1 at p={op.p}: m={op.m}, mb={op.mb}, mpad={op.mpad}")

    def hold_k1(label, o, rows_b, out_rows, B):
        """K1 with out_rows against its plain version: the zero tail rows
        and columns, and (2p + 4) u (|K| |B|) per entry; the plain version
        runs on 2^18-row chunks (its (rows, p) block is materialized)."""
        got = affinity_matmul_kernel(o.fa, rows_b, B, o.sw, o.pw,
                                     out_rows=out_rows)
        torch.cuda.synchronize()
        nr, mb_ = rows_b.shape[0], B.shape[1]
        if bool((got[nr:] != 0).any()) or bool((got[:, mb_:] != 0).any()):
            raise AssertionError(f"{label}: out_rows tail is not exact zero")
        step = 1 << 18

        def parts():
            for lo in range(0, nr, step):
                rb = rows_b[lo:lo + step]
                absb = affinity_matmul_plain(o.fa, rb, B.abs(), o.sw, o.pw)
                yield (got[lo:lo + rb.shape[0], :mb_]
                       - affinity_matmul_plain(o.fa, rb, B, o.sw, o.pw),
                       (2 * o.p + 4) * U * absb + 1e-30)

        return got, check_parts(label, parts())

    err1200 = hold_k1("K1 at p=1200 (K2's contract)", op, op.fb, npad1,
                      op.Uinv)[1]
    record("affinity_matmul_ptiled", "nle_tpu_torch/csrc/affinity.cu",
           "nle_tpu/ops/pallas/affinity_kernel.py:128", err1200,
           cuda_ms(torch, lambda: affinity_matmul_kernel(
               op.fa, op.fb, op.Uinv, op.sw, op.pw, out_rows=npad1)),
           cuda_ms(torch, lambda: affinity_matmul_plain(
               op.fa, op.fb, op.Uinv, op.sw, op.pw, out_rows=npad1)),
           4 * (3 * nb1 + op.p * op.mb + npad1 * op.mpad),
           2 * nb1 * op.p * op.mb + ENTRY_FLOPS * nb1 * op.p,
           launch=("dense_p1200_1mp", "affinity_matmul"))
    rows[-1].update(k2_core)
    # K12 at p = 1200 on the same pixels (c = the mask).
    from nle_tpu_torch.ops.kernels.streaming_kernel import pad_stream_operands
    fa_r, fb_c, mask1 = pad_stream_operands(op.fa, op.fb)
    hold_gram(torch, op, "[9b] p = 1200", fa_r, fb_c, mask1)
    del op, out, fa_r, fb_c, mask1
    torch.cuda.empty_cache()

    # [9c] streaming vs dense at p = 2112, the rank cut at eigenvalues of
    # 1e-10: each kernel route against the streaming route's float64 twin.
    outs, c9, (lab, Lg, grid) = train_routes(
        torch, _build, "[9c]", structured_frame(*STREAM_SHAPE, seed=9),
        GRID_ARGS, (("streaming", True, None), ("dense", False, None),
                    ("dense f32", False, "off")))
    gs_counts, gd_counts = c9["streaming"], c9["dense"]
    t0 = time.perf_counter()
    taps9 = {}
    edit64, c64 = streaming_edit_f64(torch, Lg, grid, GRID_ARGS, WEIGHTS,
                                     dev, taps=taps9)
    outs["float64 twin"] = recompose(lab, edit64, grid.perm)
    print(f"  the streaming route's float64 plain twin: "
          f"{time.perf_counter() - t0:.1f} s")
    # The streaming loop's c (K10, then K9 x 100 in streaming_loop's
    # float64 projections) against the float64 twin's on this frame.
    op = path_operands(torch, Lg, GRID_ARGS, dev)
    c9k = streaming_sinkhorn_vectors(op.fa, op.fb, op.Um, op.lam,
                                     GRID_ARGS[4], 1e-10, op.sw, op.pw)[1]
    rel = ((c9k[op.p:].double() - c64[op.p:]) / c64[op.p:]).abs()
    loop_c = float(rel.median())
    print(f"  the streaming loop's c against the twin's: median "
          f"{loop_c:.3e}, max {float(rel.max()):.3e} (bound {LOOP_C_TOL})")
    if not loop_c <= LOOP_C_TOL:
        raise AssertionError(f"[9c] loop c median {loop_c:.3e} > "
                             f"{LOOP_C_TOL}")
    # A reading, ungated: the same kernels in nle_tpu's loop, every
    # p-row projection in fp32 (a chaotic function of every rounding).
    from nle_tpu_torch.tools.stream_precision import sinkhorn_loop
    fa9, fb9, mask9 = pad_stream_operands(op.fa, op.fb)
    _, c32 = sinkhorn_loop(
        torch, lambda u: streaming_halfstep(fa9, fb9, mask9, u, op.sw, op.pw,
                                            1e-10),
        lambda: streaming_ap(fa9, fb9, mask9, op.sw, op.pw)[0], op.Um,
        op.lam, op.Uinv, op.n - op.p, fa9.shape[1], GRID_ARGS[4])
    c32_rel = float(((c32[op.p:].double() - c64[op.p:]) / c64[op.p:]).abs()
                    .median())
    print(f"  nle_tpu's fp32 loop around the same kernels: c median "
          f"{c32_rel:.3e} from the twin's (a reading, ungated)")
    # K8's gate: one half-step on the float64 loop's u, against float64,
    # no further than the two-pass K9's at the same Ppad, on every frame.
    t0 = time.perf_counter()
    frames = {GATE_SEEDS[0]: one_step_errors(torch, fa9, fb9, mask9, taps9,
                                             op.p, op.sw, op.pw, 1e-10)}
    del edit64, c64, c9k, c32, rel, op, lab, Lg, grid, fa9, fb9, mask9, taps9
    torch.cuda.empty_cache()
    for seed in GATE_SEEDS[1:]:
        frames[seed] = gate_frame(torch, dev, seed)
        torch.cuda.empty_cache()
    k8 = next(r for r in rows if r["name"] == "streaming_halfstep")
    k8["one_step_gate_9c"] = halfstep_gate(frames)
    k8["fp32_loop_c_9c"] = c32_rel
    print(f"  K8 gate on seeds {GATE_SEEDS}: {time.perf_counter() - t0:.1f} s")
    for a, b, what in (
            ("streaming", "dense f32", "the two f32 routes"),
            ("dense", "dense f32", "the int16 carrier, K3 vs K4"),
            ("float64 twin", "dense f32",
             "the streaming algebra without its rounding"),
            ("streaming", "float64 twin",
             "the streaming kernels against their float64 twin")):
        db = psnr(outs[a], outs[b])
        least = TWIN_DB if b == "float64 twin" else 45.0
        print(f"  {a} vs {b}: {db:.2f} dB ({what}; gate {least})")
        if not db >= least:
            raise AssertionError(f"[9c] {a} vs {b} {db:.2f} dB < {least}")
    del outs

    # [9d] the dense route past 2048 factor columns on a real train (the
    # Queue 3 input: mb 2112, mpad 2176, the auto rule): the split int16
    # route (K3) against the assembled f32 route (K4). Then K1 at p = 2112
    # and K3/K4 held on 2^20 of this frame's rest pixels.
    outs, c9d, (_, Lw, _) = train_routes(
        torch, _build, "[9d]", structured_frame(*STREAM_SHAPE, seed=9),
        WIDE_ARGS, (("dense", None, None), ("dense f32", None, "off")))
    wd_counts = c9d["dense"]
    db = psnr(outs["dense"], outs["dense f32"])
    print(f"  dense vs dense f32: {db:.2f} dB (guard tripped: "
          f"{'yes' if wd_counts['sinkhorn_halfstep_f32'] else 'no'})")
    if not db >= 45.0:
        raise AssertionError(f"[9d] dense vs dense f32 {db:.2f} dB < 45")
    del outs
    torch.cuda.empty_cache()
    op = path_operands(torch, Lw, WIDE_ARGS, dev)
    if op.mpad != WIDE_MPAD:
        raise AssertionError(f"[9d] mpad {op.mpad}, not {WIDE_MPAD}")
    rows_b = op.fb[:1 << 20]
    nb2 = rows_b.shape[0]
    print(f"  K1 at p={op.p} (m={op.m}, mb={op.mb}, mpad={op.mpad}) and "
          f"K3/K4/K6/K7 on {nb2} rest pixels")
    mbw = op.mb
    phiw, err2112 = hold_k1("K1 at p=2112", op, rows_b, nb2, op.Uinv)
    k2_row = next(r for r in rows if r["name"] == "affinity_matmul_ptiled")
    k2_row["max_abs_err_p2112"], k2_row["err_over_bound_p2112"] = err2112
    # t as the split route's first half-step takes it: scale * lam s0.
    s0w = (op.Um.T @ torch.ones(op.p, device=dev)
           + phiw[:, :op.mb].sum(dim=0))
    lamw = torch.nn.functional.pad(op.lam * s0w, (0, op.mpad - op.mb))
    del op, rows_b, s0w
    torch.cuda.empty_cache()
    q16w, scalew, _ = quantize_int16(phiw)
    torch.cuda.empty_cache()
    # K13 and K14 here too; their rows come in [10a], which takes these.
    wide10 = {}
    for label, Q, tq_w, row_name, kernel, plain in (
            ("K3 int16 at mpad 2176", q16w, (scalew * lamw).contiguous(),
             "sinkhorn_halfstep_int16", sinkhorn_halfstep,
             sinkhorn_halfstep_plain),
            ("K4 f32 at mpad 2176", phiw, lamw.contiguous(),
             "sinkhorn_halfstep_f32", sinkhorn_halfstep,
             sinkhorn_halfstep_plain),
            ("K13 f32 at mpad 2176", phiw, lamw.contiguous(),
             "sinkhorn_halfstep_tiled", sinkhorn_halfstep_tiled,
             tiled_plain),
            ("K14 bf16 at mpad 2176", phiw.to(torch.bfloat16),
             lamw.contiguous(), "sinkhorn_halfstep_bf16", sinkhorn_halfstep,
             sinkhorn_halfstep_plain)):
        xw, errw = hold_halfstep(torch, label, Q, tq_w, eps, kernel, plain)
        if label.startswith("K13"):
            wide10.setdefault(row_name, {})[
                "earlier_sweep_max_abs_diff_mpad2176"] = k13_bitwise(
                    torch, "[9d]", kernel(Q, tq_w, eps), Q, tq_w, eps,
                    k13_tile(WIDE_MPAD))
        if label.startswith("K4"):
            cw = xw[:, None].contiguous()   # a real balancing vector for K6/K7
        del xw
        row = next((r for r in rows if r["name"] == row_name), None)
        if row is None:
            row = wide10.setdefault(row_name, {})
        nbytes = Q.element_size() * nb2 * WIDE_MPAD + 4 * (nb2 + 2 * WIDE_MPAD)
        bw, byw = bound_ms(nbytes, 4 * nb2 * WIDE_MPAD)
        if Q.dtype == torch.float32:
            row["torch_mv_ms_mpad2176"] = cuda_ms(
                torch, lambda: torch.mv(Q, tq_w), reps=10)
        row.update({
            "max_abs_err_mpad2176": errw[0], "err_over_bound_mpad2176": errw[1],
            "ms_mpad2176": cuda_ms(torch, lambda: kernel(Q, tq_w, eps),
                                   reps=10),
            "plain_ms_mpad2176": cuda_ms(torch, lambda: plain(Q, tq_w, eps)),
            "bound_ms_mpad2176": bw, "bound_by_mpad2176": byw})
        print(f"  {label}: kernel {row['ms_mpad2176']:.3f} ms, plain "
              f"{row['plain_ms_mpad2176']:.3f} ms, bound {bw:.4f} ms ({byw})")
        del Q
    del q16w, lamw
    torch.cuda.empty_cache()
    for name, extra in hold_scaled(torch, record, "_mpad2176", phiw, cw, nb2,
                                   mbw, WIDE_ARGS[5]).items():
        next(r for r in rows if r["name"] == name).update(extra)
    del phiw, cw
    torch.cuda.empty_cache()
    print(f"[9] dense sampling grids: {time.perf_counter() - t9:.1f} s")

    # -- [10] the Sinkhorn modes ------------------------------------------
    mode_paths = sinkhorn_modes(torch, NLEFilter, _build, record, img, L,
                                warm, wide10)
    for name, extra in wide10.items():
        next(r for r in rows if r["name"] == name).update(extra)

    # -- [11] the A/B staging probes of tools/ at [10c]'s shape ---------
    from nle_tpu_torch.tools.bench_sk_dmaonly import MPAD, NPAD
    ab_paths = ab_probes(torch, _build, record, NPAD, MPAD)

    # -- [12] stream mode, host Lab and the port bench ------------------
    bench_mps = stream_phase(torch, NLEFilter, _build, img)

    # -- [13] the command line --------------------------------------------
    cli_paths = cli_phase(torch, img, warm)

    # -- [14] serving and the batch CLI -----------------------------------
    serve_paths = serving_phase(torch, img, warm, bench_mps)

    # -- [15] multi-GPU ---------------------------------------------------
    shard_paths = sharded_phase(torch, img, warm, cap_edit, cap_peak)
    del cap_edit

    # -- [16] the reference's dense free functions ------------------------
    free_api_phase(torch, img, card, dev)

    # -- [17] the small layout and the reference's configurations ---------
    t17 = time.perf_counter()
    small_paths, small_errs = small_layout_phase(torch, NLEFilter, _build,
                                                 card)
    golden_phase(torch, NLEFilter, card)
    print(f"[17] the small layout and the golden configurations: "
          f"{time.perf_counter() - t17:.1f} s ({card})")

    # -- [18] the edit's gather and scatter by perm -----------------------
    po_paths, po = pixel_order_phase(torch, NLEFilter, _build, card)
    for name in po:
        ms, plain_ms, nbytes = po[name][2]
        row = record(name, "nle_tpu_torch/csrc/pixel_order.cu",
                     "none (nle_tpu permutes on the host: "
                     "nle_tpu/models/filter.py)", (0.0, 0.0), ms, plain_ms,
                     nbytes, 0.0, library_ms=plain_ms,
                     launch=("denoise_1mp", name))
        for c in (1, 3):
            row[f"ms_c{c}"], row[f"plain_ms_c{c}"], row[f"bytes_c{c}"] = (
                po[name][c])

    # launches: the count of each row's own path (the dense 1 MP run for
    # K1-K7, the 32 MP factored run for K8-K12, the dense-grid runs for the
    # rows [9] adds); every path's count rides beside it.
    paths = {"dense_1mp": main_counts, **guard_counts,
             "factored_32mp": cap_counts, "streaming_4mp": stream_counts,
             "dense_grid_16mp": grid_counts, "dense_p1200_1mp": p1200_counts,
             "dense_grid_streaming_4mp": gs_counts,
             "dense_grid_dense_4mp": gd_counts,
             "dense_mpad2176_4mp": wd_counts, **mode_paths, **ab_paths,
             **cli_paths, **serve_paths, **small_paths, **po_paths}
    for row in rows:
        path, key = row.pop("_launch")
        row["launches"] = paths[path][key]
        for pname, counts in paths.items():
            row[f"launches_{pname}"] = counts[key]
        # Each rank's own count on the sharded paths ([15a] at (1, 2), [15b]).
        for pname, ranks in shard_paths.items():
            row[f"launches_{pname}"] = [c[key] for c in ranks]
        # [17a]'s kernels held and timed on its own tensors.
        row.update(small_errs.get(row["name"], {}))
        if path == "factored_32mp" and key in cap_errs:
            row["max_abs_err_32mp"], row["err_over_bound_32mp"] = (
                cap_errs[key])

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
