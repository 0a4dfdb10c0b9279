"""Where stream mode's overlap goes, on the card: a diagnostic of
models/batch.py at the 1 MP main path (832x1216, rock2 parameters).

    python3 nle_tpu_torch/tools/stream_overlap.py [--root CHECKOUT]
        [--frames 8] [--rounds 1] [--out overlap.json]

1. Wall a frame, warm, of 8 exposure-jittered structured frames (chip_smoke's
   [5] frame, from this checkout's chip_smoke.py, jittered as bench.py
   does) through: single mode
   (NLEFilter.train_and_enhance), stream mode with the edits on the
   bench's 4-thread pool (tools/bench.py run_stream), and stream mode with
   the edits after the whole stream has trained (no edit threads); each
   with the default CUDA events and with blocking ones
   (torch.cuda.Event(blocking=True), whose waits sleep instead of spin),
   in turns A, B, B, A (--rounds times). --root names the checkout whose
   nle_tpu_torch is imported (this one by default); one without stream
   mode runs single mode alone, so two versions compare in one call, one
   process each.
2. Training alone (no edits), stream against single, each profiled: the
   device time that ran inside each host stage range (from the trace), so
   a reading says whether the device's work overlapped the host f64 chain
   ("Orthogonalize") or ran while the host was still queueing it.
3. The host chain of one frame (host_orthogonalize) timed with the device
   idle and with it busy (fp32 8192^2 matmuls queued ahead), and beside a
   thread converting 1 MP frames BGR->Lab in a loop (the C kernels' OpenMP
   threads).

Prints one JSON line a reading; writes them all to --out. Needs a card:
without one it exits 2.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ARGS = (20, 30, 500.0, 10.0, 50, 50)
WEIGHTS = [4, 3, 4, 1]
SHAPE = (832, 1216)


def jittered(img: np.ndarray, n: int, lab) -> list[np.ndarray]:
    """bench.py's exposure jitter: n distinct L offsets in [-2n, 2n]."""
    rng = np.random.default_rng(0)
    out = []
    for d in rng.choice(np.arange(-2 * n, 2 * n + 1), size=n, replace=False):
        x = lab.bgr_to_lab_u8_np(img)
        x[..., 0] = np.clip(x[..., 0].astype(np.int32) + int(d), 0,
                            255).astype(np.uint8)
        out.append(lab.lab_to_bgr_u8_np(x))
    return out


def emit(rows: list, **row) -> None:
    rows.append(row)
    print(json.dumps(row), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose nle_tpu_torch is measured")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    sys.path.insert(1, ROOT)
    import torch

    import chip_smoke

    if not torch.cuda.is_available():
        print("stream_overlap: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import nle_tpu_torch
    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.color import lab

    rows = []
    emit(rows, reading="setup", package=os.path.dirname(nle_tpu_torch.__file__),
         card=torch.cuda.get_device_name(0), cpus=os.cpu_count())
    frames = jittered(chip_smoke.structured_frame(*SHAPE), a.frames, lab)

    def single():
        return [NLEFilter(device="cuda").train_and_enhance(
            f, *ARGS, weights=WEIGHTS) for f in frames]

    variants = {"single": single}
    try:
        from nle_tpu_torch.models.batch import train_filters_iter
        from nle_tpu_torch.tools import bench
    except ImportError:                    # a checkout without stream mode
        bench = None
    if bench is not None:

        def deferred():
            labs = [lab.bgr_to_lab_u8_np(f) for f in frames]
            flts = list(train_filters_iter(
                (x[..., 0].astype(np.float32) for x in labs), *ARGS,
                device="cuda"))
            outs = []
            for f, x, flt in zip(frames, labs, flts):
                e = NLEFilter(trained=flt, device="cuda")
                e.seed_lab_cache(f, x)
                outs.append(e.enhance(f, WEIGHTS))
            return outs

        variants.update(stream=lambda: bench.run_stream(frames),
                        deferred=deferred)
    event = torch.cuda.Event
    ref = None
    for fn in variants.values():
        fn()                                               # warm
    for blocking in [False, True, True, False] * a.rounds:
        torch.cuda.Event = (functools.partial(event, blocking=True)
                            if blocking else event)
        try:
            for name, fn in variants.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / len(frames) * 1e3
                ref = out if ref is None else ref
                emit(rows, reading="wall", variant=name,
                     blocking_events=blocking, ms_per_frame=ms,
                     bitwise_first=all(np.array_equal(x, y)
                                       for x, y in zip(out, ref)))
        finally:
            torch.cuda.Event = event
    if bench is not None:
        overlap(torch, rows, frames, lab)
    if a.out:
        with open(a.out, "w") as fh:
            json.dump(rows, fh)
    return 0


def stage_overlap(torch, fn) -> dict:
    """Profile fn: per host stage range, its host ms and the device ms of
    the kernels that ran inside it; and the device ms in all."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("cat") == "kernel"]
    out = {"device_ms": sum(b - a for a, b in kernels) / 1e3}
    for e in events:
        if e.get("cat") != "user_annotation":
            continue
        a, b = e["ts"], e["ts"] + e["dur"]
        row = out.setdefault(e["name"], {"host_ms": 0.0,
                                         "device_ms_inside": 0.0})
        row["host_ms"] += (b - a) / 1e3
        row["device_ms_inside"] += sum(
            max(0.0, min(y, b) - max(x, a)) for x, y in kernels) / 1e3
    return out


def overlap(torch, rows, frames, lab) -> None:
    from nle_tpu_torch import NLEFilter
    from nle_tpu_torch.models.batch import train_filters_iter
    from nle_tpu_torch.ops import pipeline

    chans = [lab.bgr_to_lab_u8_np(f)[..., 0].astype(np.float32)
             for f in frames]
    captured = {}
    chain = pipeline.host_orthogonalize

    def capture(*args, **kw):
        captured.setdefault("args", (args, kw))
        return chain(*args, **kw)

    def train_stream():
        return list(train_filters_iter(iter(chans), *ARGS, device="cuda"))

    def train_single():
        return [NLEFilter(device="cuda").train_for_enhancement(f, *ARGS)
                for f in frames]

    pipeline.host_orthogonalize = capture
    try:
        train_stream()
        train_single()
    finally:
        pipeline.host_orthogonalize = chain
    for name, fn in (("stream", train_stream), ("single", train_single)):
        emit(rows, reading="stages", variant=name, frames=len(frames),
             **stage_overlap(torch, fn))
    args, kw = captured["args"]
    x = torch.randn(8192, 8192, device="cuda")
    torch.mm(x, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        torch.mm(x, x)
    torch.cuda.synchronize()
    mm_ms = (time.perf_counter() - t0) / 5 * 1e3
    timings = {"idle": [], "busy": []}
    for busy in (False, True, True, False) * 2:
        if busy:
            for _ in range(int(700 / mm_ms) + 1):
                torch.mm(x, x)
        t0 = time.perf_counter()
        chain(*args, **kw)
        timings["busy" if busy else "idle"].append(
            (time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    stop = threading.Event()

    def lab_loop():
        while not stop.is_set():
            lab.bgr_to_lab_u8_np(frames[0])

    beside = []
    for _ in range(2):
        th = threading.Thread(target=lab_loop)
        th.start()
        try:
            t0 = time.perf_counter()
            chain(*args, **kw)
            beside.append((time.perf_counter() - t0) * 1e3)
        finally:
            stop.set()
            th.join()
        stop.clear()
    emit(rows, reading="host chain", ms_device_idle=timings["idle"],
         ms_device_busy=timings["busy"], ms_beside_lab_thread=beside,
         matmul_ms=mm_ms)


if __name__ == "__main__":
    sys.exit(main())
