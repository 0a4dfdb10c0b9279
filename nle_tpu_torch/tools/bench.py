"""End-to-end enhance throughput of the port on ~1 MP frames: bench.py's
two modes on one NVIDIA GPU.

    python3 -m nle_tpu_torch.tools.bench

NLE_BENCH_MODE=stream (the default) trains a stream of distinct frames
(the input with per-frame exposure jitter, so nothing can be cached
across frames) in stream mode (models/batch.py train_filters_iter: frame
i+1's device stage 2a runs under frame i's host f64 chain), with each
frame's edit on a 4-thread pool as soon as its filter is yielded; the
wall clock runs from the first submit to the last output, min of 3 timed
passes after a warm-up pass. NLE_BENCH_MODE=single times
NLEFilter.train_and_enhance on one frame, min of NLE_BENCH_REPEATS calls
after a warm-up. NLE_BENCH_REPEATS (default 8) is the stream's length;
NLE_BENCH_MP sizes the rock2 input. The rock2 golden parameters
(20 30 500 10 50 50) and weights [4, 3, 4, 1] throughout.

The input: the reference data's rock2.jpg resized to NLE_BENCH_MP when
that file and cv2 both exist, else the uniform-noise 832x1216 frame of
default_rng(0) (the rule of tools/bench_input.py, kept here because that
file imports cv2 unconditionally and the port needs no cv2). Uniform
noise is the int16 carrier's failure domain at small hx, where its guard
retrains a frame through the f32 carrier, so the line reports the frames
whose guard retrained (`guard_trips`, in one pass of the frames) and the
largest crush statistic seen (`crush`).

Prints one JSON line: bench.py's keys plus "device", "guard_trips" and
"crush". Runs on the card only: without one it exits 2.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

PARAMS = (20, 30, 500.0, 10.0, 50, 50)
WEIGHTS = [4.0, 3.0, 4.0, 1.0]
# The repo's reference data directory (tests/conftest.py DATA_DIR).
ROCK2 = os.path.join(os.sep, "root", "reference", "data", "rock2.jpg")
NOISE_SHAPE = (832, 1216, 3)


def load_input(target_mp: float = 1.0) -> np.ndarray:
    """The BGR input frame, by tools/bench_input.py's rule."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None and os.path.exists(ROCK2):
        img = cv2.imread(ROCK2)
        h, w = img.shape[:2]
        scale = (target_mp * 1e6 / (h * w)) ** 0.5
        return cv2.resize(img, (int(w * scale), int(h * scale)),
                          interpolation=cv2.INTER_CUBIC)
    return np.random.default_rng(0).integers(0, 256, NOISE_SHAPE, np.uint8)


def jittered_frames(img: np.ndarray, repeats: int) -> list[np.ndarray]:
    """bench.py's stream: `repeats` copies of img with distinct L offsets
    (drawn without replacement from [-2 repeats, 2 repeats])."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np, lab_to_bgr_u8_np

    rng = np.random.default_rng(0)
    span = np.arange(-2 * repeats, 2 * repeats + 1)
    frames = []
    for d in rng.choice(span, size=repeats, replace=False):
        lab = bgr_to_lab_u8_np(img)
        lab[..., 0] = np.clip(lab[..., 0].astype(np.int32) + int(d),
                              0, 255).astype(np.uint8)
        frames.append(lab_to_bgr_u8_np(lab))
    return frames


def run_single(frame: np.ndarray, device="cuda", params=PARAMS,
               weights=WEIGHTS) -> np.ndarray:
    """One train_and_enhance (the first edit fused into stage 2b)."""
    from nle_tpu_torch.models.filter import NLEFilter

    return NLEFilter(device=device).train_and_enhance(frame, *params,
                                                      weights)


def run_stream(frames_bgr, device="cuda", params=PARAMS, weights=WEIGHTS,
               lookahead=None) -> list[np.ndarray]:
    """bench.py's stream flow: lazy Lab channels into train_filters_iter;
    each yielded filter edited on a 4-thread pool through
    NLEFilter(trained=...) with the producer's Lab seeded
    (seed_lab_cache), while the main thread goes on training. Returns the
    edited frames in order; the device work is done when it returns."""
    from nle_tpu_torch.color.lab import bgr_to_lab_u8_np
    from nle_tpu_torch.models.batch import train_filters_iter
    from nle_tpu_torch.models.filter import NLEFilter

    labs = [None] * len(frames_bgr)
    out = [None] * len(frames_bgr)

    def channels():
        for i, bgr in enumerate(frames_bgr):
            labs[i] = bgr_to_lab_u8_np(bgr)
            yield labs[i][..., 0].astype(np.float32)

    def edit(i, flt):
        f = NLEFilter(trained=flt, device=device)
        f.seed_lab_cache(frames_bgr[i], labs[i])
        out[i] = f.enhance(frames_bgr[i], weights)

    with ThreadPoolExecutor(4) as ex:
        futs = [ex.submit(edit, i, flt) for i, flt in enumerate(
            train_filters_iter(channels(), *params, device=device,
                               lookahead=lookahead))]
        for fut in futs:
            fut.result()
    return out


class CarrierRecords(logging.Handler):
    """Collects the carrier guard's records (utils.logging.carrier_log):
    one (crush, retrained) per dense train that engaged the int16 carrier."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seen: list[tuple[float, bool]] = []

    def emit(self, record):
        if hasattr(record, "crush"):
            self.seen.append((record.crush, record.retrained))

    def __enter__(self):
        from nle_tpu_torch.utils.logging import carrier_log

        self._level = carrier_log.level
        carrier_log.setLevel(logging.INFO)
        carrier_log.addHandler(self)
        return self

    def __exit__(self, *exc):
        from nle_tpu_torch.utils.logging import carrier_log

        carrier_log.removeHandler(self)
        carrier_log.setLevel(self._level)


def result_line(value: float, mode: str, device: dict, guard_trips: int,
                crush: float | None) -> dict:
    """bench.py's JSON line (metric, value, unit, vs_baseline, mode) plus
    the card, the frames whose guard retrained and the largest crush
    statistic."""
    return {
        "metric": "enhance_throughput_1mp",
        "value": round(value, 3),
        "unit": "MP/s",
        "vs_baseline": round(value / 1.0, 3),
        "mode": mode,
        "device": device,
        "guard_trips": int(guard_trips),
        "crush": crush,
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench: torch.cuda.is_available() is False; the port's bench "
              "runs on an NVIDIA GPU.", file=sys.stderr)
        return 2
    target_mp = float(os.environ.get("NLE_BENCH_MP", "1.0"))
    repeats = int(os.environ.get("NLE_BENCH_REPEATS", "8"))
    mode = os.environ.get("NLE_BENCH_MODE", "stream")
    if mode not in ("stream", "single"):
        print(f"bench: NLE_BENCH_MODE={mode!r}: stream or single",
              file=sys.stderr)
        return 2
    img = load_input(target_mp)
    mp = img.shape[0] * img.shape[1] / 1e6
    with CarrierRecords() as warm:
        if mode == "single":
            run_single(img)                       # warm-up
        else:
            frames = jittered_frames(img, repeats)
            run_stream(frames)                    # warm-up
    with CarrierRecords() as timed:
        times = []
        if mode == "single":
            for _ in range(repeats):
                t0 = time.perf_counter()
                run_single(img)
                times.append(time.perf_counter() - t0)
            value = mp / min(times)
        else:
            for _ in range(3):
                t0 = time.perf_counter()
                outs = run_stream(frames)
                times.append(time.perf_counter() - t0)
                if len(outs) != repeats:
                    raise RuntimeError(f"{len(outs)} outputs of {repeats}")
            value = repeats * mp / min(times)
    crushes = [c for c, _ in warm.seen + timed.seen]
    print(json.dumps(result_line(
        value, mode,
        {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
         "count": torch.cuda.device_count()},
        sum(r for _, r in warm.seen), max(crushes) if crushes else None)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
