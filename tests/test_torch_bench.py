"""The port's bench (nle_tpu_torch/tools/bench.py) on the CPU: its input
rule against tools/bench_input.py, its JSON line, and its two flows at a
small size (the 1 MP bench runs on the card only, in chip_smoke.py)."""

import importlib.util
import json
import os

import numpy as np
import pytest

from nle_tpu_torch.tools import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bench_input():
    spec = importlib.util.spec_from_file_location(
        "bench_input", os.path.join(ROOT, "tools", "bench_input.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_input_is_bench_inputs():
    pytest.importorskip("cv2")
    img = bench.load_input()
    want = _bench_input().load_input()
    assert img.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(img, want)


def test_jittered_frames_are_distinct():
    img = np.random.default_rng(1).integers(40, 200, (16, 24, 3), np.uint8)
    frames = bench.jittered_frames(img, 4)
    assert len(frames) == 4
    assert len({f.tobytes() for f in frames}) == 4


def test_result_line():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = bench.result_line(1.23456, "stream", dev, 8, 0.4321)
    assert json.loads(json.dumps(line)) == {
        "metric": "enhance_throughput_1mp", "value": 1.235, "unit": "MP/s",
        "vs_baseline": 1.235, "mode": "stream", "device": dev,
        "guard_trips": 8, "crush": 0.4321}


def test_main_without_a_card_exits_2(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench.main() == 2
    assert "NVIDIA GPU" in capsys.readouterr().err


# [5]'s guard-tripping parameters on a noise frame (hx 5: the int16
# carrier crushes most of phi), cut to 4 Sinkhorn iterations.
NOISE_ARGS = (10, 10, 5.0, 30.0, 4, 5)


def test_stream_flow_equals_single_and_counts_guard_trips():
    """The bench's stream flow (consumer threads) gives each frame single
    mode's output bit for bit; every noise frame retrains, and the
    carrier records say so."""
    rng = np.random.default_rng(0)
    noise = [np.repeat(rng.integers(0, 256, (60, 64, 1), np.uint8), 3, -1)
             for _ in range(3)]
    with bench.CarrierRecords() as rec:
        outs = bench.run_stream(noise, "cpu", NOISE_ARGS, bench.WEIGHTS,
                                lookahead=2)
    assert len(rec.seen) == 3 and all(r for _, r in rec.seen)
    assert min(c for c, _ in rec.seen) > 0.2
    with bench.CarrierRecords() as rec1:
        for frame, out in zip(noise, outs):
            np.testing.assert_array_equal(
                out, bench.run_single(frame, "cpu", NOISE_ARGS,
                                      bench.WEIGHTS))
    assert [c for c, _ in rec1.seen] == [c for c, _ in rec.seen]
