"""The harness's arithmetic on the CPU: the closed loop's window, the work
counts against hand counts, every metric reader on a small recorded
trace, and the comparison."""

from __future__ import annotations

import os

import numpy as np
import pytest

from port_bench import flows, harness, roofline
from port_bench.roofline import ENTRY_FLOPS, FrameShape, bound_s
from port_bench.trace import Trace

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
SHAPE = FrameShape(n=1000, p=10, m=8, iters=3, k=2)


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def test_closed_loop_starts_whole_frames_until_the_deadline(monkeypatch):
    clock = Clock()
    monkeypatch.setattr(flows.time, "perf_counter", clock)
    more = flows.closed_loop(10.0)
    started = []
    i = 0
    while more(i):
        started.append(i)
        clock.now += 3.0            # each frame takes 3 s
        i += 1
    # Frames start at 0, 3, 6 and 9 s; the one due at 12 s does not.
    assert started == [0, 1, 2, 3] and clock.now == 12.0
    late = flows.closed_loop(-1.0)
    assert late(0) and not late(1)  # frame 0 always starts


def test_warm_up_frames_never_repeat_in_the_window():
    from port_bench.frames import FrameSource

    src = FrameSource((24, 32), 0.0, 2**31 + 11, "cpu", pool=2, span=3)
    warm = harness.WarmSource(src)
    frames = [src.frame(i) for i in range(src.capacity)]
    assert src.capacity == 12 and 0 not in src.offsets
    keys = {f.tobytes() for f in frames} | {warm.frame(i).tobytes()
                                            for i in range(2)}
    assert len(keys) == 14
    again = FrameSource((24, 32), 0.0, 2**31 + 11, "cpu", pool=2, span=3)
    assert all(np.array_equal(again.frame(i), frames[i]) for i in range(12))
    with pytest.raises(IndexError):
        src.frame(12)


@pytest.mark.parametrize("name,flops,nbytes", [
    ("affinity", ENTRY_FLOPS * 990 * 10 + 2 * 990 * 10 * 8,
     4 * (3 * 990 + 10 * 8 + 990 * 8)),
    ("sinkhorn", 6 * 4 * 990 * 8, 6 * (2 * 990 * 8 + 4 * (1000 + 16))),
])
def test_work_counts_by_hand(name, flops, nbytes):
    assert roofline.load_work(name).count(SHAPE) == (flops, nbytes)


def test_bound_is_the_larger_time():
    assert bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert bound_s(1.0, 134e12) == (2.0, "operations")


def frame_bound(work):
    flops, nbytes = roofline.load_work(work).count(SHAPE)
    return bound_s(nbytes, flops)[0]


def small_trace(work_frames=(SHAPE, SHAPE)):
    return Trace.from_chrome(os.path.join(DATA, "small_trace.json"), 2,
                             work_frames)


@pytest.mark.parametrize("metric,want", [
    ("lab_ms", (200 + 300) / 1e3 / 2),
    ("stage1_ms", 100 / 1e3 / 2),
    ("stage2a_host_ms", (500 + 1500) / 1e3 / 2),
    ("chain_ms", 2000 / 1e3 / 2),
    ("bilateral_ms", 300 / 1e3 / 2),
    # Busy: 1500-2500, 2600-5000 (two kernels overlap), 8000-8500; the
    # device's projection of a host range is not device work.
    ("device_idle_share", 1 - 3900 / 10000),
    # Two frames' bounds over the named kernels' device time.
    ("affinity_roofline", 100 * 2 * frame_bound("affinity") / 1000e-6),
    ("sinkhorn_roofline", 100 * 2 * frame_bound("sinkhorn") / 3000e-6),
])
def test_metric_readers_on_a_recorded_trace(metric, want):
    got = harness.load_metric(metric).read(small_trace())
    assert got == pytest.approx(want, rel=1e-12) if want is not None \
        else got is None


def test_trace_device_totals_and_idle_gaps():
    tr = small_trace()
    assert tr.window_s == pytest.approx(0.01)
    assert tr.busy_s == pytest.approx(0.0039)
    ops = dict((k[:40], v) for k, v in tr.device_ops())
    assert sum(ops.values()) == pytest.approx(0.0045)
    gaps = tr.idle_gaps()
    assert [g[0] for g in gaps] == ["Orthogonalize", "no host range",
                                    "BGR to Lab", "no host range"]
    assert [g[1] for g in gaps] == pytest.approx([0.003, 0.0025, 0.0005,
                                                  0.0001])
    assert small_trace(()).roofline_pct("sinkhorn") is None


def test_compare_numbers():
    a = np.zeros((4, 5, 3), np.uint8)
    b = a.copy()
    b[0, 0, 0] = 3
    b[1, 1, 1] = 1
    got = harness.compare(a, np.array([1.0, 0.5]), b, np.array([1.0, 0.4]))
    assert got == {"eig_gap": pytest.approx(0.1), "px_mismatch": 2 / 60,
                   "px_max": 3.0}
    # A shorter list is padded with zeros, as the program pads S.
    assert harness.compare(a, np.ones(2), b, np.ones(3))["eig_gap"] == 1.0


def test_check_sample_is_drawn_from_the_seed():
    a = harness.check_sample(2**31 + 5, list(range(9)), 2)
    assert a == harness.check_sample(2**31 + 5, list(range(9)), 2)
    assert len(set(a)) == 2 and set(a) <= set(range(9))
    assert harness.check_sample(1, [4], 3) == [4]


def test_route_of_launches():
    assert harness.route_of({"affinity_matmul": 1,
                             "sinkhorn_halfstep_int16": 100}) == "dense"
    assert harness.route_of({"affinity_matmul": 2,
                             "sinkhorn_halfstep_f32": 20}) == (
        "dense+f32 carrier")
    assert harness.route_of({}) == "no kernel"
