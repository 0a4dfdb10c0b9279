"""The span readers on a hand-made trace (`data/span_trace.json`): two
frames on thread 1, the first train_for_denoise then denoise, the second
train_and_enhance with train_for_enhancement and enhance inside it; two
uploads on thread 2 that lie inside frame 1's intervals in time but in
no frame. Times in us; each value below is worked by hand from the file."""

from __future__ import annotations

import os

import pytest

from port_bench import harness
from port_bench.spans import Spans
from port_bench.trace import Trace

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FRAMES = 2


def span_trace():
    return Trace.from_chrome(os.path.join(DATA, "span_trace.json"), FRAMES)


def small_trace():
    """A trace with the stage ranges alone, as before the new spans."""
    return Trace.from_chrome(os.path.join(DATA, "small_trace.json"), FRAMES)


@pytest.mark.parametrize("metric,want_us", [
    # Gathers 50 + 40, scatters 90 + 100.
    ("perm_ms", 50 + 40 + 90 + 100),
    # Sample grid 100 + 60, Pack channel 80 + 50.
    ("pack_ms", 100 + 60 + 80 + 50),
    # Thread 1: 50 + 40 + 30 + 20; thread 2's two count too: 20 + 20.
    ("upload_ms", 50 + 40 + 30 + 20 + 20 + 20),
    ("device_wait_ms", 90 + 300 + 90 + 50 + 150 + 180),
    # The submit 200 (no child); the finish 500 less its wait 300 and its
    # upload 30 (thread 2's upload at 1500 is no child); frame 2's 300 less
    # 150.
    ("stage2a_queue_ms", 200 + (500 - 300 - 30) + (300 - 150)),
    # train_for_denoise 2000 less Bilateral 500 (its upload and wait inside
    # it), Sample grid 100, Pack channel 80, Upload 40, the two stage-2a
    # ranges 200 + 500; denoise 1000 less 300 + 50 + 20 + 70 + 90 + 100;
    # train_and_enhance counted once, 2000 less 100 + 60 + 50 + 300 + 40 +
    # 200 + 100, its two inner roots not taken away.
    ("model_self_ms", (2000 - 1420) + (1000 - 630) + (2000 - 850)),
])
def test_span_readers_by_hand(metric, want_us):
    got = harness.load_metric(metric).read(span_trace())
    assert got == pytest.approx(want_us / 1e3 / FRAMES, rel=1e-12)


@pytest.mark.parametrize("metric", ["perm_ms", "pack_ms", "upload_ms",
                                    "device_wait_ms", "model_self_ms"])
def test_span_readers_find_nothing_without_their_spans(metric):
    assert harness.load_metric(metric).read(small_trace()) is None


def test_stage2a_queue_is_the_whole_range_without_children():
    """On a trace whose stage-2a ranges hold no span, their self time is
    their duration: stage2a_host_ms's reading."""
    tr = small_trace()
    assert harness.load_metric("stage2a_queue_ms").read(tr) == \
        pytest.approx(harness.load_metric("stage2a_host_ms").read(tr))


def test_roots_and_frames():
    sp = Spans(span_trace())
    roots = sp.roots()
    assert [(r.name, r.start) for r in roots] == [
        ("NLEFilter.train_for_denoise", 100),
        ("NLEFilter.denoise", 2200),
        ("NLEFilter.train_and_enhance", 4000)]
    # Every span of thread 1 lies in a root; thread 2's lie in none.
    in_frames = {id(c) for r in roots for c in sp.inside(r)}
    for tid, rs in sp.by_tid.items():
        for r in rs:
            if r not in roots:
                assert (id(r) in in_frames) == (tid == 1), (tid, r)
