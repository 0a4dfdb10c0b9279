"""The port's spans on the CPU: each public NLEFilter call is a root span
(`NLEFilter.<method>`) that holds the new spans of its frame on the same
thread ("Sample grid", "Pack channel", "Gather by perm", "Scatter by
perm", "Upload", "Wait for device"), as torch.profiler exports them; the
spans change no bit of the results; `stage` logs and `span` does not."""

import json
import logging

import numpy as np
import pytest
import torch

from nle_tpu_torch import NLEFilter
from nle_tpu_torch.utils.logging import span, stage

SHAPE = (48, 64)
TRAIN = (6, 8, 100.0, 30.0, 5, 6)     # samples, hx, hy, iterations, k
SIGMAS = (10.0, 10.0)
SHRINK = 2.0
WEIGHTS = (1.0, 2.0, 1.5, 1.0, 1.0, 1.0)
CALLS = ("train_for_denoise", "denoise", "train_and_enhance")
NEW = ("Sample grid", "Pack channel", "Gather by perm", "Scatter by perm",
       "Upload", "Wait for device")
# Spans of each call that run a fixed number of times.
COUNTS = {
    "train_for_denoise": {"Sample grid": 1, "Pack channel": 1,
                          "Gather by perm": 0, "Scatter by perm": 0},
    "denoise": {"Sample grid": 0, "Pack channel": 0, "Gather by perm": 1,
                "Scatter by perm": 1},
    # The first edit is fused into stage 2b: no gather, one scatter.
    "train_and_enhance": {"Sample grid": 1, "Pack channel": 1,
                          "Gather by perm": 0, "Scatter by perm": 1},
}


def _frame(seed=7):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:SHAPE[0], 0:SHAPE[1]]
    base = 120 + 60 * np.sin(xx / 11.0) + 40 * np.cos(yy / 7.0)
    img = np.stack([base + 10 * c for c in range(3)], axis=-1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(
        np.uint8)


class _Records(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def _run(img):
    """Each call's results and log lines: {call: (arrays, messages)}."""
    log = logging.getLogger("nle_tpu_torch")
    level = log.level
    log.setLevel(logging.DEBUG)
    out = {}

    def call(name, fn):
        rec = _Records()
        log.addHandler(rec)
        try:
            out[name] = (fn(), rec.messages)
        finally:
            log.removeHandler(rec)

    def arrays(tr):
        return [tr.eigvecs.numpy().copy(), tr.eigvals.numpy().copy()]

    try:
        f = NLEFilter(device="cpu")
        call("train_for_denoise",
             lambda: arrays(f.train_for_denoise(img, *TRAIN, *SIGMAS)))
        call("denoise", lambda: [f.denoise(img, SHRINK, *SIGMAS)])
        g = NLEFilter(device="cpu")
        call("train_and_enhance",
             lambda: [g.train_and_enhance(img, *TRAIN, WEIGHTS)]
             + arrays(g.trained))
    finally:
        log.setLevel(level)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three calls on the split stage-2a layout (the 8 MP frame's),
    once plain and once under torch.profiler; the profiled run's host
    spans from its exported Chrome trace."""
    img = _frame()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("NLE_CPHI_BYTES", "0")
        plain = _run(img)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            profiled = _run(img)
    path = tmp_path_factory.mktemp("spans") / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return plain, profiled, events


def _inside(outer, e):
    return (e is not outer and e["tid"] == outer["tid"]
            and outer["ts"] <= e["ts"]
            and e["ts"] + e["dur"] <= outer["ts"] + outer["dur"])


def _root(events, call):
    roots = [e for e in events if e["name"] == f"NLEFilter.{call}"]
    assert len(roots) == 1, roots
    return roots[0]


@pytest.mark.parametrize("call", CALLS)
def test_span_counts_per_call(runs, call):
    _, _, events = runs
    root = _root(events, call)
    names = [e["name"] for e in events if _inside(root, e)]
    for name, count in COUNTS[call].items():
        assert names.count(name) == count, (name, names)
    assert names.count("Upload") >= 1 and names.count("Wait for device") >= 1


@pytest.mark.parametrize("call", CALLS)
def test_new_spans_lie_inside_their_root(runs, call):
    """Every new span lies inside exactly one root on its thread, and the
    spans of this call's interval inside this call's root."""
    _, _, events = runs
    roots = [e for e in events if e["name"].startswith("NLEFilter.")]
    assert sorted(r["name"] for r in roots) == sorted(
        f"NLEFilter.{c}" for c in CALLS)
    root = _root(events, call)
    for e in events:
        if e["name"] not in NEW:
            continue
        owners = [r for r in roots if _inside(r, e)]
        assert len(owners) == 1, e
        during = root["ts"] <= e["ts"] < root["ts"] + root["dur"]
        assert (owners[0] is root) == during, e


@pytest.mark.parametrize("call", CALLS)
def test_results_bit_identical_under_the_profiler(runs, call):
    plain, profiled, _ = runs
    a, b = plain[call][0], profiled[call][0]
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


@pytest.mark.parametrize("call", CALLS)
def test_stage_logs_and_span_does_not(runs, call):
    plain, _, events = runs
    messages = plain[call][1]
    root = _root(events, call)
    stages = {e["name"] for e in events if _inside(root, e)} - set(NEW)
    assert stages and stages <= set(messages)
    assert not any(m in NEW or m.startswith(NEW) or "NLEFilter." in m
                   for m in messages), messages
    rec = _Records()
    log = logging.getLogger("nle_tpu_torch")
    level = log.level
    log.setLevel(logging.DEBUG)
    log.addHandler(rec)
    try:
        with span("a span"):
            pass
        assert rec.messages == []
        with stage("a stage"):
            pass
        assert rec.messages[0] == "a stage" and "took" in rec.messages[1]
    finally:
        log.removeHandler(rec)
        log.setLevel(level)
