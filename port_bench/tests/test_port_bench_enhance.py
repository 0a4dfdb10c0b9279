"""The enhance cell (ladder32mp-enhance) on the CPU: its pieces found by
name, its work counts against hand counts, its readers on a hand-made
trace (`data/factored_trace.json`: two frames of the factored enhance,
times in us, each value below worked by hand from the file), and its check
at a small size: the plain reference's control fails the cell's limits, a
sound run is correct, and runs with the timed path broken are not."""

from __future__ import annotations

import os
import time

import numpy as np
import pytest
import torch

from port_bench import calibrate, flows, harness, roofline
from port_bench.roofline import ENTRY_FLOPS, FrameShape, bound_s
from port_bench.trace import Trace

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
BENCH = harness.Benchmark()
CELL = "ladder32mp-enhance"
NEW = ("stream_sinkhorn_ms.enhance", "stream_gram_ms.enhance",
       "factored_apply_ms.enhance", "perm_ms.enhance",
       "device_idle_share.enhance", "stream_halfstep_roofline.enhance",
       "stream_gram_roofline.enhance", "factored_apply_roofline.enhance")
SHAPE = FrameShape(n=1000, p=10, m=8, iters=3, k=2)
# The cell's traffic at a size a CPU test holds: the ladder's recipe with
# fewer samples, hx at the same share of the width.
SMALL = {"shape": [48, 64], "filter": {"factored": True}}
SMALL_RECIPE = [6, 8, 56.0, 30.0, 20, 12]


def test_the_cell_is_found_by_name():
    cell = BENCH.cell(CELL)
    config, traffic = BENCH.config(cell), BENCH.traffic(cell)
    assert config["shape"] == [5656, 5656]
    assert config["filter"] == {"factored": True}
    assert traffic["recipe"] == [24, 25, 5000.0, 30.0, 50, 50]
    assert traffic["weights"] == [4.0, 3.0, 4.0, 1.0]
    assert issubclass(flows.load(traffic["flow"]), flows.Flow)
    assert set(BENCH.limits(cell)["limits"]) <= {"eig_gap", "px_mismatch",
                                                 "px_max"}
    assert [m["name"] for m in BENCH.end_to_end(CELL)] == [
        "mps.denoise", "peak_b_per_px", "setup_s"]
    assert [m["name"] for m in BENCH.per_layer(CELL)] == list(NEW)
    assert all(CELL not in m.get("workloads", []) for m in
               BENCH.per_layer("photo8mp-denoise"))


@pytest.mark.parametrize("name,flops,nbytes", [
    ("stream_halfstep", 6 * (ENTRY_FLOPS + 4) * 990 * 10,
     6 * 4 * (5 * 990 + 5 * 10)),
    # K12's float64 form: c K and H's lower triangle in float64, at the
    # fp32 peak over the float64 one (67 / 34); m does not enter.
    ("stream_gram", ENTRY_FLOPS * 990 * 10
     + (990 * 10 + 990 * 10 * 11) * 67 / 34,
     4 * (4 * 990 + 3 * 10) + 8 * 10 * 10),
    ("factored_apply", 3 * (ENTRY_FLOPS + 2) * 990 * 10,
     3 * 4 * (4 * 990 + 4 * 10)),
])
def test_work_counts_by_hand(name, flops, nbytes):
    assert roofline.load_work(name).count(SHAPE) == (flops, nbytes)


def frame_bound(work):
    flops, nbytes = roofline.load_work(work).count(SHAPE)
    return bound_s(nbytes, flops)[0]


def factored_trace(work_frames=(SHAPE, SHAPE)):
    return Trace.from_chrome(os.path.join(DATA, "factored_trace.json"), 2,
                             work_frames)


@pytest.mark.parametrize("metric,want", [
    ("stream_sinkhorn_ms.enhance", (3000 + 2800) / 1e3 / 2),
    ("stream_gram_ms.enhance", (800 + 700) / 1e3 / 2),
    ("factored_apply_ms.enhance", (2000 + 1800) / 1e3 / 2),
    ("perm_ms.enhance", (200 + 300 + 100 + 250) / 1e3 / 2),
    # Busy: frame 1's kernels and copy 40 + 2500 + 10 + 500 + 50 + 600 +
    # 700 + 40, frame 2's 40 + 2400 + 450 + 40 + 550 + 650.
    ("device_idle_share.enhance", 1 - (4440 + 4130) / 20000),
    # K8 2500 + 2400 us; K12's two kernels 500 + 50 + 450 + 40; K10 (the s0
    # passes too) and K11 40 + 600 + 700 + 40 + 550 + 650.
    ("stream_halfstep_roofline.enhance",
     100 * 2 * frame_bound("stream_halfstep") / 4900e-6),
    ("stream_gram_roofline.enhance",
     100 * 2 * frame_bound("stream_gram") / 1040e-6),
    ("factored_apply_roofline.enhance",
     100 * 2 * frame_bound("factored_apply") / 2580e-6),
])
def test_readers_on_a_recorded_factored_trace(metric, want):
    got = harness.load_metric(metric).read(factored_trace())
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("metric", NEW[:3] + NEW[5:])
def test_new_readers_find_nothing_on_a_dense_trace(metric):
    """The denoise's recorded trace holds none of the factored route's
    spans and kernels (as a parent without them): nothing, no error."""
    tr = Trace.from_chrome(os.path.join(DATA, "small_trace.json"), 2,
                           (SHAPE, SHAPE))
    assert harness.load_metric(metric).read(tr) is None


def small_traffic():
    traffic = dict(BENCH.traffic(BENCH.cell(CELL)))
    traffic["recipe"] = SMALL_RECIPE
    return traffic


def test_control_fails_the_cells_limits():
    """The bfloat16 control at a small size reads past at least one of the
    cell's limits on each of three seeds."""
    limits = BENCH.limits(BENCH.cell(CELL))["limits"]
    rows = calibrate.readings(BENCH, CELL, [1, 2, 3], True, False,
                              device="cpu", config=SMALL,
                              traffic=small_traffic(),
                              out=open(os.devnull, "w"))
    for row in rows:
        assert any(row[k] > v for k, v in limits.items()), row


def run_small(seed=7):
    return harness.run_cell(BENCH, CELL, seed, 0.3, False, "cpu",
                            time.perf_counter(), config=SMALL,
                            traffic=small_traffic(),
                            out=open(os.devnull, "w"))


def test_sound_small_run_is_correct(capsys):
    r = run_small()
    assert r["correct"] is True and r["failed"] == 0, r["check"]
    assert set(r["metrics"]) == {"peak_b_per_px", "setup_s", "mps.denoise"}
    # The checked frame's kept rank was held to the reference's.
    said = capsys.readouterr().out
    assert "; program: wa_kept" in said and "differs" not in said, said


class OneMoreKept:
    """The host chain's logger, with one more eigenpair of Q reported
    kept than the chain kept."""

    def __init__(self, log):
        self.log = log

    def info(self, msg, *args, extra):
        self.log.info(msg, *args, extra=dict(extra,
                                              q_kept=extra["q_kept"] + 1))


def test_a_kept_rank_unlike_the_references_is_not_correct(monkeypatch,
                                                          capsys):
    """A run whose checked frame keeps another q_kept than the float64
    reference is not correct, though its bytes and eigenvalues match: an
    eigenpair kept near eps moves no reading of its own."""
    from nle_tpu_torch.ops import orthogonalize

    monkeypatch.setattr(orthogonalize, "chain_log",
                        OneMoreKept(orthogonalize.chain_log))
    r = run_small()
    assert r["correct"] is False and r["failed"] == 0, r["check"]
    assert r["check"]["px_mismatch"]["value"] == 1.0
    assert "(q_kept differs: the frame does not match)" in \
        capsys.readouterr().out


def test_frame_key_tells_a_runs_frames_apart():
    from port_bench.flows import enhance
    from port_bench.frames import FrameSource

    src = FrameSource((48, 64), 0.0, 5, "cpu")
    keys = [enhance.frame_key(src.frame(i)) for i in range(src.capacity)]
    assert len(set(keys)) == src.capacity
    assert enhance.frame_key(src.frame(3)) == keys[3]


def no_tail(real):
    """The factored apply with the rest rows' tail left out."""
    def factored_apply(y, y_train, rr, cc, c, v_head, w, f_eigvals, sw, pw,
                       *, p):
        out = real(y, y_train, rr, cc, c, v_head, w, f_eigvals, sw, pw, p=p)
        out[..., p:] = 0
        return out
    return factored_apply


@pytest.mark.parametrize("fault", ["answer_altered", "state_unchanged",
                                   "tail_left_out"])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    from nle_tpu_torch.models import factored
    from nle_tpu_torch.models import filter as filt

    if fault == "answer_altered":
        real = filt.lab_to_bgr_u8_np
        monkeypatch.setattr(filt, "lab_to_bgr_u8_np", lambda lab: np.clip(
            real(lab).astype(np.int16) + 2, 0, 255).astype(np.uint8))
    elif fault == "state_unchanged":
        monkeypatch.setattr(filt.NLEFilter, "_apply_edit_u8",
                            lambda self, planes, scale: planes)
    else:
        monkeypatch.setattr(factored, "factored_apply",
                            no_tail(factored.factored_apply))
    r = run_small()
    assert r["correct"] is False, r["check"]


def test_reference_counts_are_its_spectrum():
    """The reference's counts: Q's rank above eps is Wa's, and S holds
    q_kept eigenvalues, none below eps, in decreasing order."""
    from port_bench.frames import FrameSource
    from port_bench.reference import enhance

    frame = FrameSource((48, 64), 0.0, 5, "cpu", pool=1, span=2).frame(1)
    out, S, (wa_kept, q_kept) = enhance.enhance(
        frame, SMALL_RECIPE, [4.0, 3.0, 4.0, 1.0], device="cpu")
    assert out.shape == frame.shape and out.dtype == np.uint8
    assert q_kept == S.size == min(wa_kept, SMALL_RECIPE[-1])
    assert S.min() >= enhance.EPS and np.all(np.diff(S) <= 0)
    assert torch.tensor(S).dtype == torch.float64


def test_a_program_without_the_chain_record_cannot_run_the_cell(
        monkeypatch):
    """A program whose host chain logs no kept-rank record (the port
    before the record) fails at its first frame, the warm-up: a clean
    failure, not a run."""
    import logging

    from nle_tpu_torch.ops import orthogonalize

    monkeypatch.setattr(orthogonalize, "chain_log",
                        logging.getLogger("port_bench.tests.elsewhere"))
    with pytest.raises(RuntimeError, match="does not report its kept rank"):
        run_small()
