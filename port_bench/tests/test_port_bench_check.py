"""The check that decides `correct`, on the CPU at small sizes: the plain
reference against nle_tpu_torch's float64 route, the bfloat16 control
against the cells' limits, and whole runs with the timed path broken
underneath, each of which has to come out not correct. One card test
runs a short cell on the card; it skips without one."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench import calibrate, flows, harness
from port_bench.frames import FrameSource
from port_bench.reference import nle as reference

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = harness.Benchmark()
CELLS = [w["name"] for w in BENCH.spec["workloads"]]
# Each cell's traffic at a size a CPU test holds: the flow, weights and
# edit parameters as the cell has them, fewer samples and eigenvectors.
SMALL_RECIPE = {"denoise": [4, 4, 200.0, 30.0, 10, 6]}
SMALL = {"shape": [48, 64], "filter": {}}


def small(cell_name):
    cell = BENCH.cell(cell_name)
    traffic = dict(BENCH.traffic(cell))
    traffic["recipe"] = SMALL_RECIPE[traffic["flow"]]
    config = dict(SMALL, filter=BENCH.config(cell).get("filter", {}))
    return config, traffic


def frame(seed=3, noise=0.0):
    src = FrameSource((48, 64), noise, seed, "cpu", pool=1, span=2)
    return src.frame(1)


def test_reference_denoise_follows_the_float64_route():
    from nle_tpu_torch.color.bilateral import bilateral_filter_u8
    from nle_tpu_torch.models.filter import NLEFilter

    img = frame(seed=5, noise=8.0)
    L = reference.lab_of(img)[..., 0]
    ours = reference.bilateral_u8(L, 10, 10, "cpu")
    theirs = bilateral_filter_u8(torch.from_numpy(L), -1, 10, 10).numpy()
    assert np.mean(ours != theirs) < 1e-3
    assert np.abs(ours.astype(int) - theirs).max() <= 1
    recipe = SMALL_RECIPE["denoise"]
    out, S = reference.denoise(img, recipe, 10, 10, 2.0, device="cpu")
    f = NLEFilter(device="cpu", dtype=torch.float64)
    f.train_for_denoise(img, *recipe, 10, 10, bilateral_L=ours)
    got = f.denoise(img, 2.0, 10, 10, bilateral_L=ours)
    c = harness.compare(got, f.trained.eigvals.numpy(), out, S)
    assert c["eig_gap"] < 1e-8 and c["px_mismatch"] == 0.0


def test_packed_order_is_sample_pixels():
    perm, p = reference.packed_order(7, 9, 2, 3)
    from nle_tpu_torch.ops.sampling import sample_grid

    g = sample_grid(7, 9, 2, 3)
    assert p == g.n_samples and np.array_equal(perm, g.perm)
    assert np.array_equal(reference.sample_pixels(7, 9, 2, 3), perm[:p])


def test_bilateral_at_the_samples_is_the_whole_planes():
    L = reference.lab_of(frame(seed=5, noise=8.0))[..., 0]
    sel = np.array([0, 5, 63, 64, 1000, 47 * 64 + 63])
    whole = reference.bilateral_u8(L, 10, 10, "cpu").reshape(-1)[sel]
    assert np.array_equal(reference.bilateral_at(L, sel, 10, 10), whole)


def test_kept_rank_is_the_reference_filters():
    """The traced run's work counts take m from the samples alone; the
    reference filter keeps the same rank from the whole frame."""
    cell = BENCH.cell(CELLS[0])
    config, traffic = small(CELLS[0])
    flow = flows.load(traffic["flow"])(config, traffic, "cpu")
    src = FrameSource((48, 64), 8.0, 11, "cpu", pool=2, span=2)
    (shape,) = flow.work_frames(src, [3])
    lab = reference.lab_of(src.frame(3))
    bl = reference.bilateral_u8(lab[..., 0], traffic["sigma_color"],
                                traffic["sigma_space"], "cpu")
    flt = reference.Filter(bl.astype(np.float64), *traffic["recipe"],
                           device="cpu")
    assert (shape.n, shape.p, shape.m) == (48 * 64, 16, flt.m)
    assert cell["traffic"] == "taj_denoise"


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limits(cell):
    """The bfloat16 control, at a size a CPU test holds, reads past at
    least one of the cell's limits on each of three seeds."""
    config, traffic = small(cell)
    limits = BENCH.limits(BENCH.cell(cell))["limits"]
    rows = calibrate.readings(BENCH, cell, [1, 2, 3], True, False,
                              device="cpu", config=config, traffic=traffic,
                              out=open(os.devnull, "w"))
    for row in rows:
        assert any(row[k] > v for k, v in limits.items()), row


def run_small(cell, seed=7):
    config, traffic = small(cell)
    return harness.run_cell(BENCH, cell, seed, 0.3, False, "cpu",
                            time.perf_counter(), config=config,
                            traffic=traffic, out=open(os.devnull, "w"))


def altered_answer(real):
    """The edit's answer altered where it is made: every byte two
    brighter."""
    def lab_to_bgr(lab):
        return np.clip(real(lab).astype(np.int16) + 2, 0, 255).astype(
            np.uint8)
    return lab_to_bgr


def half_the_pixels(real):
    """V^T y over the first half of the pixels, doubled: half of the
    batch left out and the sum taken over the rest."""
    def apply_u8(V, fs, y):
        h = V.shape[0] // 2
        c = y.to(V.dtype)
        c = c[:, None] if c.ndim == 1 else c
        t = 2 * (V[:h].T @ c[:h])
        out = torch.clamp(torch.round(V @ (fs[:, None] * t)), 0, 255)
        out = out.to(torch.uint8)
        return out[:, 0] if y.ndim == 1 else out
    return apply_u8


@pytest.mark.parametrize("cell", CELLS)
def test_sound_small_run_is_correct(cell):
    r = run_small(cell)
    assert r["correct"] is True and r["failed"] == 0, r["check"]


@pytest.mark.parametrize("fault", ["answer_altered", "state_unchanged",
                                   "half_left_out"])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from nle_tpu_torch.models import filter as filt

    if fault == "answer_altered":
        monkeypatch.setattr(filt, "lab_to_bgr_u8_np",
                            altered_answer(filt.lab_to_bgr_u8_np))
    elif fault == "state_unchanged":
        # The edit step hands back the planes it was given.
        monkeypatch.setattr(filt.NLEFilter, "_apply_edit_u8",
                            lambda self, planes, scale: planes)
    else:
        monkeypatch.setattr(filt, "apply_filter_u8",
                            half_the_pixels(filt.apply_filter_u8))
    r = run_small(cell)
    assert r["correct"] is False, r["check"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the benchmark's runs need one")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    res = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload", cell, "--seed",
         "2147483700", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["check"]
    assert list(line)[-1] == "check"
