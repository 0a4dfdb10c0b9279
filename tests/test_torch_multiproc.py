"""The port's multi-process half (nle_tpu_torch/parallel/distributed.py,
parallel/dryrun.py, and the rank worker of tools/sharded_scaling.py) over
gloo-CPU processes: train_filters_multihost against the port's
single-process route, a configuration mismatch raising on every rank, the
dry runs, the launcher's kill rules, the device and backend rules, and a
package import that starts no process group."""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from nle_tpu_torch.parallel.distributed import (
    initialize,
    launch,
    run_localhost_workers,
    worker_env,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def selfcheck():
    """Two selfcheck workers (dryrun_multihost's body): (seconds, outputs)."""
    t0 = time.monotonic()
    outs = run_localhost_workers(2, device="cpu", timeout=300)
    return time.monotonic() - t0, outs


@pytest.mark.parametrize("pid", [0, 1])
def test_multihost_matches_single_process(selfcheck, pid):
    """Each rank trained its own frame dense, streaming and factored, and
    the divergent-bucket frames at the larger bucket, each within the JAX
    selfcheck's bounds of the port's single-process route."""
    _, outs = selfcheck
    assert f"multihost selfcheck pid={pid}/2: ok" in outs[pid], outs[pid]


@pytest.mark.parametrize("pid", [0, 1])
def test_multihost_config_mismatch_raises_on_every_rank(selfcheck, pid):
    """The ranks passed different hx: each raised ValueError (no hang), well
    inside the launch's timeout."""
    seconds, outs = selfcheck
    assert "a config mismatch raised" in outs[pid]
    assert seconds < 120


def test_dryrun_multichip_runs():
    """dryrun_multichip(4): a (2, 2) mesh of gloo-CPU ranks trains dense,
    streaming and factored and applies, each rank printing ok."""
    from nle_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(4, timeout=300)


def test_launch_kills_every_worker_when_one_fails():
    """One worker exits 1 at once: the launch raises within seconds and the
    other (a 60 s sleep) is killed, not waited for."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="failed") as e:
        launch([[sys.executable, "-c", "import time; time.sleep(60)"],
                [sys.executable, "-c", "raise SystemExit(1)"]], timeout=120,
               env=worker_env())
    assert time.monotonic() - t0 < 20
    assert "rc -9" in str(e.value)


def test_launch_times_out():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="timed out"):
        launch([[sys.executable, "-c", "import time; time.sleep(60)"]] * 2,
               timeout=1.0, env=worker_env())
    assert time.monotonic() - t0 < 20


def test_sharded_scaling_ranks_run_on_cpu(tmp_path):
    """tools/sharded_scaling.py's rank worker and launcher (chip_smoke.py
    [15] drives them on the card) over two gloo-CPU ranks on a small
    frame: a dense job twice and a factored one, each rank's repeats and
    the two ranks' edits bitwise equal, the repeats' walls recorded."""
    from nle_tpu_torch.tools.sharded_scaling import run

    frame = np.random.default_rng(0).integers(0, 256, (24, 32)).astype(
        np.uint8)
    np.save(tmp_path / "dense.npy", frame[None])
    np.save(tmp_path / "cap.npy", frame)
    args = (3, 4, 50.0, 30.0, 5, 5)
    res = run(str(tmp_path), "cpu", (1, 2), "gloo", [
        dict(tag="dense", kind="dense", frames=str(tmp_path / "dense.npy"),
             args=args, reps=2),
        dict(tag="cap", kind="factored", frames=str(tmp_path / "cap.npy"),
             args=args, reps=1)], device="cpu", threads=1)
    for tag, reps in (("dense", 2), ("cap", 1)):
        ranks = res[tag]
        assert len(ranks) == 2
        for r in ranks:
            assert len(r["walls"]) == reps and len(r["edits"]) == reps
            for e in r["edits"]:
                np.testing.assert_array_equal(e, ranks[0]["edits"][0])
        assert ranks[0]["edits"][0].shape == (1, 24, 32)


def test_initialize_refuses_what_cannot_run_as_asked():
    """No quiet switch: NCCL on the CPU raises, and so does the card
    without one (before any process group starts)."""
    with pytest.raises(ValueError, match="nccl"):
        initialize("file:///nonexistent", 1, 0, device="cpu",
                   backend="nccl")
    with pytest.raises(ValueError, match="nccl|gloo"):
        initialize("file:///nonexistent", 1, 0, device="cpu",
                   backend="mpi")
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            initialize("file:///nonexistent", 1, 0, device="cuda")


def test_make_mesh_needs_a_process_group():
    from nle_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh(1, 1)


def test_parallel_imports_without_a_process_group():
    """Importing nle_tpu_torch.parallel, and its lazy multi-process half,
    starts no process group and imports no JAX."""
    code = ("import sys, torch.distributed as d, nle_tpu_torch.parallel as P; "
            "a = d.is_initialized(); "
            "b = 'nle_tpu_torch.parallel.distributed' in sys.modules; "
            "P.train_filters_multihost; P.make_global_mesh; "
            "print(a, b, d.is_initialized(), sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'nle_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=ROOT)
    assert out.stdout.strip() == "False False False []", out.stdout
