"""Peaks of the card and the least time a piece of work could take.

The H100 SXM's published peaks (NVIDIA data sheet, dense, at its full
700 W limit): HBM bytes/s and float32 FLOP/s outside the tensor cores
(the port bars TF32). A roofline share is stated against these, with the
card's power limit printed beside it.

Each piece of work is a file `work/<name>.py` that gives, for one frame,
the float32 operations and the bytes (inputs read once, outputs written
once) that its algorithm needs, from the recipe and the frame's shapes,
and the kernel names (as the trace prints them) that do it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os

PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
# float32 operations of one affinity entry's argument: three differences,
# five multiplies, two adds. The exponential is not counted, so the bound
# is low (an assumption: it keeps every share under 100%).
ENTRY_FLOPS = 10

WORK_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "work")


@dataclasses.dataclass(frozen=True)
class FrameShape:
    """What one frame's work depends on: pixels n, samples p, the kept
    Nystrom rank m, Sinkhorn iterations and eigenvectors k."""

    n: int
    p: int
    m: int
    iters: int
    k: int


def bound_s(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, and what bounds it."""
    tb, tf = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def load_work(name: str):
    """The module work/<name>.py."""
    path = os.path.join(WORK_DIR, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no work file {path}")
    spec = importlib.util.spec_from_file_location(f"port_bench_work_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def work_bound_s(name: str, frames: list[FrameShape]) -> float:
    """The summed bound of a piece of work over the given frames."""
    work = load_work(name)
    total = 0.0
    for f in frames:
        flops, nbytes = work.count(f)
        total += bound_s(nbytes, flops)[0]
    return total
