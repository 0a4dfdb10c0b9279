"""The ways a traffic mix drives the program: `flows/<name>.py`, chosen by
the traffic's `flow` key and found by name (`load`).

A flow module defines `FLOW`, a subclass of `Flow` below. Its `run` is a
closed loop: `more(i)` says whether frame i starts, so the window starts
whole frames until its time is up and lets the frames already started
finish. What a frame produced (the edited frame and the filter's
eigenvalues) is kept for the check; the eigenvalues stay on the device
until the window has closed. A flow also gives the plain reference of
its edit, the lines it adds to the run's log, its end-to-end values and
the shapes of the traced frames' work, so that a cell that needs a new
loop adds a file here and edits none.
"""

from __future__ import annotations

import importlib
import time

import numpy as np
import torch

from port_bench.reference import nle as reference
from port_bench.roofline import FrameShape


class Outcome:
    """What a flow's loop produced: per frame index, the output, the
    eigenvalues (or the error), its host start and end times, and the
    kernel launches of each frame (or of the whole loop, where frames
    overlap)."""

    def __init__(self):
        self.outputs: dict[int, np.ndarray] = {}
        self.eigvals: dict[int, object] = {}
        self.errors: dict[int, str] = {}
        self.times: dict[int, tuple[float, float]] = {}
        self.routes: list[dict] = []
        self.started = 0

    def eig_host(self, i: int) -> np.ndarray:
        ev = self.eigvals[i]
        if isinstance(ev, torch.Tensor):
            ev = ev.detach().cpu().numpy()
        return np.asarray(ev, np.float64)


def launches() -> dict:
    from nle_tpu_torch.ops.kernels import _build

    return dict(_build.LAUNCHES)


def launch_delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


class Flow:
    def __init__(self, config: dict, traffic: dict, device):
        self.traffic = traffic
        self.device = torch.device(device)
        self.recipe = tuple(traffic["recipe"])
        self.options = dict(config.get("filter", {}))

    def run(self, source, more) -> Outcome:
        raise NotImplementedError

    def reference(self, frame: np.ndarray, device, precision=torch.float64):
        """(output, eigenvalues) of the plain reference on one frame."""
        raise NotImplementedError

    def sample_values(self, frame: np.ndarray, sel: np.ndarray) -> np.ndarray:
        """The training channel at the flat pixel indices `sel`: the Lab
        L plane's values there."""
        return reference.lab_of(frame)[..., 0].reshape(-1)[sel]

    def report(self, outcome: Outcome, say) -> None:
        """Lines of the flow's own for the run's log."""

    def end_to_end(self, outcome: Outcome, seconds: float, n_pixels: int,
                   window_peak: int) -> dict:
        """{quantity: (value, unit)} of the window; a cell's end-to-end
        metric `<quantity>` or `<quantity>.<group>` reads its quantity.
        setup_s is the harness's own."""
        done = len(outcome.outputs)
        return {"mps": (done * n_pixels / 1e6 / seconds, "MP/s"),
                "peak_b_per_px": (window_peak / n_pixels, "B/px")}

    def work_frames(self, source, done) -> list[FrameShape]:
        """The work's shape of each finished frame: its pixels, samples p
        and kept rank m (from the float64 stage 1 of the training channel
        at the samples), iterations and eigenvectors."""
        nrs, ncs, hx, hy, iters, k = self.recipe[:6]
        out = []
        for i in done:
            frame = source.frame(i)
            h, w = frame.shape[:2]
            sel = reference.sample_pixels(h, w, nrs, ncs)
            m = reference.kept_rank(self.sample_values(frame, sel), sel, w,
                                    hx, hy)
            out.append(FrameShape(h * w, sel.size, m, int(iters), int(k)))
        return out


def load(name: str):
    """The Flow subclass of flows/<name>.py."""
    return importlib.import_module(f"port_bench.flows.{name}").FLOW


def closed_loop(deadline: float):
    """Frame 0 always starts; a later one only before the deadline."""
    return lambda i: i == 0 or time.perf_counter() < deadline
