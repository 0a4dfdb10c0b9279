"""GLIDE denoise as `nle_tpu_torch/cli/denoise.py` runs it, one frame at a
time: `train_for_denoise` on the bilateral-filtered L plane, then
`denoise` (the bilateral L and both chroma planes through the filter with
its eigenvalues shrunk)."""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.flows import Flow, Outcome, launch_delta, launches
from port_bench.reference import nle as reference


class Denoise(Flow):
    def run(self, source, more) -> Outcome:
        from nle_tpu_torch.models.filter import NLEFilter

        t = self.traffic
        out = Outcome()
        i = 0
        while more(i):
            t0 = time.perf_counter()
            frame = source.frame(i)
            out.started = i + 1
            before = launches()
            try:
                f = NLEFilter(device=self.device, **self.options)
                f.train_for_denoise(frame, *self.recipe, t["sigma_color"],
                                    t["sigma_space"])
                out.outputs[i] = f.denoise(frame, t["shrink"],
                                           t["sigma_color"], t["sigma_space"])
                out.eigvals[i] = f.trained.eigvals
            except Exception as e:     # a frame that fails is counted
                out.errors[i] = repr(e)
            out.routes.append(launch_delta(before, launches()))
            out.times[i] = (t0, time.perf_counter())
            i += 1
        return out

    def reference(self, frame, device, precision=torch.float64):
        t = self.traffic
        return reference.denoise(frame, self.recipe, t["sigma_color"],
                                 t["sigma_space"], t["shrink"],
                                 device=device, precision=precision)

    def sample_values(self, frame: np.ndarray, sel: np.ndarray) -> np.ndarray:
        """The bilateral-filtered L plane at the samples, the bilateral
        evaluated there alone."""
        L = reference.lab_of(frame)[..., 0]
        return reference.bilateral_at(L, sel, self.traffic["sigma_color"],
                                      self.traffic["sigma_space"])


FLOW = Denoise
