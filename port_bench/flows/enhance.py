"""Enhance as `nle_tpu_torch/cli/enhance.py` runs it, one frame at a time:
`train_and_enhance` (train on the Lab L plane, then the detail layers
re-weighted by the traffic's weights). The configuration's `filter`
options choose the route (`factored: true`, the V-free capacity route).

Each train's host chain logs its counts above eps on the logger
`nle_tpu_torch.chain` (wa_kept, q_kept, k); the flow keeps them per frame
and prints them. A frame whose train logs no such record fails: the cell
holds the kept rank to the reference's, and a program that does not
report it (one from before the record) cannot run the cell.

The check holds a checked frame's q_kept to the reference's. The harness
hands `reference` the frame alone, after the program's state has gone, so
the flow keeps each frame's record under a digest of the frame
(`frame_key`) in this module. Where the float64 reference keeps another
q_kept than the program did on that frame, `reference` returns an empty
output, which the harness's compare reads as a frame whose every byte
differs, so the run is not correct. An eigenpair kept near eps moves no
reading of its own: eig_gap sees 1e-9 against the largest eigenvalue."""

from __future__ import annotations

import hashlib
import logging
import time

import numpy as np
import torch

from port_bench.flows import Flow, Outcome, launch_delta, launches
from port_bench.reference import enhance as reference

CHAIN_LOGGER = "nle_tpu_torch.chain"
# Each frame's chain record (wa_kept, q_kept, k), by frame_key.
PROGRAM_CHAIN: dict[str, tuple[int, int, int]] = {}


def frame_key(frame: np.ndarray) -> str:
    """A digest of the frame's shape and of its pixels on a 16-pixel grid
    (a run's frames differ in every pixel that the exposure does not
    clip), cheap enough for the timed loop."""
    h = hashlib.blake2b(repr(frame.shape).encode(), digest_size=16)
    h.update(np.ascontiguousarray(frame[::16, ::16]).tobytes())
    return h.hexdigest()


class ChainRecords(logging.Handler):
    """The host chain's records: one (wa_kept, q_kept, k) per train."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seen: list[tuple[int, int, int]] = []

    def emit(self, record):
        if hasattr(record, "q_kept"):
            self.seen.append((int(record.wa_kept), int(record.q_kept),
                              int(record.k)))

    def __enter__(self):
        log = logging.getLogger(CHAIN_LOGGER)
        self._level = log.level
        log.setLevel(logging.INFO)
        log.addHandler(self)
        return self

    def __exit__(self, *exc):
        log = logging.getLogger(CHAIN_LOGGER)
        log.removeHandler(self)
        log.setLevel(self._level)


class Enhance(Flow):
    def run(self, source, more) -> Outcome:
        from nle_tpu_torch.models.filter import NLEFilter

        weights = list(self.traffic["weights"])
        out = Outcome()
        out.chain = {}
        i = 0
        with ChainRecords() as rec:
            while more(i):
                t0 = time.perf_counter()
                frame = source.frame(i)
                out.started = i + 1
                before = launches()
                seen = len(rec.seen)
                try:
                    f = NLEFilter(device=self.device, **self.options)
                    out.outputs[i] = f.train_and_enhance(
                        frame, *self.recipe, weights=weights)
                    out.eigvals[i] = f.trained.eigvals
                except Exception as e:     # a frame that fails is counted
                    out.errors[i] = repr(e)
                if len(rec.seen) > seen:
                    out.chain[i] = rec.seen[-1]
                    PROGRAM_CHAIN[frame_key(frame)] = rec.seen[-1]
                elif i not in out.errors:
                    del out.outputs[i], out.eigvals[i]
                    out.errors[i] = (f"no record on {CHAIN_LOGGER}: the "
                                     "program does not report its kept rank")
                out.routes.append(launch_delta(before, launches()))
                out.times[i] = (t0, time.perf_counter())
                i += 1
        return out

    def reference(self, frame, device, precision=torch.float64):
        out, S, (wa_kept, q_kept) = reference.enhance(
            frame, self.recipe, self.traffic["weights"], device=device,
            precision=precision)
        line = f"reference chain: wa_kept {wa_kept}, q_kept {q_kept}"
        program = PROGRAM_CHAIN.get(frame_key(frame))
        if program is not None and precision == torch.float64:
            line += f"; program: wa_kept {program[0]}, q_kept {program[1]}"
            if program[1] != q_kept:
                line += " (q_kept differs: the frame does not match)"
                out = np.empty((0,), np.uint8)
        print(line, flush=True)
        return out, S

    def report(self, outcome: Outcome, say) -> None:
        chain = getattr(outcome, "chain", {})
        say("chain (frame: wa_kept, q_kept, k): " + ", ".join(
            f"{i}: {w} {q} {k}" for i, (w, q, k) in sorted(chain.items())))


FLOW = Enhance
