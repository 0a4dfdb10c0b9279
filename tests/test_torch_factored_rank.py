"""The V-free factored route (NLEFilter(factored=True), the capacity
ladder's route) against the float64 reference of the enhance
(port_bench/reference/enhance.py), on the CPU, where the route runs the
kernels' plain twins: fp32 entries, float64 sums.

The recipes weight the detail layers 4 3 4 1, so f(0) = w0 = 4: every
eigenpair of Q kept above eps = 1e-10 enters the edit at full weight,
however small its eigenvalue. The kept rank is decided by Wa's eigenvalues
near eps (Q's rank is Wa's), and the small eigenpairs are what the
fp32 sums lose (PERF.md: the kept rank of the factored route)."""

import json
import logging
import os

import numpy as np
import pytest

from nle_tpu_torch.models.filter import NLEFilter
from port_bench import harness
from port_bench.frames import structured_pool
from port_bench.reference import enhance as reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "port_bench", "cells",
                       "ladder32mp-enhance.json")) as fh:
    LIMITS = json.load(fh)["limits"]
WEIGHTS = [4.0, 3.0, 4.0, 1.0]
SHAPE = (96, 128)


class _Chain(logging.Handler):
    """The host chain's records: (wa_kept, q_kept, k) per train."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seen = []

    def emit(self, record):
        if hasattr(record, "q_kept"):
            self.seen.append((record.wa_kept, record.q_kept, record.k))


def _port(frame, recipe):
    log = logging.getLogger("nle_tpu_torch.chain")
    level, rec = log.level, _Chain()
    log.setLevel(logging.INFO)
    log.addHandler(rec)
    try:
        f = NLEFilter(device="cpu", factored=True)
        out = f.train_and_enhance(frame, *recipe, weights=WEIGHTS)
    finally:
        log.removeHandler(rec)
        log.setLevel(level)
    return out, f.trained.eigvals.numpy().astype(np.float64), rec.seen


def _frame(seed):
    return structured_pool(*SHAPE, 1, 0.0, seed, "cpu")[0]


def _within_limits(out, S, ref_out, ref_S):
    got = harness.compare(out, S, ref_out, ref_S)
    assert all(got[k] <= v for k, v in LIMITS.items()), (got, LIMITS)


def test_kept_rank_is_the_float64_references():
    """A frame whose recipe asks for 60 eigenvectors where Q keeps 55 above
    eps, with Wa's eigenvalues crowding eps (1.01e-10, 0.98e-10): the
    route keeps the reference's 55 and edits within the cell's limits.
    With fp32 sums (fp32 stage-1 projections, K8's fp32 w and ap), r and c
    lose their proportion at the sampled rows by ~1e-5, two more of Wa's
    eigenvalues rise over eps and, at weight 4, their eigenpairs move 96%
    of the bytes."""
    frame, recipe = _frame(1), (8, 10, 300.0, 30.0, 50, 60)
    ref_out, ref_S, (wa_kept, q_kept) = reference.enhance(
        frame, recipe, WEIGHTS, device="cpu")
    assert q_kept == wa_kept < recipe[-1]
    out, S, chain = _port(frame, recipe)
    assert np.count_nonzero(S) == q_kept
    _within_limits(out, S, ref_out, ref_S)
    assert chain == [(wa_kept, q_kept, recipe[-1])]


@pytest.mark.parametrize("seed", [2, 3])
def test_factored_enhance_is_the_references(seed):
    """The ladder's sampling scaled to a small frame (hx at the same share
    of the width), k = 50: q_kept and the edit's bytes as the
    reference's."""
    frame, recipe = _frame(seed), (8, 10, 112.0, 30.0, 50, 50)
    ref_out, ref_S, (_, q_kept) = reference.enhance(frame, recipe, WEIGHTS,
                                                    device="cpu")
    out, S, chain = _port(frame, recipe)
    assert np.count_nonzero(S) == q_kept
    _within_limits(out, S, ref_out, ref_S)
    assert [q for _, q, _ in chain] == [q_kept]
