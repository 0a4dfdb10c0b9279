"""Stage logging, spans and numerical diagnostics (port of
nle_tpu/utils/logging.py).

Reference progress prints become INFO lines with per-stage wall clock;
rank truncation and solver trouble become warnings that do not abort
(reference src/filter.cpp:180-183). `span` names a host moment for
torch.profiler alone (no log line): the pixel-order gathers and scatters,
the transfers and the waits for the device, and each public NLEFilter
call, whose span is the frame's root (models/filter.py).
"""

from __future__ import annotations

import contextlib
import logging
import time

import torch

logger = logging.getLogger("nle_tpu_torch")
# One INFO record per dense train that engaged the int16 carrier, with the
# crush statistic and the guard's decision as record attributes (`crush`,
# `retrained`): how a caller (tools/bench.py) counts the frames that
# retrained through the f32 carrier without a change to any return value.
carrier_log = logging.getLogger("nle_tpu_torch.carrier")


def span(name: str):
    """A torch.profiler range named `name` on whatever device the work
    runs, and nothing else: no log line, no timing. Costs a few us with
    the profiler off."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def stage(name: str):
    """Log a pipeline stage with its wall-clock time. The stage is also a
    span of the same name, so a profiled call splits its host time by
    stage (chip_smoke.py step 6)."""
    logger.info("%s", name)
    t0 = time.perf_counter()
    with span(name):
        yield
    logger.debug("%s took %.1f ms", name, (time.perf_counter() - t0) * 1e3)


# Dedup per (p, m, eps) per process, as in nle_tpu: a retraining loop
# would otherwise repeat the identical line for every frame.
_seen_truncations: set = set()


def warn_truncation(p: int, m: int, eps: float) -> None:
    if m < p and (p, m, eps) not in _seen_truncations:
        _seen_truncations.add((p, m, eps))
        logger.warning(
            "Nystrom spectrum truncated: kept %d of %d eigenvalues above "
            "eps=%g; the balanced block boundary moves to m=%d "
            "(reference src/filter.cpp:247 semantics).", m, p, eps, m,
        )


def warn_rank_deficient(name: str, kept: int, requested: int) -> None:
    if kept < requested:
        logger.warning(
            "%s produced %d eigenpairs above threshold (requested %d). "
            "Results might be inaccurate.", name, kept, requested,
        )
