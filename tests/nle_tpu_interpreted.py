"""nle_tpu's dense train_filter on the CPU with its Pallas kernels run in
interpret mode, as tests/test_bucketing.py runs them: the layout its own
predicate picks (the small one below NLE_CPHI_BYTES), with the int16
carrier, where its CPU default (use_pallas=None) takes the XLA route
without a carrier. A helper of the port's tests (pytest does not collect
it): patch nle_tpu's stage functions with `interpreted(monkeypatch)`, then
call its train_filter or NLEFilter with use_pallas=True."""

import functools

from nle_tpu.ops import pipeline as jpipe

STAGES = ("train_filter_stage2a", "train_filter_stage2b",
          "train_filter_stage2b_edit")


def interpreted(monkeypatch) -> None:
    """Make nle_tpu's train_filter run its dense stage functions with
    interpret=True for the rest of the test (undone by monkeypatch)."""
    for name in STAGES:
        monkeypatch.setattr(jpipe, name, functools.partial(
            getattr(jpipe, name), interpret=True))
