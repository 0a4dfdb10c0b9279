"""Serving subsystem (port of nle_tpu/serving): the train-once / edit-many
flow over HTTP on the card.

`python -m nle_tpu_torch.serving.http` runs a hardened stdlib HTTP service
around NLEFilter: request coalescing into stream-mode training batches,
bearer auth, request-size limits, /metrics, and a bounded filter LRU with
disk spill; `python -m nle_tpu_torch.serving.pool` fronts several of
them. See nle_tpu_torch.serving.http.
"""

from nle_tpu_torch.serving.http import main, make_server, selftest

__all__ = ["main", "make_server", "selftest"]
