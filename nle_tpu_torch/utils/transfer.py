"""Host <-> device copies that never wait for unrelated device work.

On CUDA, a blocking copy (`tensor.cpu()`, or `.to("cuda")` from pageable
memory) synchronizes the whole stream: it waits for every kernel queued
there, including work that a pipelined caller queued for later frames
(models/batch.py). These helpers stage through pinned host memory and
enqueue the copy non-blocking on the current stream instead:

- `upload(array, device)`: a host array as a tensor on the device. The
  caching host allocator keeps the pinned staging block from being reused
  until the copy has run (it records an event on the stream when the copy
  is enqueued), so the caller may drop it at once.
- `Fetch(tensor)`: enqueues the device-to-host copy now, records an event
  after it, and `result()` waits on that event alone.

On the CPU both are plain views (no copy), as `torch.from_numpy` and
`.cpu()` are. Each upload is the span "Upload" and each wait the span
"Wait for device" (utils/logging.py span), on every device. Single mode (ops/pipeline.py train_filter, NLEFilter) and
stream mode share these, so their transfers are the same code.
"""

from __future__ import annotations

import numpy as np
import torch

from nle_tpu_torch.utils.logging import span


def upload(array, device: torch.device) -> torch.Tensor:
    """`array` (a NumPy array) as a tensor on `device`, copied without
    waiting for the work queued on the device's current stream."""
    with span("Upload"):
        host = torch.from_numpy(np.ascontiguousarray(array))
        if device.type != "cuda":
            return host
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(device, non_blocking=True)


class Fetch:
    """A device tensor's copy to the host, enqueued at construction on the
    tensor's current stream; `result()` waits for that copy only (an event
    recorded right after it), never for work queued later."""

    def __init__(self, tensor: torch.Tensor):
        if tensor.device.type != "cuda":
            self._host, self._done = tensor, None
            return
        self._host = torch.empty(tensor.shape, dtype=tensor.dtype,
                                 pin_memory=True)
        self._host.copy_(tensor, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(torch.cuda.current_stream(tensor.device))

    def result(self) -> np.ndarray:
        with span("Wait for device"):
            if self._done is not None:
                self._done.synchronize()
            return self._host.numpy()
