"""The edit's pixel order on the card (CUDA, csrc/pixel_order.cu): rows of
C bytes (C = 1, 2, 3) permuted by an int32 index, as a gather
(`perm_gather`: out[i] = x[idx[i]], pixel order to the filter's packed
[selected; rest] order) or a scatter (`perm_scatter`: out[idx[i]] = x[i],
back to pixel order).

It replaces no TPU kernel. nle_tpu permutes the edit's channels on the
host (nle_tpu/models/filter.py), because on the TPU an (N, k) device
scatter cost more than the filter application. On the H100 a permutation
of N rows moves N (4 + 2C) bytes and computes nothing: 64 MB at 8 MP with
C = 2, ~19 us at 3.35 TB/s, where the host's fancy indexing took ~160 ms
each way. The kernel is bound by device memory: a block stages 4096 index
entries (and the scatter its input rows, the gather its output rows)
through shared memory in 16-byte vectors, and walks the indexed side one
row a thread, consecutive threads on consecutive rows, which coalesces
because the edit's index is nearly sequential.

On the CPU the plain versions (`index_select` / `index_copy_`) run the
same contract; a CUDA tensor launches the kernel or raises, unless the
caller asks for the plain versions (plain=True): the routes that run no
hand-written kernel (use_kernels=False, float64) permute with them on the
card.
"""

from __future__ import annotations

import numpy as np
import torch

from nle_tpu_torch.ops.kernels import _build
from nle_tpu_torch.ops.kernels._common import cuda_or_cpu

ROW_BYTES = (1, 2, 3)     # the u8 channels of one edit the kernel moves
MAX_ROWS = 2**31 - 1      # an int32 index


def device_index(perm: np.ndarray, device: torch.device) -> torch.Tensor:
    """`perm` (a host permutation of range(N)) as the int32 tensor on
    `device` that the kernels read. On the card the cast is written
    straight into pinned staging memory and the copy is enqueued without
    waiting for the work queued on the device's current stream."""
    perm = np.asarray(perm)
    if perm.ndim != 1 or perm.size > MAX_ROWS:
        raise ValueError(f"perm of shape {perm.shape}: expected (N,) with N "
                         f"<= {MAX_ROWS}")
    if device.type != "cuda":
        return torch.from_numpy(perm.astype(np.int32))
    pinned = torch.empty(perm.shape, dtype=torch.int32, pin_memory=True)
    np.copyto(pinned.numpy(), perm, casting="same_kind")
    return pinned.to(device, non_blocking=True)


def perm_gather_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[i] = x[idx[i]]."""
    return x.index_select(0, idx)


def perm_scatter_plain(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[idx[i]] = x[i]."""
    return torch.empty_like(x).index_copy_(0, idx.long(), x)


def _check(x: torch.Tensor, idx: torch.Tensor) -> int:
    """The row width C of x, (N,) or (N, C) u8 with an (N,) int32 idx."""
    if x.dtype != torch.uint8 or idx.dtype != torch.int32:
        raise TypeError(f"rows {x.dtype} and index {idx.dtype}: expected "
                        "torch.uint8 and torch.int32")
    c = 1 if x.dim() == 1 else x.shape[1] if x.dim() == 2 else 0
    if c not in ROW_BYTES or idx.shape != (x.shape[0],):
        raise ValueError(f"rows {tuple(x.shape)} and index "
                         f"{tuple(idx.shape)}: expected (N,) or (N, C) with "
                         f"C in {ROW_BYTES} and an (N,) index")
    if x.shape[0] > MAX_ROWS:
        raise ValueError(f"{x.shape[0]} rows: an int32 index takes at most "
                         f"{MAX_ROWS}")
    return c


def _permute(x: torch.Tensor, idx: torch.Tensor, scatter: bool,
             plain: bool):
    c = _check(x, idx)
    if not cuda_or_cpu(x, idx) or plain:
        return (perm_scatter_plain if scatter else perm_gather_plain)(x, idx)
    out = torch.empty_like(x)
    if any(t.data_ptr() % 16 for t in (x, idx, out)):
        raise ValueError("kernel operands must be 16-byte aligned")
    name = "perm_scatter_u8" if scatter else "perm_gather_u8"
    lib = _build.load()
    with torch.cuda.device(x.device):
        status = lib.nle_permute_rows_u8(
            x.data_ptr(), idx.data_ptr(), out.data_ptr(), x.shape[0], c,
            int(scatter), _build.stream_ptr(x))
    _build.check(status, name)
    _build.count_launch(name)
    return out


def perm_gather(x: torch.Tensor, idx: torch.Tensor, *,
                plain: bool = False) -> torch.Tensor:
    """out[i] = x[idx[i]] for x (N,) or (N, C) uint8, C in 1..3, and idx
    an (N,) int32 permutation of range(N); plain=True takes the plain
    version on the card too."""
    return _permute(x, idx, scatter=False, plain=plain)


def perm_scatter(x: torch.Tensor, idx: torch.Tensor, *,
                 plain: bool = False) -> torch.Tensor:
    """out[idx[i]] = x[i] for x (N,) or (N, C) uint8, C in 1..3, and idx
    an (N,) int32 permutation of range(N); plain=True takes the plain
    version on the card too."""
    return _permute(x, idx, scatter=True, plain=plain)
