"""Shared checks of the kernel wrappers."""

from __future__ import annotations

import torch

SHARED_LIMIT = 232_448    # shared memory bytes one H100 block may use


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cuda_or_cpu(*tensors: torch.Tensor, dtype=None,
                contiguous: bool = True) -> bool:
    """The one dispatch rule of the port's kernel wrappers: True when every
    operand is a contiguous CUDA tensor (launch the kernel), False when
    every operand lies on the CPU (use the plain version). Anything else —
    mixed devices, another device type, a wrong dtype or a strided CUDA
    operand (when the kernel reads it in place) — raises; nothing falls
    back."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({t.device for t in tensors}) != 1:
        raise ValueError(
            f"kernel operands must all be on one CUDA device or all on the "
            f"CPU; got {[str(t.device) for t in tensors]}")
    for t in tensors:
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"kernel operand dtype {t.dtype}, expected {dtype}")
        if contiguous and not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous")
    return True
