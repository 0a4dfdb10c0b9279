"""Precision, tolerance and device policy of the PyTorch port.

The eigenvalue cutoff is the reference's absolute EPS = 1e-10 for every
dtype (see nle_tpu/config.py for the golden-sweep evidence).

Devices are explicit: the caller names "cuda" or "cpu" and gets exactly
that. "cuda" without a usable card raises — there is no silent fallback
to the CPU, because a run that quietly left the card would report CPU
numbers under a GPU label.
"""

from __future__ import annotations

import torch

EPS = 1e-10


def resolve_device(device) -> torch.device:
    """torch.device for an explicit "cuda"/"cpu" request; raises for
    anything else, and for "cuda" when torch sees no card."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain CPU versions.")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: expected cuda|cpu")
    return dev


def pin_fp32_precision() -> None:
    """Every float32 contraction on the card must be full IEEE fp32: TF32
    keeps ~3 decimal digits, and a bf16-class phi product costs ~8 dB of
    golden PSNR (nle_tpu DESIGN.md §2). Sets and asserts both TF32
    switches and the matmul precision. The one sanctioned bf16 arithmetic
    is the opt-in NLE_SINKHORN_BF16 preview mode (kernel K14, documented
    as not golden-safe); nothing else reads or computes in bf16."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "float32 matmul precision is "
            f"{torch.get_float32_matmul_precision()!r}; the port needs "
            "'highest' (no TF32).")
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError("TF32 must stay disabled for the port.")
