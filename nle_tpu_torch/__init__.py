"""nle_tpu_torch — nonlocal image editing on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch port of the JAX package nle_tpu, which stays in the repository
as its reference. Plain tensor code is PyTorch; every Pallas TPU kernel on
the ported path is a CUDA C++ kernel written for sm_90a (csrc/), built at
first use with nvcc and bound with ctypes. Host float64 islands stay
NumPy/SciPy. Importing this package never imports JAX or nle_tpu.

Entry point: NLEFilter(device="cuda").train_and_enhance(...);
NLEFilter(factored=True, device="cuda") takes the phi-free capacity path.
"""

from nle_tpu_torch.config import pin_fp32_precision

pin_fp32_precision()

from nle_tpu_torch.models.factored import FactoredFilter  # noqa: E402
from nle_tpu_torch.models.filter import (  # noqa: E402
    NLEFilter,
    TrainedFilter,
    load_filter,
)
from nle_tpu_torch.ops.pipeline import apply_filter_u8, train_filter  # noqa: E402
from nle_tpu_torch.ops.transform import transform_eigenvalues  # noqa: E402

__all__ = [
    "FactoredFilter",
    "NLEFilter",
    "TrainedFilter",
    "apply_filter_u8",
    "load_filter",
    "train_filter",
    "transform_eigenvalues",
]
