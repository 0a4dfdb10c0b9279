from nle_tpu_torch.ops.linalg import (
    eigh_descending,
    safe_reciprocal,
    safe_rsqrt,
)
from nle_tpu_torch.ops.pipeline import apply_filter, train_filter
from nle_tpu_torch.ops.sampling import SampleGrid, sample_grid
from nle_tpu_torch.ops.transform import transform_eigenvalues

__all__ = [
    "SampleGrid",
    "sample_grid",
    "eigh_descending",
    "safe_reciprocal",
    "safe_rsqrt",
    "transform_eigenvalues",
    "train_filter",
    "apply_filter",
]
