from nle_tpu_torch.color.bilateral import bilateral_filter_u8
from nle_tpu_torch.color.lab import (
    bgr_to_lab_u8,
    lab_to_bgr_u8,
    luminance_channel,
)

__all__ = [
    "bgr_to_lab_u8",
    "lab_to_bgr_u8",
    "luminance_channel",
    "bilateral_filter_u8",
]
