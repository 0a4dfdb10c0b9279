from nle_tpu_torch.utils.indexing import to_1d_index, to_2d_coords

__all__ = ["to_1d_index", "to_2d_coords"]
