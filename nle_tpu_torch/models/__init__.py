from nle_tpu_torch.models.filter import NLEFilter, TrainedFilter

__all__ = ["NLEFilter", "TrainedFilter"]
