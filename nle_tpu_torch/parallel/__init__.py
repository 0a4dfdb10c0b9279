"""Multi-GPU training over torch.distributed (port of nle_tpu/parallel/):
the pixel-sharded mesh trainer and applies (sharded.py) and the
multi-process half (distributed.py, loaded on first use). Importing the
package starts no process group."""

from nle_tpu_torch.parallel.sharded import (
    apply_filter_factored_sharded,
    apply_filter_sharded,
    make_mesh,
    train_filter_sharded,
)

__all__ = ["make_mesh", "train_filter_sharded", "apply_filter_sharded",
           "apply_filter_factored_sharded", "make_global_mesh",
           "train_filters_multihost"]


def __getattr__(name):
    # The multi-process half loads lazily, as in the JAX package.
    if name in ("make_global_mesh", "train_filters_multihost"):
        from nle_tpu_torch.parallel import distributed

        return getattr(distributed, name)
    raise AttributeError(name)
