from nle_tpu_torch.ops.kernels.affinity_kernel import affinity_matmul_kernel

__all__ = ["affinity_matmul_kernel"]
