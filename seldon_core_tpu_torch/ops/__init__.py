"""Hand-written CUDA kernels and their plain PyTorch versions."""

from seldon_core_tpu_torch.ops.kernels import (  # noqa: F401
    fused_normalize,
    fused_normalize_reference,
    imagenet_affine,
    launch_counts,
    reset_launch_counts,
)
