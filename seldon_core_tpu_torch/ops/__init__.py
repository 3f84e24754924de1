"""Hand-written CUDA kernels and their plain PyTorch versions."""

from seldon_core_tpu_torch.ops.kernels import (  # noqa: F401
    Int8Dense,
    fused_normalize,
    fused_normalize_reference,
    imagenet_affine,
    int8_matmul,
    int8_matmul_reference,
    launch_counts,
    quantize_weights,
    reset_launch_counts,
)
