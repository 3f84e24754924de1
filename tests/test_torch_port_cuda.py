"""The PyTorch port on a CUDA card: kernels against their plain versions,
and the served path through the kernel.

Every test here needs the card and skips without one (the decision is
made inside each test, never at import).  The module imports no JAX, so
it also runs on a card host without the JAX package's dependencies:

    python -m pytest --noconftest -q tests/test_torch_port_cuda.py
"""

import numpy as np
import pytest
import torch

from seldon_core_tpu_torch.models.cudaserver import CudaServer
from seldon_core_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    scale = rng.uniform(0.001, 0.05, c).astype(np.float32)
    shift = rng.uniform(-2.0, 1.0, c).astype(np.float32)
    return [torch.from_numpy(a).cuda() for a in (x, scale, shift)]


@pytest.mark.parametrize("shape", [(32, 224, 224, 3), (3, 5, 7, 1), (2, 9, 11, 4), (1, 1, 1, 17)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32])
def test_fused_normalize_bit_identical_to_plain_version(shape, dtype):
    _need_card()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    args = _inputs(shape, seed=sum(shape))
    before = kernels.launch_counts()["fused_normalize"]
    got = kernels.fused_normalize(*args, out_dtype=dtype)
    ref = kernels.fused_normalize_reference(*args, out_dtype=dtype)
    torch.cuda.synchronize()
    assert got.is_cuda and got.is_contiguous() and tuple(got.shape) == shape
    assert torch.equal(got.view(bits), ref.view(bits))
    assert kernels.launch_counts()["fused_normalize"] == before + 1


def test_fused_normalize_misaligned_view():
    _need_card()
    x, scale, shift = _inputs((2, 4, 4, 3), seed=5)
    view = x.flatten()[1:94].view(1, 31, 1, 3)  # contiguous, one byte off alignment
    assert view.data_ptr() % 16
    got = kernels.fused_normalize(view, scale, shift)
    assert torch.equal(got, kernels.fused_normalize_reference(view, scale, shift))


def test_served_uint8_batch_launches_the_kernel():
    _need_card()
    cs = CudaServer(model="resnet_tiny", num_classes=4, normalize=True, max_batch_size=2)
    cs.load()
    try:
        kernels.reset_launch_counts()
        out = cs.predict(np.random.default_rng(9).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8), [])
        assert out.shape == (2, 4) and np.isfinite(out).all()
        assert kernels.launch_counts()["fused_normalize"] == 1
    finally:
        cs.unload()
