"""K1 (``fused_normalize``) of the PyTorch port: the launch geometry of its
CUDA kernel, and its CPU path against the JAX package's Pallas kernel.

The geometry (``ops.kernels.normalize_geometry``) is plain Python that
the CUDA kernel follows: one 16-byte vector a thread, the threads
striding over the vectors in one wave of blocks whose threads are a
multiple of lcm(16, C) / 16 (so every vector of a thread starts on the
same channel), then a scalar tail.  On the CPU the wrapper
takes the plain PyTorch version (its input lies on the CPU); the JAX
kernel runs in Pallas interpret mode.  The kernel itself is held against
the plain version bit for bit on the card (tests/test_torch_port_cuda.py
and chip_smoke.py).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from seldon_core_tpu.ops import fused_normalize as jax_fused_normalize
from seldon_core_tpu_torch.ops import kernels

H100_SMS = 132
IMAGE = 224 * 224 * 3


@settings(max_examples=300, deadline=None, database=None, derandomize=True)
@given(n=st.integers(0, 40_000), c=st.integers(1, 8), sms=st.integers(1, 160), blocks_per_sm=st.integers(1, 40))
def test_geometry_covers_every_byte_once_in_one_wave(n, c, sms, blocks_per_sm):
    geo = kernels.normalize_geometry(n, c, sms, blocks_per_sm)
    assert geo.unit == 16 * c // math.gcd(16, c)
    assert 16 * geo.vectors + geo.tail == n and 0 <= geo.tail < 16
    assert geo.threads in (32, 64, 128, 256) and geo.blocks >= 1
    grid = geo.blocks * geo.threads
    assert 16 * grid % geo.unit == 0  # the channel rule the kernel checks before it launches
    # one wave: a block of T threads holds the registers of T / 256 of a full block
    resident = min(32, blocks_per_sm * 256 // geo.threads)
    assert geo.blocks <= sms * resident
    # no second vector for a thread while the wave could still grow by a step
    step = (geo.unit // 16) // math.gcd(geo.unit // 16, geo.threads)
    if grid < geo.vectors:
        assert geo.blocks + step > sms * resident
    seen = np.zeros(n, np.int32)
    for t in range(grid):
        starts = set()
        for start, end in geo.spans(t):
            if end - start == 16:
                assert (start // 16) % 32 == t % 32  # a warp's load reads 512 contiguous bytes
                starts.add(start % c)
            seen[start:end] += 1
        assert len(starts) <= 1  # every vector of a thread starts on one channel: 16 t mod C
        assert starts <= {16 * t % c}
    assert (seen == 1).all()


def test_geometry_of_the_served_batches():
    # batch 32 at 8 resident blocks of 256 an SM: 1056 blocks, 11% of the threads take a second vector
    geo = kernels.normalize_geometry(32 * IMAGE, 3, H100_SMS, 8)
    assert geo == (48, 301_056, 0, 256, 1056)
    assert geo.spans(1) == [(16, 32), (16 * (1 + 1056 * 256), 16 * (2 + 1056 * 256))]
    assert len(geo.spans(1056 * 256 - 1)) == 1
    # at 6 resident blocks the wave is 792 blocks; with room for 1176, one vector a thread
    assert kernels.normalize_geometry(32 * IMAGE, 3, H100_SMS, 6).blocks == 792
    assert kernels.normalize_geometry(32 * IMAGE, 3, H100_SMS, 9).blocks == 1176
    # batch 1: 9408 vectors spread over min(SMs, 9408 // 32) = 132 SMs or more, not 37 blocks of 256
    geo = kernels.normalize_geometry(IMAGE, 3, H100_SMS, 8)
    assert geo == (48, 9408, 0, 64, 147) and geo.blocks * geo.threads == geo.vectors
    # the grid's threads are a multiple of lcm(16, C) / 16: 3 for C = 3 and 6, 5 for C = 5, 1 for C = 1, 2, 4, 8
    assert kernels.normalize_geometry(2 * 9 * 11 * 4, 4, H100_SMS, 8)[:3] == (16, 49, 8)
    assert kernels.normalize_geometry(3 * 5 * 7, 1, H100_SMS, 8)[:3] == (16, 6, 9)
    geo = kernels.normalize_geometry(2 * 3 * 5 * 5, 5, H100_SMS, 8)
    assert geo[:3] == (80, 9, 6) and geo.blocks * geo.threads % 5 == 0
    assert kernels.normalize_geometry(15, 3, H100_SMS, 8)[:3] == (48, 0, 15)


def test_geometry_refuses_what_it_cannot_launch():
    with pytest.raises(ValueError, match="blocks_per_sm=0"):
        kernels.normalize_geometry(IMAGE, 3, H100_SMS, 0)
    with pytest.raises(ValueError, match="c=0"):
        kernels.normalize_geometry(IMAGE, 0, H100_SMS, 3)


# C = 1, 3, 4 are the kernel's compile-time patterns, 5 its generic body;
# shapes whose byte count is not a whole number of units reach the tail
SHAPES = [(3, 5, 7, 1), (2, 9, 11, 3), (1, 5, 7, 3), (2, 9, 11, 4), (2, 3, 5, 5)]
# jnp dtype, torch dtype, tolerance: JAX's f32 differs from the plain chain by
# up to one f32 ulp (XLA's fused multiply-add), so a cast may land one step
# of the format away
DTYPES = {
    "float32": (jnp.float32, torch.float32, 1e-6),
    "bfloat16": (jnp.bfloat16, torch.bfloat16, 2.0 ** -7),
    "float16": (jnp.float16, torch.float16, 2.0 ** -10),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SHAPES, ids=[f"c{s[-1]}-{np.prod(s)}" for s in SHAPES])
def test_cpu_path_matches_jax_kernel(shape, dtype):
    jdt, tdt, rtol = DTYPES[dtype]
    rng = np.random.default_rng(sum(shape))
    c = shape[-1]
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    scale = rng.uniform(0.001, 0.05, c).astype(np.float32)
    shift = rng.uniform(-2.0, 1.0, c).astype(np.float32)
    ref = np.asarray(jax_fused_normalize(jnp.asarray(x), scale, shift, out_dtype=jdt)).astype(np.float32)
    got = kernels.fused_normalize(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(shift), tdt)
    assert got.dtype == tdt and tuple(got.shape) == shape and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol, atol=1e-6)
