"""The port's K2 wrapper (``int8_matmul``), ``quantize_weights`` and
``Int8Dense`` against the JAX package's.

The same numpy inputs go through the JAX functions (the Pallas kernel in
interpret mode, as ``tests/test_ops.py`` runs it on the CPU) and through
the port's, which on a CPU tensor is K2's plain version.  Tolerances:
``quantize_weights`` bit for bit; float32 outputs within 1e-5 of the
largest |JAX output| (the order of the K sums differs); bfloat16 x within
one bfloat16 step of JAX's output (a step is 2**-7 of the value, with a
floor at 2**-8 of a step of the largest output, for outputs near zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops import kernels as jax_kernels
from seldon_core_tpu_torch.ops import kernels

SHAPES = [(16, 64, 48), (5, 16, 10), (16, 128, 128), (100, 300, 70)]  # (M, K, N)
F32_REL = 1e-5
BF16_STEP = 2.0 ** -7


def _case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(64, 32), (7, 5), (300, 70), (1, 1)])
def test_quantize_weights_bit_equal(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w[:, 0] = 0.0  # a zero column gets scale 1.0
    want_q, want_s = jax_kernels.quantize_weights(w)
    got_q, got_s = kernels.quantize_weights(w)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32
    np.testing.assert_array_equal(got_q, want_q)
    assert got_s.tobytes() == want_s.tobytes()
    assert got_s[0] == 1.0


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_f32_matches_jax(m, k, n):
    x, w = _case(m, k, n, seed=m + k + n)
    w_q, scale = jax_kernels.quantize_weights(w)
    want = np.asarray(jax_kernels.int8_matmul(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(scale)))
    got = kernels.int8_matmul(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    err = np.abs(got.numpy() - want).max()
    assert err <= F32_REL * np.abs(want).max(), err


@pytest.mark.parametrize("m,k,n", SHAPES)
def test_int8_matmul_bf16_within_one_step_of_jax(m, k, n):
    x, w = _case(m, k, n, seed=2 * (m + k + n))
    w_q, scale = jax_kernels.quantize_weights(w)
    want = np.asarray(jax_kernels.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w_q),
                                              jnp.asarray(scale))).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = kernels.int8_matmul(xb, torch.from_numpy(w_q), torch.from_numpy(scale))
    assert got.dtype == torch.bfloat16
    diff = np.abs(got.float().numpy() - want)
    limit = BF16_STEP * np.maximum(np.abs(want), 2.0 ** -8 * np.abs(want).max())
    assert (diff <= limit).all(), diff.max()
    # out_dtype: one rounding of the f32 sum
    f32 = kernels.int8_matmul(xb, torch.from_numpy(w_q), torch.from_numpy(scale), out_dtype=torch.float32)
    assert f32.dtype == torch.float32
    assert torch.equal(f32.to(torch.bfloat16), got)


def test_reference_is_the_dequantised_product():
    x, w = _case(9, 24, 40, seed=3)
    w_q, scale = kernels.quantize_weights(w)
    got = kernels.int8_matmul_reference(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale))
    np.testing.assert_allclose(got.numpy(), x @ (w_q.astype(np.float32) * scale), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("x_shape,w_shape,s_shape", [
    ((3, 4, 5), (5, 6), (6,)),      # not 2-D
    ((8, 16), (24, 32), (32,)),     # K mismatch
    ((8, 16), (16, 32), (16,)),     # scale shape
])
def test_errors_name_the_same_dims_as_jax(x_shape, w_shape, s_shape):
    with pytest.raises(ValueError) as want:
        jax_kernels.int8_matmul(jnp.zeros(x_shape), jnp.zeros(w_shape, jnp.int8), jnp.ones(s_shape))
    with pytest.raises(ValueError) as got:
        kernels.int8_matmul(torch.zeros(x_shape), torch.zeros(w_shape, dtype=torch.int8), torch.ones(s_shape))
    assert str(got.value) == str(want.value)


def test_int8_dense_matches_jax():
    rng = np.random.default_rng(3)
    kernel = rng.standard_normal((32, 16)).astype(np.float32)
    bias = rng.standard_normal((16,)).astype(np.float32)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    want = np.asarray(jax_kernels.Int8Dense(kernel, bias)(jnp.asarray(x)))
    layer = kernels.Int8Dense(kernel, bias, device="cpu")
    assert layer.w_q.dtype == torch.int8 and tuple(layer.w_q.shape) == (32, 16)
    np.testing.assert_array_equal(layer.w_q.numpy(), jax_kernels.quantize_weights(kernel)[0])
    got = layer(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert kernels.Int8Dense(kernel, device="cpu").bias is None


def test_cpu_calls_launch_nothing():
    x, w = _case(8, 16, 8, seed=4)
    w_q, scale = kernels.quantize_weights(w)
    before = kernels.launch_counts()["int8_matmul"]
    kernels.int8_matmul(torch.from_numpy(x), torch.from_numpy(w_q), torch.from_numpy(scale))
    kernels.Int8Dense(w, device="cpu")(torch.from_numpy(x))
    assert kernels.launch_counts()["int8_matmul"] == before


def test_int8_dense_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        kernels.Int8Dense(np.ones((8, 8), np.float32))
