"""The port's ``flash_attention`` (K3) against the JAX package's.

On the CPU the port's wrapper runs its plain version
(``flash_attention_reference``); the JAX package's runs its Pallas
kernel in interpret mode, as ``tests/test_ops.py`` runs it.  The same
numpy inputs go to both, at sequence lengths 32, 50 and 197 (ViT-B/16's
token count, which the TPU kernel pads to its blocks and the port never
pads), causal and not, 2 heads of 16 and of 64.

Tolerances: float32 within 1e-5 absolute (both compute in float32; the
TPU kernel's blockwise online softmax sums in another order).  bfloat16
within one bf16 step of the JAX value: rtol 2**-7, and an absolute floor
of 2**-15 times the largest |value| (one bf16 step at 2**-8 of the
largest value), since for outputs near zero the two float32 sums differ
by more than a bf16 step of the value itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.ops import kernels as jax_kernels
from seldon_core_tpu.parallel.ring_attention import plain_attention as jax_plain_attention
from seldon_core_tpu_torch.models.transformer import plain_attention
from seldon_core_tpu_torch.ops import kernels

BATCH, HEADS = 2, 2
F32_ATOL = 1e-5
BF16_RTOL = 2.0 ** -7


def _qkv(L, d, dtype, seed, Lk=None):
    rng = np.random.default_rng(seed)
    Lk = L if Lk is None else Lk
    arrs = [rng.standard_normal((BATCH, n, HEADS, d)).astype(np.float32) for n in (L, Lk, Lk)]
    if dtype == "bfloat16":  # both sides start from the same bf16 values
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32)) for a in arrs]
    return arrs


def _port(arrs, dtype, **kw):
    dt = getattr(torch, dtype)
    return kernels.flash_attention(*(torch.from_numpy(a).to(dt) for a in arrs), **kw).float().numpy()


def _jax(arrs, dtype, **kw):
    dt = getattr(jnp, dtype)
    return np.asarray(jax_kernels.flash_attention(*(jnp.asarray(a, dt) for a in arrs), **kw), np.float32)


def _assert_close(got, ref, dtype):
    assert got.shape == ref.shape and not np.isnan(got).any()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=0, atol=F32_ATOL)
    else:
        np.testing.assert_allclose(got, ref, rtol=BF16_RTOL, atol=2.0 ** -15 * np.abs(ref).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("head_dim", [16, 64])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("L", [32, 50, 197])
def test_plain_version_matches_jax_kernel(L, causal, head_dim, dtype):
    arrs = _qkv(L, head_dim, dtype, seed=L + head_dim)
    _assert_close(_port(arrs, dtype, causal=causal), _jax(arrs, dtype, causal=causal), dtype)


def test_block_sizes_do_not_change_the_result():
    arrs = [torch.from_numpy(a) for a in _qkv(50, 16, "float32", seed=1)]
    base = kernels.flash_attention(*arrs, causal=True)
    for bq, bk in ((16, 16), (64, 32), (8, 128)):
        torch.testing.assert_close(kernels.flash_attention(*arrs, causal=True, block_q=bq, block_k=bk), base,
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="positive"):
        kernels.flash_attention(*arrs, block_q=0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_cross_length_calls(causal):
    """sq != sk: a causal call is ``plain_attention`` on both sides (the
    JAX function's contract); a non-causal one is the flash arithmetic."""
    arrs = _qkv(24, 16, "float32", seed=2, Lk=40)
    got = _port(arrs, "float32", causal=causal)
    _assert_close(got, _jax(arrs, "float32", causal=causal), "float32")
    if causal:
        tq, tk, tv = (torch.from_numpy(a) for a in arrs)
        np.testing.assert_array_equal(got, plain_attention(tq, tk, tv, causal=True).numpy())
        np.testing.assert_allclose(got, np.asarray(jax_plain_attention(*(jnp.asarray(a) for a in arrs), causal=True)),
                                   rtol=0, atol=F32_ATOL)


def test_single_token_and_no_nan():
    for causal in (False, True):
        arrs = _qkv(1, 8, "float32", seed=3)
        got = _port(arrs, "float32", causal=causal)
        np.testing.assert_allclose(got, arrs[2], rtol=0, atol=1e-7)  # one key: the output is its value


def test_dtype_and_layout_follow_q():
    arrs = [torch.from_numpy(a).to(torch.float16) for a in _qkv(20, 16, "float32", seed=4)]
    out = kernels.flash_attention(*arrs)
    assert out.dtype == torch.float16 and tuple(out.shape) == (BATCH, 20, HEADS, 16)
    # strided views, as the qkv split leaves them, give the same answer as contiguous copies
    qkv = torch.from_numpy(np.random.default_rng(5).standard_normal((BATCH, 20, 3 * HEADS * 16)).astype(np.float32))
    views = [t.reshape(BATCH, 20, HEADS, 16) for t in qkv.split(HEADS * 16, dim=-1)]
    assert not views[0].is_contiguous()
    torch.testing.assert_close(kernels.flash_attention(*views), kernels.flash_attention(*(v.contiguous() for v in views)),
                               rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    before = kernels.launch_counts()
    arrs = _qkv(32, 16, "float32", seed=6)
    fn = kernels.flash_attn_fn(block_q=16, block_k=16)
    tq, tk, tv = (torch.from_numpy(a) for a in arrs)
    torch.testing.assert_close(fn(tq, tk, tv, causal=True), kernels.flash_attention_reference(tq, tk, tv, causal=True),
                               rtol=0, atol=0)
    assert kernels.launch_counts() == before


def test_rejects_mismatched_shapes():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="do not match"):
        kernels.flash_attention(q, torch.zeros(1, 4, 2, 8), torch.zeros(1, 5, 2, 8))
    with pytest.raises(ValueError, match="batch, seq, heads, head_dim"):
        kernels.flash_attention(q[0], q[0], q[0])
