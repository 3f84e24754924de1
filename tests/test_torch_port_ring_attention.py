"""The port's ring attention against the JAX package's
(``seldon_core_tpu_torch/parallel/ring_attention.py``).

The JAX ring runs under ``shard_map`` on conftest's host devices; the
port's ring is the same online-softmax carry over explicit positions,
K/V blocks passed along the ring with ``ppermute``.  Same inputs, f32,
within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_core_tpu.parallel import create_mesh as jax_create_mesh
from seldon_core_tpu.parallel.ring_attention import ring_attention as jax_ring_attention
from seldon_core_tpu_torch.models.transformer import TransformerLM, ring_attn_fn
from seldon_core_tpu_torch.parallel import ShardedTensor, create_mesh
from seldon_core_tpu_torch.parallel.ring_attention import plain_attention, ring_attention, sequence_sharding

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(batch=2, seq=16, heads=2, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=(batch, seq, heads, dim)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_jax_s_ring(n, causal):
    q, k, v = _qkv(seq=32, seed=n + int(causal))
    theirs = jax_ring_attention(*(jnp.asarray(t) for t in (q, k, v)), mesh=jax_create_mesh({"seq": n}),
                                seq_axis="seq", causal=causal)
    mine = ring_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                          mesh=create_mesh({"seq": n}, devices=["cpu"] * n), seq_axis="seq", causal=causal)
    np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), **TOL)
    np.testing.assert_allclose(mine.numpy(), plain_attention(*(torch.from_numpy(t) for t in (q, k, v)),
                                                             causal=causal).numpy(), **TOL)


def test_sequence_sharded_input_gives_sharded_output():
    mesh = create_mesh({"seq": 4}, devices=["cpu"] * 4)
    q, k, v = (torch.from_numpy(t) for t in _qkv(batch=1, seq=64, heads=2, dim=4, seed=3))
    spec = sequence_sharding(mesh).spec
    qs, ks, vs = (ShardedTensor.from_tensor(mesh, t, spec) for t in (q, k, v))
    out = ring_attention(qs, ks, vs, mesh=mesh, seq_axis="seq", causal=True)
    assert isinstance(out, ShardedTensor) and out.local((2,)).shape == (1, 16, 2, 4)
    np.testing.assert_allclose(out.full().numpy(), plain_attention(q, k, v, causal=True).numpy(), **TOL)


def test_ring_over_the_serving_data_axis():
    """The data axis of a 2-D serving mesh doubles as a ring (the JAX
    package's long-context oracle); the model positions repeat it."""
    mesh = create_mesh({"data": 4, "model": 2}, devices=["cpu"] * 8)
    q, k, v = (torch.from_numpy(t) for t in _qkv(seq=16, seed=5))
    out = ring_attention(q, k, v, mesh=mesh, seq_axis="data", causal=True)
    np.testing.assert_allclose(out.numpy(), plain_attention(q, k, v, causal=True).numpy(), **TOL)


def test_gradients_flow_and_match_plain():
    q, k, v = (torch.from_numpy(t).requires_grad_(True) for t in _qkv(seq=8, seed=4))
    mesh = create_mesh({"seq": 4}, devices=["cpu"] * 4)
    ring_attention(q, k, v, mesh=mesh, seq_axis="seq", causal=True).sum().backward()
    grads = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    plain_attention(q, k, v, causal=True).sum().backward()
    for g, t in zip(grads, (q, k, v)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), t.grad.numpy(), rtol=1e-4, atol=1e-5)


def test_indivisible_sequence_and_missing_axis_raise():
    mesh = create_mesh({"seq": 4}, devices=["cpu"] * 4)
    q = torch.zeros(1, 6, 1, 4)
    with pytest.raises(ValueError, match="not divisible by the ring size 4"):
        ring_attention(q, q, q, mesh=mesh)
    with pytest.raises(ValueError, match="has no axis 'ring'"):
        ring_attention(q, q, q, mesh=mesh, seq_axis="ring")


def test_transformer_lm_with_ring_attention_matches_its_plain_forward():
    """``ring_attn_fn`` in every block of a TransformerLM: the logits of
    its plain forward, within 1e-4."""
    cfg = dict(vocab_size=64, d_model=32, num_layers=2, num_heads=4, max_len=64, dtype=torch.float32)
    plain = TransformerLM(**cfg).reset_parameters(torch.Generator().manual_seed(0))
    ring = TransformerLM(attn_fn=ring_attn_fn(create_mesh({"seq": 4}, devices=["cpu"] * 4)), **cfg)
    ring.load_state_dict(plain.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 64, size=(2, 32)))
    with torch.no_grad():
        np.testing.assert_allclose(ring(tokens).numpy(), plain(tokens).numpy(), rtol=1e-4, atol=1e-4)
