"""Ring attention: sequence-parallel attention over a mesh axis.

The port's counterpart of ``seldon_core_tpu/parallel/ring_attention.py``.
Each ring position holds its shard of the sequence; the positions run
the online-softmax carry (m, l, acc in float32) for ``n`` steps, passing
their K/V block to the next position after each (:func:`ppermute`), as
the JAX package's ``_ring_shard_body`` does inside ``shard_map``.
Causal masking uses global positions.  :func:`plain_attention` is the
one-device oracle (and the transformer family's default attention).
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np
import torch

from seldon_core_tpu_torch.parallel.mesh import Mesh, mesh_shape
from seldon_core_tpu_torch.parallel.sharding import NamedSharding, P, ShardedTensor, ppermute

NEG_INF = -1e30


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Single-device attention on (batch, seq, heads, dim), as the JAX
    package's ``plain_attention``: scores in the input dtype, scaled in
    float32, softmax in float32, weights cast back."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.arange(s_k, device=q.device)[None, :] > torch.arange(s_q, device=q.device)[:, None]
        scores = torch.where(mask[None, None], NEG_INF, scores)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _ring_positions(mesh: Mesh, seq_axis: str) -> List[Tuple[int, ...]]:
    """The ring's positions in axis order, at index 0 of every other axis
    (the sequence spec replicates over them, so their rings repeat this
    one's work)."""
    if seq_axis not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.shape} has no axis {seq_axis!r}")
    a = mesh.axis_names.index(seq_axis)
    base = [0] * len(mesh.axis_names)
    out = []
    for i in range(mesh.devices.shape[a]):
        base[a] = i
        out.append(tuple(base))
    return out


def _ring_body(qs, ks, vs, devices, causal: bool):
    """Every ring position's carry, ``n`` steps: ``qs`` / ``ks`` / ``vs``
    the local sequence shards (b, s_local, h, d) in ring order."""
    n = len(qs)
    b, s_local, h, d = qs[0].shape
    scale = 1.0 / np.sqrt(d)
    q32 = [q.float() for q in qs]
    carry = []
    for dev in devices:
        carry.append([torch.full((b, h, s_local), NEG_INF, dtype=torch.float32, device=dev),
                      torch.zeros((b, h, s_local), dtype=torch.float32, device=dev),
                      torch.zeros((b, h, s_local, d), dtype=torch.float32, device=dev)])
    k_blk, v_blk = list(ks), list(vs)
    ring = [(j, (j + 1) % n) for j in range(n)]
    for i in range(n):
        for me in range(n):
            m, l, acc = carry[me]
            dev = devices[me]
            local_pos = torch.arange(s_local, device=dev)
            src = (me - i) % n  # the block held now started at position src
            scores = torch.einsum("bqhd,bkhd->bhqk", q32[me], k_blk[me].float()) * scale
            if causal:
                q_pos = me * s_local + local_pos
                k_pos = src * s_local + local_pos
                mask = k_pos[None, :] > q_pos[:, None]
                scores = torch.where(mask[None, None], NEG_INF, scores)
            m_new = torch.maximum(m, scores.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(scores - m_new[..., None])
            l_new = l * alpha + p.sum(dim=-1)
            acc_new = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v_blk[me].float())
            carry[me] = [m_new, l_new, acc_new]
        # pass K/V to the next position of the ring
        k_blk = ppermute(k_blk, ring, devices)
        v_blk = ppermute(v_blk, ring, devices)
    outs = []
    for me in range(n):
        _m, l, acc = carry[me]
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(out.permute(0, 2, 1, 3).to(qs[me].dtype))
    return outs


def ring_attention(q: Union[torch.Tensor, ShardedTensor], k, v, mesh: Mesh, seq_axis: str = "seq",
                   causal: bool = False):
    """Sequence-parallel attention over ``mesh``'s ``seq_axis`` ring.

    ``q`` / ``k`` / ``v``: (batch, seq, heads, dim) global tensors, or
    :class:`ShardedTensor` already laid out by :func:`sequence_sharding`;
    ``seq`` must divide by the ring's size.  A tensor input gives the
    global output on ``q``'s device, a sharded input a sharded output."""
    spec = P(None, seq_axis, None, None)
    n = mesh_shape(mesh).get(seq_axis, 0)
    if n == 0:
        raise ValueError(f"mesh {mesh.shape} has no axis {seq_axis!r}")
    ring = _ring_positions(mesh, seq_axis)
    devices = [mesh.device(pos) for pos in ring]
    sharded_in = isinstance(q, ShardedTensor)
    if sharded_in:
        qs, ks, vs = ([t.local(pos) for pos in ring] for t in (q, k, v))
        out_dtype = q.dtype
    else:
        seq = q.shape[1]
        if seq % n:
            raise ValueError(f"sequence length {seq} is not divisible by the ring size {n}")
        s_local = seq // n
        qs, ks, vs = ([t[:, i * s_local:(i + 1) * s_local].to(devices[i]) for i in range(n)] for t in (q, k, v))
        out_dtype = q.dtype
    outs = _ring_body(qs, ks, vs, devices, causal)
    if not sharded_in:
        return torch.cat([o.to(q.device) for o in outs], dim=1).to(out_dtype)
    shards = np.empty(mesh.devices.shape, dtype=object)
    a = mesh.axis_names.index(seq_axis)
    for pos in mesh.positions():
        local = outs[pos[a]]
        shards[pos] = local if mesh.device(pos) == local.device else local.to(mesh.device(pos))
    return ShardedTensor(mesh, spec, shards, q.shape, out_dtype)


def sequence_sharding(mesh: Mesh, seq_axis: str = "seq") -> NamedSharding:
    """The layout placing (batch, seq, ...) tensors on the ring."""
    return NamedSharding(mesh, P(None, seq_axis))
