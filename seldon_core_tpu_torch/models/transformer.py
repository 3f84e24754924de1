"""Transformer family in PyTorch: the encoder and the causal decoder LM.

The port's counterpart of ``seldon_core_tpu/models/transformer.py``
``TransformerBlock``, ``TransformerEncoder`` and ``TransformerLM``, with
the LM's ``decode=True`` cache as :class:`DecodeCache`.
Attention is pluggable as in the JAX package: ``attn_fn`` is
:func:`plain_attention` (``parallel/ring_attention.py``) by default,
``ops.kernels.flash_attn_fn()`` for the CUDA flash kernel and
:func:`ring_attn_fn` for the sequence-parallel ring over a mesh axis.
The parameter trees are the flax modules', name for name
(``models/convert.py`` maps one onto the other), and the arithmetic
follows flax's defaults, which differ from PyTorch's:

* ``nn.LayerNorm(dtype=float32)``: epsilon 1e-6, computed in float32
  and returned in float32 whatever the input's dtype;
* ``nn.Dense(dtype=...)``: input, kernel and bias in the compute dtype,
  output in the compute dtype;
* ``nn.Embed(dtype=...)``: the table looked up in the compute dtype, so
  the residual stream stays in it;
* ``nn.gelu``: the tanh approximation;
* the head's logits are cast to float32.

The cached forward (``TransformerLM.forward(..., cache=DecodeCache)``)
rounds as the JAX block's ``_cached_attention``: ``q`` scaled in the
compute dtype before the product, scores in the compute dtype masked with
its ``finfo.min``, softmax in float32 and the weights cast back.  The
cache is an object the caller owns, not module state, so concurrent
callers each hold their own.

Weights of the dense and embedding layers are held in the compute dtype
(flax keeps float32 parameters and casts them at every call, which
rounds them the same way once); LayerNorm parameters stay float32.
"""

from __future__ import annotations

import math
import functools
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.ops.lora import lora_delta
from seldon_core_tpu_torch.parallel.ring_attention import plain_attention  # noqa: F401 (the family's default attention)

LN_EPS = 1e-6    # flax nn.LayerNorm's default epsilon


class LayerNorm32(nn.Module):
    """flax ``nn.LayerNorm(dtype=float32)``: float32 in, float32 out."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features, dtype=torch.float32))
        self.bias = nn.Parameter(torch.zeros(features, dtype=torch.float32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, eps=LN_EPS)


class Dense(nn.Linear):
    """flax ``nn.Dense(dtype=...)``: the input is cast to the weight's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


AttnFn = Callable[..., torch.Tensor]


def ring_attn_fn(mesh, seq_axis: str = "seq") -> AttnFn:
    """Attention routed through the sequence-parallel ring
    (``parallel.ring_attention.ring_attention``) over ``mesh``'s
    ``seq_axis``."""
    from seldon_core_tpu_torch.parallel.ring_attention import ring_attention

    def fn(q, k, v, causal: bool = False):
        return ring_attention(q, k, v, mesh=mesh, seq_axis=seq_axis, causal=causal)

    return fn


@functools.lru_cache(maxsize=None)
def head_scale(head_dim: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(head_dim)`` the way the JAX block forms it: the root in
    float32, cast to the model dtype, inverted in the model dtype.  The
    value is exact in the model dtype, so multiplying by it as a Python
    float rounds as multiplying by the dtype's scalar does, and no
    host-to-device copy (a stream synchronisation) happens per layer."""
    return float(1.0 / torch.tensor(math.sqrt(head_dim), dtype=torch.float32).to(dtype))


class DecodeCache:
    """The K/V cache of one cached generation: per layer one K and one V
    tensor of shape (B, max_len, heads, head_dim) in the compute dtype,
    and the running ``index`` (a host int: the slot the next call writes
    first, one for every row, as the JAX cache's scalar ``cache_index``).
    ``TransformerLM.forward(..., cache=)`` writes into it in place and
    advances ``index``; the caller may set ``index`` (the prefill of a
    padded prompt sets it to the true length)."""

    def __init__(self, keys: List[torch.Tensor], values: List[torch.Tensor], index: int = 0):
        self.keys, self.values, self.index = keys, values, int(index)

    @classmethod
    def zeros(cls, batch: int, *, num_layers: int, max_len: int, num_heads: int, head_dim: int,
              dtype: torch.dtype, device) -> "DecodeCache":
        shape = (batch, max_len, num_heads, head_dim)
        return cls([torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)],
                   [torch.zeros(shape, dtype=dtype, device=device) for _ in range(num_layers)])

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (*self.keys, *self.values))


def cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Attention of ``q`` (B, L, h, hd) over every slot of a decode cache
    ``ck`` / ``cv`` (B, max_len, h, hd) under ``mask`` (L, max_len), as
    the JAX block's ``_cached_attention``: ``q`` scaled in its dtype,
    scores masked with the dtype's finfo.min, softmax in float32, the
    weights cast back."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q * head_scale(q.shape[-1], q.dtype), ck)
    scores = torch.where(mask[None, None], scores, torch.finfo(scores.dtype).min)
    weights = torch.softmax(scores.float(), dim=-1).to(ck.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, cv)


class TransformerBlock(nn.Module):
    """Pre-LayerNorm block: self-attention through ``attn_fn`` (causal
    when ``causal``), then a GELU MLP."""

    def __init__(self, d_model: int, num_heads: int, mlp_ratio: int = 4, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: AttnFn = plain_attention, causal: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.attn_fn = attn_fn
        self.causal = causal
        self.ln0 = LayerNorm32(d_model)
        self.qkv = Dense(d_model, 3 * d_model, dtype=dtype)
        self.attn_proj = Dense(d_model, d_model, dtype=dtype)
        self.ln1 = LayerNorm32(d_model)
        self.mlp_in = Dense(d_model, mlp_ratio * d_model, dtype=dtype)
        self.mlp_out = Dense(mlp_ratio * d_model, d_model, dtype=dtype)

    def project(self, name: str, inp: torch.Tensor, lora=None, adapter_idx=None) -> torch.Tensor:
        """The dense layer ``name`` on ``inp``, plus each lane's LoRA delta
        when ``lora`` (target -> (A, B) of this layer, see ``ops/lora.py``)
        decorates it: ``dense(inp) + lora_delta(inp, ...)`` cast to the
        dense output's dtype, as the JAX paged block adds it.  Without
        ``lora`` this is the dense layer alone."""
        out = getattr(self, name)(inp)
        if lora is not None and name in lora:
            a, b = lora[name]
            out = out + lora_delta(inp, a, b, adapter_idx).to(out.dtype)
        return out

    def split_heads(self, qkv: torch.Tensor):
        """(B, L, 3d) -> q, k, v of shape (B, L, heads, head_dim)."""
        B, L, d3 = qkv.shape
        shape = (B, L, self.num_heads, d3 // 3 // self.num_heads)
        q, k, v = qkv.split(d3 // 3, dim=-1)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)

    def qkv_heads(self, x: torch.Tensor):
        """(B, L, d) -> q, k, v of shape (B, L, heads, head_dim)."""
        return self.split_heads(self.qkv(self.ln0(x)))

    def mlp_tail(self, x: torch.Tensor, attn: torch.Tensor, lora=None, adapter_idx=None) -> torch.Tensor:
        """Residual attention projection, then the residual MLP."""
        x = x + self.project("attn_proj", attn, lora, adapter_idx)
        y = F.gelu(self.project("mlp_in", self.ln1(x), lora, adapter_idx), approximate="tanh")
        return x + self.project("mlp_out", y, lora, adapter_idx)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv_heads(x)
        return self.mlp_tail(x, self.attn_fn(q, k, v, causal=self.causal).reshape(x.shape))

    def forward_cached(self, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor, index: int,
                       mask: torch.Tensor) -> torch.Tensor:
        """The block on ``x`` (B, L, d) at cache slots ``index``..``index+L-1``:
        this call's K/V written into ``ck`` / ``cv`` (B, max_len, h, hd)
        there, then attention over all ``max_len`` slots under ``mask``
        (L, max_len), true where slot <= index + i (JAX
        ``_cached_attention``)."""
        q, k, v = self.qkv_heads(x)
        seg_len = x.shape[1]
        ck[:, index:index + seg_len] = k
        cv[:, index:index + seg_len] = v
        return self.mlp_tail(x, cached_attention(q, ck, cv, mask).reshape(x.shape))


@torch.no_grad()
def flax_default_init_(root: nn.Module, generator: torch.Generator) -> None:
    """Random init of every dense, convolution, embedding and LayerNorm
    under ``root`` in flax's default scheme, drawn from ``generator``
    (the values differ from jax's RNG; ``models/convert.py`` carries a
    flax init across): dense and conv kernels LeCun-normal (truncated at
    two standard deviations, std sqrt(1/fan_in) / 0.8796), their biases
    0, embeddings normal with std sqrt(1/features), LayerNorm scale 1 and
    bias 0."""
    for module in root.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            fan_in = module.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(module.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            module.weight.copy_(w)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            w = torch.randn(module.weight.shape, generator=generator, dtype=torch.float32)
            module.weight.copy_(w * math.sqrt(1.0 / module.embedding_dim))
        elif isinstance(module, LayerNorm32):
            module.weight.fill_(1.0)
            module.bias.zero_()


class TransformerEncoder(nn.Module):
    """Token classifier: non-causal blocks, the final LayerNorm in
    float32, mean pooling over the sequence (``pool="mean"``) or
    per-token logits (``pool="none"``), the head in the compute dtype and
    float32 logits."""

    def __init__(self, num_classes: int = 2, vocab_size: int = 32_000, d_model: int = 256, num_layers: int = 4,
                 num_heads: int = 8, max_len: int = 2048, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: AttnFn = plain_attention, pool: str = "mean"):
        super().__init__()
        if pool not in ("mean", "none"):
            raise ValueError(f"pool must be 'mean' or 'none', got {pool!r}")
        self.pool = pool
        self.tok_embed = nn.Embedding(vocab_size, d_model, dtype=dtype)
        self.pos_embed = nn.Embedding(max_len, d_model, dtype=dtype)
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, num_heads, dtype=dtype, attn_fn=attn_fn, causal=False)
            for _ in range(num_layers))
        self.ln_f = LayerNorm32(d_model)
        self.head = Dense(d_model, num_classes, dtype=dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.tok_embed(tokens.long()) + self.pos_embed(positions)
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        if self.pool == "mean":
            x = x.mean(dim=1)
        return self.head(x).float()

    def reset_parameters(self, generator: torch.Generator) -> "TransformerEncoder":
        """Random init in flax's default scheme (:func:`flax_default_init_`)."""
        flax_default_init_(self, generator)
        return self


class TransformerLM(nn.Module):
    """Causal decoder: next-token logits over a whole sequence, or, with
    ``cache=``, the kv-cached forward on the same parameters (a
    :class:`DecodeCache` from :meth:`init_cache`; ``positions`` are then
    absolute)."""

    block_cls = TransformerBlock

    def __init__(self, vocab_size: int = 32_000, d_model: int = 256, num_layers: int = 4,
                 num_heads: int = 8, max_len: int = 2048, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: AttnFn = plain_attention):
        super().__init__()
        self.vocab_size, self.d_model, self.num_heads, self.dtype = vocab_size, d_model, num_heads, dtype
        self.tok_embed = nn.Embedding(vocab_size, d_model, dtype=dtype)
        self.pos_embed = nn.Embedding(max_len, d_model, dtype=dtype)
        self.blocks = nn.ModuleList(self.block_cls(d_model, num_heads, dtype=dtype, attn_fn=attn_fn, causal=True)
                                    for _ in range(num_layers))
        self.ln_f = LayerNorm32(d_model)
        self.head = Dense(d_model, vocab_size, dtype=dtype)

    def embed(self, tokens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        return self.tok_embed(tokens.long()) + self.pos_embed(positions.long())

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.ln_f(x)).float()

    def init_cache(self, batch: int) -> DecodeCache:
        """A zero :class:`DecodeCache` for ``batch`` rows, in the compute
        dtype, on the module's device."""
        return DecodeCache.zeros(batch, num_layers=len(self.blocks), max_len=self.pos_embed.num_embeddings,
                                 num_heads=self.num_heads, head_dim=self.d_model // self.num_heads,
                                 dtype=self.dtype, device=self.ln_f.weight.device)

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None,
                cache: Optional[DecodeCache] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens, positions)
        if cache is None:
            for block in self.blocks:
                x = block(x)
            return self.logits(x)
        seg_len, max_len = tokens.shape[1], cache.keys[0].shape[1]
        q_pos = cache.index + torch.arange(seg_len, device=x.device)
        mask = torch.arange(max_len, device=x.device)[None, :] <= q_pos[:, None]
        for block, ck, cv in zip(self.blocks, cache.keys, cache.values):
            x = block.forward_cached(x, ck, cv, cache.index, mask)
        cache.index += seg_len
        return self.logits(x)

    def reset_parameters(self, generator: torch.Generator) -> "TransformerLM":
        """Random init in flax's default scheme (:func:`flax_default_init_`)."""
        flax_default_init_(self, generator)
        return self
