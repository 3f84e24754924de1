"""Transformer family in PyTorch: the encoder and the causal decoder LM.

The port's counterpart of ``seldon_core_tpu/models/transformer.py``
``TransformerBlock``, ``TransformerEncoder`` and ``TransformerLM`` (the
``decode=True`` cache and ``ring_attn_fn`` come with later slices).
Attention is pluggable as in the JAX package: ``attn_fn`` is
:func:`plain_attention` by default, ``ops.kernels.flash_attn_fn()`` for
the CUDA flash kernel.  The parameter trees are the flax modules', name
for name (``models/convert.py`` maps one onto the other), and the
arithmetic follows flax's defaults, which differ from PyTorch's:

* ``nn.LayerNorm(dtype=float32)``: epsilon 1e-6, computed in float32
  and returned in float32 whatever the input's dtype;
* ``nn.Dense(dtype=...)``: input, kernel and bias in the compute dtype,
  output in the compute dtype;
* ``nn.Embed(dtype=...)``: the table looked up in the compute dtype, so
  the residual stream stays in it;
* ``nn.gelu``: the tanh approximation;
* the head's logits are cast to float32.

Weights of the dense and embedding layers are held in the compute dtype
(flax keeps float32 parameters and casts them at every call, which
rounds them the same way once); LayerNorm parameters stay float32.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e30  # the JAX package's causal-mask fill (parallel/ring_attention.py)
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


AttnFn = Callable[..., torch.Tensor]


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

    def qkv_heads(self, x: torch.Tensor):
        """(B, L, d) -> q, k, v of shape (B, L, heads, head_dim)."""
        B, L, d = x.shape
        q, k, v = self.qkv(self.ln0(x)).split(d, dim=-1)
        shape = (B, L, self.num_heads, d // self.num_heads)
        return q.reshape(shape), k.reshape(shape), v.reshape(shape)

    def mlp_tail(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """Residual attention projection, then the residual MLP."""
        x = x + self.attn_proj(attn)
        y = F.gelu(self.mlp_in(self.ln1(x)), approximate="tanh")
        return x + self.mlp_out(y)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.qkv_heads(x)
        return self.mlp_tail(x, self.attn_fn(q, k, v, causal=self.causal).reshape(x.shape))


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
    """Causal decoder: next-token logits over a whole sequence."""

    block_cls = TransformerBlock

    def __init__(self, vocab_size: int = 32_000, d_model: int = 256, num_layers: int = 4,
                 num_heads: int = 8, max_len: int = 2048, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: AttnFn = plain_attention):
        super().__init__()
        self.vocab_size = vocab_size
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

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device)
        x = self.embed(tokens, positions)
        for block in self.blocks:
            x = block(x)
        return self.logits(x)

    def reset_parameters(self, generator: torch.Generator) -> "TransformerLM":
        """Random init in flax's default scheme (:func:`flax_default_init_`)."""
        flax_default_init_(self, generator)
        return self
