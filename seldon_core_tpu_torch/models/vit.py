"""Vision Transformer in PyTorch.

The port's counterpart of ``seldon_core_tpu/models/vit.py``: patch embed
(a stride-``patch_size`` convolution), the CLS token and the position
embedding, then the transformer blocks of ``models/transformer.py``
(non-causal, attention through ``attn_fn``), the final LayerNorm in
float32 and the head on the CLS row.  The parameter tree is the flax
module's (``models/convert.py`` ``vit_params_from_flax``), and the
arithmetic follows it: the image is cast to the compute dtype before the
convolution, ``pos_embed`` is added in the compute dtype, the logits are
float32.  At a resolution other than the native one the grid part of
``pos_embed`` is resized bicubically in float32, with the weights of
``jax.image.resize(method="bicubic")`` (:func:`bicubic_weights`).

``forward`` takes NHWC images, as the JAX package does; the convolution
runs on an NCHW view of them (no copy).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import torch
from torch import nn

from seldon_core_tpu_torch.models.transformer import (AttnFn, Dense, LayerNorm32, TransformerBlock,
                                                       flax_default_init_, plain_attention)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic convolution kernel with a = -0.5 at distances x >= 0."""
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    return torch.where(x >= 2.0, torch.zeros_like(x), torch.where(x >= 1.0, far, near))


def bicubic_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(out_size, in_size) float32 weights of one axis of
    ``jax.image.resize(..., method="bicubic")`` (its ``compute_weight_mat``):
    half-pixel centres, the Keys cubic (a = -0.5), the kernel widened by
    in/out when downsampling (antialiasing), each output's weights
    renormalised to sum to 1 over the taps that fall inside the input, and
    an output whose centre lies outside the input all zero.  Computed in
    float32, as JAX computes it (``torch.nn.functional.interpolate``'s
    bicubic is a = -0.75 and never antialiases)."""
    inv_scale = torch.tensor(in_size / out_size, dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(out_size, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(in_size, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)                                  # (in, out)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)), torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T.contiguous()


def resize_pos_embed(pos: torch.Tensor, grid: int, h: int, w: int) -> torch.Tensor:
    """(1, grid*grid + 1, d) position embedding -> (1, h*w + 1, d) float32:
    the CLS row kept, the grid rows resized bicubically to (h, w) as the
    JAX module resizes them (an axis of unchanged size is left as it is,
    as ``jax.image.resize`` leaves it)."""
    pos = pos.float()
    g = pos[0, 1:].reshape(grid, grid, -1)
    if h != grid:
        g = torch.einsum("oi,iwd->owd", bicubic_weights(grid, h).to(g.device), g)
    if w != grid:
        g = torch.einsum("oi,hid->hod", bicubic_weights(grid, w).to(g.device), g)
    return torch.cat([pos[:, :1], g.reshape(1, h * w, -1)], dim=1)


class VisionTransformer(nn.Module):
    """ViT classifier: patch embed + transformer + CLS head.

    ``pos_grid`` is the native position-embedding grid (14 for 224/16):
    ``pos_embed`` holds ``pos_grid**2 + 1`` rows, and an input whose patch
    grid differs gets the grid rows resized bicubically
    (:func:`resize_pos_embed`, in float32 from the stored parameter), so
    one checkpoint serves any resolution divisible by ``patch_size``.
    ``pos_grid=0`` is the legacy single-resolution mode: ``pos_embed``
    takes its shape from ``image_size``, the served input's (H, W).
    """

    def __init__(self, num_classes: int = 1000, patch_size: int = 16, d_model: int = 384, num_layers: int = 12,
                 num_heads: int = 6, mlp_ratio: int = 4, dtype: torch.dtype = torch.bfloat16,
                 attn_fn: AttnFn = plain_attention, pos_grid: int = 0, in_channels: int = 3,
                 image_size: Optional[Sequence[int]] = None):
        super().__init__()
        self.patch_size = patch_size
        self.pos_grid = pos_grid
        self.dtype = dtype
        if pos_grid:
            n_tokens = pos_grid * pos_grid + 1
        elif image_size is not None:
            n_tokens = (image_size[0] // patch_size) * (image_size[1] // patch_size) + 1
        else:
            raise ValueError("VisionTransformer needs pos_grid or image_size to size pos_embed")
        self.patch_embed = nn.Conv2d(in_channels, d_model, patch_size, stride=patch_size, dtype=dtype)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d_model, dtype=dtype))
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tokens, d_model, dtype=dtype))
        self.blocks = nn.ModuleList(
            TransformerBlock(d_model, num_heads, mlp_ratio, dtype=dtype, attn_fn=attn_fn, causal=False)
            for _ in range(num_layers))
        self.ln_f = LayerNorm32(d_model)
        self.head = Dense(d_model, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, num_classes) float32 logits."""
        H, W = x.shape[1], x.shape[2]
        if H % self.patch_size or W % self.patch_size:
            raise ValueError(f"ViT input {H}x{W} not divisible by patch_size {self.patch_size} — the strided "
                             "conv would silently crop edge pixels")
        h, w = H // self.patch_size, W // self.patch_size
        pos = self.pos_embed
        if self.pos_grid and (h, w) != (self.pos_grid, self.pos_grid):
            pos = resize_pos_embed(pos, self.pos_grid, h, w).to(self.dtype)
        if h * w + 1 != pos.shape[1]:
            raise ValueError(f"ViT input {H}x{W} gives {h * w + 1} tokens; pos_embed holds {pos.shape[1]}")
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))  # (B, d, h, w)
        x = x.flatten(2).transpose(1, 2)                             # (B, h*w, d), row-major patches
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + pos
        for block in self.blocks:
            x = block(x)
        x = self.ln_f(x)
        return self.head(x[:, 0]).float()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> "VisionTransformer":
        """Random init in flax's scheme: the patch conv and the dense
        layers LeCun-normal with zero bias (:func:`flax_default_init_`),
        ``cls_token`` 0, ``pos_embed`` normal with std 0.02."""
        flax_default_init_(self, generator)
        self.cls_token.zero_()
        pos = torch.randn(self.pos_embed.shape, generator=generator, dtype=torch.float32)
        self.pos_embed.copy_(pos * 0.02)
        return self


# the JAX package's configurations (seldon_core_tpu/models/vit.py)
ViTTiny = partial(VisionTransformer, patch_size=8, d_model=64, num_layers=2, num_heads=4, pos_grid=4)  # 32 / 8
ViTBase16 = partial(VisionTransformer, d_model=768, num_layers=12, num_heads=12, pos_grid=14)       # 224 / 16
ViTLarge16 = partial(VisionTransformer, d_model=1024, num_layers=24, num_heads=16, pos_grid=14)     # 224 / 16
