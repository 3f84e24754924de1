"""Vision Transformer in PyTorch.

The port's counterpart of ``seldon_core_tpu/models/vit.py``: patch embed
(a stride-``patch_size`` convolution), the CLS token and the position
embedding, then the transformer blocks of ``models/transformer.py``
(non-causal, attention through ``attn_fn``), the final LayerNorm in
float32 and the head on the CLS row.  The parameter tree is the flax
module's (``models/convert.py`` ``vit_params_from_flax``), and the
arithmetic follows it: the image is cast to the compute dtype before the
convolution, ``pos_embed`` is added in the compute dtype, the logits are
float32.

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
from seldon_core_tpu_torch.runtime.component import MicroserviceError


class VisionTransformer(nn.Module):
    """ViT classifier: patch embed + transformer + CLS head.

    ``pos_grid`` is the native position-embedding grid (14 for 224/16):
    ``pos_embed`` holds ``pos_grid**2 + 1`` rows and serves that grid
    only; the JAX package's bicubic resize to other grids is not ported
    yet, so another resolution raises.  ``pos_grid=0`` is the legacy
    single-resolution mode: ``pos_embed`` takes its shape from
    ``image_size``, the served input's (H, W).
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
        if self.pos_grid and (h, w) != (self.pos_grid, self.pos_grid):
            raise MicroserviceError(
                f"ViT input {H}x{W} is a {h}x{w} patch grid; pos_embed is held at its native "
                f"{self.pos_grid}x{self.pos_grid} grid, and the bicubic pos_embed resize for other "
                "resolutions is not ported yet (ROADMAP.md §A 9)",
                status_code=400,
                reason="BAD_INPUT_SHAPE",
            )
        if h * w + 1 != self.pos_embed.shape[1]:
            raise ValueError(f"ViT input {H}x{W} gives {h * w + 1} tokens; pos_embed holds {self.pos_embed.shape[1]}")
        x = self.patch_embed(x.to(self.dtype).permute(0, 3, 1, 2))  # (B, d, h, w)
        x = x.flatten(2).transpose(1, 2)                             # (B, h*w, d), row-major patches
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1)
        x = x + self.pos_embed
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
