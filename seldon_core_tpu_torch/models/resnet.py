"""ResNet family in PyTorch — the flagship served model.

The counterpart of ``seldon_core_tpu/models/resnet.py`` (flax), built to
compute what the flax model computes, so one set of weights gives the
same logits in both (``models/convert.py`` maps the flax tree):

* convolutions and the classifier head run in ``dtype`` (bfloat16 by
  default); BatchNorm runs in float32 in eval mode (eps 1e-5), so block
  outputs and the residual add are float32, as flax's dtype promotion
  makes them; logits are float32;
* padding follows flax's ``SAME``, which is asymmetric where torch's
  symmetric ``padding=k//2`` is not: a 3x3 stride-2 conv on an even
  size pads (0, 1), as does the 3x3 stride-2 max-pool (``same_pads``);
  the 7x7 stem keeps its explicit (3, 3);
* the public layout is the JAX package's NHWC: ``forward`` takes
  (B, H, W, C) and views it as NCHW with channels_last strides, so
  cuDNN reads NHWC with no transpose copy.

The JAX model's ``precision`` option (int8 ``w8a8`` convolutions) is not
ported yet: the constructor has no such parameter.
"""

from __future__ import annotations

import math
from functools import partial
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

IMAGENET_INPUT_SHAPE = (224, 224, 3)
BN_EPS = 1e-5


def same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA ``SAME`` padding (low, high) of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvSame(nn.Module):
    """Bias-free 2-D conv with flax ``SAME`` padding (or explicit pads)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 padding: Optional[int] = None, dtype: torch.dtype = torch.bfloat16,
                 device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel, dtype=dtype, device=device),
                                   requires_grad=False)
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.weight.dtype)
        if self.padding is not None:
            return F.conv2d(x, self.weight, stride=self.stride, padding=self.padding)
        (ph0, ph1), (pw0, pw1) = (same_pads(s, self.kernel, self.stride) for s in x.shape[-2:])
        if ph0 == ph1 and pw0 == pw1:
            return F.conv2d(x, self.weight, stride=self.stride, padding=(ph0, pw0))
        return F.conv2d(F.pad(x, (pw0, pw1, ph0, ph1)), self.weight, stride=self.stride)


class BatchNorm(nn.Module):
    """Inference BatchNorm in float32 (flax ``nn.BatchNorm``, eval mode)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        f32 = dict(dtype=torch.float32, device=device)
        self.weight = nn.Parameter(torch.ones(channels, **f32), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels, **f32), requires_grad=False)
        self.register_buffer("running_mean", torch.zeros(channels, **f32))
        self.register_buffer("running_var", torch.ones(channels, **f32))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x.float(), self.running_mean, self.running_var,
                            self.weight, self.bias, False, 0.0, BN_EPS)


def max_pool_same(x: torch.Tensor, kernel: int = 3, stride: int = 2) -> torch.Tensor:
    """``nn.max_pool(x, (k, k), strides=(s, s), padding="SAME")``: pads
    with -inf, asymmetrically where SAME is."""
    (ph0, ph1), (pw0, pw1) = (same_pads(s, kernel, stride) for s in x.shape[-2:])
    x = F.pad(x, (pw0, pw1, ph0, ph1), value=-math.inf)
    return F.max_pool2d(x, kernel, stride)


class BasicBlock(nn.Module):
    """Two 3x3 convs with identity shortcut (ResNet-18/34)."""

    expansion = 1
    n_convs = 2

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype, device=None):
        super().__init__()
        conv = partial(ConvSame, dtype=dtype, device=device)
        self.conv0 = conv(cin, filters, 3, stride)
        self.bn0 = BatchNorm(filters, device)
        self.conv1 = conv(filters, filters, 3)
        self.bn1 = BatchNorm(filters, device)
        self.shortcut_conv = self.shortcut_bn = None
        if stride != 1 or cin != filters:
            self.shortcut_conv = conv(cin, filters, 1, stride)
            self.shortcut_bn = BatchNorm(filters, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = self.bn1(self.conv1(y))
        residual = x if self.shortcut_conv is None else self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(residual + y)


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck (ResNet-50/101/152)."""

    expansion = 4
    n_convs = 3

    def __init__(self, cin: int, filters: int, stride: int, dtype: torch.dtype, device=None):
        super().__init__()
        conv = partial(ConvSame, dtype=dtype, device=device)
        self.conv0 = conv(cin, filters, 1)
        self.bn0 = BatchNorm(filters, device)
        self.conv1 = conv(filters, filters, 3, stride)
        self.bn1 = BatchNorm(filters, device)
        self.conv2 = conv(filters, filters * 4, 1)
        self.bn2 = BatchNorm(filters * 4, device)
        self.shortcut_conv = self.shortcut_bn = None
        if stride != 1 or cin != filters * 4:
            self.shortcut_conv = conv(cin, filters * 4, 1, stride)
            self.shortcut_bn = BatchNorm(filters * 4, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv0(x)))
        y = F.relu(self.bn1(self.conv1(y)))
        y = self.bn2(self.conv2(y))
        residual = x if self.shortcut_conv is None else self.shortcut_bn(self.shortcut_conv(x))
        return F.relu(residual + y)


class ResNet(nn.Module):
    """ResNet v1.5 classifier; ``forward`` takes NHWC images."""

    def __init__(self, stage_sizes: Sequence[int], block_cls, num_classes: int = 1000,
                 num_filters: int = 64, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 3, device=None):
        super().__init__()
        self.stage_sizes = list(stage_sizes)
        self.block_cls = block_cls
        self.dtype = dtype
        self.conv_init = ConvSame(in_channels, num_filters, 7, 2, padding=3, dtype=dtype, device=device)
        self.bn_init = BatchNorm(num_filters, device)
        blocks: List[nn.Module] = []
        cin = num_filters
        for i, size in enumerate(self.stage_sizes):
            for j in range(size):
                stride = 2 if i > 0 and j == 0 else 1
                filters = num_filters * 2**i
                blocks.append(block_cls(cin, filters, stride, dtype, device))
                cin = filters * block_cls.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes, dtype=dtype, device=device)
        self.head.requires_grad_(False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator, zero_init_residual: bool = True) -> "ResNet":
        """Random init in flax's scheme: LeCun-normal conv and dense
        kernels (std sqrt(1/fan_in)), zero dense bias, BatchNorm scale 1
        and bias 0 with identity statistics, and — as flax's
        ``scale_init=zeros`` — a zero scale on each block's last
        BatchNorm unless ``zero_init_residual`` is False."""
        for m in self.modules():
            if isinstance(m, (ConvSame, nn.Linear)):
                w = torch.randn(m.weight.shape, generator=generator, dtype=torch.float32)
                m.weight.copy_(w * math.sqrt(1.0 / (m.weight[0].numel())))
                if isinstance(m, nn.Linear):
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
        if zero_init_residual:
            for b in self.blocks:
                getattr(b, f"bn{b.n_convs - 1}").weight.zero_()
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, num_classes) float32 logits."""
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(self.bn_init(self.conv_init(x)))
        x = max_pool_same(x)
        for block in self.blocks:
            x = block(x)
        x = x.mean(dim=(2, 3))
        return self.head(x.to(self.dtype)).float()


ResNet18 = partial(ResNet, stage_sizes=[2, 2, 2, 2], block_cls=BasicBlock)
ResNet34 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BasicBlock)
ResNet50 = partial(ResNet, stage_sizes=[3, 4, 6, 3], block_cls=BottleneckBlock)
ResNet101 = partial(ResNet, stage_sizes=[3, 4, 23, 3], block_cls=BottleneckBlock)
ResNet152 = partial(ResNet, stage_sizes=[3, 8, 36, 3], block_cls=BottleneckBlock)

# small config for tests: same topology, tiny widths
ResNetTiny = partial(ResNet, stage_sizes=[1, 1, 1, 1], block_cls=BasicBlock, num_filters=8)
