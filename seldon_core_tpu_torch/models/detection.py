"""Object detection family: anchor-free CenterNet-style heads.

The port's counterpart of ``seldon_core_tpu/models/detection.py``:

* backbone: the port's :class:`~seldon_core_tpu_torch.models.resnet.ResNet`
  with ``capture_features=True``, the classifier's own parameters (its
  head included), so a converted ImageNet checkpoint seeds the detector
  backbone unchanged;
* neck: one 3x3 conv, then bilinear upsampling x2 (``F.interpolate`` with
  half-pixel centres, no antialiasing: the JAX package's
  ``jax.image.resize(..., "bilinear")``, whose weights are renormalised
  inside the image at the borders, which is what clamping the source
  coordinate does), then a 3x3 refine conv;
* heads: a per-cell class heatmap, a box size (w, h) and a centre offset,
  each a 1x1 conv, returned as float32 NHWC maps;
* decode (:func:`decode_detections`): peak-NMS as equality with a 3x3
  max-pool, then the ``top_k`` largest cells of the flattened heatmap.

Every conv computes in ``dtype`` with a bias, flax ``nn.Conv``'s default
``SAME`` padding at stride 1.  Answers are ``(batch, k, 6)`` rows
``[x1, y1, x2, y2, score, class]`` in input pixels, ``k`` fixed (rows
under ``score_threshold`` are zeroed, never dropped).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.models import resnet as resnet_mod
from seldon_core_tpu_torch.models.transformer import flax_default_init_

BACKBONES = {
    "resnet18": resnet_mod.ResNet18,
    "resnet34": resnet_mod.ResNet34,
    "resnet50": resnet_mod.ResNet50,
    "resnet_tiny": resnet_mod.ResNetTiny,
}


class Conv(nn.Conv2d):
    """flax ``nn.Conv(dtype=...)`` at stride 1 with ``SAME`` padding (odd
    kernels): input, kernel and bias in the weight's dtype."""

    def __init__(self, cin: int, cout: int, kernel: int, dtype: torch.dtype):
        super().__init__(cin, cout, kernel, padding=kernel // 2, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x.to(self.weight.dtype), self.weight, self.bias, padding=self.padding)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Bilinear x2 of an NCHW map: ``jax.image.resize`` to twice the size
    with ``method="bilinear"``."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False, antialias=False)


class DetectionHead(nn.Module):
    """Neck + CenterNet heads over a backbone feature map."""

    def __init__(self, in_channels: int, num_classes: int = 80, head_dim: int = 64,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.neck_conv = Conv(in_channels, head_dim, 3, dtype)
        self.refine_conv = Conv(head_dim, head_dim, 3, dtype)
        self.heatmap = Conv(head_dim, num_classes, 1, dtype)
        self.size = Conv(head_dim, 2, 1, dtype)
        self.offset = Conv(head_dim, 2, 1, dtype)

    def forward(self, features: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, H, W, C) stride-32 map -> float32 (heat, size, offset)
        NHWC maps at stride 16."""
        x = F.relu(self.neck_conv(features.permute(0, 3, 1, 2)))
        x = F.relu(self.refine_conv(upsample2x(x)))
        return tuple(head(x).permute(0, 2, 3, 1).float() for head in (self.heatmap, self.size, self.offset))


class Detector(nn.Module):
    """ResNet backbone + CenterNet head; returns the raw head maps."""

    def __init__(self, num_classes: int = 80, backbone: str = "resnet18", num_filters: int = 64,
                 head_dim: int = 64, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        # the classifier head's width stays 1000 so ImageNet checkpoints drop in
        self.backbone = BACKBONES[backbone](num_classes=1000, num_filters=num_filters, dtype=dtype)
        self.det_head = DetectionHead(self.backbone.head.in_features, num_classes, head_dim, dtype)

    def forward(self, x: torch.Tensor):
        _, features = self.backbone(x, capture_features=True)
        return self.det_head(features)

    def reset_parameters(self, generator: torch.Generator) -> "Detector":
        """Random init: the backbone's scheme (no zero residual scale, as
        ``CudaServer`` inits the ResNets), flax's for the head."""
        self.backbone.reset_parameters(generator, zero_init_residual=False)
        flax_default_init_(self.det_head, generator)
        return self


def decode_detections(heat: torch.Tensor, size: torch.Tensor, offset: torch.Tensor, *, top_k: int = 100,
                      stride: int = 16, score_threshold: float = 0.0) -> torch.Tensor:
    """CenterNet decode: NHWC head maps -> (B, k, 6) [x1, y1, x2, y2,
    score, cls].  Peak-NMS keeps a cell whose probability equals the max
    of its 3x3 neighbourhood; selection is the ``top_k`` largest of the
    flattened (H, W, C) map, equal values in index order."""
    b, h, w, c = heat.shape
    prob = torch.sigmoid(heat)
    pooled = F.max_pool2d(prob.permute(0, 3, 1, 2), 3, stride=1, padding=1).permute(0, 2, 3, 1)
    prob = torch.where(prob == pooled, prob, 0.0)  # local peaks only
    # lax.top_k breaks ties toward the lower index, and every cell that is
    # not a peak is an equal zero, chosen whenever top_k exceeds the peaks.
    # torch.topk promises no order among equal values; a stable
    # descending sort keeps them in index order.
    scores, idx = torch.sort(prob.reshape(b, h * w * c), dim=1, descending=True, stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]
    cls = idx % c
    cell = idx // c
    cy, cx = cell // w, cell % w

    def gather_map(m):  # (B, H, W, 2) -> (B, k, 2) at the peak cells
        return torch.gather(m.reshape(b, h * w, 2), 1, cell[..., None].expand(-1, -1, 2))

    off = gather_map(offset)
    sz = gather_map(size).abs()  # sizes are magnitudes
    center_x = (cx.float() + off[..., 0]) * stride
    center_y = (cy.float() + off[..., 1]) * stride
    half_w = sz[..., 0] * stride / 2.0
    half_h = sz[..., 1] * stride / 2.0
    keep = (scores >= score_threshold).float()
    boxes = torch.stack([center_x - half_w, center_y - half_h, center_x + half_w, center_y + half_h,
                         scores, cls.float()], dim=-1)
    return boxes * keep[..., None]


class ServedDetector(nn.Module):
    """The served module: a :class:`Detector` (``detector``, flax's name)
    whose forward returns decoded boxes."""

    def __init__(self, detector: Detector, top_k: int, stride: int, score_threshold: float):
        super().__init__()
        self.detector = detector
        self.top_k, self.stride, self.score_threshold = top_k, stride, score_threshold

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return decode_detections(*self.detector(x), top_k=self.top_k, stride=self.stride,
                                 score_threshold=self.score_threshold)

    def reset_parameters(self, generator: torch.Generator) -> "ServedDetector":
        self.detector.reset_parameters(generator)
        return self


def make_detector(num_classes: int, dtype: torch.dtype, *, backbone: str = "resnet_tiny", num_filters: int = 0,
                  head_dim: int = 64, top_k: int = 50, stride: int = 16, score_threshold: float = 0.0,
                  input_size: int = 64) -> Tuple[ServedDetector, Tuple[int, int, int]]:
    """``CudaServer`` registry factory: ``(module returning boxes, its
    (input_size, input_size, 3) input shape)``.  ``num_filters`` 0 is 8
    for ``resnet_tiny`` and 64 otherwise."""
    if not num_filters:
        num_filters = 8 if backbone == "resnet_tiny" else 64
    detector = Detector(num_classes=num_classes, backbone=backbone, num_filters=num_filters, head_dim=head_dim,
                        dtype=dtype)
    return ServedDetector(detector, top_k, stride, score_threshold), (input_size, input_size, 3)
