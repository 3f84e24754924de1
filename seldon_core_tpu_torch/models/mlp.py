"""Small MLP classifier: the port's counterpart of
``seldon_core_tpu/models/mlp.py`` (``JaxServer``'s and ``CudaServer``'s
default model, for tabular inputs).

The layers carry flax's names, ``dense_{i}`` and ``head``, so a flax
tree converts leaf for leaf (``models/convert.py``
``mlp_params_from_flax``); every layer computes in ``dtype`` (float32 by
default) and the logits are float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from seldon_core_tpu_torch.models.transformer import Dense, flax_default_init_


class MLPClassifier(nn.Module):
    """``Dense -> relu`` per hidden width, then the ``head``; the input's
    last dim is ``in_features`` (flax infers it, torch is told)."""

    def __init__(self, hidden_sizes: Sequence[int] = (64, 64), num_classes: int = 3,
                 dtype: torch.dtype = torch.float32, in_features: int = 4):
        super().__init__()
        self.dtype = dtype
        self.hidden = len(hidden_sizes)
        width = in_features
        for i, out in enumerate(hidden_sizes):
            self.add_module(f"dense_{i}", Dense(width, out, dtype=dtype))
            width = out
        self.head = Dense(width, num_classes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for i in range(self.hidden):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x).float()

    def reset_parameters(self, generator: torch.Generator) -> "MLPClassifier":
        """Random init in flax's default scheme (``flax_default_init_``)."""
        flax_default_init_(self, generator)
        return self
