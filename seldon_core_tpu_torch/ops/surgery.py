"""Checkpoint surgery: weight-only int8 quantisation of a loaded model.

The counterpart of ``seldon_core_tpu/ops/surgery.py``, acting on a torch
module and its ``state_dict`` instead of a flax variables tree: every
large kernel (the ``weight`` of an ``nn.Linear``, ``nn.Conv2d`` or the
ResNet's ``ConvSame``) becomes a :class:`QuantizedKernel`, int8 with one
float32 scale per output channel, and the serving program
re-materialises compute-dtype weights from it on every forward
(:func:`materialize`), so the kernels rest int8 in device memory.

Layouts: torch keeps the output channel in dim 0 (``(out, in)``, OIHW),
flax in its last axis; both reduce over everything else, so the int8
values and scales here equal the JAX package's once the kernel is
transposed.  The manifest rows name the flax path and shape
(``models/convert.flax_kernel_path``), so the two manifests compare row
for row; ``key`` is the port's ``state_dict`` key.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from seldon_core_tpu_torch.ops.kernels import quantize_weights

__all__ = [
    "QuantizedKernel",
    "quantize_kernel",
    "quantize_params",
    "dequantize_params",
    "materialize",
    "validate_quantize_mode",
    "validate_precision",
    "quantize_mode_for",
    "PRECISIONS",
    "tree_hbm_bytes",
]


class QuantizedKernel:
    """int8 kernel + float32 per-output-channel scale.

    ``q`` keeps the torch kernel's shape (N, ...); ``scale`` is (N,).
    Dequant: ``q.float() * scale`` broadcast over the trailing dims.
    """

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        scale = self.scale.reshape(-1, *([1] * (self.q.dim() - 1)))
        return (self.q.float() * scale).to(dtype)

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"QuantizedKernel(shape={tuple(self.q.shape)})"


def quantize_kernel(w: torch.Tensor) -> QuantizedKernel:
    """Symmetric per-output-channel int8 quantisation of a torch kernel
    (N, ...): the numerics of ``ops.kernels.quantize_weights`` on the
    (everything else, N) matrix, computed on the host in numpy float32;
    the result lies on ``w``'s device and keeps its memory format."""
    arr = w.detach().float().cpu().numpy()
    n = arr.shape[0]
    q2d, scale = quantize_weights(arr.reshape(n, -1).T)
    q = torch.from_numpy(np.ascontiguousarray(q2d.T).reshape(arr.shape)).to(w.device)
    if w.dim() == 4 and w.is_contiguous(memory_format=torch.channels_last) and not w.is_contiguous():
        q = q.contiguous(memory_format=torch.channels_last)
    return QuantizedKernel(q, torch.from_numpy(scale).to(w.device))


def _kernel_modules():
    from seldon_core_tpu_torch.models.resnet import ConvSame

    return (nn.Linear, nn.Conv2d, ConvSame)


def kernel_keys(module: nn.Module) -> List[str]:
    """``state_dict`` keys of the module's kernels: the ``weight`` of each
    dense or conv layer (flax's ``kernel`` leaves; not embeddings,
    ``pos_embed`` or ``cls_token``, which flax names otherwise)."""
    kinds = _kernel_modules()
    return [f"{name}.weight" if name else "weight" for name, m in module.named_modules() if isinstance(m, kinds)]


def quantize_params(
    module: nn.Module,
    min_elems: int = 4096,
    predicate: Optional[Callable[[str, torch.Tensor], bool]] = None,
    state: Optional[Mapping[str, torch.Tensor]] = None,
) -> Tuple[Dict[str, Any], List[Dict[str, Any]]]:
    """The module's ``state_dict`` with eligible kernels swapped for
    :class:`QuantizedKernel` entries.

    Eligible (default, the JAX package's rule): kernels with >= 2 dims,
    at least ``min_elems`` elements and a floating dtype — on a ResNet
    that includes the 7x7 stem, as in the JAX package.  BatchNorm and
    LayerNorm parameters, biases and embeddings are never touched.
    ``predicate(key, tensor)`` replaces the rule.

    ``state`` (default the module's ``state_dict``) is the tensors to
    quantise, keyed as the module's: the paged engine passes its float32
    checkpoint, as the JAX package quantises float32 parameters.

    Returns ``(quantized_state, manifest)``; each manifest row has the
    flax ``path`` and ``shape``, ``bytes_fp`` (the tensor as stored) and
    ``bytes_q``, and the port's ``key``.
    """
    from seldon_core_tpu_torch.models.convert import flax_kernel_path

    state: Dict[str, Any] = dict(module.state_dict() if state is None else state)
    kernels = set(kernel_keys(module))
    manifest: List[Dict[str, Any]] = []
    for key, t in state.items():
        if predicate is not None:
            keep = predicate(key, t)
        else:
            keep = key in kernels and t.dim() >= 2 and t.numel() >= min_elems and t.is_floating_point()
        if not keep:
            continue
        qk = quantize_kernel(t)
        state[key] = qk
        flax_shape = tuple(t.permute(*range(2, t.dim()), 1, 0).shape)
        manifest.append({
            "path": flax_kernel_path(module, key),
            "shape": flax_shape,
            "bytes_fp": t.element_size() * t.numel(),
            "bytes_q": qk.q.element_size() * qk.q.numel() + qk.scale.element_size() * qk.scale.numel(),
            "key": key,
        })
    return state, manifest


def dequantize_params(state: Mapping[str, Any], dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Compute-dtype kernels from :class:`QuantizedKernel` entries:
    ``(q.float() * scale).to(dtype)``, broadcast over the trailing dims;
    every other entry passes through."""
    return {k: v.dequantize(dtype) if isinstance(v, QuantizedKernel) else v for k, v in state.items()}


def validate_quantize_mode(quantize: str) -> str:
    """The one place the supported modes live; every lane calls this."""
    if quantize not in ("", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r} (supported: 'int8')")
    return quantize


PRECISIONS = ("", "bf16", "int8w", "w8a8")


def validate_precision(precision: str) -> str:
    """The serving precision lanes, one vocabulary for every server:

    * ``bf16`` (or ``""``) — the default: weights and compute in the
      compute dtype;
    * ``int8w`` — weight-only int8: kernels rest int8 (this module's
      surgery) and are dequantised to the compute dtype per forward;
    * ``w8a8`` — weight and activation int8: the at-rest surgery plus
      int8 x int8 compute with int32 accumulation (``ops/w8a8.py``).
    """
    if precision not in PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r} (supported: "
            + ", ".join(repr(p) for p in PRECISIONS if p) + ")"
        )
    return precision


def quantize_mode_for(precision: str) -> str:
    """At-rest storage mode a precision lane implies (int8w and w8a8 both
    rest int8: w8a8's in-compute requantisation of an f32 dequant gives
    the surgery's integers back exactly)."""
    return "int8" if precision in ("int8w", "w8a8") else ""


def materialize(state: Mapping[str, Any], quantize: str, dtype: torch.dtype = torch.bfloat16) -> Mapping[str, Any]:
    """Weights for one forward of a (possibly) quantised state: dequant
    if int8, else pass through."""
    if quantize == "int8":
        return dequantize_params(state, dtype)
    return state


def tree_hbm_bytes(state: Mapping[str, Any]) -> int:
    """Total parameter bytes as resident (int8 counted at 1 byte)."""
    total = 0
    for v in state.values():
        parts = (v.q, v.scale) if isinstance(v, QuantizedKernel) else (v,)
        total += sum(t.element_size() * t.numel() for t in parts)
    return total
