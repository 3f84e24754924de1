"""Hand-written CUDA kernels for serving hot ops, with their plain versions.

* ``fused_normalize`` — uint8 NHWC batch -> normalised activation dtype
  in one pass (cast + per-channel affine fused; the plain PyTorch chain
  runs a convert, a multiply, an add and a cast as four passes over
  device memory before the first convolution).

Every wrapper dispatches on where its input lies and on nothing else: a
CUDA tensor launches the kernel (building it at first use from
``ops/csrc``), a CPU tensor takes the plain version.  A kernel that does
not build or launch raises; it never falls back.  Each wrapper counts
its kernel launches (``launch_counts``), so a run can show that its
main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.ops import _build

_COUNT_LOCK = threading.Lock()
_LAUNCHES: Dict[str, int] = {"fused_normalize": 0}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    with _COUNT_LOCK:
        return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for k in _LAUNCHES:
            _LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _COUNT_LOCK:
        _LAUNCHES[name] += 1


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch was refused or failed."""


# ---------------------------------------------------------------------------
# fused uint8 -> normalised float
# ---------------------------------------------------------------------------

# output dtype -> the kernel's out_kind code (csrc/fused_normalize.cu)
_OUT_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_normalize_args(x, scale, shift, out_dtype) -> None:
    if x.dtype != torch.uint8:
        raise TypeError(f"fused_normalize takes uint8 input, got {x.dtype}")
    if x.dim() < 1:
        raise ValueError("fused_normalize input needs a channel (last) dimension")
    if out_dtype not in _OUT_KINDS:
        raise TypeError(
            f"fused_normalize out_dtype must be one of {sorted(map(str, _OUT_KINDS))}, got {out_dtype}"
        )
    c = x.shape[-1]
    for name, t in (("scale", scale), ("shift", shift)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"fused_normalize {name} must have shape ({c},), got {tuple(t.shape)}")


def fused_normalize_reference(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The plain PyTorch version: ``y = x * scale[c] + shift[c]`` in f32,
    then cast.  The CUDA kernel agrees with it bit for bit."""
    _check_normalize_args(x, scale, shift, out_dtype)
    y = x.to(torch.float32) * scale.to(torch.float32) + shift.to(torch.float32)
    return y.to(out_dtype)


def fused_normalize(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(batch, H, W, C) uint8 -> out_dtype, y = x * scale + shift per channel.

    scale/shift: (C,) tensors; e.g. imagenet normalisation folded into
    a = 1/(255*std), b = -mean/std (``imagenet_affine``).  The result is
    a contiguous (batch, H, W, C) tensor, so ``y.permute(0, 3, 1, 2)`` is
    an NCHW view with channels_last strides and no copy.
    """
    if not x.is_cuda:
        return fused_normalize_reference(x, scale, shift, out_dtype)
    _check_normalize_args(x, scale, shift, out_dtype)
    lib = _normalize_lib()
    x = x.contiguous()
    if x.data_ptr() % 16:  # the kernel reads 16-byte vectors
        x = x.clone()
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    shift = shift.to(device=x.device, dtype=torch.float32).contiguous()
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_normalize_u8(
            x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(),
            x.numel(), x.shape[-1], _OUT_KINDS[out_dtype], _sm_count(x.device.index),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise KernelLaunchError(f"fused_normalize launch failed: cudaError {err}")
    _count("fused_normalize")
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _normalize_lib() -> ctypes.CDLL:
    lib = _build.load("fused_normalize")
    fn = lib.fused_normalize_u8
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return lib


def imagenet_affine(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)) -> Tuple[np.ndarray, np.ndarray]:
    """Fold 'x/255 then standardise' into one per-channel affine."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return 1.0 / (255.0 * std), -mean / std
