"""cudaserver — the prepackaged inference server of the PyTorch port.

The counterpart of ``seldon_core_tpu/models/jaxserver.py`` (``JaxServer``)
for one NVIDIA GPU:

* the model comes from the port's registry: the ResNets
  (resnet18/34/50/101/152, resnet_tiny), the ViTs (vit_tiny, vit_base16,
  vit_large16), ``transformer_encoder`` and ``transformer_lm``; its
  weights are held in device memory once;
* ``model_kwargs`` go to the model, and for the transformer families
  ``{"attention": "flash"}`` selects the hand-written CUDA flash-attention
  kernel (``"plain"`` or no entry: the einsum attention; anything else is
  ``BAD_ATTENTION``); the token families take no default
  ``input_shape`` (``MISSING_INPUT_SHAPE`` without one);
* parameters come from ``variables=`` (the JAX package's flax tree,
  converted by ``models/convert.py`` for the model's family) or, without
  it, a random init from ``seed`` (flax's scheme; for the ResNets each
  block's last BatchNorm scale is one, not zero, so random weights give
  answers that depend on every residual branch);
* compute runs in ``bfloat16`` by default; ResNet convolutions run in
  cuDNN with channels_last activations and BatchNorm in float32; the
  transformers keep LayerNorm in float32;
* uint8 image batches go through the hand-written CUDA ``fused_normalize``
  kernel when ``normalize=True``; then the model; then the optional
  softmax or top-k;
* requests flow through the dynamic batcher: concurrent requests
  coalesce into padded-bucket device calls, and every bucket is warmed
  at load time so cuDNN has picked its algorithms before traffic.

The server runs on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the tests do); asking for CUDA on a host without it is
an error, never a quiet fall back to the CPU.

Not ported yet (each is a ``BAD_PARAMETER`` error when set): ``model_uri``
checkpoint loading, ``quantize``/``precision`` (int8), ``mesh``, and
``extra_input_shapes`` (multi-signature batching); nor the detection
family (``detector_*``).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.batching.batcher import DynamicBatcher
from seldon_core_tpu_torch.codec.device import to_device
from seldon_core_tpu_torch.ops import kernels
from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent, gauge_metric

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}
_LATER = ("model_uri", "quantize", "precision", "mesh", "extra_input_shapes")


def _compute_dtype(name: str) -> torch.dtype:
    try:
        return _DTYPES[name]
    except KeyError:
        raise MicroserviceError(
            f"unknown dtype {name!r} (supported: bfloat16, float32, float16)",
            status_code=400,
            reason="BAD_DTYPE",
        ) from None


class _Entry(NamedTuple):
    factory: Callable[..., torch.nn.Module]  # (num_classes, dtype, input_shape, **model_kwargs) -> module
    input_shape: Optional[Tuple[int, ...]]   # the default served shape; None: the caller must give one
    family: str                              # "resnet", "vit", "encoder" or "lm": weights and memory format


def _model_registry() -> Dict[str, _Entry]:
    """name -> registry entry (the JAX package's registry, less ``mlp``
    and the detection family)."""
    from seldon_core_tpu_torch.models import resnet, transformer, vit

    def image(cls):
        def make(num_classes, dtype, input_shape, **kw):
            return cls(num_classes=num_classes, dtype=dtype, in_channels=input_shape[-1], **kw)

        return make

    def vision(cls):
        def make(num_classes, dtype, input_shape, **kw):
            return cls(num_classes=num_classes, dtype=dtype, in_channels=input_shape[-1],
                       image_size=tuple(input_shape[:2]), **_resolve_attention(kw))

        return make

    def encoder(num_classes, dtype, input_shape, **kw):
        return transformer.TransformerEncoder(num_classes=num_classes, dtype=dtype, **_resolve_attention(kw))

    def lm(num_classes, dtype, input_shape, **kw):
        return transformer.TransformerLM(dtype=dtype, **_resolve_attention(kw))

    img = resnet.IMAGENET_INPUT_SHAPE
    return {
        "resnet18": _Entry(image(resnet.ResNet18), img, "resnet"),
        "resnet34": _Entry(image(resnet.ResNet34), img, "resnet"),
        "resnet50": _Entry(image(resnet.ResNet50), img, "resnet"),
        "resnet101": _Entry(image(resnet.ResNet101), img, "resnet"),
        "resnet152": _Entry(image(resnet.ResNet152), img, "resnet"),
        "resnet_tiny": _Entry(image(resnet.ResNetTiny), (32, 32, 3), "resnet"),
        "vit_tiny": _Entry(vision(vit.ViTTiny), (32, 32, 3), "vit"),
        "vit_base16": _Entry(vision(vit.ViTBase16), img, "vit"),
        "vit_large16": _Entry(vision(vit.ViTLarge16), img, "vit"),
        # token-id sequences: input_shape is the served context length
        "transformer_encoder": _Entry(encoder, None, "encoder"),
        "transformer_lm": _Entry(lm, None, "lm"),
    }


def _resolve_attention(kw: Dict[str, Any]) -> Dict[str, Any]:
    """Map a JSON-able {"attention": "flash"|"plain"} kwarg to attn_fn."""
    kw = dict(kw)
    choice = kw.pop("attention", None)
    if choice == "flash":
        kw["attn_fn"] = kernels.flash_attn_fn()
    elif choice not in (None, "plain"):
        raise MicroserviceError(
            f"unknown attention {choice!r} (supported: plain, flash)",
            status_code=400,
            reason="BAD_ATTENTION",
        )
    return kw


def _load_flax_variables(module: torch.nn.Module, family: str, variables: Mapping[str, Any]) -> None:
    from seldon_core_tpu_torch.models import convert

    to_state_dict = {
        "resnet": convert.resnet_params_from_flax,
        "vit": convert.vit_params_from_flax,
        "encoder": convert.encoder_params_from_flax,
        "lm": convert.lm_params_from_flax,
    }[family]
    module.load_state_dict(to_state_dict(variables))


def resolve_device(device: str) -> torch.device:
    """The serving device; CUDA must be present when it is asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise MicroserviceError(
                f"device {device!r} requested but CUDA is not available on this host "
                "(pass device='cpu' to serve on the CPU)",
                status_code=500,
                reason="NO_CUDA_DEVICE",
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise MicroserviceError(f"unsupported device {device!r} (cuda or cpu)", status_code=400,
                                reason="BAD_DEVICE")
    return dev


class CudaServer(TPUComponent):
    """Serve a registry model on one GPU (or the CPU, when asked) with dynamic batching."""

    accepts_device_arrays = True

    def __init__(
        self,
        model: str = "resnet50",
        num_classes: int = 1000,
        dtype: str = "bfloat16",
        max_batch_size: int = 64,
        max_wait_ms: float = 1.0,
        buckets: Optional[Sequence[int]] = None,
        input_shape: Optional[Sequence[int]] = None,
        class_names_list: Optional[List[str]] = None,
        softmax_outputs: bool = False,
        top_k: int = 0,
        warmup: bool = True,
        warmup_dtypes: Sequence[str] = ("float32", "uint8"),
        normalize: bool = False,
        normalize_mean: Optional[Sequence[float]] = None,
        normalize_std: Optional[Sequence[float]] = None,
        seed: int = 0,
        model_kwargs: Optional[Dict[str, Any]] = None,
        pipeline_depth: int = 16,
        finisher_threads: int = 12,
        device: str = "cuda",
        variables: Optional[Mapping[str, Any]] = None,
        **kwargs: Any,
    ):
        later = sorted(k for k in _LATER if kwargs.get(k))
        if later:
            raise MicroserviceError(
                f"CudaServer does not support {later} yet (later slices of the PyTorch port)",
                status_code=400,
                reason="BAD_PARAMETER",
            )
        super().__init__(**kwargs)
        self.device = resolve_device(device)
        self.model_name = model
        self.num_classes = int(num_classes)
        self.dtype_name = dtype
        self.compute_dtype = _compute_dtype(dtype)
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.buckets = list(buckets) if buckets else None
        self.input_shape = tuple(input_shape) if input_shape else None
        self._class_names = class_names_list
        self.softmax_outputs = bool(softmax_outputs)
        # top_k > 0: the output is [batch, 2, k] (row 0: class indices,
        # row 1: scores), computed on device before the readback
        self.top_k = int(top_k)
        self.warmup = bool(warmup)
        self.warmup_dtypes = tuple(warmup_dtypes)
        # normalize=True: uint8 image batches go through the CUDA
        # fused_normalize kernel (cast + per-channel affine in one pass)
        self.normalize = bool(normalize)
        self._norm_mean = tuple(normalize_mean) if normalize_mean else None
        self._norm_std = tuple(normalize_std) if normalize_std else None
        self.seed = int(seed)
        self.model_kwargs = dict(model_kwargs or {})
        self.pipeline_depth = int(pipeline_depth)
        self.finisher_threads = int(finisher_threads)
        self.variables = variables
        self._loaded = False
        self.module: Optional[torch.nn.Module] = None
        self.batcher: Optional[DynamicBatcher] = None
        self._load_time_s: Optional[float] = None
        self._norm_scale: Optional[torch.Tensor] = None
        self._norm_shift: Optional[torch.Tensor] = None

    # ----------------------------------------------------------------- load

    def _build_module(self) -> torch.nn.Module:
        registry = _model_registry()
        if self.model_name not in registry:
            raise MicroserviceError(
                f"unknown model {self.model_name!r}; builtin options: {sorted(registry)}",
                status_code=400,
                reason="UNKNOWN_MODEL",
            )
        entry = registry[self.model_name]
        if self.input_shape is None:
            if entry.input_shape is None:
                raise MicroserviceError(
                    f"model {self.model_name!r} needs an explicit input_shape",
                    status_code=400,
                    reason="MISSING_INPUT_SHAPE",
                )
            self.input_shape = tuple(entry.input_shape)
        module = entry.factory(self.num_classes, self.compute_dtype, self.input_shape, **self.model_kwargs)
        if self.variables is not None:
            _load_flax_variables(module, entry.family, self.variables)
        elif entry.family == "resnet":
            module.reset_parameters(torch.Generator().manual_seed(self.seed), zero_init_residual=False)
        else:
            module.reset_parameters(torch.Generator().manual_seed(self.seed))
        module = module.to(self.device).eval()
        if self.device.type == "cuda" and entry.family == "resnet":
            module = module.to(memory_format=torch.channels_last)
        return module

    def _normalize_affine(self) -> Tuple[np.ndarray, np.ndarray]:
        if self._norm_mean is not None or self._norm_std is not None:
            mean = np.asarray(self._norm_mean or (0.0,), np.float32)
            std = np.asarray(self._norm_std or (1.0,), np.float32)
            # mean/std broadcast together to the channel count so that
            # supplying only one of them still yields per-channel scale/shift
            mean, std = np.broadcast_arrays(mean, std)
            scale, shift = 1.0 / (255.0 * std), -mean / std
        else:
            scale, shift = kernels.imagenet_affine()
        c = self.input_shape[-1]
        return (np.broadcast_to(np.asarray(scale, np.float32), (c,)).copy(),
                np.broadcast_to(np.asarray(shift, np.float32), (c,)).copy())

    def apply_fn(self, x: torch.Tensor) -> torch.Tensor:
        """The served program on a device batch: normalize (uint8 only) ->
        model -> softmax / top-k."""
        if self.normalize and x.dtype == torch.uint8:
            x = kernels.fused_normalize(x, self._norm_scale, self._norm_shift, out_dtype=self.compute_dtype)
        y = self.module(x)
        if self.softmax_outputs:
            y = torch.softmax(y, dim=-1)
        if self.top_k:
            values, indices = torch.topk(y, self.top_k, dim=-1)
            y = torch.stack([indices.to(torch.float32), values], dim=-2)
        return y

    def device_call(self, batch: np.ndarray) -> torch.Tensor:
        """Host batch -> device -> served program; returns the device
        tensor (the batcher reads it back asynchronously)."""
        with torch.inference_mode():
            return self.apply_fn(to_device(batch, self.device))

    def load(self) -> None:
        if self._loaded:
            return
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            # warmup then lets cuDNN pick each bucket's fastest algorithms
            torch.backends.cudnn.benchmark = True
        self.module = self._build_module()
        if self.normalize:
            scale, shift = self._normalize_affine()
            self._norm_scale = torch.from_numpy(scale).to(self.device)
            self._norm_shift = torch.from_numpy(shift).to(self.device)
        self.batcher = DynamicBatcher(
            self.device_call,
            max_batch_size=self.max_batch_size,
            max_wait_ms=self.max_wait_ms,
            buckets=self.buckets,
            name=f"cudaserver-{self.model_name}",
            pipeline_depth=self.pipeline_depth,
            finisher_threads=self.finisher_threads,
        )
        self.batcher.start()
        if self.warmup:
            # every (bucket, dtype) pair clients may send, over the
            # batcher's NORMALIZED bucket list (it force-appends
            # max_batch_size), so no request pays an algorithm search
            for b in self.batcher.buckets:
                for dt in self.warmup_dtypes:
                    self.device_call(np.zeros((b, *self.input_shape), np.dtype(dt)))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._load_time_s = time.perf_counter() - t0
        self._loaded = True
        logger.info(
            "cudaserver %s loaded on %s in %.2fs (buckets=%s, dtype=%s)",
            self.model_name, self.device, self._load_time_s, self.batcher.buckets, self.dtype_name,
        )

    def unload(self) -> None:
        if self.batcher is not None:
            self.batcher.stop()
        self._loaded = False

    # -------------------------------------------------------------- serving

    def accepted_shapes(self) -> List[Tuple[int, ...]]:
        """Input signatures (without batch dim) this server accepts."""
        return [tuple(self.input_shape)]

    def _prepare(self, X) -> Tuple[np.ndarray, bool]:
        """Canonicalise dtype and shape (as JaxServer._prepare).

        A dtype outside ``warmup_dtypes`` is cast to the first of them, so
        a JSON ``ndarray`` (float64) reaches the model as float32 and is
        NOT normalized: normalization applies to uint8 payloads only.
        An array whose trailing dims match the signature is a batch; one
        that matches it whole is a single example; flat rows
        [batch, prod(sig)] are reshaped to the signature."""
        if not self._loaded:
            self.load()
        arr = np.asarray(X)
        if arr.dtype.name not in self.warmup_dtypes:
            arr = arr.astype(np.dtype(self.warmup_dtypes[0]))
        accepted = self.accepted_shapes()
        squeeze = False
        if tuple(arr.shape[1:]) not in accepted and tuple(arr.shape) in accepted:
            arr = arr[None]  # single example without batch dim
            squeeze = True
        if tuple(arr.shape[1:]) not in accepted and arr.ndim == 2:
            for sig in accepted:
                if arr.shape[1] == int(np.prod(sig)):
                    arr = arr.reshape((arr.shape[0], *sig))
                    break
        if tuple(arr.shape[1:]) not in accepted:
            shapes = " | ".join("(batch, " + ", ".join(map(str, s)) + ")" for s in accepted)
            raise MicroserviceError(
                f"input shape {tuple(arr.shape)} does not match model input {shapes}",
                status_code=400,
                reason="BAD_INPUT_SHAPE",
            )
        return arr, squeeze

    def predict(self, X, names, meta=None):
        arr, squeeze = self._prepare(X)
        out = self.batcher.submit(arr)
        return out[0] if squeeze else out

    async def predict_async(self, X, names, meta=None):
        """Awaits the batch future without pinning a dispatch thread."""
        arr, squeeze = self._prepare(X)
        out = await asyncio.wrap_future(self.batcher.submit_future(arr))
        return out[0] if squeeze else out

    def class_names(self):
        if self.top_k:  # rows are (indices, scores), not per-class columns
            return []
        if self._class_names:
            return self._class_names
        return [f"t:{i}" for i in range(self.num_classes)]

    def metrics(self):
        if self.batcher is None:
            return []
        out = [
            gauge_metric("cudaserver_mean_batch_rows", self.batcher.stats.mean_batch_rows),
            gauge_metric("cudaserver_batches_total", float(self.batcher.stats.batches)),
        ]
        for name, n in kernels.launch_counts().items():
            out.append(gauge_metric("cudaserver_kernel_launches", float(n), tags={"kernel": name}))
        return out

    def health_status(self):
        return {
            "model": self.model_name,
            "loaded": self._loaded,
            "device": str(self.device),
            "device_name": torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu",
            "dtype": self.dtype_name,
            "normalize": self.normalize,
            "load_time_s": self._load_time_s,
            "buckets": list(self.batcher.buckets) if self.batcher else [],
            "signatures": [list(s) for s in self.accepted_shapes()] if self._loaded else [],
            "kernel_launches": kernels.launch_counts(),
        }

