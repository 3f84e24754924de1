"""cudaserver — the prepackaged inference server of the PyTorch port.

The counterpart of ``seldon_core_tpu/models/jaxserver.py`` (``JaxServer``)
for one NVIDIA GPU:

* the model comes from the port's registry (``mlp`` by default, as in
  ``JaxServer``): ``mlp``, the ResNets (resnet18/34/50/101/152,
  resnet_tiny), the ViTs (vit_tiny, vit_base16, vit_large16),
  ``transformer_encoder``, ``transformer_lm`` and the detectors
  (``detector_tiny``, ``detector_resnet18``, ``detector_resnet50``: a
  (batch, top_k, 6) box answer; ``model_kwargs`` ``backbone``, ``top_k``,
  ``score_threshold``, ``input_size``, ``head_dim``, ``num_filters``); its
  weights are held in device memory once;
* ``model_kwargs`` go to the model, and for the transformer families
  ``{"attention": "flash"}`` selects the hand-written CUDA flash-attention
  kernel (``"plain"`` or no entry: the einsum attention; anything else is
  ``BAD_ATTENTION``); the token families take no default
  ``input_shape`` (``MISSING_INPUT_SHAPE`` without one);
* parameters come from ``model_uri`` (a checkpoint: fetched by
  ``utils/storage.py``; an orbax directory, one holding
  ``_CHECKPOINT_METADATA``, is read by ``utils/orbax.py``; another
  directory serves its first ``.msgpack`` or ``.bin`` file by name; a
  file is flax msgpack, read by ``utils/serialization.py``), from
  ``variables=`` (the JAX package's flax tree in memory), or, with
  neither, a random init from ``seed`` (flax's scheme; for the ResNets
  each block's last BatchNorm scale is one, not zero, so random weights
  give answers that depend on every residual branch).  A flax tree is
  converted by ``models/convert.py`` for the model's family; a w8a8
  server calibrates its activation scales at load and never reads them
  from a checkpoint;
* compute runs in ``bfloat16`` by default; ResNet convolutions run in
  cuDNN with channels_last activations and BatchNorm in float32; the
  transformers keep LayerNorm in float32;
* uint8 image batches go through the hand-written CUDA ``fused_normalize``
  kernel when ``normalize=True``; then the model; then the optional
  softmax or top-k;
* ``precision`` picks the serving precision lane, as in ``JaxServer``:
  ``bf16`` (or empty; the default: everything in ``dtype``), ``int8w``
  (weight-only int8) or ``w8a8`` (int8 weights and activations in the
  ResNets' block convs, ``ops/w8a8.py``; activation scales calibrated at
  load over ``calibration_batches`` seeded batches).  Both int8 lanes,
  and ``quantize="int8"`` alone, rest every large kernel int8 on the
  device (``ops/surgery.py``) and dequantise per forward: to ``dtype``
  (``int8w``), to float32 (``w8a8``, whose layers requantise exactly);
  no dequantised copy is kept.  ``w8a8`` on a family without a
  ``precision`` option is ``BAD_PRECISION``;
* requests flow through the dynamic batcher: concurrent requests
  coalesce into padded-bucket device calls, and every bucket is warmed
  at load time so cuDNN has picked its algorithms before traffic;
* ``extra_input_shapes`` adds input signatures beside ``input_shape``
  (a ViT with ``pos_grid`` serves one checkpoint at several
  resolutions): each (dtype, shape) signature then batches in its own
  group of a ``MultiSignatureBatcher``, and warmup covers every shape,
  bucket and dtype;
* the native ingress (``engine/native_ingress.py``) calls
  ``raw_batch_call`` once per batch it coalesced in C++, and the
  zero-copy frame lane calls ``raw_batch_views``; both keep a uint8
  batch uint8 and ride the same batcher.

The server runs on ``device="cuda"`` unless the caller passes
``device="cpu"`` (the tests do); asking for CUDA on a host without it is
an error, never a quiet fall back to the CPU.

``mesh`` (a ``parallel.mesh.Mesh``, or its axes as a dict: over the
host's CUDA devices, or over CPU positions for ``device="cpu"``) serves
a batch-sharded replica group, as ``JaxServer`` does: the weights are
replicated once per distinct device of the mesh, each batch is split
over the ``data`` axis (``data_axis``), every position runs the whole
served program (K1 included) on its rows, and the positions' answers
are joined in order.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.batching.batcher import DynamicBatcher, MultiSignatureBatcher
from seldon_core_tpu_torch.codec.device import to_device
from seldon_core_tpu_torch.ops import kernels, surgery
from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent, gauge_metric

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


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
    # the default served shape, or a function of model_kwargs giving it;
    # None: the caller must give one
    input_shape: Any
    family: str  # "resnet", "vit", "encoder", "lm", "mlp" or "detector": weights and memory format


def _model_registry() -> Dict[str, _Entry]:
    """name -> registry entry (the JAX package's registry)."""
    from seldon_core_tpu_torch.models import detection, mlp, resnet, transformer, vit

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

    def tabular(num_classes, dtype, input_shape, **kw):
        return mlp.MLPClassifier(num_classes=num_classes, dtype=dtype, in_features=input_shape[-1], **kw)

    def detector(backbone: str, default_size: int) -> _Entry:
        def make(num_classes, dtype, input_shape, **kw):
            kw.setdefault("backbone", backbone)
            kw.setdefault("input_size", default_size)
            return detection.make_detector(num_classes, dtype, **kw)[0]

        def shape(kw):
            size = kw.get("input_size", default_size)
            return (size, size, 3)

        return _Entry(make, shape, "detector")

    img = resnet.IMAGENET_INPUT_SHAPE
    return {
        "mlp": _Entry(tabular, (4,), "mlp"),
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
        # boxes (batch, top_k, 6): [x1, y1, x2, y2, score, class]
        "detector_tiny": detector("resnet_tiny", 64),
        "detector_resnet18": detector("resnet18", 512),
        "detector_resnet50": detector("resnet50", 512),
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
        "mlp": convert.mlp_params_from_flax,
        "detector": convert.detector_params_from_flax,
    }[family]
    module.load_state_dict(to_state_dict(variables))
    if family == "resnet":
        convert.load_act_scales(module, variables)


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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's autotuner off and its deterministic algorithms on for the
    block, then the settings as they were.  The w8a8 calibration runs in
    it: with the autotuner on, each process may time other convolution
    algorithms, and an abs-max over activations that differ in the last
    bit calibrates another scale."""
    cudnn = torch.backends.cudnn
    before = cudnn.benchmark, cudnn.deterministic
    cudnn.benchmark, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.deterministic = before


class CudaServer(TPUComponent):
    """Serve a registry model on one GPU (or the CPU, when asked) with dynamic batching."""

    accepts_device_arrays = True

    def __init__(
        self,
        model: str = "mlp",
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
        quantize: str = "",
        precision: str = "",
        calibration_batches: int = 4,
        normalize: bool = False,
        normalize_mean: Optional[Sequence[float]] = None,
        normalize_std: Optional[Sequence[float]] = None,
        seed: int = 0,
        model_kwargs: Optional[Dict[str, Any]] = None,
        pipeline_depth: int = 16,
        finisher_threads: int = 12,
        device: str = "cuda",
        variables: Optional[Mapping[str, Any]] = None,
        model_uri: str = "",
        extra_input_shapes: Optional[Sequence[Sequence[int]]] = None,
        mesh: Any = None,
        data_axis: str = "data",
        **kwargs: Any,
    ):
        if model_uri and variables is not None:
            raise MicroserviceError("give model_uri or variables, not both", status_code=400,
                                    reason="BAD_PARAMETER")
        super().__init__(**kwargs)
        try:
            surgery.validate_quantize_mode(quantize)
            surgery.validate_precision(precision)
        except ValueError as e:
            raise MicroserviceError(str(e), status_code=400, reason="BAD_QUANTIZE") from None
        self.precision = precision
        self.quantize = quantize or surgery.quantize_mode_for(precision)
        self.calibration_batches = int(calibration_batches)
        self.act_scales_calibrated = 0
        self.act_scales: Dict[str, float] = {}  # w8a8: each layer's calibrated scale, for /health/status
        self.quantize_manifest: List[Dict[str, Any]] = []
        self.param_bytes = 0
        # the int8 kernels (key -> QuantizedKernel), dequantised per forward
        self._qparams: Dict[str, surgery.QuantizedKernel] = {}
        self._apply_lock = threading.Lock()  # functional_call swaps the module's weights
        self.device = resolve_device(device)
        if isinstance(mesh, str):
            import json

            mesh = json.loads(mesh) if mesh else None
        if isinstance(mesh, Mapping):
            from seldon_core_tpu_torch.models.paged import component_mesh

            mesh = component_mesh(dict(mesh), self.device)
        self.mesh = mesh or None
        self.data_axis = data_axis
        if self.mesh is not None:
            # the first position's device holds the batcher's staging
            self.device = self.mesh.devices.flat[0]
        self._replicas: Dict[Any, torch.nn.Module] = {}
        self.model_name = model
        self.num_classes = int(num_classes)
        self.dtype_name = dtype
        self.compute_dtype = _compute_dtype(dtype)
        self.max_batch_size = int(max_batch_size)
        self.max_wait_ms = float(max_wait_ms)
        self.buckets = list(buckets) if buckets else None
        self.input_shape = tuple(input_shape) if input_shape else None
        # extra accepted input signatures (without batch dim), e.g. a ViT
        # with pos_grid served at several resolutions from one checkpoint
        self.extra_input_shapes = [tuple(s) for s in (extra_input_shapes or [])]
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
        self.model_uri = model_uri
        # model_uri: seconds to fetch, decode, convert into the module and pin on the device
        self.checkpoint_times: Dict[str, float] = {}
        self._loaded = False
        self.module: Optional[torch.nn.Module] = None
        self.batcher: Optional[DynamicBatcher | MultiSignatureBatcher] = None
        self._load_time_s: Optional[float] = None
        # the process's launch counts when load finished, warmup included:
        # the launches of served traffic are the counts less these, while
        # nothing resets them (a replica process, /health/status)
        self.launches_at_ready: Dict[str, int] = {}
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
        model_kwargs = dict(self.model_kwargs)
        if self.precision == "w8a8":
            mk_precision = model_kwargs.get("precision")
            if mk_precision not in (None, "w8a8"):
                raise MicroserviceError(
                    f"precision={self.precision!r} conflicts with model_kwargs precision={mk_precision!r}",
                    status_code=400,
                    reason="BAD_PRECISION",
                )
            model_kwargs["precision"] = "w8a8"
        if self.input_shape is None:
            default_shape = entry.input_shape(model_kwargs) if callable(entry.input_shape) else entry.input_shape
            if default_shape is None:
                raise MicroserviceError(
                    f"model {self.model_name!r} needs an explicit input_shape",
                    status_code=400,
                    reason="MISSING_INPUT_SHAPE",
                )
            self.input_shape = tuple(default_shape)
        try:
            module = entry.factory(self.num_classes, self.compute_dtype, self.input_shape, **model_kwargs)
        except TypeError as e:
            if self.precision == "w8a8" and "precision" in str(e):
                raise MicroserviceError(
                    f"model {self.model_name!r} does not take a precision kwarg (w8a8 is supported by the "
                    f"resnet family): {e}",
                    status_code=400,
                    reason="BAD_PRECISION",
                ) from None
            raise
        variables = self._checkpoint_variables() if self.model_uri else self.variables
        t0 = time.perf_counter()
        if variables is not None:
            _load_flax_variables(module, entry.family, variables)
        elif entry.family == "resnet":
            module.reset_parameters(torch.Generator().manual_seed(self.seed), zero_init_residual=False)
        else:
            module.reset_parameters(torch.Generator().manual_seed(self.seed))
        t1 = time.perf_counter()
        module = module.to(self.device).eval()
        if self.device.type == "cuda" and entry.family in ("resnet", "detector"):
            module = module.to(memory_format=torch.channels_last)
        if self.model_uri:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.checkpoint_times.update(convert_s=t1 - t0, pin_s=time.perf_counter() - t1)
        return module

    def _checkpoint_variables(self) -> Dict[str, Any]:
        """The flax variables tree at ``model_uri`` (JaxServer's loading
        branch): an orbax directory, a directory's first ``.msgpack`` /
        ``.bin`` file by name, or a msgpack file."""
        from seldon_core_tpu_torch.utils import orbax, serialization, storage

        t0 = time.perf_counter()
        path = storage.download(self.model_uri)
        t1 = time.perf_counter()
        try:
            if orbax.is_checkpoint(path):
                variables = orbax.restore(os.path.abspath(path))
            else:
                if os.path.isdir(path):
                    candidates = [f for f in os.listdir(path) if f.endswith((".msgpack", ".bin"))]
                    if not candidates:
                        raise MicroserviceError(f"no .msgpack checkpoint under {path}", status_code=500,
                                                reason="BAD_CHECKPOINT")
                    path = os.path.join(path, sorted(candidates)[0])
                with open(path, "rb") as f:
                    variables = serialization.msgpack_restore(f.read())
        except (orbax.CheckpointError, ValueError) as e:
            raise MicroserviceError(f"model_uri {self.model_uri!r}: {e}", status_code=500,
                                    reason="BAD_CHECKPOINT") from None
        if not isinstance(variables, dict):
            raise MicroserviceError(f"model_uri {self.model_uri!r} holds a {type(variables).__name__}, not a "
                                    "variables tree", status_code=500, reason="BAD_CHECKPOINT")
        # checkpoints come from precision-less modules: w8a8's activation
        # scales are calibrated at load, never looked up in the bytes
        variables = {k: v for k, v in serialization.to_numpy_tree(variables).items() if k != "act_scales"}
        self.checkpoint_times.update(download_s=t1 - t0, decode_s=time.perf_counter() - t1)
        return variables

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

    def _data_positions(self) -> List[Any]:
        """The devices of the mesh's data positions, in axis order (index 0
        of every other axis)."""
        mesh = self.mesh
        if self.data_axis not in mesh.axis_names:
            return [mesh.devices.flat[0]]
        a = mesh.axis_names.index(self.data_axis)
        out = []
        for i in range(mesh.devices.shape[a]):
            pos = [0] * len(mesh.axis_names)
            pos[a] = i
            out.append(mesh.devices[tuple(pos)])
        return out

    def _replicate(self) -> None:
        """One copy of the weights per distinct device of the mesh."""
        import copy

        self._replicas = {self.device: self.module}
        for dev in self.mesh.distinct_devices():
            if dev not in self._replicas:
                self._replicas[dev] = copy.deepcopy(self.module).to(dev)

    def apply_fn(self, x: torch.Tensor) -> torch.Tensor:
        """The served program on a device batch: normalize (uint8 only) ->
        model -> softmax / top-k.  Under a mesh, each data position runs it
        on its rows with its device's weights; rows are joined in order."""
        if self.mesh is None:
            return self._apply_one(x, self.module, self.device)
        devices = self._data_positions()
        base, extra = divmod(x.shape[0], len(devices))
        outs, off = [], 0
        for i, dev in enumerate(devices):
            n = base + (1 if i < extra else 0)
            if n == 0:
                continue
            part = x[off:off + n].to(dev)
            off += n
            outs.append(self._apply_one(part, self._replicas[dev], dev).to(x.device))
        return torch.cat(outs, dim=0)

    def _apply_one(self, x: torch.Tensor, module: torch.nn.Module, device) -> torch.Tensor:
        if self.normalize and x.dtype == torch.uint8:
            scale, shift = self._norm_scale.to(device), self._norm_shift.to(device)
            x = kernels.fused_normalize(x, scale, shift, out_dtype=self.compute_dtype)
        if self._qparams:
            weights = surgery.materialize(self._qparams, self.quantize, self._dequant_dtype())
            if device != self.device:
                weights = {k: v.to(device) for k, v in weights.items()}
            with self._apply_lock:
                y = torch.func.functional_call(module, weights, (x,))
        else:
            y = module(x)
        if self.softmax_outputs:
            y = torch.softmax(y, dim=-1)
        if self.top_k:
            values, indices = torch.topk(y, self.top_k, dim=-1)
            y = torch.stack([indices.to(torch.float32), values], dim=-2)
        return y

    def _dequant_dtype(self) -> torch.dtype:
        # w8a8 dequantises to float32: its layers requantise the kernels,
        # and a bf16 intermediate would round twice and move integers by
        # one; the other layers cast to their own dtype as they run
        return torch.float32 if self.precision == "w8a8" else self.compute_dtype

    def _calibration_batches(self) -> List[torch.Tensor]:
        """JaxServer's calibration batches: uint8 images from the seed,
        through the numpy float32 affine when normalizing."""
        crng = np.random.default_rng(self.seed + 101)
        cb = min(8, self.max_batch_size)
        scale, shift = self._normalize_affine()
        batches = []
        for _ in range(self.calibration_batches):
            img = crng.integers(0, 256, size=(cb, *self.input_shape))
            if self.normalize:
                x = img.astype(np.float32) * scale + shift
            else:
                x = img.astype(np.dtype(self.warmup_dtypes[0]))
            batches.append(torch.from_numpy(x).to(self.device))
        return batches

    def _quantize(self) -> None:
        """Rest every large kernel int8 on the device: the module keeps an
        empty placeholder where each quantised weight was."""
        bytes_fp = surgery.tree_hbm_bytes(self.module.state_dict())
        state, self.quantize_manifest = surgery.quantize_params(self.module)
        self._qparams = {row["key"]: state[row["key"]] for row in self.quantize_manifest}
        for key in self._qparams:
            owner, _, name = key.rpartition(".")
            old = self.module.get_parameter(key)
            setattr(self.module.get_submodule(owner), name,
                    torch.nn.Parameter(old.new_empty(0), requires_grad=False))
        self.param_bytes = surgery.tree_hbm_bytes(self.module.state_dict()) + surgery.tree_hbm_bytes(self._qparams)
        logger.info("int8 surgery: %d kernels quantized, params %.1f MB -> %.1f MB",
                    len(self.quantize_manifest), bytes_fp / 1e6, self.param_bytes / 1e6)

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
        if self.precision == "w8a8" and self.calibration_batches > 0:
            from seldon_core_tpu_torch.ops.w8a8 import act_scale_table, calibrate_act_scales

            batches = self._calibration_batches()
            with deterministic_cudnn():
                self.act_scales_calibrated = calibrate_act_scales(self.module, batches)
            self.act_scales = act_scale_table(self.module)
            logger.info("w8a8 calibration: %d activation scales fixed over %d batches",
                        self.act_scales_calibrated, len(batches))
        if self.quantize == "int8":
            self._quantize()
        else:
            self.param_bytes = surgery.tree_hbm_bytes(self.module.state_dict())
        if self.mesh is not None:
            self._replicate()
        batcher_cls = MultiSignatureBatcher if self.extra_input_shapes else DynamicBatcher
        self.batcher = batcher_cls(
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
            # every (shape, bucket, dtype) triple clients may send, over
            # the batcher's NORMALIZED bucket list (it force-appends
            # max_batch_size), so no request pays an algorithm search
            for shape in self.accepted_shapes():
                for b in self.batcher.buckets:
                    for dt in self.warmup_dtypes:
                        self.device_call(np.zeros((b, *shape), np.dtype(dt)))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        self._load_time_s = time.perf_counter() - t0
        self.launches_at_ready = kernels.launch_counts()
        self._loaded = True
        logger.info(
            "cudaserver %s loaded on %s in %.2fs (buckets=%s, dtype=%s)",
            self.model_name, self.device, self._load_time_s, self.batcher.buckets, self.dtype_name,
        )

    def unload(self) -> None:
        """Stop the batcher (its threads are joined) and let go of the
        weights, so a drained generation returns its card memory; a later
        request loads again."""
        if self.batcher is not None:
            self.batcher.stop()
        self._loaded = False
        self.module = None
        self._replicas = {}
        self._qparams = {}
        self._norm_scale = self._norm_shift = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -------------------------------------------------------------- serving

    def accepted_shapes(self) -> List[Tuple[int, ...]]:
        """Input signatures (without batch dim) this server accepts: the
        primary ``input_shape``, then ``extra_input_shapes``."""
        return [tuple(self.input_shape), *self.extra_input_shapes]

    def _prepare(self, X) -> Tuple[np.ndarray, bool]:
        """Canonicalise dtype and shape (as JaxServer._prepare).

        A dtype outside ``warmup_dtypes`` is cast to the first of them, so
        a JSON ``ndarray`` (float64) reaches the model as float32 and is
        NOT normalized: normalization applies to uint8 payloads only.
        The batch reading wins: an array whose trailing dims match an
        accepted signature is a batch, even when its whole shape matches
        another one; then an array that matches a signature whole is a
        single example; then flat rows [batch, prod(sig)] are reshaped to
        the first signature of that size; anything else is a 400 listing
        the accepted shapes."""
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

    # ---- native fast lane -------------------------------------------------

    def flat_feature_dim(self) -> int:
        """Row width of the flattened input the native ingress sends."""
        if self.input_shape is None:
            self.load()
        return int(np.prod(self.input_shape))

    def flat_out_dim(self) -> int:
        """Row width of the flattened output (2k for top-k)."""
        return 2 * self.top_k if self.top_k else self.num_classes

    def raw_batch_call(self, batch2d: np.ndarray, timeout_s: float = 120.0) -> np.ndarray:
        """One model call for a batch the C++ ingress coalesced:
        [rows, flat] uint8 | float32 -> [rows, out] float32.

        The dtype is kept: a uint8 batch reaches the device as uint8 and
        goes through ``fused_normalize``; other dtypes are cast to
        ``warmup_dtypes[0]``.  The call rides the same DynamicBatcher as
        every other lane (its ``max_wait_ms`` is a second coalescing
        window after the C++ one), and waits for its answer: ``batch2d``
        may be a view of memory the caller frees when this returns, and
        the batcher resolves the future only after ``device_call`` has
        copied the rows into the staging buffer.  After ``timeout_s`` it
        raises ``TimeoutError``, as the reference does, and still never
        returns while the batcher may read the rows
        (``DynamicBatcher.submit_lent``), so the C++ side answers its
        clients with an error instead of holding a batch thread forever.
        """
        if not self._loaded:
            self.load()
        arr = np.asarray(batch2d)
        if arr.dtype.name not in self.warmup_dtypes:
            arr = arr.astype(np.dtype(self.warmup_dtypes[0]))
        arr = arr.reshape((-1, *self.input_shape))
        out = self.batcher.submit_lent(arr, timeout_s=timeout_s)
        return np.asarray(out).reshape(arr.shape[0], -1)

    def raw_batch_views(self, views, timeout_s: float = 120.0) -> List[np.ndarray]:
        """The batched submission of the zero-copy lane: N buffer views
        ``[rows_i, flat]`` stack into ONE micro-batch (one allocation; a
        lone full view passes through without a copy), ride the batcher
        as one request and split back into per-view outputs.  A
        mixed-dtype wave stacks at the canonical dtype."""
        from seldon_core_tpu_torch.codec.bufview import BufferView, stack_views

        if not self._loaded:
            self.load()
        norm = []
        for v in views:
            arr = v.array() if isinstance(v, BufferView) else np.asarray(v)
            if arr.ndim == 1:
                arr = arr[None, :]
            if arr.dtype.name not in self.warmup_dtypes:
                arr = arr.astype(np.dtype(self.warmup_dtypes[0]))
            norm.append(arr.reshape(arr.shape[0], -1))
        if len({a.dtype for a in norm}) > 1:
            canon = np.dtype(self.warmup_dtypes[0])
            norm = [a.astype(canon, copy=False) for a in norm]
        batch, offsets = stack_views(norm, dtype=norm[0].dtype)
        out = self.raw_batch_call(batch, timeout_s=timeout_s)
        return [out[offsets[i]:offsets[i + 1]] for i in range(len(norm))]

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
            # sums whose differences over the count's give a window's mean collection wait and enqueue -> result
            gauge_metric("cudaserver_batched_requests_total", float(self.batcher.stats.requests)),
            gauge_metric("cudaserver_batch_collect_ms_total", self.batcher.stats.collect_ms_total),
            gauge_metric("cudaserver_batch_total_ms_total", self.batcher.stats.total_ms_sum),
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
            "mesh": self.mesh.shape if self.mesh is not None else None,
            "dtype": self.dtype_name,
            "precision": self.precision or "bf16",
            "quantize": self.quantize,
            "quantized_kernels": len(self.quantize_manifest),
            "act_scales_calibrated": self.act_scales_calibrated,
            "act_scales": self.act_scales,
            "param_bytes": self.param_bytes,
            "normalize": self.normalize,
            "load_time_s": self._load_time_s,
            "buckets": list(self.batcher.buckets) if self.batcher else [],
            "signatures": [list(s) for s in self.accepted_shapes()] if self._loaded else [],
            "signature_groups": ([[dt, list(shape)] for dt, shape in self.batcher.signatures]
                                 if isinstance(self.batcher, MultiSignatureBatcher) else []),
            "model_uri": self.model_uri,
            "checkpoint_times": self.checkpoint_times,
            "kernel_launches": kernels.launch_counts(),
            "kernel_launches_at_ready": self.launches_at_ready,
        }

