"""Autoregressive generation: kv-cache prefill + bucketed decode.

The port's counterpart of ``seldon_core_tpu/models/generate.py``: the
prompt bucket ladder, the LM parameter loader, ``Generator`` (rectangular,
non-paged generation: every row of a request shares one prompt length) and
the deployable ``GenerativeLM``.

* **prefill** runs the whole bucket-padded prompt through one cached
  forward (``TransformerLM.forward(..., cache=)``), takes the logits at
  ``true_len - 1`` and sets the cache's index to ``true_len``;
* **decode** is a host loop of one-token cached forwards with no host
  synchronisation inside it: sampling, the EOS freeze (finished rows
  emit ``eos_id`` and keep stepping) and ``done`` stay on the device, and
  the ids are read back once at the end;
* the shapes a request runs are keyed ``(batch, bucket, new_bucket)``:
  prompt lengths on the bucket ladder, ``max_new_tokens`` on a
  power-of-two ladder.  ``Generator.programs`` records the keys served
  (the JAX package compiles one program per key).

``GenerativeLM`` wraps this as a component: token ids in, generated ids
out, temperature / top-k sampling from one ``torch.Generator`` per
request, seeded from the request.
"""

from __future__ import annotations

import threading
import zlib
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.ops.surgery import validate_quantize_mode
from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent


def _buckets_for(max_len: int) -> List[int]:
    """Prompt length buckets: 16, 32, ... doubling below ``max_len``, then
    ``max_len`` itself (one prefill shape per bucket)."""
    out, b = [], 16
    while b < max_len:
        out.append(b)
        b *= 2
    out.append(max_len)
    return out


def load_lm_params(model_uri: str, config: Dict[str, int], seed: int,
                   device: torch.device = torch.device("cpu")) -> Dict[str, torch.Tensor]:
    """A ``TransformerLM`` state_dict (float32, on ``device``): flax's
    default init drawn from a ``torch.Generator`` seeded with ``seed``;
    with ``model_uri``, the flax msgpack checkpoint there (fetched by
    ``utils/storage.py``) restored onto that seeded tree as a template,
    as the JAX package's loader does, then converted by
    ``lm_params_from_flax``.

    ``config`` holds vocab_size, d_model, num_layers, num_heads and
    max_len."""
    from seldon_core_tpu_torch.models.transformer import TransformerLM

    lm = TransformerLM(dtype=torch.float32, **config)
    lm.reset_parameters(torch.Generator().manual_seed(int(seed)))
    state = lm.state_dict()
    if model_uri:
        from seldon_core_tpu_torch.models import convert
        from seldon_core_tpu_torch.utils import serialization, storage

        with open(storage.download(model_uri), "rb") as f:
            params = serialization.from_bytes(convert.lm_flax_params(state), f.read())
        state = convert.lm_params_from_flax(serialization.to_numpy_tree(params))
    return {k: v.to(device) for k, v in state.items()}


def sample_tokens(logits: torch.Tensor, temperature: float, top_k: int,
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """Each row's next token from float32 ``logits`` (B, V): the argmax
    when ``temperature`` is 0, else a draw from ``softmax(logits /
    max(temperature, 1e-6))`` over every logit ``>=`` the row's
    ``top_k``-th (ties kept; ``top_k`` 0 or ``>= V`` keeps all), by
    Gumbel-max with ``generator``.  No host synchronisation."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    scaled = logits / max(float(temperature), 1e-6)
    if 0 < top_k < scaled.shape[-1]:
        cutoff = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled >= cutoff, scaled, float("-inf"))
    u = torch.rand(scaled.shape, generator=generator, device=scaled.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return torch.argmax(scaled + gumbel, dim=-1)


class RequestSeeds:
    """A component's per-request seed: the ``seed`` tag, else the CRC-32
    of the request's puid, else a per-component counter (locked)."""

    def __init__(self):
        self._count = 0
        self._lock = threading.Lock()

    def __call__(self, tags, meta) -> int:
        if "seed" in tags:
            return int(tags["seed"])
        puid = meta.get("puid", "")
        if puid:
            return zlib.crc32(puid.encode())
        with self._lock:
            self._count += 1
            return self._count


class Generator:
    """Cached generation around a ``TransformerLM`` state_dict.

    Runs on ``cuda`` unless ``device="cpu"``; ``dtype`` is bfloat16 unless
    given.  ``quantize="int8"`` rests the kernels int8 (``ops/surgery.py``)
    and dequantises them once per ``generate`` call, never per step.
    ``mesh`` / ``tp`` / ``dp`` (``SELDON_TPU_TP`` / ``SELDON_TPU_DP``)
    resolve as the paged engine's do and run ``parallel/tp.py``'s cached
    forward: rows over ``data``, weights by JAX's specs and the cache's
    heads over ``model``."""

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        *,
        vocab_size: int,
        d_model: int = 256,
        num_layers: int = 4,
        num_heads: int = 8,
        max_len: int = 2048,
        dtype: Any = None,
        prompt_buckets: Optional[Sequence[int]] = None,
        mesh: Any = None,
        tp: Optional[int] = None,
        dp: Optional[int] = None,
        quantize: str = "",
        device: Any = "cuda",
    ):
        # paged.py imports this module at its top: import it here
        from seldon_core_tpu_torch.models.cudaserver import resolve_device
        from seldon_core_tpu_torch.models.paged import _resolve_dtype, drop_float_kernels, rest_kernels_int8
        from seldon_core_tpu_torch.models.transformer import TransformerLM
        from seldon_core_tpu_torch.parallel.mesh import resolve_mesh

        self.quantize = validate_quantize_mode(quantize)
        if mesh is None:
            mesh = resolve_mesh(tp=tp, dp=dp)
        self._mesh = mesh
        self.tp_degree = mesh.axis_size("model") if mesh is not None else 1
        self.dp_degree = mesh.axis_size("data") if mesh is not None else 1
        if mesh is not None:
            self.device = mesh.devices.flat[0]
        else:
            self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.dtype = _resolve_dtype(dtype)
        self.max_len = int(max_len)
        self.vocab_size = int(vocab_size)
        self.prompt_buckets = sorted(set(prompt_buckets or _buckets_for(self.max_len)))
        self.quantize_manifest: List[Dict[str, Any]] = []
        self._qkernels = {}
        if mesh is not None:
            self.module = self._mesh_module(params, mesh, d_model=d_model, num_layers=num_layers,
                                            num_heads=num_heads)
        else:
            module = TransformerLM(vocab_size=self.vocab_size, d_model=d_model, num_layers=num_layers,
                                   num_heads=num_heads, max_len=self.max_len, dtype=self.dtype)
            module.load_state_dict(params)
            self.module = module.to(self.device).eval().requires_grad_(False)
            if self.quantize == "int8":
                self._qkernels, self.quantize_manifest = rest_kernels_int8(self.module, params, self.device)
                drop_float_kernels(self.module, self._qkernels)
        # the int8 lane swaps dequantised kernels into the shared module
        # for a whole call: one call at a time holds them
        self._weights_lock = threading.Lock()
        # the (batch, bucket, new_bucket) shapes served
        self.programs: Set[Tuple[int, int, int]] = set()

    def _mesh_module(self, params, mesh, *, d_model: int, num_layers: int, num_heads: int):
        """The mesh's cached forward (``parallel/tp.py``): an int8w
        generator's kernels quantised on the host and laid out by JAX's
        paired specs."""
        from seldon_core_tpu_torch.models.transformer import TransformerLM
        from seldon_core_tpu_torch.ops.surgery import QuantizedKernel, quantize_params
        from seldon_core_tpu_torch.parallel.sharding import P
        from seldon_core_tpu_torch.parallel.tp import MeshPagedLM

        state = {k: v.detach().float().cpu() for k, v in params.items()}
        qkernels = None
        if self.quantize == "int8":
            with torch.device("meta"):
                template = TransformerLM(vocab_size=self.vocab_size, d_model=d_model, num_layers=num_layers,
                                         num_heads=num_heads, max_len=self.max_len, dtype=self.dtype)
            qstate, self.quantize_manifest = quantize_params(template, state=state)
            qkernels = {k: v for k, v in qstate.items() if isinstance(v, QuantizedKernel)}
        tp = mesh.axis_size("model")
        heads = "model" if tp > 1 and num_heads % tp == 0 else None
        return MeshPagedLM(state, vocab_size=self.vocab_size, d_model=d_model, num_layers=num_layers,
                           num_heads=num_heads, max_len=self.max_len, dtype=self.dtype, mesh=mesh,
                           pool_spec=P(None, None, None, heads), lanes_sharded=True, qkernels=qkernels)

    def _shape_key(self, batch: int, plen: int, max_new_tokens: int) -> Tuple[int, int, int]:
        if max_new_tokens < 1:
            raise MicroserviceError("max_new_tokens must be >= 1", status_code=400, reason="BAD_REQUEST")
        bucket = next((b for b in self.prompt_buckets if b >= plen), None)
        # the cache holds max(bucket, plen + new) positions: prefill
        # writes `bucket` slots, decode continues from plen
        new_bucket = 1 << (max_new_tokens - 1).bit_length()
        if bucket is None or max(bucket, plen + new_bucket) > self.max_len:
            # the exact count may fit where its power-of-two bucket does not
            if bucket is not None and max(bucket, plen + max_new_tokens) <= self.max_len:
                new_bucket = max_new_tokens
            else:
                raise MicroserviceError(
                    f"prompt {plen} + max_new {max_new_tokens} exceeds max_len {self.max_len}",
                    status_code=400,
                    reason="SEQUENCE_TOO_LONG",
                )
        return batch, bucket, new_bucket

    def generate(
        self,
        prompts: np.ndarray,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        eos_id: int = -1,
        seed: int = 0,
    ) -> np.ndarray:
        """prompts: (batch, prompt_len) int -> (batch, max_new) int32 ids.

        Rows stop at ``eos_id`` (further slots filled with eos_id)."""
        prompts = np.atleast_2d(np.asarray(prompts, np.int32))
        batch, plen = prompts.shape
        max_new_tokens = int(max_new_tokens)
        key = self._shape_key(batch, plen, max_new_tokens)
        self.programs.add(key)
        padded = np.zeros((batch, key[1]), np.int64)
        padded[:, :plen] = prompts
        dev = self.device
        generator = None
        if temperature > 0:
            generator = torch.Generator(device=dev).manual_seed(int(seed) % (1 << 63))
        if self._mesh is not None and self.quantize == "int8":
            with self._weights_lock, self.module.materialized():
                out = self._run(padded, plen, max_new_tokens, float(temperature), int(top_k), int(eos_id), generator)
        elif self._qkernels:
            from seldon_core_tpu_torch.models.paged import materialized

            with self._weights_lock, materialized(self.module, self._qkernels, self.dtype):
                out = self._run(padded, plen, max_new_tokens, float(temperature), int(top_k), int(eos_id), generator)
        else:
            out = self._run(padded, plen, max_new_tokens, float(temperature), int(top_k), int(eos_id), generator)
        return out.astype(np.int32)

    @torch.inference_mode()
    def _run(self, padded: np.ndarray, plen: int, max_new: int, temperature: float, top_k: int, eos_id: int,
             generator: Optional[torch.Generator]) -> np.ndarray:
        dev = self.device
        batch, bucket = padded.shape
        cache = self.module.init_cache(batch)
        logits = self.module(torch.from_numpy(padded).to(dev), torch.arange(bucket, device=dev), cache=cache)
        # the pad slots are overwritten by decode: the next write lands
        # right after the true prompt
        cache.index = plen
        logits = logits[:, plen - 1]
        positions = torch.arange(plen, plen + max_new, device=dev)
        out = torch.empty((batch, max_new), dtype=torch.int64, device=dev)
        done = torch.zeros((batch,), dtype=torch.bool, device=dev)
        for n in range(max_new):
            token = torch.where(done, eos_id, sample_tokens(logits, temperature, top_k, generator))
            out[:, n] = token
            done |= token == eos_id
            if n + 1 < max_new:  # the last token needs no forward
                logits = self.module(token[:, None], positions[n:n + 1], cache=cache)[:, 0]
        return out.cpu().numpy()


class GenerativeLM(TPUComponent):
    """Deployable generation component: token ids in, generated ids out.

    Parameters mirror ``TransformerLM``'s architecture plus sampling
    defaults; ``model_uri`` loads a flax msgpack checkpoint (a trained
    TransformerLM parameter tree).  Serves in bfloat16, as the JAX
    component does; runs on ``cuda`` unless ``device="cpu"``.  Per-request
    overrides via ``meta.tags``: ``max_new_tokens``, ``temperature``,
    ``top_k`` and ``seed``."""

    device_exclusive = True  # weights and caches on the card: one process per card

    def __init__(
        self,
        vocab_size: int = 32000,
        d_model: int = 256,
        num_layers: int = 4,
        num_heads: int = 8,
        max_len: int = 2048,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        top_k: int = 0,
        eos_id: int = -1,
        model_uri: str = "",
        seed: int = 0,
        tp: int = 0,
        dp: int = 0,
        quantize: str = "",
        device: str = "cuda",
        mesh_axes: Optional[Dict[str, int]] = None,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        self.config = dict(vocab_size=int(vocab_size), d_model=int(d_model), num_layers=int(num_layers),
                           num_heads=int(num_heads), max_len=int(max_len))
        # serving-mesh degrees: 0 defers to SELDON_TPU_TP / SELDON_TPU_DP;
        # mesh_axes (a component's spelling) wins over both
        self.tp = int(tp)
        self.dp = int(dp)
        if isinstance(mesh_axes, str):
            import json

            mesh_axes = json.loads(mesh_axes) if mesh_axes else None
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = int(eos_id)
        self.model_uri = model_uri
        self.seed = int(seed)
        self.quantize = validate_quantize_mode(quantize)  # fail at construction
        self.device = device
        self.generator: Optional[Generator] = None
        self._request_seed = RequestSeeds()
        self._load_lock = threading.Lock()

    def load(self) -> None:
        # idempotent and locked: the executor loads on graph build while
        # concurrent first predicts load lazily
        with self._load_lock:
            if self.generator is not None:
                return
            from seldon_core_tpu_torch.models.cudaserver import resolve_device

            from seldon_core_tpu_torch.models.paged import component_mesh

            device = resolve_device(self.device)
            params = load_lm_params(self.model_uri, self.config, self.seed, device)
            self.generator = Generator(params, quantize=self.quantize, tp=self.tp or None, dp=self.dp or None,
                                       mesh=component_mesh(self.mesh_axes, device), dtype=torch.bfloat16,
                                       device=device, **self.config)

    def predict(self, X, names, meta=None):
        if self.generator is None:
            self.load()
        meta = meta or {}
        tags = meta.get("tags", {})
        return self.generator.generate(
            np.asarray(X),
            max_new_tokens=int(tags.get("max_new_tokens", self.max_new_tokens)),
            temperature=float(tags.get("temperature", self.temperature)),
            top_k=int(tags.get("top_k", self.top_k)),
            eos_id=self.eos_id,
            seed=self.seed ^ self._request_seed(tags, meta),
        )

    def class_names(self):
        return []

    def health_status(self):
        gen = self.generator
        return {"loaded": gen is not None, "device": str(gen.device) if gen else self.device,
                "dtype": "bfloat16", "quantize": self.quantize,
                "tp_degree": gen.tp_degree if gen else None, "dp_degree": gen.dp_degree if gen else None,
                "programs": sorted(gen.programs) if gen else [], "config": self.config}
