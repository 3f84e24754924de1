"""Speculative greedy decoding: draft k tokens, verify them in one forward.

The port's counterpart of ``seldon_core_tpu/models/speculative.py``.
Sequential decode steps are bound by their launches and their round
trips; drafting ``k`` candidate tokens and verifying them in one cached
forward of ``k + 1`` positions turns up to ``k + 1`` steps into one.
The output is exactly greedy decoding: every emitted token is the
target's own argmax, and the drafts only decide how many argmaxes one
forward confirms.

Two draft sources:

* ``ngram`` (default) — prompt lookup: the tokens that followed the
  latest earlier occurrence of the context's suffix;
* ``model`` — a smaller ``TransformerLM`` decodes ``k`` greedy tokens on
  its own paged cache.

Cache discipline: the verify forward writes K/V for all ``k + 1``
positions, but only ``accepted + 1`` become visible; the stream's length
advances by that and the next round overwrites the rest, so a rollback
is an assignment to the length.

Each state is a single-stream pool in the port's split ``(layers, pages,
page_size, heads, head_dim)`` layout with an identity block table.  Its
one-token forwards (the draft model's decode steps and a one-token
catch-up) take the paged-decode kernel lane under the engine's own
predicates (``paged_kernel_requested`` / ``paged_kernel_static_eligible``:
on a CUDA device by default, on the CPU under
``SELDON_TPU_PAGED_KERNEL=force`` through the kernel's plain version);
wider segments (prefill, the verify forward, a two-token catch-up) the
gather lane.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from seldon_core_tpu_torch.models.cudaserver import resolve_device
from seldon_core_tpu_torch.models.generate import _buckets_for, load_lm_params
from seldon_core_tpu_torch.models.paged import (PagedTransformerLM, _resolve_dtype, check_ported_options,
                                                component_mesh, drop_float_kernels, materialized, paged_kernel_mode,
                                                paged_kernel_static_eligible, rest_kernels_int8, write_kv)
from seldon_core_tpu_torch.ops import kernels
from seldon_core_tpu_torch.ops.surgery import QuantizedKernel, quantize_params, validate_quantize_mode
from seldon_core_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, resolve_mesh
from seldon_core_tpu_torch.parallel.sharding import ShardedTensor, pool_spec
from seldon_core_tpu_torch.runtime import knobs as _knobs
from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent, gauge_metric

logger = logging.getLogger(__name__)


def ngram_draft(context: np.ndarray, k: int, ngram: int = 2) -> np.ndarray:
    """Prompt-lookup draft: find the most recent earlier occurrence of
    the trailing ``ngram`` tokens and propose what followed it.

    Returns up to ``k`` proposed tokens (possibly 0 — no match)."""
    n = len(context)
    for width in range(min(ngram, n - 1), 0, -1):
        suffix = context[n - width:]
        # scan right-to-left for the latest match before the suffix itself
        for start in range(n - width - 1, -1, -1):
            if np.array_equal(context[start: start + width], suffix):
                follow = context[start + width: start + width + k]
                if len(follow):
                    return np.asarray(follow, np.int32)
    return np.zeros((0,), np.int32)


class _PagedState:
    """Single-stream paged cache with an identity block table: logical
    page p at pool page p + 1, page 0 the trash page.  ``quantize="int8"``
    rests the kernels int8 (``ops/surgery.py``) and dequantises them once
    per forward."""

    def __init__(self, config: Dict[str, int], params: Dict[str, torch.Tensor], *, max_len: int, page_size: int,
                 dtype: torch.dtype, device: torch.device, quantize: str = "", mesh: Any = None,
                 model_axis: str = MODEL_AXIS, data_axis: str = DATA_AXIS, min_weight_size: int = 16_384):
        self.quantize = validate_quantize_mode(quantize)
        self.dtype = dtype
        self.max_len = max_len
        self.page_size = page_size
        self.quantize_manifest: List[Dict[str, Any]] = []
        self._qkernels = {}
        heads = config["num_heads"]
        num_pages = max_len // page_size + 1  # + trash page 0
        if mesh is not None:
            # the engine's mesh layout (JAX speculative.py:86-108): the page
            # count rounds up to a multiple of dp (the identity table never
            # reaches the extra pages), pools and weights sharded
            from seldon_core_tpu_torch.parallel.tp import MeshPagedLM

            seq_shard = _knobs.flag("SELDON_TPU_SEQ_SHARD")
            dp = mesh.axis_size(data_axis)
            if dp > 1 and seq_shard and num_pages % dp:
                num_pages += -num_pages % dp
            shape = (config["num_layers"], num_pages, page_size, heads, config["d_model"] // heads)
            spec = pool_spec(mesh, num_pages=num_pages, num_heads=heads, model_axis=model_axis,
                             data_axis=data_axis, seq_shard=seq_shard)
            state = {k: v.detach().float().cpu() for k, v in params.items()}
            qkernels = None
            if self.quantize == "int8":
                with torch.device("meta"):
                    template = PagedTransformerLM(dtype=dtype, **config)
                qstate, self.quantize_manifest = quantize_params(template, state=state)
                qkernels = {k: v for k, v in qstate.items() if isinstance(v, QuantizedKernel)}
            self.module = MeshPagedLM(state, dtype=dtype, mesh=mesh, pool_spec=spec, lanes_sharded=False,
                                      model_axis=model_axis, data_axis=data_axis, min_weight_size=min_weight_size,
                                      qkernels=qkernels, **config)
            self.pk = ShardedTensor.zeros(mesh, shape, spec, dtype)
            self.pv = ShardedTensor.zeros(mesh, shape, spec, dtype)
            device = mesh.devices.flat[0]
        else:
            module = PagedTransformerLM(dtype=dtype, **config)
            module.load_state_dict(params)
            self.module = module.to(device).eval().requires_grad_(False)
            if self.quantize == "int8":
                self._qkernels, self.quantize_manifest = rest_kernels_int8(self.module, params, device)
                drop_float_kernels(self.module, self._qkernels)
            shape = (config["num_layers"], num_pages, page_size, heads, config["d_model"] // heads)
            self.pk = torch.zeros(shape, dtype=dtype, device=device)
            self.pv = torch.zeros(shape, dtype=dtype, device=device)
        self.mesh = mesh
        self.table = torch.arange(1, max_len // page_size + 1, dtype=torch.int32, device=device)[None, :]
        self.length = 0  # host-side; rollback is an assignment

    def weights(self):
        """The compute-dtype kernels for one forward (a no-op unless int8)."""
        if self.mesh is not None:
            return self.module.materialized()
        if not self._qkernels:
            return contextlib.nullcontext()
        return materialized(self.module, self._qkernels, self.dtype)


class SpeculativeGenerator:
    """Greedy generation with draft-and-verify acceleration.

    ``draft="ngram"`` needs nothing extra; ``draft="model"`` takes
    ``draft_params`` (a ``TransformerLM`` state_dict) and
    ``draft_config`` when its architecture differs from the target's.
    ``stats`` accumulates the acceptance counters serving exports;
    ``single_token_forwards`` counts the forwards of one token (the
    paged-decode kernel's calls, one a layer, on the kernel lane).  Runs
    on ``cuda`` unless ``device="cpu"``."""

    def __init__(
        self,
        params: Dict[str, torch.Tensor],
        *,
        vocab_size: int,
        d_model: int = 256,
        num_layers: int = 4,
        num_heads: int = 8,
        max_len: int = 2048,
        page_size: int = 64,
        draft: str = "ngram",
        draft_k: int = 4,
        ngram: int = 2,
        draft_params: Optional[Dict[str, torch.Tensor]] = None,
        draft_config: Optional[Dict[str, int]] = None,
        prompt_buckets: Optional[Sequence[int]] = None,
        dtype: Any = None,
        device: Any = "cuda",
        mesh: Any = None,
        tp: Optional[int] = None,
        dp: Optional[int] = None,
        model_axis: str = MODEL_AXIS,
        data_axis: str = DATA_AXIS,
        shard_min_weight_size: int = 16_384,
        quantize: str = "",
        chunk_token_budget: int = 0,
    ):
        check_ported_options()
        # the engine's mesh precedence: an explicit mesh wins, else tp= /
        # dp= / SELDON_TPU_TP / SELDON_TPU_DP, degrading with a WARN
        if mesh is None:
            mesh = resolve_mesh(tp=tp, dp=dp, model_axis=model_axis, data_axis=data_axis)
        self.mesh = mesh
        self.tp_degree = mesh.axis_size(model_axis) if mesh is not None else 1
        self.dp_degree = mesh.axis_size(data_axis) if mesh is not None else 1
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        if draft not in ("ngram", "model"):
            raise ValueError(f"draft must be 'ngram' or 'model', got {draft!r}")
        if draft == "model" and draft_params is None:
            raise ValueError("draft='model' needs draft_params")
        if mesh is not None:
            self.device = mesh.devices.flat[0]
        else:
            self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.dtype = _resolve_dtype(dtype)
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.draft_mode = draft
        self.draft_k = int(draft_k)
        self.ngram = int(ngram)
        self.prompt_buckets = sorted(set(prompt_buckets or _buckets_for(max_len)))
        # chunked prompt prefill (the engine's knob): page-aligned chunks
        # of one width instead of one bucket-sized forward; 0 is off
        if not chunk_token_budget:
            chunk_token_budget = int(_knobs.raw("SELDON_TPU_CHUNK_TOKEN_BUDGET", "0") or 0)
        self.chunk_token_budget = max(0, int(chunk_token_budget))
        if self.chunk_token_budget and self.chunk_token_budget < page_size:
            logger.warning("chunk_token_budget %d is under one page (%d); clamping", self.chunk_token_budget,
                           page_size)
            self.chunk_token_budget = page_size
        self.stats = {"rounds": 0, "drafted": 0, "accepted": 0, "tokens": 0}
        self.single_token_forwards = 0
        # the engine's lane rule: one-token forwards on the kernel lane
        self._use_kernel = paged_kernel_static_eligible(paged_kernel_mode(), mesh is None, self.dtype, self.device)
        target_cfg = dict(vocab_size=int(vocab_size), d_model=int(d_model), num_layers=int(num_layers),
                          num_heads=int(num_heads), max_len=self.max_len)
        if self._use_kernel:
            kernels.paged_kernel_impl(target_cfg["num_heads"], d_model // num_heads)  # a bad IMPL knob fails here
        mesh_kw = dict(mesh=mesh, model_axis=model_axis, data_axis=data_axis, min_weight_size=shard_min_weight_size)
        self.target = _PagedState(target_cfg, params, max_len=self.max_len, page_size=self.page_size,
                                  dtype=self.dtype, device=self.device, quantize=quantize, **mesh_kw)
        self.quantize_manifest = self.target.quantize_manifest
        self.draft_state: Optional[_PagedState] = None
        if draft == "model":
            cfg = dict(target_cfg)
            cfg.update({k: int(v) for k, v in (draft_config or {}).items()})
            cfg["vocab_size"] = self.vocab_size  # must share the vocabulary
            cfg["max_len"] = self.max_len
            if self._use_kernel:
                kernels.paged_kernel_impl(cfg["num_heads"], cfg["d_model"] // cfg["num_heads"])
            self.draft_state = _PagedState(cfg, draft_params, max_len=self.max_len, page_size=self.page_size,
                                           dtype=self.dtype, device=self.device, quantize=quantize, **mesh_kw)

    # ---- forwards -----------------------------------------------------------

    def _run(self, state: _PagedState, tokens: np.ndarray, start: int, write_table: torch.Tensor,
             write_start: int, from_zero: bool) -> np.ndarray:
        """``tokens`` (1, L) at absolute positions start..start+L-1 over
        the pool masked at ``start``, their K/V written through
        ``write_table`` from ``write_start``; -> greedy ids (L,).  The
        caller owns ``state.length``."""
        dev = self.device
        seg = tokens.shape[1]
        toks = torch.from_numpy(np.ascontiguousarray(tokens, np.int64)).to(dev)
        positions = torch.clamp(start + torch.arange(seg, device=dev), max=self.max_len - 1)[None, :]
        lengths = torch.full((1,), start, dtype=torch.int32, device=dev)
        if seg == 1:
            self.single_token_forwards += 1
        with torch.inference_mode(), state.weights():
            logits, nk, nv = state.module(toks, positions, state.pk, state.pv, state.table, lengths,
                                          use_kernel=self._use_kernel)
            write_kv(state.pk, state.pv, nk, nv, write_table, torch.full((1,), write_start, dtype=torch.int32,
                                                                         device=dev),
                     torch.ones((1, seg), dtype=torch.bool, device=dev), page_size=self.page_size,
                     max_len=self.max_len, from_zero=from_zero)
            return torch.argmax(logits[0], dim=-1).cpu().numpy()

    def _forward(self, state: _PagedState, tokens: np.ndarray, start: int) -> np.ndarray:
        """``tokens`` (1, L) through the cached forward at ``start``; the
        prompt's prefill (``start == 0``) writes whole page blocks."""
        return self._run(state, tokens, start, state.table, start, from_zero=start == 0)

    def _forward_chunk(self, state: _PagedState, tokens: np.ndarray, start: int) -> np.ndarray:
        """One page-aligned prompt chunk at ``start``: reads the pool
        through the full table masked at ``start`` (the earlier chunks'
        K/V), writes whole page blocks through the table's window at
        ``start``'s page (page 0, the trash page, pads a window that runs
        past the table)."""
        wpages = -(-tokens.shape[1] // self.page_size)
        shift = int(start) // self.page_size
        window = state.table[:, shift: shift + wpages]
        wt = torch.zeros((1, wpages), dtype=torch.int32, device=self.device)
        wt[:, : window.shape[1]] = window
        return self._run(state, tokens, start, wt, 0, from_zero=True)

    def _prefill_prompt(self, state: _PagedState, prompt: np.ndarray) -> int:
        """Prompt prefill for one state; returns the next greedy token.
        One bucket-padded forward, or with ``chunk_token_budget`` set,
        page-aligned chunks of one width: the same K/V, the same argmax."""
        plen = len(prompt)
        budget = self.chunk_token_budget
        if not budget or plen <= budget:
            bucket = next(b for b in self.prompt_buckets if b >= plen)
            padded = np.zeros((1, bucket), np.int32)
            padded[0, :plen] = prompt
            greedy = self._forward(state, padded, 0)
            state.length = plen
            return int(greedy[plen - 1])
        W = (budget // self.page_size) * self.page_size
        start = 0
        greedy = None
        n = 0
        while start < plen:
            n = min(W, plen - start)
            seg = np.zeros((1, W), np.int32)
            seg[0, :n] = prompt[start: start + n]
            greedy = self._forward_chunk(state, seg, start)
            start += n
            state.length = start
        return int(greedy[n - 1])

    # ---- drafting -------------------------------------------------------------

    def _draft(self, context: np.ndarray, k: int) -> np.ndarray:
        if self.draft_mode == "ngram":
            return ngram_draft(context, k, ngram=self.ngram)
        # draft model: its cache is valid up to draft_state.length; catch up
        # on the tokens it has not seen, then decode k greedy steps
        ds = self.draft_state
        missing = context[ds.length:]
        out: List[int] = []
        token_seg = np.asarray(missing, np.int32)[None, :]
        while len(out) < k:
            greedy = self._forward(ds, token_seg, ds.length)
            ds.length += token_seg.shape[1]
            nxt = int(greedy[-1])
            out.append(nxt)
            token_seg = np.asarray([[nxt]], np.int32)
        return np.asarray(out, np.int32)

    # ---- the loop -------------------------------------------------------------

    def generate(self, prompt: np.ndarray, max_new_tokens: int = 32, eos_id: int = -1) -> np.ndarray:
        """(plen,) int prompt -> (max_new,) greedy ids, eos-padded: the
        tokens plain cached greedy decoding gives, token by token."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = len(prompt)
        max_new_tokens = int(max_new_tokens)
        if plen < 1 or max_new_tokens < 1:
            raise MicroserviceError("need a non-empty prompt and max_new_tokens >= 1", status_code=400,
                                    reason="BAD_REQUEST")
        # the verify segment may write up to draft_k + 1 positions past the
        # accepted length; keep every write inside the table
        if plen + max_new_tokens + self.draft_k + 1 > self.max_len:
            raise MicroserviceError(
                f"prompt {plen} + max_new {max_new_tokens} + draft_k {self.draft_k} headroom exceeds max_len "
                f"{self.max_len}", status_code=400, reason="SEQUENCE_TOO_LONG")

        # a fresh single-stream state per call
        self.target.length = 0
        if self.draft_state is not None:
            self.draft_state.length = 0

        next_token = self._prefill_prompt(self.target, prompt)
        if self.draft_state is not None:
            # prime the draft cache on the same prompt
            self._prefill_prompt(self.draft_state, prompt)

        out: List[int] = [next_token]
        while len(out) < max_new_tokens and next_token != eos_id:
            context = np.concatenate([prompt, np.asarray(out, np.int32)])
            k = min(self.draft_k, max_new_tokens - len(out))
            drafted = self._draft(context, k)[:k]
            # verify segment: [last emitted, d1..dk] padded to draft_k + 1;
            # pads are never accepted
            seg = np.zeros((1, self.draft_k + 1), np.int32)
            seg[0, 0] = next_token
            seg[0, 1: 1 + len(drafted)] = drafted
            greedy = self._forward(self.target, seg, self.target.length)
            accepted = 0
            while accepted < len(drafted) and drafted[accepted] == greedy[accepted]:
                accepted += 1
            emitted = list(drafted[:accepted]) + [int(greedy[accepted])]
            self.target.length += accepted + 1
            if self.draft_state is not None:
                # accepted tokens are what the draft generated, so its cache
                # is valid through them; the bonus token is new
                self.draft_state.length = min(self.draft_state.length, self.target.length - 1)
            self.stats["rounds"] += 1
            self.stats["drafted"] += len(drafted)
            self.stats["accepted"] += accepted
            for token in emitted:
                out.append(int(token))
                if len(out) >= max_new_tokens or token == eos_id:
                    break
            next_token = out[-1]
        self.stats["tokens"] += min(len(out), max_new_tokens)

        out = out[:max_new_tokens]
        if eos_id in out:
            out = out[: out.index(eos_id) + 1]
        out = out + [eos_id] * (max_new_tokens - len(out))
        return np.asarray(out, np.int32)


class SpeculativeLM(TPUComponent):
    """Deployable speculative-greedy generation component.

    The JAX component's parameters: the LM's sizes, ``max_new_tokens``,
    ``eos_id``, ``model_uri``, ``draft`` ("ngram" | "model"),
    ``draft_k``, ``ngram``, ``draft_uri`` / ``draft_config`` for a draft
    checkpoint (seeded with ``seed + 1`` when ``draft_uri`` is empty),
    ``page_size``, ``seed``, ``quantize`` and ``chunk_token_budget``;
    ``mesh`` (a ``parallel.mesh.Mesh``), ``mesh_axes``, ``tp`` / ``dp`` run
    the generator on a serving mesh (``models/paged.component_mesh``).
    Runs on ``cuda`` unless ``device="cpu"``; ``dtype`` is bfloat16 unless
    ``float32``.  ``metrics()`` exports the acceptance rate and the verify
    rounds."""

    def __init__(
        self,
        vocab_size: int = 32000,
        d_model: int = 256,
        num_layers: int = 4,
        num_heads: int = 8,
        max_len: int = 2048,
        max_new_tokens: int = 32,
        eos_id: int = -1,
        model_uri: str = "",
        draft: str = "ngram",
        draft_k: int = 4,
        ngram: int = 2,
        draft_uri: str = "",
        draft_config: Optional[Dict[str, int]] = None,
        page_size: int = 64,
        seed: int = 0,
        mesh_axes: Optional[Dict[str, int]] = None,
        tp: int = 0,
        dp: int = 0,
        quantize: str = "",
        chunk_token_budget: int = 0,
        device: str = "cuda",
        dtype: str = "bfloat16",
        mesh: Any = None,
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        check_ported_options()
        if isinstance(mesh_axes, str):
            mesh_axes = json.loads(mesh_axes) if mesh_axes else None
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        # an explicit Mesh (programmatic, as JaxServer's mesh=) wins over
        # mesh_axes and the degrees
        self.mesh = mesh
        self.tp, self.dp = int(tp or 0), int(dp or 0)
        self.config = dict(vocab_size=int(vocab_size), d_model=int(d_model), num_layers=int(num_layers),
                           num_heads=int(num_heads), max_len=int(max_len))
        self.max_new_tokens = int(max_new_tokens)
        self.eos_id = int(eos_id)
        self.model_uri = model_uri
        self.draft = draft
        self.draft_k = int(draft_k)
        self.ngram = int(ngram)
        self.draft_uri = draft_uri
        self.draft_config = dict(draft_config or {})
        self.page_size = int(page_size)
        self.seed = int(seed)
        self.quantize = validate_quantize_mode(quantize)  # fail at construction
        self.chunk_token_budget = int(chunk_token_budget)
        self.device = resolve_device(device)
        self.dtype = _resolve_dtype(dtype)
        self.generator: Optional[SpeculativeGenerator] = None
        # one pool and host-side lengths per generator: concurrent predicts
        # serialise (replicas parallelise)
        self._gen_lock = threading.Lock()
        self._load_lock = threading.Lock()

    def load(self) -> None:
        """Build the generator once (idempotent and locked, so a lazy
        predict and the executor's load never swap it mid-use)."""
        with self._load_lock:
            if self.generator is not None:
                return
            params = load_lm_params(self.model_uri, self.config, self.seed, self.device)
            draft_params = None
            if self.draft == "model":
                cfg = dict(self.config)
                cfg.update({k: int(v) for k, v in self.draft_config.items()})
                cfg["vocab_size"] = self.config["vocab_size"]
                cfg["max_len"] = self.config["max_len"]
                draft_params = load_lm_params(self.draft_uri, cfg, self.seed + 1, self.device)
            self.generator = SpeculativeGenerator(
                params, dtype=self.dtype, device=self.device, page_size=self.page_size, draft=self.draft,
                draft_k=self.draft_k, ngram=self.ngram, draft_params=draft_params, draft_config=self.draft_config,
                quantize=self.quantize, chunk_token_budget=self.chunk_token_budget,
                mesh=self.mesh or component_mesh(self.mesh_axes, self.device), tp=self.tp, dp=self.dp,
                **self.config)

    def predict(self, X, names, meta=None):
        with self._gen_lock:
            if self.generator is None:
                self.load()
            meta = meta or {}
            tags = meta.get("tags", {})
            max_new = int(tags.get("max_new_tokens", self.max_new_tokens))
            X = np.atleast_2d(np.asarray(X, np.int32))
            return np.stack([self.generator.generate(row, max_new_tokens=max_new, eos_id=self.eos_id)
                             for row in X])

    def metrics(self):
        s = self.generator.stats if self.generator else {}
        # GAUGEs: metrics() is collected after every request, so a
        # cumulative COUNTER would be added again each time
        return [gauge_metric("speculative_acceptance_rate", s.get("accepted", 0) / max(1, s.get("drafted", 0))),
                gauge_metric("speculative_rounds", s.get("rounds", 0))]

    def class_names(self):
        return []
