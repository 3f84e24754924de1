"""Paged KV-cache + continuous batching for autoregressive serving.

The port's counterpart of ``seldon_core_tpu/models/paged.py``, in the
JAX package's production configuration: the pool chunk
(``SELDON_TPU_CHUNK_IMPL=pool``), the split pool layout
``(layers, pages, page_size, heads, head_dim)``, pages in the engine's
dtype, no adapters, greedy or sampled decoding.

* **Paged pool** — K/V live in one pool of fixed-size pages; each
  stream owns a block-table row mapping its positions to pages.  Page 0
  is the trash page: writes of pad rows and of lanes that are not
  decoding land there, and no stream reads it below its length.
* **Continuous batching** — streams join and leave between decode
  chunks; the decode batch is always ``max_slots`` lanes wide, so a
  lane's arithmetic never depends on which other streams run.
* **Decode lanes** — on a CUDA engine each decode step of each layer
  launches the hand-written CUDA paged-decode kernel
  (``ops.kernels.paged_attention_decode``: K4 ``stream`` by default, K5
  ``grid`` under ``SELDON_TPU_PAGED_KERNEL_IMPL=grid``) and merges the
  current token by the flash rule in float32; ``SELDON_TPU_PAGED_KERNEL=0``
  takes the gather lane (the pool pages gathered through the table,
  scores in the engine dtype, softmax in float32).  The two lanes are
  two numeric regimes, as in the JAX package; their greedy tokens agree
  bit for bit in float32.
* **One host round trip per chunk** — a chunk's ``steps_per_call``
  decode steps, sampling included, run as device work, and its tokens
  come back in one device-to-host copy.

Decisions of this slice (the JAX engine has more machinery):

* a stream is admitted only when the pages for its prompt plus
  ``max_new_tokens`` are free (reserve at admission), so no stream
  stalls or is evicted mid-decode;
* sampling draws from one ``torch.Generator`` per stream, seeded from
  the stream's seed: greedy tokens equal the JAX engine's, sampled
  tokens cannot equal ``jax.random``'s;
* the prefix cache, chunked prefill, the steps ladder, the ring chunk,
  speculative decoding, LoRA adapters, int8 KV and weights, meshes,
  token streaming, drain and migration raise, naming the later slice
  (``ROADMAP.md`` §A item 8).
"""

from __future__ import annotations

import functools
import logging
import math
import threading
import time
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from seldon_core_tpu_torch.models.cudaserver import resolve_device
from seldon_core_tpu_torch.models.generate import _buckets_for, load_lm_params
from seldon_core_tpu_torch.models.transformer import TransformerBlock, TransformerLM
from seldon_core_tpu_torch.ops import kernels
from seldon_core_tpu_torch.runtime import knobs as _knobs
from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent, gauge_metric

logger = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


# ---------------------------------------------------------------------------
# knob helpers (the JAX package's paged.py:49-101, CUDA in place of TPU)
# ---------------------------------------------------------------------------

def paged_kernel_mode() -> str:
    """``SELDON_TPU_PAGED_KERNEL``: "auto" (default) | "1" | "force" | "0"."""
    return _knobs.raw("SELDON_TPU_PAGED_KERNEL", "auto")


def paged_kernel_explicit(mode: Optional[str] = None) -> bool:
    """True when the operator explicitly opted in ("1" | "force")."""
    return (mode if mode is not None else paged_kernel_mode()) in ("1", "force")


def paged_kernel_requested(mode: Optional[str], device: torch.device) -> bool:
    """Whether this engine wants the kernel lane: an explicit "1"/"force",
    or the "auto" default on a CUDA device."""
    mode = mode if mode is not None else paged_kernel_mode()
    if mode in ("1", "force"):
        return True
    return mode == "auto" and device.type == "cuda"


def paged_kernel_static_eligible(mode: str, mesh_absent: bool, dtype: torch.dtype,
                                 device: torch.device) -> bool:
    """The kernel lane's gate: requested, no mesh, a bfloat16 or float32
    pool, and a CUDA device unless forced ("force" on the CPU runs the
    kernel's plain version; the tests use it)."""
    return (
        paged_kernel_requested(mode, device)
        and mesh_absent
        and dtype in (torch.bfloat16, torch.float32)
        and (mode == "force" or device.type == "cuda")
    )


# ---------------------------------------------------------------------------
# later slices
# ---------------------------------------------------------------------------

# option -> where ROADMAP.md §A item 8 queues it
_LATER_SLICES = {
    "SELDON_TPU_CHUNK_IMPL=ring": "8.1, the ring chunk / ChunkTransformerLM",
    "prefix_cache": "8.2, the prefix cache",
    "max_steps_per_call": "8.3, the steps ladder and evict/stall",
    "chunk_token_budget": "8.4, chunked prefill",
    "max_queue": "8.5, SLO/deadlines and the bounded queue",
    "predict_stream": "8.6, predict_stream",
    "SELDON_TPU_KV_DTYPE=int8": "8.7, the int8 KV pool (kernels K4/K5 int8)",
    "max_adapters": "8.8, LoRA with the K4 fold",
    "adapters": "8.8, LoRA with the K4 fold",
    "speculative": "8.9, speculative decoding",
    "drain": "8.10, drain/migration/KV tier",
    "quantize": "queue item 7, int8 / w8a8",
    "precision": "queue item 7, int8 / w8a8",
    "tp/dp/mesh": "queue item 12, parallel/*",
}


def _refuse(option: str) -> MicroserviceError:
    return MicroserviceError(
        f"{option} is not ported yet: it comes with a later slice of the PyTorch port "
        f"(ROADMAP.md §A, {_LATER_SLICES[option]})",
        status_code=400,
        reason="BAD_PARAMETER",
    )


def check_ported_options(*, prefix_cache=None, chunk_token_budget=0, steps_per_call=8,
                         max_steps_per_call=0, speculative=None, max_adapters=0, adapters=None,
                         quantize="", precision="", tp=None, dp=None, mesh=None, max_queue=0) -> None:
    """Raise for every option of the JAX engine this slice does not
    run, and for the env knobs that select one (int8 KV, the ring
    chunk, the prefix cache)."""
    if prefix_cache is None:
        prefix_cache = _knobs.flag("SELDON_TPU_PREFIX_CACHE")
    checks = (
        ("prefix_cache", bool(prefix_cache)),
        ("chunk_token_budget", int(chunk_token_budget or 0) > 0),
        ("max_steps_per_call", int(max_steps_per_call or 0) > int(steps_per_call)),
        ("speculative", bool(speculative)),
        ("max_adapters", int(max_adapters or 0) > 0),
        ("adapters", bool(adapters)),
        ("quantize", bool(quantize)),
        ("precision", (precision or "bf16") != "bf16"),
        ("tp/dp/mesh", int(tp or 0) > 1 or int(dp or 0) > 1 or bool(mesh)),
        ("max_queue", int(max_queue or 0) > 0),
    )
    for option, set_ in checks:
        if set_:
            raise _refuse(option)
    kv_dtype = _knobs.raw("SELDON_TPU_KV_DTYPE", "bf16") or "bf16"
    if kv_dtype == "int8":
        raise _refuse("SELDON_TPU_KV_DTYPE=int8")
    if kv_dtype != "bf16":
        raise ValueError(f"SELDON_TPU_KV_DTYPE={kv_dtype!r}: supported values are 'bf16' "
                         "(native pool dtype) and 'int8'")
    chunk_impl = _knobs.raw("SELDON_TPU_CHUNK_IMPL", "") or "pool"
    if chunk_impl == "ring":
        raise _refuse("SELDON_TPU_CHUNK_IMPL=ring")
    if chunk_impl != "pool":
        raise ValueError(f"SELDON_TPU_CHUNK_IMPL={chunk_impl!r}: supported values are 'pool' and 'ring'")


# ---------------------------------------------------------------------------
# device half: the paged model and the pool write
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _head_scale(head_dim: int, dtype: torch.dtype) -> float:
    """``1 / sqrt(head_dim)`` the way the JAX block forms it: the root in
    float32, cast to the model dtype, inverted in the model dtype.  The
    value is exact in the model dtype, so multiplying by it as a Python
    float rounds as multiplying by the dtype's scalar does, and no
    host-to-device copy (a stream synchronisation) happens per layer."""
    return float(1.0 / torch.tensor(math.sqrt(head_dim), dtype=torch.float32).to(dtype))


class PagedTransformerBlock(TransformerBlock):
    """TransformerBlock whose attention reads a paged K/V pool.

    Returns this call's K/V instead of writing them: the caller owns the
    pool write (:func:`write_kv`)."""

    def forward(self, x, pk, pv, block_tables, lengths, use_kernel: bool = False):
        # x (B, L, d); pk/pv (num_pages, ps, h, hd); block_tables (B, P)
        # int32; lengths (B,) int32 tokens already in the pool
        batch, seg_len, d_model = x.shape
        heads = self.num_heads
        head_dim = d_model // heads
        q, k, v = self.qkv_heads(x)
        scale = _head_scale(head_dim, q.dtype)
        if use_kernel and seg_len == 1:
            # kernel lane: K4/K5 over the pool, then the current token
            # merged by the flash rule in float32
            q1 = (q * scale)[:, 0]  # (B, h, hd), in the model dtype
            acc, m, l = kernels.paged_attention_decode(q1, pk, pv, block_tables, lengths, page_size=pk.shape[1])
            q_self, k_self, v_self = q1.float(), k[:, 0].float(), v[:, 0].float()
            s_self = torch.einsum("bhd,bhd->bh", q_self, k_self)
            m2 = torch.maximum(m, s_self)
            alpha = torch.exp(m - m2)
            w_self = torch.exp(s_self - m2)
            l2 = l * alpha + w_self
            out = (acc * alpha[..., None] + v_self * w_self[..., None]) / l2[..., None]
            attn = out[:, None].to(x.dtype).reshape(batch, seg_len, d_model)
        else:
            # gather lane: scores in the model dtype masked with its
            # finfo.min, softmax in float32, weights cast back
            gk = pk[block_tables]  # (B, P, ps, h, hd)
            gv = pv[block_tables]
            cache_len = gk.shape[1] * gk.shape[2]
            gk = gk.reshape(batch, cache_len, heads, head_dim)
            gv = gv.reshape(batch, cache_len, heads, head_dim)
            qs = q * scale
            sc = torch.einsum("bqhd,bkhd->bhqk", qs, gk)
            ss = torch.einsum("bqhd,bkhd->bhqk", qs, k)
            neg = torch.finfo(sc.dtype).min
            cache_mask = torch.arange(cache_len, device=x.device)[None, :] < lengths[:, None]
            sc = torch.where(cache_mask[:, None, None, :], sc, neg)
            pos = torch.arange(seg_len, device=x.device)
            ss = torch.where((pos[None, :] <= pos[:, None])[None, None], ss, neg)
            weights = torch.softmax(torch.cat([sc, ss], dim=-1).float(), dim=-1).to(q.dtype)
            wc, ws = weights[..., :cache_len], weights[..., cache_len:]
            attn = (torch.einsum("bhqk,bkhd->bqhd", wc, gv) + torch.einsum("bhqk,bkhd->bqhd", ws, v))
            attn = attn.reshape(batch, seg_len, d_model)
        return self.mlp_tail(x, attn), k, v


class PagedTransformerLM(TransformerLM):
    """TransformerLM forward against a paged pool; the same parameters as
    :class:`TransformerLM` (one ``state_dict`` loads into either)."""

    block_cls = PagedTransformerBlock

    def forward(self, tokens, positions, pages_k, pages_v, block_tables, lengths, *,
                use_kernel: bool = False, select: Optional[torch.Tensor] = None):
        """-> ``(logits, new_k, new_v)``: float32 logits (B, L, vocab) and
        this call's K/V (layers, B, L, h, hd) for the caller to write.
        ``select`` (B,) keeps one position per row before the head, so
        the logits are (B, 1, vocab); the head is per position, so the
        kept rows are those of the full call.  Token ids wrap modulo the
        vocabulary, as ``jnp.take`` does, so a finished lane's ``eos_id``
        of -1 embeds like the JAX engine's."""
        x = self.embed(torch.remainder(tokens.long(), self.vocab_size), positions)
        new_k, new_v = [], []
        for i, block in enumerate(self.blocks):
            x, k, v = block(x, pages_k[i], pages_v[i], block_tables, lengths, use_kernel)
            new_k.append(k)
            new_v.append(v)
        if select is not None:
            x = x[torch.arange(x.shape[0], device=x.device), select.long()][:, None]
        return self.logits(x), torch.stack(new_k), torch.stack(new_v)


def write_kv(pk, pv, new_k, new_v, block_tables, start, valid, *, page_size, max_len,
             from_zero: bool = False):
    """Write (layers, B, L, h, hd) K/V into the pools (layers, pages, ps,
    h, hd) in place, and return them.

    ``start`` (B,): each row's first absolute position; ``valid`` (B, L):
    tokens that are real, the others go to trash page 0 at their offset.
    ``from_zero`` (prefill): rows start at position 0 and every position
    below L is written to its row's page ``block_tables[b, pos // ps]``,
    pad positions included (a row's unallocated pages are 0 in its
    table, so they land in the trash page); attention masks by length,
    and later tokens overwrite them.  Positions are clamped to
    ``max_len - 1``.  Writes to distinct (page, offset) pairs are
    exact; which of several writes to the trash page lands is
    unspecified, as nothing reads it."""
    L, B, S = new_k.shape[:3]
    tail = new_k.shape[3:]
    offs = torch.arange(S, device=new_k.device)
    if from_zero:
        pos = offs[None, :].expand(B, S)
        page = block_tables.long().gather(1, pos // page_size)
    else:
        pos = torch.clamp(start.long()[:, None] + offs[None, :], max=max_len - 1)
        idx = torch.clamp(pos // page_size, max=block_tables.shape[1] - 1)
        page = torch.where(valid, block_tables.long().gather(1, idx), 0)
    page, row = page.reshape(-1), (pos % page_size).reshape(-1)
    pk[:, page, row] = new_k.reshape(L, B * S, *tail)
    pv[:, page, row] = new_v.reshape(L, B * S, *tail)
    return pk, pv


# ---------------------------------------------------------------------------
# host half: the engine
# ---------------------------------------------------------------------------

class _Stream:
    """One in-flight generation request bound to a slot."""

    __slots__ = ("req_id", "prompt", "max_new", "temperature", "top_k", "eos_id", "seed", "tokens",
                 "event", "result", "error", "slot", "pages", "cancelled", "generator")

    def __init__(self, req_id, prompt, max_new, temperature, top_k, eos_id, seed):
        self.req_id = req_id
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.top_k = top_k
        self.eos_id = eos_id
        self.seed = seed
        self.tokens: List[int] = []
        self.event = threading.Event()
        self.result: Optional[np.ndarray] = None
        self.error: Optional[Exception] = None
        self.slot: Optional[int] = None
        self.pages: List[int] = []
        self.cancelled = False
        # the stream's sampler, seeded from `seed` when its prefill ends
        self.generator: Optional[torch.Generator] = None


def _resolve_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.bfloat16
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise MicroserviceError(f"unknown dtype {dtype!r} (supported: bfloat16, float32)",
                                status_code=400, reason="BAD_DTYPE") from None


class PagedEngine:
    """Continuous-batching decode engine over a paged K/V pool.

    ``submit()`` from any thread; ``step()`` (or the decode loop of
    :class:`StreamingLM`) admits queued streams, prefills them by prompt
    bucket, and advances every active stream by ``steps_per_call``
    tokens in one chunk.  ``params`` is a ``TransformerLM`` state_dict
    (``load_lm_params`` or ``models.convert.lm_params_from_flax``).
    """

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
        num_pages: Optional[int] = None,
        max_slots: int = 8,
        steps_per_call: int = 8,
        max_steps_per_call: int = 0,
        dtype: Any = None,
        device: Any = "cuda",
        mesh: Any = None,
        tp: Optional[int] = None,
        dp: Optional[int] = None,
        quantize: str = "",
        precision: str = "",
        speculative: Optional[Dict[str, Any]] = None,
        prefix_cache: Optional[bool] = None,
        max_queue: int = 0,
        chunk_token_budget: int = 0,
        max_adapters: int = 0,
    ):
        check_ported_options(
            prefix_cache=prefix_cache, chunk_token_budget=chunk_token_budget, steps_per_call=steps_per_call,
            max_steps_per_call=max_steps_per_call, speculative=speculative, max_adapters=max_adapters,
            quantize=quantize, precision=precision, tp=tp, dp=dp, mesh=mesh, max_queue=max_queue,
        )
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.dtype = _resolve_dtype(dtype)
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_stream = self.max_len // self.page_size
        self.max_slots = int(max_slots)
        self.steps_per_call = int(steps_per_call)
        # default pool = worst case (every slot full-length) + trash page
        self.num_pages = int(num_pages or self.max_slots * self.pages_per_stream + 1)
        self.prompt_buckets = _buckets_for(self.max_len)
        self.module = PagedTransformerLM(
            vocab_size=vocab_size, d_model=d_model, num_layers=num_layers, num_heads=num_heads,
            max_len=max_len, dtype=self.dtype,
        )
        self.module.load_state_dict(params)
        self.module = self.module.to(self.device).eval().requires_grad_(False)
        head_dim = d_model // num_heads
        pool_shape = (num_layers, self.num_pages, self.page_size, num_heads, head_dim)
        self.pages_k = torch.zeros(pool_shape, dtype=self.dtype, device=self.device)
        self.pages_v = torch.zeros(pool_shape, dtype=self.dtype, device=self.device)
        # which decode lane this engine runs (the `kernel_active` gauge)
        mode = paged_kernel_mode()
        self._kernel_active = paged_kernel_static_eligible(mode, True, self.dtype, self.device)
        if paged_kernel_explicit(mode) and not self._kernel_active:
            logger.warning("SELDON_TPU_PAGED_KERNEL=%s requested but the kernel lane cannot run here (it needs "
                           "a CUDA device unless 'force', and bf16/f32 pages): keeping the gather lane", mode)
        if self._kernel_active:
            kernels.paged_kernel_impl(num_heads, head_dim)  # a bad IMPL knob fails here, not mid-chunk
        # last logits of every slot: the next chunk samples from them
        self._logits = torch.zeros((self.max_slots, self.vocab_size), dtype=torch.float32, device=self.device)

        # host bookkeeping, guarded by _lock
        self._lock = threading.Lock()
        self._free_pages: Deque[int] = deque(range(1, self.num_pages))  # page 0 = trash
        self._queue: Deque[_Stream] = deque()
        self._slots: List[Optional[_Stream]] = [None] * self.max_slots
        self._block_tables = np.zeros((self.max_slots, self.pages_per_stream), np.int32)
        self._lengths = np.zeros((self.max_slots,), np.int32)
        self._next_id = 0
        self._closed = False
        self._counters = {"chunks": 0, "tokens": 0, "prefills": 0, "completed": 0}

    # ---- submission ------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0, top_k: int = 0,
               eos_id: int = -1, seed: int = 0) -> _Stream:
        """Queue one prompt (1-D int array).  Returns a stream handle whose
        ``event`` fires when ``result`` (``(max_new,)`` ids) is ready."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = len(prompt)
        if plen < 1:
            raise MicroserviceError("empty prompt", status_code=400, reason="BAD_REQUEST")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise MicroserviceError("max_new_tokens must be >= 1", status_code=400, reason="BAD_REQUEST")
        bucket = next((b for b in self.prompt_buckets if b >= plen), None)
        if bucket is None or plen + max_new_tokens > self.max_len:
            raise MicroserviceError(f"prompt {plen} + max_new {max_new_tokens} exceeds max_len {self.max_len}",
                                    status_code=400, reason="SEQUENCE_TOO_LONG")
        need = self._pages_for(plen, max_new_tokens)
        if need > self.num_pages - 1:
            raise MicroserviceError(f"request needs {need} pages but the pool holds {self.num_pages - 1}",
                                    status_code=400, reason="SEQUENCE_TOO_LONG")
        with self._lock:
            if self._closed:
                raise MicroserviceError("engine closed", status_code=503, reason="SHUTTING_DOWN")
            stream = _Stream(self._next_id, prompt, max_new_tokens, float(temperature), int(top_k),
                             int(eos_id), int(seed))
            self._next_id += 1
            self._queue.append(stream)
        return stream

    def _pages_for(self, plen: int, max_new: int) -> int:
        return -(-(plen + max_new) // self.page_size)

    # ---- page allocator + admission (caller holds _lock) -------------------

    def _alloc_locked(self, n: int) -> Optional[List[int]]:
        if len(self._free_pages) < n:
            return None
        return [self._free_pages.popleft() for _ in range(n)]

    def _free_locked(self, pages: List[int]) -> None:
        self._free_pages.extend(pages)

    def _admit_locked(self) -> List[_Stream]:
        """Move queued streams into free slots, FIFO.  A stream is admitted
        only with the pages for its prompt and all its new tokens; when
        the head of the queue does not fit, the wave stops (no shorter
        request overtakes it)."""
        admitted: List[_Stream] = []
        free_slots = deque(i for i in range(self.max_slots) if self._slots[i] is None)
        while self._queue and free_slots:
            stream = self._queue[0]
            pages = self._alloc_locked(self._pages_for(len(stream.prompt), stream.max_new))
            if pages is None:
                break
            self._queue.popleft()
            slot = free_slots.popleft()
            stream.slot, stream.pages = slot, pages
            self._slots[slot] = stream
            self._block_tables[slot] = 0
            self._block_tables[slot, : len(pages)] = pages
            self._lengths[slot] = len(stream.prompt)
            admitted.append(stream)
        return admitted

    # ---- prefill -------------------------------------------------------------

    def _pages_pow2(self, need_pages: int) -> int:
        """A page count rounded up to a power of two, capped at the
        per-stream table width (the JAX engine's shape ladder)."""
        p = 1
        while p < need_pages:
            p *= 2
        return min(p, self.pages_per_stream)

    def _prefill_group(self, bucket: int, group: List[_Stream]) -> None:
        """One batched prefill call for same-bucket prompts: ``k`` rows, a
        power of two; pad rows (one token, table row 0) write only the
        trash page.  Installs each stream's last-token logits."""
        k = 1
        while k < len(group):
            k *= 2
        pages_h = self._pages_pow2(-(-bucket // self.page_size))
        padded = np.zeros((k, bucket), np.int64)
        true_lens = np.ones((k,), np.int64)
        block_rows = np.zeros((k, pages_h), np.int32)
        for i, stream in enumerate(group):
            padded[i, : len(stream.prompt)] = stream.prompt
            true_lens[i] = len(stream.prompt)
            block_rows[i] = self._block_tables[stream.slot, :pages_h]
        dev = self.device
        tokens = torch.from_numpy(padded).to(dev)
        rows = torch.from_numpy(block_rows).to(dev)
        last_pos = torch.from_numpy(true_lens - 1).to(dev)
        positions = torch.arange(bucket, device=dev)[None, :].expand(k, bucket)
        zeros = torch.zeros((k,), dtype=torch.int32, device=dev)
        last, nk, nv = self.module(tokens, positions, self.pages_k, self.pages_v, rows, zeros,
                                   use_kernel=self._kernel_active, select=last_pos)
        write_kv(self.pages_k, self.pages_v, nk, nv, rows, zeros, None, page_size=self.page_size,
                 max_len=self.max_len, from_zero=True)
        slots = torch.tensor([s.slot for s in group], device=dev)
        self._logits[slots] = last[: len(group), 0]
        for stream in group:
            if stream.temperature > 0:
                stream.generator = torch.Generator(device=dev).manual_seed(stream.seed % (1 << 63))

    def _prefill(self, streams: List[_Stream]) -> None:
        """Prefill admitted streams, grouped by prompt bucket."""
        groups: Dict[int, List[_Stream]] = {}
        for stream in streams:
            bucket = next(b for b in self.prompt_buckets if b >= len(stream.prompt))
            groups.setdefault(bucket, []).append(stream)
        for bucket, group in groups.items():
            self._prefill_group(bucket, group)

    # ---- decode chunk ------------------------------------------------------

    def _pages_horizon(self, runnable: List[_Stream], per_chunk: int) -> int:
        """Block-table columns the next chunk needs: the longest runnable
        stream plus this chunk, in pages, rounded up to a power of two."""
        if not runnable:
            return 1
        need = max(int(self._lengths[s.slot]) for s in runnable) + per_chunk
        return self._pages_pow2(-(-need // self.page_size))

    def _sample_batch(self, logits: torch.Tensor, samplers) -> torch.Tensor:
        """Every slot's next token: greedy argmax, or, for the slots in
        ``samplers`` (slot, generator, temperature, top_k), a draw from
        ``softmax(logits / temperature)`` restricted to the top_k logits
        (Gumbel-max with the stream's own generator)."""
        token = torch.argmax(logits, dim=-1)
        for slot, generator, temperature, top_k in samplers:
            scaled = logits[slot] / max(temperature, 1e-6)
            if 0 < top_k < scaled.shape[-1]:
                cutoff = torch.topk(scaled, top_k).values[-1]
                scaled = torch.where(scaled >= cutoff, scaled, float("-inf"))
            u = torch.rand(scaled.shape, generator=generator, device=logits.device)
            gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
            token[slot] = torch.argmax(scaled + gumbel)
        return token

    def _chunk(self, steps: int, tables: np.ndarray, lengths: np.ndarray, done: np.ndarray,
               max_new: np.ndarray, eos_ids: np.ndarray, samplers) -> np.ndarray:
        """``steps`` decode steps of every slot as device work; one
        device-to-host copy at the end returns ``(B, steps + 2)``: the
        tokens, then each slot's emitted count and new length."""
        dev = self.device
        tables_t = torch.from_numpy(tables).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        done_t = torch.from_numpy(done).to(dev)
        max_new_t = torch.from_numpy(max_new).to(dev)
        eos_t = torch.from_numpy(eos_ids.astype(np.int64)).to(dev)
        emitted = torch.zeros_like(lengths_t)
        logits = self._logits
        toks = []
        for _ in range(steps):
            token = self._sample_batch(logits, samplers)
            active = ~done_t
            token = torch.where(active, token, eos_t)
            emitted = emitted + active.int()
            done_t = done_t | (token == eos_t) | (emitted >= max_new_t)
            positions = torch.clamp(lengths_t, max=self.max_len - 1)[:, None]
            new_logits, nk, nv = self.module(token[:, None], positions, self.pages_k, self.pages_v, tables_t,
                                             lengths_t, use_kernel=self._kernel_active)
            write_kv(self.pages_k, self.pages_v, nk, nv, tables_t, lengths_t, active[:, None],
                     page_size=self.page_size, max_len=self.max_len)
            logits = torch.where(active[:, None], new_logits[:, 0], logits)
            lengths_t = lengths_t + active.int()
            toks.append(token)
        self._logits = logits
        out = torch.cat([torch.stack(toks, dim=1), emitted[:, None].long(), lengths_t[:, None].long()], dim=1)
        return out.cpu().numpy()

    def step(self) -> bool:
        """Admit + prefill joiners, run one decode chunk, retire finished.
        Returns True while there is (or may be) more work."""
        with self._lock:
            admitted = self._admit_locked()
        if admitted:
            with torch.inference_mode():
                self._prefill(admitted)
        with self._lock:
            self._counters["prefills"] += len(admitted)
            active = self._retire_cancelled_locked([s for s in self._slots if s is not None])
            if not active:
                return bool(self._queue)
            steps = self.steps_per_call
            B = self.max_slots
            done = np.ones((B,), bool)
            max_new = np.zeros((B,), np.int32)
            eos_ids = np.full((B,), -1, np.int32)
            samplers = []
            for stream in active:
                s = stream.slot
                done[s] = False
                max_new[s] = stream.max_new - len(stream.tokens)
                eos_ids[s] = stream.eos_id
                if stream.temperature > 0:
                    samplers.append((s, stream.generator, stream.temperature, stream.top_k))
            pages_h = self._pages_horizon(active, steps)
            tables = np.ascontiguousarray(self._block_tables[:, :pages_h])
            lengths = self._lengths.copy()
        with torch.inference_mode():
            out = self._chunk(steps, tables, lengths, done, max_new, eos_ids, samplers)
        toks, emitted, lengths_out = out[:, :steps], out[:, steps], out[:, steps + 1]
        with self._lock:
            self._lengths = lengths_out.astype(np.int32)
            self._counters["chunks"] += 1
            for stream in active:
                n = int(emitted[stream.slot])
                self._counters["tokens"] += n
                got = toks[stream.slot, :n].tolist()
                stream.tokens.extend(got)
                if stream.eos_id in got or len(stream.tokens) >= stream.max_new:
                    self._finish_locked(stream)
            return bool(self._queue) or any(s is not None for s in self._slots)

    # ---- retirement ----------------------------------------------------------

    def _finish_locked(self, stream: _Stream) -> None:
        """Deliver ``(max_new,)`` ids, cut after the first eos and padded
        with eos, and free the slot and its pages."""
        slot = stream.slot
        toks = stream.tokens[: stream.max_new]
        if stream.eos_id in toks:
            toks = toks[: toks.index(stream.eos_id) + 1]
        toks = toks + [stream.eos_id] * (stream.max_new - len(toks))
        stream.result = np.asarray(toks, np.int32)
        self._slots[slot] = None
        self._free_locked(stream.pages)
        stream.pages = []
        self._lengths[slot] = 0
        self._block_tables[slot] = 0
        self._counters["completed"] += 1
        stream.event.set()

    def _retire_cancelled_locked(self, active: List[_Stream]) -> List[_Stream]:
        live = []
        for stream in active:
            if stream.cancelled:
                self._finish_locked(stream)
            else:
                live.append(stream)
        return live

    def cancel(self, stream: _Stream) -> None:
        """Abandon a stream: a queued one resolves at once (eos-padded); an
        in-slot one is flagged and retired before the next chunk, never
        mid-chunk."""
        with self._lock:
            if stream.result is not None or stream.error is not None:
                return
            if stream in self._queue:
                self._queue.remove(stream)
                toks = stream.tokens[: stream.max_new]
                stream.result = np.asarray(toks + [stream.eos_id] * (stream.max_new - len(toks)), np.int32)
                stream.event.set()
                return
            stream.cancelled = True

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(s is not None for s in self._slots)

    def engine_stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "kernel_active": int(self._kernel_active),
                "prefills": self._counters["prefills"],
                "chunks": self._counters["chunks"],
                "tokens": self._counters["tokens"],
                "completed": self._counters["completed"],
                "active": sum(s is not None for s in self._slots),
                "queued": len(self._queue),
                "free_pages": len(self._free_pages),
            }

    def close(self, exc: Optional[Exception] = None) -> None:
        """Shut the engine: later submits get 503, pending streams fail."""
        with self._lock:
            self._closed = True
        self.fail_all(exc or MicroserviceError("engine closed", status_code=503, reason="SHUTTING_DOWN"))

    def fail_all(self, exc: Exception) -> None:
        """Error out every queued and in-flight stream; the engine stays usable."""
        with self._lock:
            victims = [s for s in self._slots if s is not None] + list(self._queue)
            self._queue.clear()
            self._slots = [None] * self.max_slots
            self._lengths[:] = 0
            self._block_tables[:] = 0
            for stream in victims:
                self._free_locked(stream.pages)
                stream.pages = []
                stream.error = exc
                stream.event.set()

    def run(self) -> None:
        """Drain everything synchronously (tests, batch jobs)."""
        while self.has_work():
            self.step()

    def generate(self, prompt, **kw) -> np.ndarray:
        stream = self.submit(np.asarray(prompt), **kw)
        self.run()
        if stream.error:
            raise stream.error
        return stream.result


# ---------------------------------------------------------------------------
# the served component
# ---------------------------------------------------------------------------

class StreamingLM(TPUComponent):
    """Deployable continuous-batching generation component.

    Concurrent ``predict`` calls share one :class:`PagedEngine`: each
    request's rows become streams, one decode-loop thread steps the
    engine (and is the only thread that touches the device), and every
    caller waits only for its own streams.  Per-request overrides via
    ``meta.tags``: ``max_new_tokens``, ``temperature``, ``top_k``,
    ``seed``.  Runs on ``cuda`` unless ``device="cpu"``; ``dtype`` is
    bfloat16 unless ``float32``.
    """

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
        page_size: int = 64,
        num_pages: int = 0,
        max_slots: int = 8,
        steps_per_call: int = 8,
        max_steps_per_call: int = 0,
        mesh_axes: Optional[Dict[str, int]] = None,
        tp: int = 0,
        dp: int = 0,
        quantize: str = "",
        precision: str = "",
        speculative: Optional[Dict[str, Any]] = None,
        prefix_cache: Optional[bool] = None,
        max_queue: int = 0,
        chunk_token_budget: int = 0,
        max_adapters: int = 0,
        adapters: Any = None,
        device: str = "cuda",
        dtype: str = "bfloat16",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        check_ported_options(
            prefix_cache=prefix_cache, chunk_token_budget=chunk_token_budget, steps_per_call=steps_per_call,
            max_steps_per_call=max_steps_per_call, speculative=speculative, max_adapters=max_adapters,
            adapters=adapters, quantize=quantize, precision=precision, tp=tp, dp=dp, mesh=mesh_axes,
            max_queue=max_queue,
        )
        self.device = resolve_device(device)
        self.dtype_name = dtype
        self.dtype = _resolve_dtype(dtype)
        self.config = dict(vocab_size=int(vocab_size), d_model=int(d_model), num_layers=int(num_layers),
                           num_heads=int(num_heads), max_len=int(max_len))
        self.engine_config = dict(page_size=int(page_size), num_pages=int(num_pages) or None,
                                  max_slots=int(max_slots), steps_per_call=int(steps_per_call))
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.eos_id = int(eos_id)
        self.model_uri = model_uri
        self.seed = int(seed)
        self.engine: Optional[PagedEngine] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stop = False
        self._load_lock = threading.Lock()
        self._counter = 0
        self._counter_lock = threading.Lock()
        self._load_time_s: Optional[float] = None

    def load(self) -> None:
        """Build the engine (seeded weights), warm it with one short
        generation, and start the decode loop.  Idempotent: a second
        call must not start a second loop over the same engine."""
        with self._load_lock:
            if self.engine is not None:
                return
            t0 = time.perf_counter()
            params = load_lm_params(self.model_uri, self.config, self.seed, self.device)
            engine = PagedEngine(params, dtype=self.dtype, device=self.device, **self.config,
                                 **self.engine_config)
            # first CUDA calls (library handles, the kernel build) pay here, not in a request
            engine.generate(np.zeros((1,), np.int32), max_new_tokens=2)
            self._loop_thread = threading.Thread(target=self._loop, name="streaminglm-decode", daemon=True)
            self.engine = engine  # published after construction; the loop reads it
            self._loop_thread.start()
            self._load_time_s = time.perf_counter() - t0
            logger.info("streaminglm loaded on %s in %.2fs (kernel lane %s)", self.device, self._load_time_s,
                        "on" if engine._kernel_active else "off")

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop:
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            try:
                while self.engine.has_work():
                    if self._stop:
                        break
                    self.engine.step()
            except Exception as exc:  # noqa: BLE001 — surfaced to every waiter
                logger.exception("decode loop failed")
                self.engine.fail_all(exc)
        self.engine.close(MicroserviceError("component shut down", status_code=503, reason="SHUTTING_DOWN"))

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()

    def unload(self) -> None:
        self.shutdown()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=30)

    def _request_seed(self, tags, meta) -> int:
        """Explicit ``seed`` tag, else a hash of the request puid, else a
        per-process counter."""
        if "seed" in tags:
            return int(tags["seed"])
        puid = meta.get("puid", "")
        if puid:
            return zlib.crc32(puid.encode())
        with self._counter_lock:
            self._counter += 1
            return self._counter

    def predict(self, X, names, meta=None):
        if self.engine is None:
            self.load()
        meta = meta or {}
        tags = meta.get("tags", {})
        max_new = int(tags.get("max_new_tokens", self.max_new_tokens))
        temperature = float(tags.get("temperature", self.temperature))
        top_k = int(tags.get("top_k", self.top_k))
        request_seed = self._request_seed(tags, meta)
        X = np.atleast_2d(np.asarray(X, np.int32))
        streams = []
        try:
            for i, row in enumerate(X):
                streams.append(self.engine.submit(
                    row, max_new_tokens=max_new, temperature=temperature, top_k=top_k, eos_id=self.eos_id,
                    seed=self.seed ^ (request_seed * 1000003 + i),
                ))
            self._wake.set()
            for stream in streams:
                stream.event.wait()
                if stream.error:
                    raise stream.error
            return np.stack([s.result for s in streams])
        except BaseException:
            # one row failed: its siblings must not keep decoding unread
            for s in streams:
                if s.result is None and s.error is None:
                    self.engine.cancel(s)
            raise

    def predict_stream(self, X, names=None, meta=None):
        raise _refuse("predict_stream")

    def drain(self, *args, **kwargs):
        raise _refuse("drain")

    def class_names(self):
        return []

    def metrics(self):
        if self.engine is None:
            return []
        s = self.engine.engine_stats()
        out = [
            gauge_metric("paged_active_slots", s["active"]),
            gauge_metric("paged_queued_streams", s["queued"]),
            gauge_metric("paged_chunks", s["chunks"]),
            gauge_metric("paged_tokens_emitted", s["tokens"]),
            gauge_metric("paged_streams_completed", s["completed"]),
            gauge_metric("paged_free_pages", s["free_pages"]),
            gauge_metric("paged_kernel_active", s["kernel_active"]),
        ]
        for name, n in kernels.launch_counts().items():
            out.append(gauge_metric("streaminglm_kernel_launches", float(n), tags={"kernel": name}))
        return out

    def health_status(self):
        engine = self.engine
        return {
            "model": "streaminglm",
            "loaded": engine is not None,
            "device": str(self.device),
            "device_name": torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu",
            "dtype": self.dtype_name,
            "load_time_s": self._load_time_s,
            "kernel_active": bool(engine is not None and engine._kernel_active),
            "kernel_launches": kernels.launch_counts(),
            "engine": engine.engine_stats() if engine is not None else {},
        }
