"""Paged KV-cache + continuous batching for autoregressive serving.

The port's counterpart of ``seldon_core_tpu/models/paged.py``: both
decode chunks, the split pool layout ``(layers, pages, page_size,
heads, head_dim)``, greedy or sampled decoding, token streaming.

* **Pool dtype** — pages in the engine's dtype, or int8 under
  ``SELDON_TPU_KV_DTYPE=int8``: one float32 scale per page per K/V in
  the ``(layers, num_pages)`` tables ``scales_k`` / ``scales_v``, half
  the pool bytes.  Writes requantise whole pages (:func:`write_kv`); the
  decode kernel dequantises in-register, the gather lane right after the
  page fetch.
* **Multi-LoRA** — ``max_adapters`` slots of a factor pool
  (``ops/lora.py``) beside the KV pool; each stream names its adapter at
  submit (``meta.tags.adapter`` / ``X-Seldon-Adapter`` through
  :class:`StreamingLM`), pins its slot for its lifetime, and every
  projection adds its lane's delta.  On the kernel lane with the
  ``stream`` kernel the qkv delta folds into K4's launch.

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
* **Decode chunks** — ``SELDON_TPU_CHUNK_IMPL``, chosen as the JAX
  engine chooses: the pool chunk (each step attends over the pool: the
  kernel lane or the gather lane) where the kernel lane can run, the
  ring chunk elsewhere (the context gathered from the pool once a
  chunk, the chunk's own K/V in a step-indexed ring, dense products
  only, one write-back a chunk).  Both can split a chunk's lanes into
  two length buckets (``SELDON_TPU_CTX_BUCKETS``; unset, on off CUDA and
  off on a CUDA device, where each bucket costs a launch a layer-step):
  the shorter half of the running lanes attends at its own table width.
* **One host round trip per chunk** — a chunk's ``steps_per_call``
  decode steps, sampling included, run as device work, and its tokens
  come back in one device-to-host copy.
* **Token streaming** — ``submit(stream_tokens=True)`` pushes each
  chunk's new tokens on the stream's queue as they land;
  ``StreamingLM.predict_stream`` serves them, and the gateway streams
  them over SSE and ``Seldon/GenerateStream`` (``engine/``).

* **Scheduler** — the JAX engine's, under its names: admission with
  the prompt's pages from a refcounted allocator, growth a chunk at a
  time, stall and then evict under pool pressure; a prefix index of
  full prompt pages, hash-chained per weight set, shared by refcount
  (``SELDON_TPU_PREFIX_CACHE``, on by default); the steps ladder
  (``max_steps_per_call``); priorities, deadlines and the bounded queue
  that sheds and preempts (``max_queue``); chunked prefill under a
  token budget (``chunk_token_budget``).  ``SELDON_TPU_PAGED_DEBUG=1``
  audits the allocator at every chunk boundary.
* **Precision lanes** — ``quantize="int8"`` rests the kernels int8 and
  dequantises them once per device call; ``precision="w8a8"`` makes
  every projection and the head a ``W8A8Dense`` whose integers and
  steps are fixed at construction, with dynamic per-token activation
  scales, so no weight is quantised in a call or a step.
* **Speculative decoding** — ``speculative={"draft": "ngram" | "oracle"
  | "model", "draft_k": k, ...}``: each wave drafts up to ``k`` tokens a
  stream (prompt lookup, the caller's ``draft_hint``, or a small draft
  ``TransformerLM`` over a sliding window) and verifies every stream's
  drafts in one forward of ``k + 1`` positions on the gather lane.
  Every emitted token is the target's own argmax, so greedy tokens
  equal plain decode's; sampling is refused.

* **Drain, migration and the KV tier** — ``drain()`` journals every
  live stream's re-derivation recipe (:func:`journal_entry`) and
  ``replay()`` re-submits it, so a respawned process re-derives them
  (``StreamingLM`` writes the journal on SIGTERM to
  ``SELDON_TPU_DRAIN_JOURNAL`` and replays it on load);
  ``migrate_export`` / ``migrate_import`` move mid-decode streams to a
  peer engine with their K/V pages, decode cursor and sampler state, in
  process (``models/disagg.evacuate_streams``) or as a migration
  container (``SELDON_TPU_EVACUATE_TO``); ``prefill_export`` /
  ``submit_prefilled`` hand a prefilled prompt's pages over; and
  ``SELDON_TPU_KV_OFFLOAD=1`` demotes reclaimed prefix pages to a host /
  disk tier (``models/kvtier.py``) and promotes them back on a chain hit.
  Pages move with plain tensor indexing (the JAX engine's ``.at[].set``
  and gathers are XLA ops, not kernels); a resumed stream decodes on K4.

* **Telemetry and chaos** — a per-wave flight recorder (the JAX
  engine's record keys, ``engine_stats(detail=True)``), gen.* lifecycle
  spans through the tracer ring, the cost ledger (page-seconds, tokens,
  preemptions by stream and by adapter), the NaN screen (one more column
  of the chunk's one device-to-host copy; a non-finite lane's stream
  retires 500 ``NUMERIC_POISON``), the health watchdog
  (``engine_stats()["health"]``, which ``models/disagg.evacuate_streams``
  reads), request capture (``capture_trigger`` / ``capture_request``),
  and the fault points ``paged.alloc`` / ``paged.chunk`` / ``paged.nan``
  (``utils/faults.py``).  Each has its knob and its off lane, as in JAX.

Decisions of this slice:

* sampling draws from one ``torch.Generator`` per stream, seeded from
  the stream's seed when its prompt is whole (again after an eviction):
  greedy tokens equal the JAX engine's, sampled tokens cannot equal
  ``jax.random``'s.  A migration carries the generator's state in the
  container's ``key_data`` frame (uint32 words of ``get_state()``); a
  sampled stream whose state is not one of the engine's generator kind
  (a JAX key, a CPU state sent to a CUDA engine) is refused with 400
  ``RNG_STATE_MISMATCH``, and the evacuation journals it;
* the pool is always the split layout: a flat (rank-4) container is
  refused with the JAX engine's geometry message, never reshaped;
* a mesh (``mesh``, ``tp`` / ``dp``, ``SELDON_TPU_TP`` / ``SELDON_TPU_DP``)
  runs the explicit programs of ``parallel/tp.py`` on the gather lane or
  the ring chunk, never the kernel lane, as the JAX engine does; the pool
  keeps the split layout there too;
* an unknown ``SELDON_TPU_CHUNK_IMPL`` raises, where the JAX engine runs
  the ring chunk for it;
* ``model_uri`` and an adapter's ``{"uri": ...}`` name flax msgpack
  checkpoints, read without flax (``models/generate.py``,
  ``utils/serialization.py``).
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import queue
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from seldon_core_tpu_torch.models.cudaserver import resolve_device
from seldon_core_tpu_torch.models.generate import RequestSeeds, _buckets_for, load_lm_params
from seldon_core_tpu_torch.models.transformer import TransformerBlock, TransformerLM
from seldon_core_tpu_torch.models.transformer import head_scale as _head_scale
from seldon_core_tpu_torch.ops import kernels
from seldon_core_tpu_torch.ops.lora import LORA_TARGETS, LoraPool, make_lora_params, target_dims
from seldon_core_tpu_torch.ops.surgery import (QuantizedKernel, quantize_mode_for, quantize_params,
                                               validate_precision, validate_quantize_mode)
from seldon_core_tpu_torch.ops.w8a8 import W8A8Dense, quantize_weight
from seldon_core_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, mesh_from_axes, resolve_mesh
from seldon_core_tpu_torch.parallel.sharding import ShardedTensor, pool_spec
from seldon_core_tpu_torch.parallel.tp import write_kv_mesh
from seldon_core_tpu_torch.runtime import knobs as _knobs
from seldon_core_tpu_torch.runtime.component import MicroserviceError, TPUComponent, gauge_metric
from seldon_core_tpu_torch.utils import faults as _faults
from seldon_core_tpu_torch.utils import telemetry as _telemetry
from seldon_core_tpu_torch.utils.jitwatch import JitSentinel
from seldon_core_tpu_torch.utils.deadlines import (clamp_priority, current_deadline, deadline_exceeded,
                                                   normalize_adapter)

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


def paged_kv_dtype_mode() -> str:
    """``SELDON_TPU_KV_DTYPE``: "bf16" (default: pages in the engine's
    dtype) | "int8"; anything else raises."""
    mode = _knobs.raw("SELDON_TPU_KV_DTYPE", "bf16") or "bf16"
    if mode not in ("bf16", "int8"):
        raise ValueError(f"SELDON_TPU_KV_DTYPE={mode!r}: supported values are 'bf16' "
                         "(native pool dtype) and 'int8'")
    return mode


def paged_kv_int8(mesh_absent: bool, chunk_impl: str) -> bool:
    """Whether the engine's pool is int8: asked for, and the single-device
    pool chunk (the ring chunk would need a third dequantisation site);
    otherwise a WARN and the native pool, as in the JAX engine."""
    if paged_kv_dtype_mode() != "int8":
        return False
    if not mesh_absent or chunk_impl != "pool":
        logger.warning("SELDON_TPU_KV_DTYPE=int8 requested but the int8 KV pool is single-device pool-chunk "
                       "only (mesh=%s, chunk_impl=%s): keeping the native pool dtype", not mesh_absent, chunk_impl)
        return False
    return True


def paged_chunk_impl_env() -> str:
    """``SELDON_TPU_CHUNK_IMPL``: "" (unset: the engine picks), "pool" or
    "ring"; anything else raises (the JAX engine runs the ring body for
    any value but "pool")."""
    impl = _knobs.raw("SELDON_TPU_CHUNK_IMPL", "") or ""
    if impl not in ("", "pool", "ring"):
        raise ValueError(f"SELDON_TPU_CHUNK_IMPL={impl!r}: supported values are 'pool' and 'ring'")
    return impl


def resolve_chunk_impl(kernel_mode: str, kernel_eligible: bool) -> str:
    """The decode chunk an engine runs (the JAX engine's rule, its
    ``paged.py:1552-1583``): unset means the pool chunk where the kernel
    lane can run and the ring chunk elsewhere; an explicit choice wins.
    An explicit kernel opt-in that the chosen chunk never reaches WARNs."""
    asked = paged_chunk_impl_env()
    impl = asked or ("pool" if kernel_eligible else "ring")
    if not paged_kernel_explicit(kernel_mode):
        return impl
    if asked == "ring":
        logger.warning("SELDON_TPU_PAGED_KERNEL is set but SELDON_TPU_CHUNK_IMPL=ring: the ring chunk never "
                       "launches the paged decode kernel; set SELDON_TPU_CHUNK_IMPL=pool to run it")
    elif not kernel_eligible:
        logger.warning("SELDON_TPU_PAGED_KERNEL=%s requested but the kernel lane cannot run here (it needs a "
                       "CUDA device unless 'force', and bf16/f32 pages): keeping the %s", kernel_mode,
                       "gather lane" if impl == "pool" else "ring chunk")
    return impl


def paged_ctx_buckets(device: torch.device) -> int:
    """``SELDON_TPU_CTX_BUCKETS``: 1 or 2; anything else raises with the
    JAX engine's message.  Unset, the default follows the engine's
    device: 1 on a CUDA device, where each bucket is one more K4 launch
    a layer-step on a host-paced loop and two buckets decoded slower
    than one in every card run (``ROADMAP.md`` C19), and 2, the JAX
    engine's default, elsewhere."""
    val = _knobs.raw("SELDON_TPU_CTX_BUCKETS", "") or ("1" if device.type == "cuda" else "2")
    if val not in ("1", "2"):
        raise ValueError(f"SELDON_TPU_CTX_BUCKETS={val!r}: supported values are '1' (disable) and '2' (default)")
    return int(val)


def check_ported_options() -> None:
    """Raise for an unknown ``SELDON_TPU_KV_DTYPE`` at construction."""
    paged_kv_dtype_mode()


# the KV tier's counters: engine_stats sheds them with the tier off; a
# flight-recorder record carries the wave's delta of the second tuple
# when the tier is on
_TIER_COUNTER_KEYS = (
    "kv_tier_demotions", "kv_tier_promotions", "kv_tier_host_hits",
    "kv_tier_disk_hits", "kv_tier_misses", "kv_tier_evictions",
    "kv_tier_bytes_demoted", "kv_tier_bytes_promoted",
)
_TIER_DELTA_KEYS = ("kv_tier_demotions", "kv_tier_promotions", "kv_tier_host_hits", "kv_tier_disk_hits")

# the lifecycle counters whose per-wave deltas every record carries
_SLO_COUNTER_KEYS = ("shed", "expired", "preempted", "restored", "drained", "replayed", "quarantined")

# process-wide sequence of StreamingLM bridges: one model_name per engine
_BRIDGE_SEQ = 0
_BRIDGE_SEQ_LOCK = threading.Lock()


def journal_entry(*, req_id: Any, prompt: List[int], max_new_tokens: int, temperature: float = 0.0, top_k: int = 0,
                  eos_id: int = -1, seed: int = 0, priority: int = 0, deadline_remaining_ms: Optional[float] = None,
                  streamed: int = 0, stream_tokens: bool = False, tokens_decoded: int = 0,
                  adapter: Optional[str] = None) -> Dict[str, Any]:
    """The drain journal's entry, the one key set :meth:`PagedEngine.replay`
    reads (the JAX package's ``paged.py:1343``): a live stream's
    (:meth:`PagedEngine._journal_entry`) and a migration payload's
    (``models/disagg.migration_journal_entry``) both go through here."""
    return {
        "req_id": req_id,
        "prompt": prompt,
        "max_new_tokens": int(max_new_tokens),
        "temperature": float(temperature),
        "top_k": int(top_k),
        "eos_id": int(eos_id),
        "seed": int(seed),
        "priority": int(priority),
        "deadline_remaining_ms": deadline_remaining_ms,
        "streamed": int(streamed),
        "stream_tokens": bool(stream_tokens),
        "tokens_decoded": int(tokens_decoded),
        "adapter": adapter,
    }


def _host_tensor(x) -> torch.Tensor:
    """A payload's page stack or scale table as a CPU tensor: a tensor
    as it is, a numpy array as one (a bfloat16 array of the JAX package,
    ``ml_dtypes``, through its 16-bit words)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)
    return torch.from_numpy(a)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# the prefix index's keys (the JAX package's paged.py:1162-1197)
# ---------------------------------------------------------------------------

# the chain root of the base model's weights; an adapter chains off a
# root of its own (PagedEngine._prefix_root_for)
_PREFIX_ROOT = 0x9E3779B97F4A7C15


def prefix_chain_key(parent: int, tokens: Tuple[int, ...]) -> int:
    """Key of the prefix ending at a full page: ``parent`` is the key of
    the page before (``_PREFIX_ROOT`` for page 0), ``tokens`` the page's
    ids.  Module-level so a test can make every key collide: entries
    compare their tokens before sharing, so a collision degrades to a
    private prefill, never to another stream's K/V."""
    return hash((parent, tokens))


class _CachedPrefix:
    """One registered full prompt page of the prefix index: its K/V is a
    function of the token chain its key encodes, so any stream whose
    prompt starts with that chain may map the page read-only."""

    __slots__ = ("key", "page", "tokens", "parent")

    def __init__(self, key: int, page: int, tokens: Tuple[int, ...], parent: int):
        self.key = key
        self.page = page
        self.tokens = tokens
        self.parent = parent


# ---------------------------------------------------------------------------
# device half: the paged model and the pool write
# ---------------------------------------------------------------------------

def _bucket_slices(tables):
    """``(table, lane slice)`` of each length bucket: ``tables`` is one
    (B, P) table or a tuple of per-bucket tables whose lanes arrive
    bucket-sorted, ``sum(Bb) == B``."""
    if not isinstance(tables, (tuple, list)):
        tables = (tables,)
    out, off = [], 0
    for tb in tables:
        out.append((tb, slice(off, off + tb.shape[0])))
        off += tb.shape[0]
    return out


def _cat(parts):
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def gather_attention(q, k, v, gk, gv, lengths, scale):
    """The gather lane's attention for one bucket's lanes: ``q`` / ``k`` /
    ``v`` (nb, L, h, hd) of this call, ``gk`` / ``gv`` (nb, P, ps, h, hd)
    the lanes' gathered pages, ``lengths`` (nb,) the tokens already in
    them.  Scores in the model dtype masked with its finfo.min (the cache
    past each length, the call's own future), one float32 softmax over
    both, the weights cast back."""
    nb, seg_len, heads, head_dim = q.shape
    cache_len = gk.shape[1] * gk.shape[2]
    gk = gk.reshape(nb, cache_len, heads, head_dim)
    gv = gv.reshape(nb, cache_len, heads, head_dim)
    qs = q * scale
    sc = torch.einsum("bqhd,bkhd->bhqk", qs, gk)
    ss = torch.einsum("bqhd,bkhd->bhqk", qs, k)
    neg = torch.finfo(sc.dtype).min
    cache_mask = torch.arange(cache_len, device=q.device)[None, :] < lengths[:, None]
    sc = torch.where(cache_mask[:, None, None, :], sc, neg)
    pos = torch.arange(seg_len, device=q.device)
    ss = torch.where((pos[None, :] <= pos[:, None])[None, None], ss, neg)
    weights = torch.softmax(torch.cat([sc, ss], dim=-1).float(), dim=-1).to(q.dtype)
    wc, ws = weights[..., :cache_len], weights[..., cache_len:]
    return torch.einsum("bhqk,bkhd->bqhd", wc, gv) + torch.einsum("bhqk,bkhd->bqhd", ws, v)


def ring_step_attention(q, k, v, ck, cv, ring_k, ring_v, step: int, len0, scale):
    """One ring-chunk step's attention for one bucket's lanes: three score
    products (the context gathered at the chunk's start ``ck`` / ``cv``
    (nb, C, h, hd), columns at or past ``len0`` masked; the chunk's ring
    ``ring_k`` / ``ring_v`` (nb, S, h, hd), columns at or past ``step``
    masked; the current token), one float32 softmax over the three, the
    weights cast back and the three weighted sums added (JAX
    ``paged.py:432-512``)."""
    C, S = ck.shape[1], ring_k.shape[1]
    neg = torch.finfo(q.dtype).min
    qb = q * scale
    sc = torch.einsum("bqhd,bkhd->bhqk", qb, ck)
    sr = torch.einsum("bqhd,bkhd->bhqk", qb, ring_k)
    ss = torch.einsum("bqhd,bkhd->bhqk", qb, k)
    ctx_mask = torch.arange(C, device=q.device)[None, :] < len0[:, None]
    sc = torch.where(ctx_mask[:, None, None, :], sc, neg)
    sr = torch.where((torch.arange(S, device=q.device) < step)[None, None, None, :], sr, neg)
    weights = torch.softmax(torch.cat([sc, sr, ss], dim=-1).float(), dim=-1).to(q.dtype)
    wc, wr, ws = weights[..., :C], weights[..., C:C + S], weights[..., C + S:]
    return (torch.einsum("bhqk,bkhd->bqhd", wc, cv) + torch.einsum("bhqk,bkhd->bqhd", wr, ring_v)
            + torch.einsum("bhqk,bkhd->bqhd", ws, v))


class PagedTransformerBlock(TransformerBlock):
    """TransformerBlock whose attention reads a paged K/V pool.

    Returns this call's K/V instead of writing them: the caller owns the
    pool write (:func:`write_kv`).  ``kv_scales=(sk, sv)`` (this layer's
    (num_pages,) float32 scales) marks an int8 pool; ``lora`` (target ->
    (A, B) of this layer) with ``adapter_idx`` (B,) adds each lane's
    adapter delta to every projection.

    ``block_tables`` may be a tuple of per-bucket tables (the
    length-bucketed split, JAX ``paged.py:170-189``): each bucket's lanes
    attend at its own table width, one kernel call per bucket on the
    kernel lane; the projections and the MLP stay full-batch.

    :meth:`forward_ring` is the ring chunk's attention on the same
    weights (the JAX package's ``ChunkTransformerBlock``)."""

    def forward(self, x, pk, pv, block_tables, lengths, use_kernel: bool = False, kv_scales=None, lora=None,
                adapter_idx=None):
        # x (B, L, d); pk/pv (num_pages, ps, h, hd); block_tables (B, P)
        # int32 or per-bucket tables; lengths (B,) int32 tokens already
        # in the pool
        batch, seg_len, d_model = x.shape
        heads = self.num_heads
        head_dim = d_model // heads
        kernel_lane = use_kernel and seg_len == 1
        # the qkv delta folds into K4's launch; the grid kernel keeps the
        # einsum delta (this model applies no rotation between the qkv
        # projection and attention, so the delta is linear in its output)
        fold = (kernel_lane and lora is not None and "qkv" in lora
                and kernels.paged_kernel_impl(heads, head_dim) == "stream")
        y = self.ln0(x)
        q, k, v = self.split_heads(self.project("qkv", y, None if fold else lora, adapter_idx))
        scale = _head_scale(head_dim, q.dtype)
        buckets = _bucket_slices(block_tables)
        if kernel_lane:
            # kernel lane: K4/K5 over the pool, one call per bucket, then
            # the current token merged by the flash rule in float32
            outs, ks, vs = [], [], []
            for tb, sl in buckets:
                nb = tb.shape[0]
                q1 = (q[sl] * scale)[:, 0]  # (nb, h, hd), in the model dtype
                q_self, k_self, v_self = q1.float(), k[sl, 0].float(), v[sl, 0].float()
                if fold:
                    q_scale = float(head_dim) ** -0.5
                    a, b = lora["qkv"]
                    acc, m, l, delta = kernels.paged_attention_decode(
                        q1, pk, pv, tb, lengths[sl], page_size=pk.shape[1], kv_scales=kv_scales,
                        lora=(y[sl, 0], a, b, adapter_idx[sl], q_scale))
                    dq, dk, dv = (t.reshape(nb, heads, head_dim) for t in delta.split(d_model, dim=-1))
                    q_self = q_self + q_scale * dq
                    k_self = k_self + dk
                    v_self = v_self + dv
                    # the pool write stores the adapted keys and values
                    ks.append(k_self[:, None].to(k.dtype))
                    vs.append(v_self[:, None].to(v.dtype))
                else:
                    acc, m, l = kernels.paged_attention_decode(q1, pk, pv, tb, lengths[sl],
                                                               page_size=pk.shape[1], kv_scales=kv_scales)
                s_self = torch.einsum("bhd,bhd->bh", q_self, k_self)
                m2 = torch.maximum(m, s_self)
                alpha = torch.exp(m - m2)
                w_self = torch.exp(s_self - m2)
                l2 = l * alpha + w_self
                outs.append((acc * alpha[..., None] + v_self * w_self[..., None]) / l2[..., None])
            attn = _cat(outs)[:, None].to(x.dtype).reshape(batch, seg_len, d_model)
            if fold:
                k, v = _cat(ks), _cat(vs)
        else:
            # gather lane: scores in the model dtype masked with its
            # finfo.min, softmax in float32, weights cast back; int8
            # pages dequantised right after the fetch, one scale per page
            outs = []
            for tb, sl in buckets:
                gk = pk[tb]  # (nb, P, ps, h, hd)
                gv = pv[tb]
                if kv_scales is not None:
                    sk, sv = kv_scales
                    bshape = (tb.shape[0], gk.shape[1], 1, 1, 1)
                    gk = (gk.float() * sk[tb].reshape(bshape)).to(q.dtype)
                    gv = (gv.float() * sv[tb].reshape(bshape)).to(q.dtype)
                outs.append(gather_attention(q[sl], k[sl], v[sl], gk, gv, lengths[sl], scale))
            attn = _cat(outs).reshape(batch, seg_len, d_model)
        return self.mlp_tail(x, attn, lora, adapter_idx), k, v

    def forward_ring(self, x, ctx_k, ctx_v, ring_k, ring_v, step: int, len0, lora=None, adapter_idx=None):
        """One decode step of the ring chunk: attention over the context
        gathered at the chunk's start (``ctx_k`` / ``ctx_v`` (B, C, h,
        hd), or per-bucket tuples of (Bb, Cb, h, hd) with the lanes
        bucket-sorted), the chunk's own K/V in the ring (``ring_k`` /
        ``ring_v`` (B, S, h, hd), columns below ``step`` written) and the
        current token: three score products a bucket, context columns at
        or past ``len0`` (B,) and ring columns at or past ``step``
        masked, one float32 softmax over the three, the weights cast
        back and the three weighted sums added (JAX ``paged.py:432-512``).
        Dense products only, no kernel; returns ``(x, k, v)`` as
        :meth:`forward` does."""
        if not isinstance(ctx_k, (tuple, list)):
            ctx_k, ctx_v = (ctx_k,), (ctx_v,)
        batch, seg_len, d_model = x.shape
        q, k, v = self.split_heads(self.project("qkv", self.ln0(x), lora, adapter_idx))
        scale = _head_scale(d_model // self.num_heads, q.dtype)
        outs, off = [], 0
        for ck, cv in zip(ctx_k, ctx_v):
            sl = slice(off, off + ck.shape[0])
            off += ck.shape[0]
            outs.append(ring_step_attention(q[sl], k[sl], v[sl], ck, cv, ring_k[sl], ring_v[sl], step, len0[sl],
                                            scale))
        attn = _cat(outs).reshape(batch, seg_len, d_model)
        return self.mlp_tail(x, attn, lora, adapter_idx), k, v


class PagedTransformerLM(TransformerLM):
    """TransformerLM forward against a paged pool; the same parameters as
    :class:`TransformerLM` (one ``state_dict`` loads into either).

    ``precision="w8a8"`` makes every projection (qkv, attn_proj, mlp_in,
    mlp_out) and the head a :class:`ops.w8a8.W8A8Dense` (the JAX paged
    LM's ``_dense`` factory); the ``state_dict`` stays the plain one."""

    block_cls = PagedTransformerBlock

    def __init__(self, *args, precision: str = "bf16", **kwargs):
        super().__init__(*args, **kwargs)
        if precision not in ("bf16", "w8a8"):
            raise ValueError(f"precision must be 'bf16' or 'w8a8', got {precision!r}")
        self.precision = precision
        if precision == "w8a8":
            dtype = self.head.weight.dtype
            for block in self.blocks:
                for name in ("qkv", "attn_proj", "mlp_in", "mlp_out"):
                    dense = getattr(block, name)
                    setattr(block, name, W8A8Dense(dense.in_features, dense.out_features, dtype=dtype))
            self.head = W8A8Dense(self.head.in_features, self.head.out_features, dtype=dtype)

    def forward(self, tokens, positions, pages_k, pages_v, block_tables, lengths, *,
                use_kernel: bool = False, select: Optional[torch.Tensor] = None, kv_scales=None, lora=None,
                adapter_idx=None):
        """-> ``(logits, new_k, new_v)``: float32 logits (B, L, vocab) and
        this call's K/V (layers, B, L, h, hd) for the caller to write.
        ``select`` (B,) keeps one position per row before the head, so
        the logits are (B, 1, vocab); the head is per position, so the
        kept rows are those of the full call.  Token ids wrap modulo the
        vocabulary, as ``jnp.take`` does, so a finished lane's ``eos_id``
        of -1 embeds like the JAX engine's.  ``kv_scales=(sk, sv)``, the
        (layers, num_pages) scale tables of an int8 pool; ``lora`` (target
        -> (A (layers, slots, d_in, r), B (layers, slots, r, d_out))) with
        ``adapter_idx`` (B,) int32 slot ids: each layer gets its slices."""
        x = self.embed(torch.remainder(tokens.long(), self.vocab_size), positions)
        new_k, new_v = [], []
        for i, block in enumerate(self.blocks):
            scales_i = (kv_scales[0][i], kv_scales[1][i]) if kv_scales is not None else None
            lora_i = {t: (ab[0][i], ab[1][i]) for t, ab in lora.items()} if lora is not None else None
            x, k, v = block(x, pages_k[i], pages_v[i], block_tables, lengths, use_kernel, kv_scales=scales_i,
                            lora=lora_i, adapter_idx=adapter_idx)
            new_k.append(k)
            new_v.append(v)
        if select is not None:
            x = x[torch.arange(x.shape[0], device=x.device), select.long()][:, None]
        return self.logits(x), torch.stack(new_k), torch.stack(new_v)

    def forward_ring(self, tokens, positions, ctx_k, ctx_v, ring_k, ring_v, step: int, len0, *, lora=None,
                     adapter_idx=None):
        """The ring chunk's decode step on these weights (the JAX
        package's ``ChunkTransformerLM``, one parameter tree with this
        module): ``ctx_k`` / ``ctx_v`` (layers, B, C, h, hd), or tuples of
        per-bucket (layers, Bb, Cb, h, hd); ``ring_k`` / ``ring_v``
        (layers, B, S, h, hd).  -> ``(logits, new_k, new_v)`` as
        :meth:`forward`."""
        x = self.embed(torch.remainder(tokens.long(), self.vocab_size), positions)
        bucketed = isinstance(ctx_k, (tuple, list))
        new_k, new_v = [], []
        for i, block in enumerate(self.blocks):
            ck = tuple(c[i] for c in ctx_k) if bucketed else ctx_k[i]
            cv = tuple(c[i] for c in ctx_v) if bucketed else ctx_v[i]
            lora_i = {t: (ab[0][i], ab[1][i]) for t, ab in lora.items()} if lora is not None else None
            x, k, v = block.forward_ring(x, ck, cv, ring_k[i], ring_v[i], step, len0, lora=lora_i,
                                         adapter_idx=adapter_idx)
            new_k.append(k)
            new_v.append(v)
        return self.logits(x), torch.stack(new_k), torch.stack(new_v)


def kv_split(pool):
    """A pool argument as ``(pages, scales)``: the int8 bundle is the
    2-tuple ``(int8 pages, float32 per-page scales)``, a bare tensor (the
    native-dtype pool) splits to ``(pool, None)``."""
    if isinstance(pool, tuple):
        return pool
    return pool, None


def kv_join(pages, scales):
    """Inverse of :func:`kv_split`."""
    return pages if scales is None else (pages, scales)


def _write_positions(block_tables, start, valid, S, *, page_size, max_len, from_zero, device):
    """Each written token's (page, row): (B, S) page ids and offsets."""
    B = block_tables.shape[0]
    offs = torch.arange(S, device=device)
    if from_zero:
        pos = offs[None, :].expand(B, S)
        page = block_tables.long().gather(1, pos // page_size)
    else:
        pos = torch.clamp(start.long()[:, None] + offs[None, :], max=max_len - 1)
        idx = torch.clamp(pos // page_size, max=block_tables.shape[1] - 1)
        page = torch.where(valid, block_tables.long().gather(1, idx), 0)
    return page, pos % page_size


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
    unspecified, as nothing reads it.

    An int8 pool comes as ``(pages, scales)`` bundles (:func:`kv_split`)
    and takes the quantising write, :func:`_write_kv_int8`."""
    pk_pages, sk = kv_split(pk)
    pv_pages, sv = kv_split(pv)
    if isinstance(pk_pages, ShardedTensor):
        # a mesh engine's pools: each write lands on the positions that
        # hold its page and heads (parallel/tp.py)
        S = new_k.parts[next(iter(new_k.parts))].shape[2]
        page, row = _write_positions(block_tables, start, valid, S, page_size=page_size, max_len=max_len,
                                     from_zero=from_zero, device=block_tables.device)
        write_kv_mesh(pk_pages, pv_pages, new_k, new_v, page, row,
                      pages_sharded=pk_pages.spec.axis_of(1) is not None)
        return pk, pv
    if sk is not None:
        _write_kv_int8(pk_pages, sk, pv_pages, sv, new_k, new_v, block_tables, start, valid,
                       page_size=page_size, max_len=max_len, from_zero=from_zero)
        return pk, pv
    L, B, S = new_k.shape[:3]
    tail = new_k.shape[3:]
    page, row = _write_positions(block_tables, start, valid, S, page_size=page_size, max_len=max_len,
                                 from_zero=from_zero, device=new_k.device)
    page, row = page.reshape(-1), row.reshape(-1)
    pk[:, page, row] = new_k.reshape(L, B * S, *tail)
    pv[:, page, row] = new_v.reshape(L, B * S, *tail)
    return pk, pv


def _quantize_pages(pagef: torch.Tensor):
    """(L, N, ps, *tail) float32 pages -> int8 pages and their (L, N)
    scales: one scale per layer and page, ``max(amax / 127, 1e-8)``,
    values rounded half to even and clipped to +-127 (the JAX engine's
    ``_quant``)."""
    amax = pagef.abs().amax(dim=tuple(range(2, pagef.dim())))
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.round(pagef / scale.reshape(*scale.shape, *(1,) * (pagef.dim() - 2)))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _write_kv_int8(pk, sk, pv, sv, new_k, new_v, block_tables, start, valid, *, page_size, max_len, from_zero):
    """The quantising twin of :func:`write_kv` for the int8 pool, in place.

    Quantisation is page-granular (one float32 scale per page per K/V
    per layer), so every write touches whole pages, as in the JAX
    engine's ``_write_kv_int8``:

    * **prefill** (``from_zero``) — each (row, page) block of the
      segment quantises fresh over its abs-max, the pad tokens between a
      row's length and the bucket included; only positions past the
      segment are zero;
    * **decode and segments** — a read-modify-write requantisation per
      token: the page dequantised at its old scale, its tail at and past
      the write offset zeroed (a recycled page's dead values must not
      inflate the new scale), the token inserted, the whole page
      requantised.  Lanes are written together (two live lanes never
      share a page; which write lands on trash page 0 is unspecified),
      the tokens of a segment one after another."""
    L, B, S = new_k.shape[:3]
    tail = new_k.shape[3:]
    if from_zero:
        nblk = -(-S // page_size)
        pages = block_tables.long()[:, :nblk].reshape(-1)  # (B * nblk,)
        for pool, scales, new in ((pk, sk, new_k), (pv, sv, new_v)):
            f = new.float()
            if nblk * page_size > S:
                f = torch.cat([f, f.new_zeros((L, B, nblk * page_size - S, *tail))], dim=2)
            q, s = _quantize_pages(f.reshape(L, B * nblk, page_size, *tail))
            pool[:, pages] = q
            scales[:, pages] = s
        return
    page, off = _write_positions(block_tables, start, valid, S, page_size=page_size, max_len=max_len,
                                 from_zero=False, device=new_k.device)
    lanes = torch.arange(B, device=new_k.device)
    ones = (1,) * len(tail)
    rows = torch.arange(page_size, device=new_k.device)
    for t in range(S):
        p, o = page[:, t], off[:, t]
        live = (rows[None, :] < o[:, None]).reshape(1, B, page_size, *ones)
        for pool, scales, new in ((pk, sk, new_k), (pv, sv, new_v)):
            pagef = pool[:, p].float() * scales[:, p].reshape(L, B, 1, *ones)
            pagef = torch.where(live, pagef, 0.0)
            pagef[:, lanes, o] = new[:, :, t].float()
            q, s = _quantize_pages(pagef)
            pool[:, p] = q
            scales[:, p] = s


# ---------------------------------------------------------------------------
# capacity accounting (pure arithmetic)
# ---------------------------------------------------------------------------

def paged_hbm_accounting(
    *,
    streams: int,
    ctx_len: int,
    d_model: int,
    num_layers: int,
    page_size: int = 64,
    steps_per_call: int = 8,
    dtype_bytes: int = 2,
    flat_pool: bool = True,
    chunk_impl: str = "ring",
    donated: bool = True,
    split_tile_pad: float = 2.0,
    cached_prefix_pages: int = 0,
    tp_degree: int = 1,
    dp_degree: int = 1,
    num_pool_pages: Optional[int] = None,
    num_heads: Optional[int] = None,
    inflight_prefill_tokens: int = 0,
    adapter_bytes: int = 0,
    reclaimable_weight_bytes: int = 0,
    kv_dtype: str = "bf16",
    host_tier_gib: float = 0.0,
) -> Dict[str, int]:
    """Pool bytes on one device for ``streams`` concurrent streams at
    ``ctx_len`` tokens: the JAX package's capacity model, same arguments,
    defaults and returned dict (equal answers for equal arguments).

    * **pool (at rest)**: pages x page_size x d_model x 2 (K+V) x layers
      x the element's bytes.  The flat layout stores logical bytes; the
      split (heads, head_dim) layout pads by ``split_tile_pad``.  The
      default 2.0 is the JAX package's reading under the TPU's (8, 128)
      tile.  The port's pool is always split and unpadded, so its real
      bytes are this term at ``flat_pool=False, split_tile_pad=1.0`` plus
      the trash page 0 (``chip_smoke.py`` phase 24 reads them on the
      card).
    * **donated vs copied**: ``donated=False`` doubles the at-rest pool
      (input and output pools both live during a chunk).
    * **working set** (``chunk_impl="ring"`` only): the context gathered
      once a chunk plus the step ring, in the compute dtype, times
      ``split_tile_pad``; the pool chunk carries none.
    * **cached prefix pages**: reclaimable, so ``reclaimable_bytes``
      only, never ``peak_bytes``.
    * **tp / dp degrees**: per-shard bytes; an indivisible ``num_heads``
      or ``num_pool_pages`` replicates the pool, so full bytes.
    * **in-flight prefill**: pages mapped by prompts still chunking
      (``inflight_prefill_tokens``) count into ``peak_bytes``.
    * **adapters**: ``adapter_bytes`` (the LoRA pool) counts into
      ``peak_bytes``; ``reclaimable_weight_bytes`` (cached weight sets)
      into ``reclaimable_bytes``.
    * **int8 KV** (``kv_dtype="int8"``): one byte an element plus the
      scale tables' 8 bytes a page a layer; the ring working set stays in
      the compute dtype.
    * **host KV tier**: ``host_tier_gib`` is host memory, reported as
      ``host_tier_bytes`` and ``host_reclaimable_bytes``, never in
      ``peak_bytes``.

    Base weights, activations and the host runtime are out of scope."""
    shard = max(1, int(tp_degree))
    if num_heads is not None and num_heads % shard:
        shard = 1
    dshard = max(1, int(dp_degree))
    if num_pool_pages is not None and num_pool_pages % dshard:
        dshard = 1
    kv_shard = shard * dshard
    pages = -(-ctx_len // page_size)
    kv_int8 = kv_dtype == "int8"
    pool_elt_bytes = 1 if kv_int8 else dtype_bytes
    tok_bytes = num_layers * d_model * 2 * pool_elt_bytes
    page_scale_bytes = num_layers * 2 * 4 if kv_int8 else 0
    pool_pad = 1.0 if flat_pool else split_tile_pad
    page_bytes = page_size * tok_bytes * pool_pad + page_scale_bytes
    pool = int(streams * pages * page_bytes) // kv_shard
    ws = 0
    if chunk_impl == "ring":
        ws = int(
            streams * (pages * page_size + steps_per_call)
            * num_layers * d_model * 2 * dtype_bytes * split_tile_pad
        ) // kv_shard
    at_rest = pool if donated else 2 * pool
    inflight_pages = -(-int(inflight_prefill_tokens) // page_size)
    inflight = int(inflight_pages * page_bytes) // kv_shard
    return {
        "pool_bytes": pool,
        "working_set_bytes": ws,
        "peak_bytes": at_rest + ws + inflight + int(adapter_bytes),
        "per_stream_bytes": (at_rest + ws) // max(1, streams),
        "reclaimable_bytes": int(cached_prefix_pages * page_bytes) // kv_shard + int(reclaimable_weight_bytes),
        "inflight_prefill_bytes": inflight,
        "adapter_bytes": int(adapter_bytes),
        "reclaimable_weight_bytes": int(reclaimable_weight_bytes),
        "tp_degree": shard,
        "dp_degree": dshard,
        "host_tier_bytes": int(float(host_tier_gib) * (1 << 30)),
        "host_reclaimable_bytes": int(float(host_tier_gib) * (1 << 30)),
    }


def paged_capacity_streams(
    budget_bytes: int, ctx_len: int, *, donated: bool = True,
    inflight_prefill_tokens: int = 0, adapter_bytes: int = 0, **model_kw
) -> int:
    """Most concurrent streams whose peak bytes fit ``budget_bytes`` at
    ``ctx_len`` tokens each: one division over the one-stream accounting,
    after the in-flight prefill pages and the adapter pool come off the
    top (they are resident whatever the stream count).  Reclaimable
    prefix pages never count against it."""
    one = paged_hbm_accounting(
        streams=1, ctx_len=ctx_len, donated=donated,
        inflight_prefill_tokens=inflight_prefill_tokens,
        adapter_bytes=adapter_bytes, **model_kw
    )
    fixed = one["inflight_prefill_bytes"] + one["adapter_bytes"]
    per_stream = max(1, one["peak_bytes"] - fixed)
    usable = max(0, int(budget_bytes) - fixed)
    return int(usable // per_stream)


def paged_max_context(
    budget_bytes: int, *, page_size: int = 64, max_len_cap: int = 1 << 20,
    **model_kw,
) -> int:
    """Largest page-aligned context one stream can hold under
    ``budget_bytes``: :func:`paged_capacity_streams` inverted over
    ``ctx_len`` by a binary search over page counts (the peak grows with
    the context).  0 when not even one page fits."""
    def fits(ctx_len: int) -> bool:
        one = paged_hbm_accounting(streams=1, ctx_len=ctx_len, page_size=page_size, **model_kw)
        return one["peak_bytes"] <= int(budget_bytes)

    lo, hi = 0, max_len_cap // page_size
    if not fits(page_size):
        return 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if fits(mid * page_size):
            lo = mid
        else:
            hi = mid - 1
    return lo * page_size


# ---------------------------------------------------------------------------
# host half: the engine
# ---------------------------------------------------------------------------

class _Stream:
    """One in-flight generation request bound to a slot."""

    __slots__ = ("req_id", "prompt", "max_new", "temperature", "top_k", "eos_id", "seed", "tokens",
                 "event", "result", "error", "slot", "pages", "cancelled", "generator", "adapter",
                 "adapter_slot", "adapter_pinned", "cached_len", "prefilled", "priority", "deadline",
                 "preempted", "t_submit", "t_prefill_start", "t_decode_start", "t_first_token", "t_finish",
                 "queue_depth_at_submit", "token_queue", "streamed", "pending", "draft_hint", "kv_export",
                 "kv_import", "kv_payload", "kv_imported", "tier_promote", "trace_id", "parent_span_id", "puid",
                 "cost_page_s", "cost_t", "cost_prefill_tokens", "cost_decode_tokens", "cost_preempts",
                 "cost_restores", "cost_closed")

    def __init__(self, req_id, prompt, max_new, temperature, top_k, eos_id, seed, adapter_slot=0):
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
        # (again after an eviction, so a re-derived run draws the same)
        self.generator: Optional[torch.Generator] = None
        # the adapter it decodes with (None: the base model), its pool
        # slot (0: the zero adapter), and whether it still holds its pin
        # on that slot (released once)
        self.adapter: Optional[str] = None
        self.adapter_slot = int(adapter_slot)
        self.adapter_pinned = bool(adapter_slot)
        # prompt tokens resident in shared prefix pages at admission
        # (page-aligned), and prompt tokens whose K/V is in the pool:
        # cached_len at admission, advanced by each prefill slice; the
        # stream decodes once prefilled == len(prompt)
        self.cached_len = 0
        self.prefilled = 0
        # SLO terms: admission / shedding / preemption order (higher
        # wins), absolute time.monotonic() expiry (None: none), and
        # whether a preemption evicted it (its re-admission is a restore)
        self.priority = 0
        self.deadline: Optional[float] = None
        self.preempted = False
        # wall-clock stamps: queue wait = t_prefill_start - t_submit,
        # prefill = t_decode_start - t_prefill_start, TTFT =
        # t_first_token - t_submit (tracer or not: a capture's phase
        # terms and the profile tools read them)
        self.t_submit = 0.0
        self.t_prefill_start = 0.0
        self.t_decode_start = 0.0
        self.t_first_token = 0.0
        self.t_finish = 0.0
        self.queue_depth_at_submit = 0
        # lifecycle-span linkage, set at submit when a tracer is
        # installed: the decode loop runs on another thread, so gen.*
        # spans link by (trace_id, parent_span_id) explicitly; and the
        # request's puid (tracer or not), which flight-recorder records
        # and capture containers key on
        self.trace_id = ""
        self.parent_span_id: Optional[str] = None
        self.puid = ""
        # the cost ledger: KV page-seconds so far (the integral of pages
        # held over wall time, stamped at every page-count change), the
        # stamp of the last accrual (0.0: holding no pages), prompt and
        # decode tokens computed for the stream (a re-derivation after an
        # eviction is more cost), preemptions and restores, and the guard
        # that folds it into the engine totals once
        self.cost_page_s = 0.0
        self.cost_t = 0.0
        self.cost_prefill_tokens = 0
        self.cost_decode_tokens = 0
        self.cost_preempts = 0
        self.cost_restores = 0
        self.cost_closed = False
        # token streaming: each chunk's new tokens go on the queue as they
        # land, None ends it; `streamed` counts the tokens pushed, and an
        # eviction resets the tokens but not it, so the re-derived run
        # pushes from where the consumer left off
        self.token_queue: Optional[queue.Queue] = None
        self.streamed = 0
        # speculative engine: the next token to verify from (the argmax of
        # the last logits; tokens[-1] once the prefill's token is emitted),
        # and an oracle draft's expected continuation
        self.pending: Optional[int] = None
        self.draft_hint: Optional[np.ndarray] = None
        # KV handoff and migration: a kv_export stream finishes at the end
        # of its prefill with its pages read back into kv_payload; a
        # kv_import stream carries a payload whose pages are written at
        # admission in place of a prefill, and is kv_imported once they
        # are (drain does not journal either)
        self.kv_export = False
        self.kv_import: Optional[Dict[str, Any]] = None
        self.kv_payload: Optional[Dict[str, Any]] = None
        self.kv_imported = False
        # the KV tier: admission's chain walk hit the tier,
        # {"pages": fresh pool pages, "entries": the popped entries},
        # written into the pool before the stream's first device work (or
        # put back into the tier if the stream dies first)
        self.tier_promote: Optional[Dict[str, Any]] = None


@dataclass(slots=True)
class _ChunkState:
    """One decode chunk's device carries, lanes in the chunk's order."""

    tables: torch.Tensor  # (B, pages) full-width block tables: every write goes through them
    split: Tuple[torch.Tensor, ...]  # one table per length bucket, each at its own width
    lengths: torch.Tensor  # (B,) tokens in the cache
    done: torch.Tensor  # (B,) bool
    emitted: torch.Tensor  # (B,) tokens this chunk emitted
    max_new: torch.Tensor  # (B,) budgets left
    eos: torch.Tensor  # (B,) eos ids
    model_kw: Dict[str, Any]  # the model's keyword inputs (adapter ids)
    logits: torch.Tensor  # (B, vocab) float32: the next step samples from them
    samplers: list  # (lane, generator, temperature, top_k) of every sampled lane


def _reported_speculative(spec: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Speculative options as reported: the draft's weights left out."""
    return None if spec is None else {k: v for k, v in spec.items() if k != "draft_params"}


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


def _precision_modes(quantize: str, precision: str):
    """``(precision, quantize)`` as the JAX engine resolves them: both
    validated, ``precision`` defaulting to ``bf16``, and ``w8a8`` /
    ``int8w`` implying int8 at rest.  A bad value is 400 ``BAD_QUANTIZE``."""
    try:
        precision = validate_precision(precision or "") or "bf16"
        quantize = validate_quantize_mode(quantize or "") or quantize_mode_for(precision)
    except ValueError as exc:
        raise MicroserviceError(str(exc), status_code=400, reason="BAD_QUANTIZE") from exc
    return precision, quantize


@contextlib.contextmanager
def _swapped_weights(module: torch.nn.Module, tensors: Dict[str, torch.Tensor]):
    """``module``'s parameters named in ``tensors`` (``state_dict`` keys)
    replaced by those tensors for the block, then put back."""
    saved = []
    for key, t in tensors.items():
        owner, _, leaf = key.rpartition(".")
        sub = module.get_submodule(owner)
        saved.append((sub, leaf, sub._parameters[leaf]))
        sub._parameters[leaf] = t
    try:
        yield
    finally:
        for sub, leaf, p in saved:
            sub._parameters[leaf] = p


def rest_kernels_int8(module: torch.nn.Module, params: Dict[str, torch.Tensor],
                      device: torch.device) -> Tuple[Dict[str, QuantizedKernel], List[Dict[str, Any]]]:
    """``module``'s kernels quantised per output channel from the float32
    checkpoint ``params`` (``ops/surgery.py``, as the JAX package
    quantises float32 parameters): ``({key: QuantizedKernel on device},
    manifest)``."""
    qstate, manifest = quantize_params(module, state={k: v.float() for k, v in params.items()})
    return ({k: QuantizedKernel(v.q.to(device), v.scale.to(device)) for k, v in qstate.items()
             if isinstance(v, QuantizedKernel)}, manifest)


def drop_float_kernels(module: torch.nn.Module, keys) -> None:
    """Drop ``module``'s float copies of the kernels named by ``keys``
    (they rest int8 and are swapped in per call by :func:`materialized`)."""
    for key in keys:
        owner, _, leaf = key.rpartition(".")
        sub = module.get_submodule(owner)
        sub._parameters[leaf] = torch.nn.Parameter(sub._parameters[leaf].new_empty((0,)), requires_grad=False)


def materialized(module: torch.nn.Module, qkernels: Dict[str, QuantizedKernel], dtype: torch.dtype):
    """``module`` with its int8 kernels dequantised to ``dtype`` for the
    block (one device call, never one step)."""
    return _swapped_weights(module, {k: qk.dequantize(dtype) for k, qk in qkernels.items()})


class PagedEngine:
    """Continuous-batching decode engine over a paged K/V pool.

    ``submit()`` from any thread; ``step()`` (or the decode loop of
    :class:`StreamingLM`) admits queued streams, prefills them by prompt
    bucket, and advances every decoding stream by ``steps_per_call``
    tokens in one chunk (doubling up to ``max_steps_per_call`` while
    nothing waits).  ``params`` is a ``TransformerLM`` state_dict
    (``load_lm_params`` or ``models.convert.lm_params_from_flax``).

    The JAX engine's scheduler, under its names: a refcounted page
    allocator with a prefix index (``prefix_cache``, default
    ``SELDON_TPU_PREFIX_CACHE``), admission with the prompt's pages and
    growth a chunk at a time (stall, then evict, under pool pressure),
    priorities and deadlines with a bounded queue (``max_queue`` /
    ``SELDON_TPU_MAX_QUEUE``) that sheds and preempts, and chunked
    prefill under a token budget (``chunk_token_budget`` /
    ``SELDON_TPU_CHUNK_TOKEN_BUDGET``).  ``quantize="int8"`` rests the
    kernels int8 and dequantises them once per device call;
    ``precision="w8a8"`` runs every projection int8 x int8.  A chunk runs
    on the pool chunk or the ring chunk (``SELDON_TPU_CHUNK_IMPL``), its
    lanes split into length buckets (``SELDON_TPU_CTX_BUCKETS``);
    ``submit(stream_tokens=True)`` streams a request's tokens.
    ``speculative`` (see :meth:`_init_speculative`) runs a draft/verify
    round a wave in place of the decode chunk.

    ``max_adapters`` (``SELDON_TPU_MAX_ADAPTERS`` when 0) slots of rank
    ``lora_rank`` serve LoRA adapters, resolved by name through
    ``weight_registry`` (a :class:`models.registry.WeightRegistry`) or
    installed with :meth:`load_adapter`; 0 serves the base model only.
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
        lora_rank: int = 8,
        weight_registry: Any = None,
        shard_min_weight_size: int = 16_384,
        model_axis: str = MODEL_AXIS,
        data_axis: str = DATA_AXIS,
    ):
        check_ported_options()
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of page_size {page_size}")
        self.precision, self.quantize = _precision_modes(quantize, precision)
        # the serving mesh (JAX paged.py:1431-1446): an explicit mesh wins,
        # else tp= / dp= / SELDON_TPU_TP / SELDON_TPU_DP through the one
        # precedence home, degrading (data axis first) with a WARN on a
        # host with fewer distinct CUDA devices
        if mesh is None:
            mesh = resolve_mesh(tp=tp, dp=dp, model_axis=model_axis, data_axis=data_axis)
        self._mesh = mesh
        self._model_axis, self._data_axis = model_axis, data_axis
        self.tp_degree = mesh.axis_size(model_axis) if mesh is not None else 1
        self.dp_degree = mesh.axis_size(data_axis) if mesh is not None else 1
        if mesh is not None:
            # the controller's device: the engine's slot-major state lives
            # on the mesh's first position
            self.device = mesh.devices.flat[0]
        else:
            self.device = device if isinstance(device, torch.device) else resolve_device(device)
        self.dtype = _resolve_dtype(dtype)
        self.vocab_size = int(vocab_size)
        self.max_len = int(max_len)
        self.page_size = int(page_size)
        self.pages_per_stream = self.max_len // self.page_size
        self.max_slots = int(max_slots)
        self.steps_per_call = int(steps_per_call)
        # the saturated-decode ladder: with nothing queued, chunks double
        # up to max_steps (a waiting queue pins the short chunk)
        self.max_steps = max(self.steps_per_call, int(max_steps_per_call or 0))
        # default pool = worst case (every slot full-length) + trash page
        self.num_pages = int(num_pages or self.max_slots * self.pages_per_stream + 1)
        # sequence sharding (JAX paged.py:1500-1515): the data axis shards
        # the pool's page dim (SELDON_TPU_SEQ_SHARD=0 replicates it), so
        # the page count rounds up to a multiple of dp
        self._seq_shard = _knobs.flag("SELDON_TPU_SEQ_SHARD")
        if self.dp_degree > 1 and self._seq_shard and self.num_pages % self.dp_degree:
            self.num_pages += -self.num_pages % self.dp_degree
        self.prompt_buckets = _buckets_for(self.max_len)
        head_dim = d_model // num_heads
        self.num_layers, self.num_heads, self.head_dim = int(num_layers), int(num_heads), head_dim
        pool_shape = (num_layers, self.num_pages, self.page_size, num_heads, head_dim)
        # the decode chunk: the pool chunk (per-step attention over the
        # pool, where the kernel lane lives) or the ring chunk
        mode = paged_kernel_mode()
        eligible = paged_kernel_static_eligible(mode, mesh is None, self.dtype, self.device)
        self._chunk_impl = resolve_chunk_impl(mode, eligible)
        # the length-bucketed split of each chunk's lanes (1 or 2 buckets)
        self._ctx_buckets = paged_ctx_buckets(self.device)
        # int8 pool: pages rest int8 with one float32 scale per page per
        # K/V in the sibling (layers, num_pages) tables
        self._kv_int8 = paged_kv_int8(mesh is None, self._chunk_impl)
        pool_dtype = torch.int8 if self._kv_int8 else self.dtype
        # lane sharding (JAX paged.py:1699-1713): a call's rows split over
        # data when max_slots divides, else they replicate with a WARN
        self._lane_sharded = self.dp_degree > 1 and self.max_slots % self.dp_degree == 0
        if self.dp_degree > 1 and not self._lane_sharded:
            logger.warning("decode lanes NOT sharded over (%r, %r): max_slots=%d is not divisible by mesh axis %r "
                           "size %d — lane-major arrays replicate (pool page sharding is unaffected)",
                           data_axis, model_axis, self.max_slots, data_axis, self.dp_degree)
        if mesh is None:
            self.module = PagedTransformerLM(
                vocab_size=vocab_size, d_model=d_model, num_layers=num_layers, num_heads=num_heads,
                max_len=max_len, dtype=self.dtype, precision="w8a8" if self.precision == "w8a8" else "bf16",
            )
            self.module.load_state_dict(params)
            self.module = self.module.to(self.device).eval().requires_grad_(False)
            self._init_precision(params)
            self.pages_k = torch.zeros(pool_shape, dtype=pool_dtype, device=self.device)
            self.pages_v = torch.zeros(pool_shape, dtype=pool_dtype, device=self.device)
            self._pool_shard_bytes = 2 * self.pages_k.numel() * self.pages_k.element_size()
        else:
            self._init_mesh(params, pool_shape, pool_dtype, shard_min_weight_size)
        if self._kv_int8:
            self.scales_k = torch.zeros((num_layers, self.num_pages), dtype=torch.float32, device=self.device)
            self.scales_v = torch.zeros((num_layers, self.num_pages), dtype=torch.float32, device=self.device)
            self._pool_shard_bytes += 2 * self.scales_k.numel() * 4
        else:
            self.scales_k = self.scales_v = None
        # which decode lane this engine runs (the `kernel_active` gauge):
        # the kernel fires only in the pool chunk's per-step attention
        self._kernel_active = self._chunk_impl == "pool" and eligible
        if self._kernel_active:
            kernels.paged_kernel_impl(num_heads, head_dim)  # a bad IMPL knob fails here, not mid-chunk
        # last logits of every slot: the next chunk samples from them
        self._logits = torch.zeros((self.max_slots, self.vocab_size), dtype=torch.float32, device=self.device)
        self._init_speculative(speculative)

        # one step at a time: the StreamingLM decode loop and a caller's
        # run()/generate() both step the engine, and two interleaved
        # steps would advance the same slots twice
        self._step_lock = threading.Lock()
        # host bookkeeping, guarded by _lock
        self._lock = threading.Lock()
        # the refcounted page allocator.  A non-trash page is free (on
        # _free_pages, refcount 0), mapped (refcount = the live block
        # tables holding it; a shared prefix page counts once per
        # stream) or cached (refcount 0 but registered in the prefix
        # index: parked on the _lru, oldest first, and reclaimed by
        # _alloc_locked under pressure)
        self._free_pages: Deque[int] = deque(range(1, self.num_pages))  # page 0 = trash
        self._page_ref = np.zeros((self.num_pages,), np.int32)
        self._prefix_index: Dict[int, _CachedPrefix] = {}
        self._page_entry: Dict[int, _CachedPrefix] = {}
        self._lru: "OrderedDict[int, _CachedPrefix]" = OrderedDict()
        if prefix_cache is None:
            prefix_cache = _knobs.flag("SELDON_TPU_PREFIX_CACHE")
        self._prefix_cache_enabled = bool(prefix_cache)
        # SELDON_TPU_PAGED_DEBUG=1: the allocator audit at every chunk boundary
        self._debug_invariants = _knobs.flag("SELDON_TPU_PAGED_DEBUG")
        # run queue (deque + identity set); bounded when max_queue > 0
        if not max_queue:
            max_queue = int(_knobs.raw("SELDON_TPU_MAX_QUEUE", "0") or 0)
        self.max_queue = max(0, int(max_queue))
        # chunked prefill: each wave carries at most this many tokens,
        # decode first, then page-aligned prompt slices (0: monolithic)
        if not chunk_token_budget:
            chunk_token_budget = int(_knobs.raw("SELDON_TPU_CHUNK_TOKEN_BUDGET", "0") or 0)
        self.chunk_token_budget = max(0, int(chunk_token_budget))
        if self.chunk_token_budget:
            floor = self.page_size + self.steps_per_call
            if self.chunk_token_budget < floor:
                logger.warning("SELDON_TPU_CHUNK_TOKEN_BUDGET=%d cannot cover one prefill page plus one decode "
                               "chunk; clamping to %d", self.chunk_token_budget, floor)
                self.chunk_token_budget = floor
        self._queue: Deque[_Stream] = deque()
        self._queued: set = set()
        self._slots: List[Optional[_Stream]] = [None] * self.max_slots
        self._block_tables = np.zeros((self.max_slots, self.pages_per_stream), np.int32)
        self._lengths = np.zeros((self.max_slots,), np.int32)
        self._next_id = 0
        self._closed = False
        self._counters = {"chunks": 0, "tokens": 0, "prefills": 0, "completed": 0, "evictions": 0, "stalls": 0,
                          "prefix_hits": 0, "prefix_misses": 0, "prefix_evictions": 0, "prefix_tokens_saved": 0,
                          "shed": 0, "expired": 0, "preempted": 0, "restored": 0,
                          "prefill_tokens": 0, "prefill_chunks": 0, "weight_materializations": 0,
                          "adapter_loads": 0, "adapter_hits": 0, "adapter_misses": 0, "adapter_evictions": 0,
                          # chunks split into two length buckets, and their
                          # decode steps (a kernel call per bucket per
                          # layer-step: layers x (steps + bucketed_steps))
                          "bucketed_chunks": 0, "bucketed_steps": 0,
                          # speculative engine: drafts proposed and accepted
                          "spec_drafted": 0, "spec_accepted": 0,
                          # drain: live streams journaled, journal entries
                          # re-submitted here
                          "drained": 0, "replayed": 0,
                          # KV handoff: prefills exported as page payloads,
                          # payloads written into this pool; live migration:
                          # mid-decode streams exported to / imported from
                          # a peer
                          "kv_exports": 0, "kv_imports": 0, "migrated_out": 0, "migrated_in": 0,
                          # wall seconds in decode chunks and prefill
                          # waves (predict_cost_s prices a request by them)
                          "chunk_wall_s": 0.0, "prefill_wall_s": 0.0,
                          # chunk failures contained to their streams, and
                          # streams the NaN screen retired
                          "chunk_faults": 0, "quarantined": 0,
                          # the cost ledger's totals, folded in once a
                          # stream at termination (shed from engine_stats
                          # with SELDON_TPU_TELEMETRY=0), and capture
                          # containers written (shed with the capture
                          # plane off)
                          "cost_page_seconds": 0.0, "cost_prefill_tokens": 0, "cost_decode_tokens": 0,
                          "captures": 0,
                          # the KV tier (shed from engine_stats when off):
                          # pages demoted, chains promoted, promoted pages
                          # per level, uncached full pages the tier also
                          # missed, entries its budgets dropped, and the
                          # container bytes each way
                          **{k: 0 for k in _TIER_COUNTER_KEYS}}
        # decode chunks by their step count (the ladder's trace)
        self._chunk_steps: Dict[int, int] = {}
        # the KV tier (SELDON_TPU_KV_OFFLOAD=1): a reclaimed prefix page is
        # staged here as (key, parent, tokens, page) and gathered to the
        # host by the next _tier_flush, before any write can reach it
        self._kv_tier = None
        self._tier_pending: List[Tuple[int, int, Tuple[int, ...], int]] = []
        if _knobs.flag("SELDON_TPU_KV_OFFLOAD"):
            from seldon_core_tpu_torch.models.kvtier import HostKvTier

            self._kv_tier = HostKvTier(
                budget_bytes=int(float(_knobs.raw("SELDON_TPU_KV_HOST_BUDGET_GIB", "4") or 4) * (1 << 30)),
                spill_dir=_knobs.raw("SELDON_TPU_KV_SPILL_DIR") or None,
                spill_budget_bytes=int(float(_knobs.raw("SELDON_TPU_KV_SPILL_GIB", "16") or 16) * (1 << 30)),
            )

        self._init_observability()

        # multi-LoRA: a slot-granular factor pool beside the KV pool (slot 0
        # = the zero adapter), and the adapter table, guarded by _lock:
        # name -> slot, per-slot pin counts, an LRU of resident refcount-0
        # slots (reclaimed when a cold adapter needs one), and the pins
        # and installs of submits in flight (the audit counts them).
        # _adapter_io_lock serialises the slow load/install path so two
        # cold admissions of one adapter never install it twice.
        if not max_adapters:
            max_adapters = int(_knobs.raw("SELDON_TPU_MAX_ADAPTERS", "0") or 0)
        self.max_adapters = max(0, int(max_adapters))
        self._registry = weight_registry
        self._lora = (LoraPool(num_layers=num_layers, d_model=d_model, max_adapters=self.max_adapters,
                               rank=int(lora_rank), device=self.device, mesh=mesh, model_axis=model_axis)
                      if self.max_adapters else None)
        self._adapter_io_lock = threading.Lock()
        self._adapter_table: Dict[str, int] = {}
        self._adapter_names: Dict[int, str] = {}
        self._adapter_ref = np.zeros((self.max_adapters + 1,), np.int32)
        self._adapter_free: List[int] = list(range(self.max_adapters, 0, -1))
        self._adapter_lru: "OrderedDict[int, str]" = OrderedDict()
        self._adapter_temp_pins: Dict[int, int] = {}
        self._adapter_installing: set = set()
        # adapter names whose registry pin this engine holds while they are
        # resident in its pool
        self._adapter_reg_pinned: set = set()
        self._adapter_requests: Dict[str, int] = {}
        # each slot's adapter slot id (slot-major, like _block_tables)
        self._adapter_slots = np.zeros((self.max_slots,), np.int32)

    def _init_mesh(self, params: Dict[str, torch.Tensor], pool_shape, pool_dtype, min_weight_size: int) -> None:
        """The mesh engine's weights and pool (JAX ``shard_decode_state``):
        :class:`parallel.tp.MeshPagedLM` over JAX's parameter specs (an
        int8w engine's kernels quantised on the host and laid out by the
        paired specs; a w8a8 engine's projections as int8 integers and
        steps), and pools created already sharded, heads over
        ``model`` and pages over ``data`` (``parallel.sharding.pool_spec``,
        with its WARNs)."""
        from seldon_core_tpu_torch.parallel.tp import MeshPagedLM

        mesh = self._mesh
        spec = pool_spec(mesh, num_pages=self.num_pages, num_heads=self.num_heads, model_axis=self._model_axis,
                         data_axis=self._data_axis, seq_shard=self._seq_shard)
        state = {k: v.detach().float().cpu() for k, v in params.items()}
        self.quantize_manifest: List[Dict[str, Any]] = []
        self._qkernels: Dict[str, QuantizedKernel] = {}
        qkernels = None
        if self.quantize == "int8":
            with torch.device("meta"):
                template = PagedTransformerLM(vocab_size=self.vocab_size, d_model=self.num_heads * self.head_dim,
                                              num_layers=self.num_layers, num_heads=self.num_heads,
                                              max_len=self.max_len, dtype=self.dtype)
            qstate, self.quantize_manifest = quantize_params(template, state=state)
            qkernels = {k: v for k, v in qstate.items() if isinstance(v, QuantizedKernel)}
        self.module = MeshPagedLM(state, vocab_size=self.vocab_size, d_model=self.num_heads * self.head_dim,
                                  num_layers=self.num_layers, num_heads=self.num_heads, max_len=self.max_len,
                                  dtype=self.dtype, mesh=mesh, pool_spec=spec, lanes_sharded=self._lane_sharded,
                                  model_axis=self._model_axis, data_axis=self._data_axis,
                                  min_weight_size=min_weight_size, qkernels=qkernels,
                                  precision="w8a8" if self.precision == "w8a8" else "bf16")
        self.pages_k = ShardedTensor.zeros(mesh, pool_shape, spec, pool_dtype)
        self.pages_v = ShardedTensor.zeros(mesh, pool_shape, spec, pool_dtype)
        # the K+V bytes one position holds (JAX's addressable shard)
        self._pool_shard_bytes = 2 * self.pages_k.position_nbytes(tuple(0 for _ in mesh.axis_names))

    def _init_observability(self) -> None:
        """The engine's telemetry and chaos state, each part behind its
        knob as in the JAX engine:

        * the cost ledger (``SELDON_TPU_TELEMETRY``): a per-adapter split
          of the ``cost_*`` totals, and ``_cost_clock``, the monotonic
          clock the occupancy integral reads (a test may script it);
        * the flight recorder (``SELDON_TPU_FLIGHT_RECORDER``: ``0`` off,
          digits the ring's size), its p99-breach dump
          (``SELDON_TPU_DUMP_P99_MS`` / ``_DUMP_DIR``);
        * the capture plane (``SELDON_TPU_CAPTURE``,
          ``SELDON_TPU_CAPTURE_SAMPLE``) and the breach-puid hook;
        * the profiler hook (``SELDON_TPU_PROFILE_DIR``: the first
          ``SELDON_TPU_PROFILE_CHUNKS`` decode chunks under
          ``torch.profiler``, written as a Chrome trace);
        * the NaN screen (``SELDON_TPU_NAN_GUARD``) and the watchdog
          (``SELDON_TPU_WATCHDOG``), whose compile signal is a chunk
          signature the engine has not run before or a kernel library
          built or loaded during the wave;
        * the deferred gen.* spans, emitted by :meth:`step` after the
          engine lock drops."""
        from seldon_core_tpu_torch.ops import _build
        from seldon_core_tpu_torch.utils import capture as _capture
        from seldon_core_tpu_torch.utils.watchdog import EngineWatchdog, watchdog_enabled

        self._cost_by_adapter: Dict[str, Dict[str, Any]] = {}
        self._cost_clock = time.monotonic
        self._telemetry_enabled = _telemetry.telemetry_enabled()
        rec_env = _knobs.raw("SELDON_TPU_FLIGHT_RECORDER", "") or ""
        self.recorder = None
        if rec_env != "0":
            from seldon_core_tpu_torch.utils.flightrec import FlightRecorder

            self.recorder = FlightRecorder(
                capacity=int(rec_env) if rec_env.isdigit() else 512,
                dump_p99_ms=float(_knobs.raw("SELDON_TPU_DUMP_P99_MS", "0") or 0),
                dump_dir=_knobs.raw("SELDON_TPU_DUMP_DIR") or None,
            )
        self._capture_enabled = _capture.capture_enabled()
        self._capture_sample = _capture.sample_every() if self._capture_enabled else 0
        self._capture_seen = 0
        self._capture_lock = threading.Lock()
        # puids of breach-dump windows, captured when their stream ends
        self._breach_puids: "OrderedDict[str, float]" = OrderedDict()
        if self._capture_enabled and self.recorder is not None:
            self.recorder.on_dump = self._note_breach_puids
        self._profile_dir = _knobs.raw("SELDON_TPU_PROFILE_DIR") or None
        self._profile_chunks_left = int(_knobs.raw("SELDON_TPU_PROFILE_CHUNKS", "4") or 4) if self._profile_dir else 0
        self._profiler = None
        self._nan_guard = _knobs.flag("SELDON_TPU_NAN_GUARD")
        self._watchdog = EngineWatchdog() if watchdog_enabled() else None
        # first-use sentinels on the engine's four programs, under the JAX
        # engine's names (utils/jitwatch.py): engine_stats()["jit_compiles"]
        # sums them, and the watchdog exempts a wave that counted one
        self._sentinels = {name: JitSentinel(name) for name in
                           ("paged_chunk", "paged_prefill", "paged_spec_chunk", "paged_draft_rollout")}
        self._wd_compiles = 0
        self._wd_builds = _build.build_events()
        self._pending_spans: list = []

    # ---- precision lanes -----------------------------------------------------

    def _init_precision(self, params: Dict[str, torch.Tensor]) -> None:
        """Rest the kernels int8 when ``quantize="int8"``: the float32
        checkpoint quantised per output channel (``ops/surgery.py``), the
        module's float copies of those kernels dropped.

        * ``int8w`` (``quantize="int8"`` at bf16 / f32 compute): the
          kernels are dequantised to the compute dtype once per device
          call (:meth:`_materialized`), as the JAX engine's program entry
          does;
        * ``w8a8``: each projection's ``W8A8Dense`` is frozen with the
          integers and steps its call would compute from the float32
          dequant (the JAX engine's re-quantisation of its f32
          materialise, which gives the at-rest integers back), once
          here, so no call and no step quantises a weight.  Kernels too
          small to rest int8 are frozen from their float32 values, as
          JAX quantises its f32 parameters."""
        self.quantize_manifest: List[Dict[str, Any]] = []
        self._qkernels: Dict[str, QuantizedKernel] = {}
        if self.quantize == "int8":
            self._qkernels, self.quantize_manifest = rest_kernels_int8(self.module, params, self.device)
        if self.precision == "w8a8":
            for name, layer in self.module.named_modules():
                if not isinstance(layer, W8A8Dense):
                    continue
                key = f"{name}.weight"
                qk = self._qkernels.pop(key, None)
                w = qk.dequantize(torch.float32) if qk is not None else params[key].float()
                layer.freeze(*quantize_weight(w.to(self.device).t()))
        drop_float_kernels(self.module, self._qkernels)

    @contextlib.contextmanager
    def _materialized(self):
        """The compute-dtype kernels of an ``int8w`` engine for one device
        call (a prefill wave or a decode chunk), never one step; a no-op
        for every other lane."""
        if self._mesh is not None:
            if self.module.qkernels:
                with self._lock:
                    self._counters["weight_materializations"] += 1
            with self.module.materialized():
                yield
            return
        if not self._qkernels:
            yield
            return
        with self._lock:
            self._counters["weight_materializations"] += 1
        with materialized(self.module, self._qkernels, self.dtype):
            yield

    def weight_bytes(self) -> int:
        """Bytes of the model's weights as they rest on the device (int8
        kernels at one byte, their scales and the w8a8 steps included)."""
        if self._mesh is not None:
            return self.module.weight_bytes()
        total = sum(t.numel() * t.element_size() for t in self.module.parameters())
        for qk in self._qkernels.values():
            total += qk.q.numel() * qk.q.element_size() + qk.scale.numel() * qk.scale.element_size()
        for layer in self.module.modules():
            if isinstance(layer, W8A8Dense) and layer.frozen is not None:
                total += sum(t.numel() * t.element_size() for t in layer.frozen)
        return total

    # ---- speculative decoding --------------------------------------------------

    def _init_speculative(self, speculative: Optional[Dict[str, Any]]) -> None:
        """The speculative options, checked as the JAX engine checks them
        (its ``paged.py:2041-2093``): ``draft`` "ngram" (default),
        "oracle" (the ``draft_hint`` a caller submits) or "model";
        ``draft_k`` (default 4) drafts a round; ``ngram`` (default 2).
        ``draft="model"`` takes ``draft_params`` (a ``TransformerLM``
        state_dict) and ``draft_config`` (its sizes, the target's
        vocabulary), and drafts from each stream's last ``draft_window``
        (default 64) tokens."""
        self.speculative = dict(speculative) if speculative else None
        self.draft_k = 0
        self.draft_window = 0
        self._draft_module: Optional[TransformerLM] = None
        if self.speculative is None:
            return
        draft = self.speculative.setdefault("draft", "ngram")
        if draft not in ("ngram", "oracle", "model"):
            raise ValueError("PagedEngine speculative mode supports draft='ngram', draft='oracle' or draft='model'")
        self.speculative.setdefault("draft_k", 4)
        self.speculative.setdefault("ngram", 2)
        self.draft_k = int(self.speculative["draft_k"])
        if self.draft_k < 1:
            raise ValueError("speculative draft_k must be >= 1")
        if draft != "model":
            return
        draft_params = self.speculative.get("draft_params")
        if draft_params is None:
            raise ValueError("draft='model' needs draft_params (and usually "
                             "draft_config={vocab_size,d_model,num_layers,...})")
        dc = dict(self.speculative.get("draft_config") or {})
        dc.setdefault("vocab_size", self.vocab_size)
        if int(dc["vocab_size"]) != self.vocab_size:
            raise ValueError("draft model must share the target's vocab_size")
        self.draft_window = int(self.speculative.get("draft_window", 64))
        dc.setdefault("max_len", self.draft_window)
        if int(dc["max_len"]) < self.draft_window:
            raise ValueError("draft_config.max_len must cover draft_window")
        module = TransformerLM(dtype=self.dtype, **{k: int(v) for k, v in dc.items()})
        module.load_state_dict({k: torch.as_tensor(v) for k, v in draft_params.items()})
        self._draft_module = module.to(self.device).eval().requires_grad_(False)

    def _draft_rollout(self, windows: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """``draft_k`` greedy steps of the draft model for every slot in
        one batched call a step (JAX ``_draft_rollout_fn``): ``windows``
        (slots, W) holds each context's last <= W tokens left-aligned,
        ``lens`` (slots,) their counts; a full window drops its oldest
        token for each new one.  Plain causal attention over the whole
        window; the zeros past ``lens`` are invisible to the positions
        read.  -> (slots, draft_k) int32."""
        W = self.draft_window
        dev = self.device
        win = torch.from_numpy(windows.astype(np.int64)).to(dev)
        ln = torch.from_numpy(lens.astype(np.int64)).to(dev)
        rows = torch.arange(win.shape[0], device=dev)
        toks = []
        for _ in range(self.draft_k):
            logits = self._draft_module(win)
            tok = torch.argmax(logits[rows, torch.clamp(ln - 1, min=0)], dim=-1)
            full = ln >= W
            win = torch.where(full[:, None], torch.cat([win[:, 1:], torch.zeros_like(win[:, :1])], dim=1), win)
            win[rows, torch.where(full, W - 1, ln)] = tok
            ln = torch.clamp(ln + 1, max=W)
            toks.append(tok)
        return torch.stack(toks, dim=1).cpu().numpy().astype(np.int32)

    def _spec_chunk(self, segs: np.ndarray, n_drafts: np.ndarray, active: np.ndarray, tables: np.ndarray,
                    lengths: np.ndarray, adapter_ids: np.ndarray) -> np.ndarray:
        """One verify forward for every slot (JAX ``_spec_chunk_fn``):
        ``segs[i]`` = [pending, d_1..d_k], pads past ``n_drafts[i]``
        never accepted.  The forward scores the ``k + 1`` positions on the
        gather lane, accepts the longest run of drafts equal to the
        target's argmax, and adds the argmax after it (the bonus token).
        K/V of all ``k + 1`` positions of every active lane are written
        (their pages are the stream's own: the last prompt page and every
        page after it are private), but only ``accepted + 1`` become
        visible: the length advances by that, and the next round
        overwrites the rest.  One device-to-host copy returns
        ``(B, k + 3)``: the emitted tokens, then each slot's count and
        new length."""
        dev = self.device
        L = self.draft_k + 1
        segs_t = torch.from_numpy(segs.astype(np.int64)).to(dev)
        lengths_t = torch.from_numpy(lengths).to(dev)
        active_t = torch.from_numpy(active).to(dev)
        tables_t = torch.from_numpy(tables).to(dev)
        offs = torch.arange(L, device=dev)
        positions = torch.clamp(lengths_t.long()[:, None] + offs[None, :], max=self.max_len - 1)
        logits, nk, nv = self.module(segs_t, positions, self.pages_k, self.pages_v, tables_t, lengths_t,
                                     use_kernel=False, **self._model_kwargs(adapter_ids))
        greedy = torch.argmax(logits, dim=-1)  # (B, L)
        n_t = torch.from_numpy(n_drafts.astype(np.int64)).to(dev)
        match = (greedy[:, : L - 1] == segs_t[:, 1:]) & (offs[None, : L - 1] < n_t[:, None])
        accepted = torch.cumprod(match.long(), dim=1).sum(dim=1)
        shifted = torch.cat([segs_t[:, 1:], torch.zeros_like(segs_t[:, :1])], dim=1)
        bonus = greedy.gather(1, accepted[:, None])
        out = torch.where(offs[None, :] < accepted[:, None], shifted,
                          torch.where(offs[None, :] == accepted[:, None], bonus, 0))
        counts = (accepted + 1) * active_t.long()
        write_kv(kv_join(self.pages_k, self.scales_k), kv_join(self.pages_v, self.scales_v), nk, nv, tables_t,
                 lengths_t, active_t[:, None].expand(-1, L), page_size=self.page_size, max_len=self.max_len)
        return torch.cat([out, counts[:, None], lengths_t.long()[:, None] + counts[:, None]], dim=1).cpu().numpy()

    # ---- submission ------------------------------------------------------

    # ---- observability: spans, flight recorder, capture, watchdog ----------

    def _gen_span(self, stream: _Stream, name: str, start_s: float, duration_s: float, **tags: Any) -> None:
        """One gen.* lifecycle span of a stream, linked to the submitter's
        request span by the (trace_id, parent_span_id) pair taken at
        submit.  An untraced stream costs one attribute read."""
        if not stream.trace_id:
            return
        from seldon_core_tpu_torch.utils.tracing import record_span

        record_span(name, stream.trace_id, start_s, duration_s, parent_span_id=stream.parent_span_id,
                    puid=stream.trace_id, req_id=stream.req_id, **tags)

    def _gen_span_deferred(self, stream: _Stream, name: str, start_s: float, duration_s: float,
                           **tags: Any) -> None:
        """Queue a span from code that holds ``_lock``; :meth:`step` emits
        it after the lock drops (a tracer may write to disk)."""
        if stream.trace_id:
            self._pending_spans.append((stream, name, start_s, duration_s, tags))

    def _flush_spans(self) -> None:
        if not self._pending_spans:  # a benign unlocked read: every step flushes again
            return
        with self._lock:
            pending, self._pending_spans = self._pending_spans, []
        for stream, name, start_s, duration_s, tags in pending:
            self._gen_span(stream, name, start_s, duration_s, **tags)

    def _record_chunk(self, rec: Dict[str, Any]) -> None:
        """One wave's record into the flight recorder (naming the decode
        lane it ran), and its wall time into the watchdog.  Host
        bookkeeping only: ``wall_ms`` is the wall time around work that
        already ended in a device-to-host copy."""
        rec.setdefault("kernel_active", int(self._kernel_active))
        if self.recorder is not None:
            self.recorder.record(rec)
        self._feed_watchdog(float(rec.get("wall_ms", 0.0)), fault=False)

    def _note_breach_puids(self, records, path) -> None:
        """The recorder's dump hook: every puid of a breached window is
        captured when its stream ends.  Runs outside the ring lock and
        never takes the engine lock."""
        puids = {p for rec in records for p in rec.get("puids", ()) if p}
        if not puids:
            return
        with self._capture_lock:
            now = self._cost_clock()
            for p in puids:
                self._breach_puids[p] = now
            while len(self._breach_puids) > 1024:
                self._breach_puids.popitem(last=False)

    def capture_trigger(self, puid: str, error: Optional[BaseException]) -> Optional[str]:
        """The trigger of a terminating request, in order: an error, then
        membership of a p99-breach window, then head sampling (every Nth
        completed request).  None: no capture."""
        if not self._capture_enabled:
            return None
        if error is not None:
            return "error"
        with self._capture_lock:
            if puid and self._breach_puids.pop(puid, None) is not None:
                return "breach"
            self._capture_seen += 1
            if self._capture_sample > 0 and self._capture_seen % self._capture_sample == 0:
                return "sample"
        return None

    def capture_request(self, stream: _Stream, *, puid: str, trigger: str, status: str = "ok", reason: str = "",
                        tokens=None, extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Store one request's black box: its phase terms, the recorder's
        records of its waves, its cost totals, the sampling recipe and
        seed, and the knob snapshot a replay rebuilds from.  Runs outside
        the engine lock; a failure is logged and never reaches serving.
        Returns the container's path."""
        if not self._capture_enabled:
            return None
        from seldon_core_tpu_torch.utils import capture as _capture

        try:
            waves = []
            if self.recorder is not None:
                waves = [r for r in self.recorder.snapshot() if puid in r.get("puids", ())]
            extra = extra or {}
            cap = _capture.RequestCapture(
                puid=puid, trace_id=stream.trace_id, status=status, reason=reason, trigger=trigger,
                seed=extra.get("request_seed"), max_new_tokens=stream.max_new,
                temperature=float(stream.temperature), top_k=int(stream.top_k), eos_id=stream.eos_id,
                adapter=stream.adapter, priority=int(stream.priority),
                deadline_remaining_ms=extra.get("deadline_remaining_ms"), rows=int(extra.get("rows", 1)),
                phases=_capture.phase_terms(stream.t_submit, stream.t_prefill_start, stream.t_decode_start,
                                            stream.t_first_token, stream.t_finish),
                waves=waves,
                cost={"page_seconds": stream.cost_page_s, "prefill_tokens": stream.cost_prefill_tokens,
                      "decode_tokens": stream.cost_decode_tokens, "preemptions": stream.cost_preempts,
                      "restores": stream.cost_restores, "adapter": stream.adapter or "base"},
                knobs=_capture.knob_snapshot(),
                model=dict(extra.get("model") or {}),
                tags=dict(extra.get("tags") or {}),
                time=_capture.now(),
                prompt=np.asarray(stream.prompt, np.int32).reshape(-1),
                tokens=(np.asarray(tokens, np.int32).reshape(-1) if tokens is not None
                        else np.asarray(stream.tokens, np.int32)),
            )
            path = _capture.default_store().put(cap)
        except Exception:  # noqa: BLE001 — forensics never breaks serving
            logger.exception("request capture failed (puid=%s)", puid)
            return None
        if path is not None:
            with self._lock:
                self._counters["captures"] += 1
        return path

    def _feed_watchdog(self, wall_ms: float, fault: bool) -> None:
        """One wave into the health watchdog: its wall time, whether it
        faulted, the pool's occupancy, and its compile events since the
        last wave (the sentinels' first calls under a new signature, kernel
        libraries built or loaded), which exempt it from the wall ceiling."""
        wd = self._watchdog
        if wd is None:
            return
        from seldon_core_tpu_torch.ops import _build

        seen = sum(s.compiles for s in self._sentinels.values())
        built = _build.build_events()
        compiles = seen - self._wd_compiles + built - self._wd_builds
        self._wd_compiles, self._wd_builds = seen, built
        with self._lock:
            used = self.num_pages - 1 - len(self._free_pages) - len(self._lru)
        wd.observe(wall_ms=wall_ms, compiled=compiles > 0, fault=fault,
                   pool_used_pct=100.0 * used / max(1, self.num_pages - 1), compiles_delta=compiles)

    def _quarantine_poisoned(self, runnable: List[_Stream], finite: Optional[np.ndarray]) -> List[_Stream]:
        """Retire every runnable stream whose lane's logits went
        non-finite (``finite``: the NaN screen's column of the chunk's one
        device-to-host copy, slot-major) with 500 ``NUMERIC_POISON`` and a
        ``quarantined`` count, before the harvest delivers its tokens.
        Its wave-mates are untouched: lanes are independent.  The
        speculative verify lane is not screened (its logits never reach
        the host)."""
        if finite is None or not runnable:
            return []
        poisoned = [s for s in runnable if not finite[s.slot]]
        if not poisoned:
            return []
        with self._lock:
            for s in poisoned:
                self._counters["quarantined"] += 1
                self._fail_stream_locked(s, MicroserviceError(
                    f"stream req {s.req_id} quarantined: served logits went non-finite after {len(s.tokens)} "
                    "tokens (numeric poison contained to this stream; its wave-mates are unaffected)",
                    status_code=500, reason="NUMERIC_POISON"))
        logger.error("NaN guard quarantined %d stream(s): %s", len(poisoned), [s.req_id for s in poisoned])
        return poisoned

    def _contain_chunk_fault(self, streams: List[_Stream], exc: Exception) -> bool:
        """A chunk that failed before its device work: only the streams
        that would have run it fail (503 ``ENGINE_CHUNK_FAULT``), every
        other slot and the queue stay, the allocator stays consistent,
        and the watchdog counts a fault.  Returns step()'s value."""
        err = MicroserviceError(f"decode chunk failed: {exc}", status_code=503, reason="ENGINE_CHUNK_FAULT")
        with self._lock:
            self._counters["chunk_faults"] += 1
            for stream in streams:
                self._fail_stream_locked(stream, err)
            more = self._wave_end_locked()
        self._feed_watchdog(0.0, fault=True)
        return more

    def _profile_before_chunk(self) -> None:
        """``SELDON_TPU_PROFILE_DIR``: the first N decode chunks run under
        one ``torch.profiler`` session; a profiler failure turns the hook
        off, never decoding."""
        if self._profile_chunks_left <= 0 or self._profiler is not None:
            return
        try:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()
            logger.info("profiling the next %d decode chunks to %s", self._profile_chunks_left, self._profile_dir)
        except Exception:  # noqa: BLE001 — the hook goes off, decoding goes on
            logger.exception("torch profiler start failed; hook disabled")
            self._profiler = None
            self._profile_chunks_left = 0

    def _profile_after_chunk(self) -> None:
        if self._profiler is None:
            return
        self._profile_chunks_left -= 1
        if self._profile_chunks_left > 0:
            return
        prof, self._profiler = self._profiler, None
        try:
            prof.__exit__(None, None, None)
            os.makedirs(self._profile_dir, exist_ok=True)
            path = os.path.join(self._profile_dir, f"paged-chunks-{os.getpid()}-{int(time.time() * 1000)}.json")
            prof.export_chrome_trace(path)
            logger.info("decode-chunk profile written to %s", path)
        except Exception:  # noqa: BLE001 — a profiler failure never stops decoding
            logger.exception("torch profiler stop failed")

    def submit(self, prompt, max_new_tokens: int = 32, temperature: float = 0.0, top_k: int = 0,
               eos_id: int = -1, seed: int = 0, adapter: Optional[str] = None, priority: int = 0,
               deadline: Optional[float] = None, stream_tokens: bool = False,
               draft_hint: Optional[np.ndarray] = None, kv_export: bool = False,
               kv_import: Optional[Dict[str, Any]] = None, trace_id: str = "",
               parent_span_id: Optional[str] = None, puid: str = "") -> _Stream:
        """Queue one prompt (1-D int array).  Returns a stream handle whose
        ``event`` fires when ``result`` (``(max_new,)`` ids) is ready.
        ``stream_tokens`` gives it a ``token_queue``: each decode chunk's
        new tokens (cut at eos and at ``max_new``, as ``result`` is) go on
        it as lists as they land, and None ends it on every way out.

        ``priority`` (higher wins) orders admission, shedding and
        preemption; ``deadline`` is an absolute ``time.monotonic()``
        expiry: a spent one fails at once with 504, a queued stream whose
        budget dies is dropped before it reaches the device, and a
        decoding one retires at the next chunk boundary.  Both default to
        every stream equal and none expiring, the engine's FIFO.

        ``adapter`` names the LoRA weight set the stream decodes with: a
        resident adapter pins its pool slot for the stream's lifetime, a
        cold one loads through the weight registry first, on this thread
        (load -> pin -> serve -> unpin).  ``None`` is the base model:
        slot 0, no lookup, no pin.

        ``draft_hint`` (a speculative engine with ``draft="oracle"``): the
        continuation the caller expects, drafted from in place of a
        lookup.  A speculative engine refuses ``temperature > 0`` and
        keeps ``draft_k + 1`` positions of headroom past ``max_new``.

        ``kv_export``: the stream finishes at the end of its prefill with
        its pages read back into ``stream.kv_payload`` (no decode);
        ``kv_import``: a checked page payload written into the pool at
        admission in place of a prefill.  :meth:`prefill_export`,
        :meth:`submit_prefilled` and :meth:`migrate_import` are the
        fronts that check payloads.

        ``puid`` names the request in flight-recorder records and capture
        containers (tracer or not).  With a tracer installed the stream's
        gen.* spans join ``trace_id`` under ``parent_span_id``, by default
        the caller's active span's (the decode loop runs on another
        thread, so the link is taken here); an explicit ``trace_id``
        wins."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        plen = len(prompt)
        if plen < 1:
            raise MicroserviceError("empty prompt", status_code=400, reason="BAD_REQUEST")
        max_new_tokens = int(max_new_tokens)
        if max_new_tokens < 1:
            raise MicroserviceError("max_new_tokens must be >= 1", status_code=400, reason="BAD_REQUEST")
        if self.speculative is not None and temperature > 0:
            raise MicroserviceError(
                "the speculative engine is greedy-exact only: verification compares the model's argmax against "
                "drafts, which has no meaning under sampling — deploy without speculative (or send "
                "temperature=0) for this request", status_code=400, reason="BAD_REQUEST")
        # the verify segment writes up to draft_k + 1 positions past the
        # accepted length
        headroom = self.draft_k + 1 if self.speculative is not None else 0
        bucket = next((b for b in self.prompt_buckets if b >= plen), None)
        if bucket is None or plen + max_new_tokens + headroom > self.max_len:
            raise MicroserviceError(f"prompt {plen} + max_new {max_new_tokens} exceeds max_len {self.max_len}",
                                    status_code=400, reason="SEQUENCE_TOO_LONG")
        # the ceiling is the whole non-trash pool: cached prefix pages are
        # reclaimable, so a warm cache never shrinks the admissible size
        need = -(-(plen + max_new_tokens + headroom) // self.page_size)
        if need > self.num_pages - 1:
            raise MicroserviceError(f"request needs {need} pages but the pool holds {self.num_pages - 1}",
                                    status_code=400, reason="SEQUENCE_TOO_LONG")
        if deadline is not None and time.monotonic() >= deadline:
            # a spent budget burns no queue place, wave or step
            raise deadline_exceeded("paged-engine submit")
        adapter = adapter or None
        if adapter is not None:
            # the cheap refusals first: an overload burst about to shed (or
            # a closed engine) must not thrash warm adapters with cold loads
            with self._lock:
                self._check_open_locked()
                if self.max_queue and len(self._queue) >= self.max_queue:
                    self._shed_for_admission_locked(int(priority))
        adapter_slot = self._acquire_adapter_slot(adapter) if adapter is not None else 0
        try:
            with self._lock:
                self._check_open_locked()
                if self.max_queue and len(self._queue) >= self.max_queue:
                    self._shed_for_admission_locked(int(priority))
                stream = _Stream(self._next_id, prompt, max_new_tokens, float(temperature), int(top_k),
                                 int(eos_id), int(seed), adapter_slot=adapter_slot)
                stream.adapter = adapter
                stream.priority = int(priority)
                stream.deadline = float(deadline) if deadline is not None else None
                stream.t_submit = time.time()
                stream.queue_depth_at_submit = len(self._queue)
                stream.puid = str(puid or trace_id or "")
                from seldon_core_tpu_torch.utils import tracing as _tracing

                if _tracing.get_tracer() is not None:  # one global read when tracing is off
                    enclosing = _tracing.current_span()
                    stream.trace_id = trace_id or (enclosing.trace_id if enclosing is not None
                                                   else f"gen-{stream.req_id}")
                    stream.parent_span_id = parent_span_id or (enclosing.span_id if enclosing is not None
                                                               else None)
                stream.kv_export = bool(kv_export)
                stream.kv_import = kv_import
                if stream_tokens:
                    stream.token_queue = queue.Queue()
                if draft_hint is not None:
                    stream.draft_hint = np.asarray(draft_hint, np.int32).reshape(-1)
                if adapter_slot:
                    # the submit's temporary pin becomes the stream's
                    self._drop_temp_pin_locked(adapter_slot)
                    self._adapter_requests[adapter] = self._adapter_requests.get(adapter, 0) + 1
                self._next_id += 1
                self._queue.append(stream)
                self._queued.add(stream)
        except BaseException:
            if adapter_slot:
                with self._lock:
                    self._drop_temp_pin_locked(adapter_slot)
                    self._unpin_adapter_slot_locked(adapter_slot)
            raise
        return stream

    def submit_views(self, views, **kwargs) -> List[_Stream]:
        """Batched admission for the zero-copy lane (JAX
        ``paged.py:3413-3450``): N token buffers (``codec.bufview``
        ``BufferView`` s or arrays; an int32 one stays a view over its
        buffer, no copy) are decoded to 1-D int32 prompts and admitted in
        one pass.  Each stream keeps exactly :meth:`submit`'s semantics
        (validation, queue-bound shedding, priority admission, deadline
        fast-fail); ``kwargs`` apply to every view.  Admission is
        all-or-nothing: when a later view's admission raises, every stream
        this call already admitted is cancelled before the error surfaces,
        so none decodes tokens nobody holds a handle to."""
        from seldon_core_tpu_torch.codec.bufview import BufferView

        prompts = []
        for v in views:
            arr = v.array() if isinstance(v, BufferView) else np.asarray(v)
            prompts.append(arr.astype(np.int32, copy=False).reshape(-1))
        admitted: List[_Stream] = []
        try:
            for p in prompts:
                admitted.append(self.submit(p, **kwargs))
        except BaseException:
            for stream in admitted:
                try:
                    self.cancel(stream)
                except Exception:  # noqa: BLE001 — the admission error below is the one the caller acts on
                    logger.exception("submit_views rollback cancel failed")
            raise
        return admitted

    def _check_open(self) -> None:
        with self._lock:
            self._check_open_locked()

    def _check_open_locked(self) -> None:
        if self._closed:
            raise MicroserviceError("engine closed", status_code=503, reason="SHUTTING_DOWN")

    # ---- multi-LoRA adapter pool: slots, pins, LRU reclaim -----------------

    def _unpin_adapter_slot_locked(self, slot: int) -> None:
        """Drop one pin on a pool slot; the last pin parks the slot on the
        adapter LRU (still resident, reclaimed only when a cold load
        needs it)."""
        r = int(self._adapter_ref[slot]) - 1
        self._adapter_ref[slot] = max(r, 0)
        if r <= 0 and slot in self._adapter_names:
            self._adapter_lru[slot] = self._adapter_names[slot]

    def _release_adapter_locked(self, stream: _Stream) -> None:
        """The terminal-path unpin (finish, cancel, failure): exactly once
        per stream, which ``adapter_pinned`` guards."""
        if not stream.adapter_pinned:
            return
        stream.adapter_pinned = False
        self._unpin_adapter_slot_locked(stream.adapter_slot)

    def _drop_temp_pin_locked(self, slot: int) -> None:
        n = self._adapter_temp_pins.get(slot, 0) - 1
        if n > 0:
            self._adapter_temp_pins[slot] = n
        else:
            self._adapter_temp_pins.pop(slot, None)

    def _install_adapter(self, name: str, params: Dict[str, Any]) -> int:
        """Place one adapter's factors into a pool slot (under
        ``_adapter_io_lock``, not ``_lock``): a free slot, or the LRU
        refcount-0 one reclaimed; every slot pinned is a clean 503.  A
        wrong-rank or partial adapter is a 400 with the slot returned
        untouched.  The returned slot carries one temporary pin."""
        victim: Optional[str] = None
        with self._lock:
            if self._adapter_free:
                slot = self._adapter_free.pop()
            elif self._adapter_lru:
                slot, victim = self._adapter_lru.popitem(last=False)
                del self._adapter_table[victim]
                self._adapter_names.pop(slot, None)
                self._counters["adapter_evictions"] += 1
            else:
                raise MicroserviceError(f"adapter pool exhausted: all {self.max_adapters} slots pinned by live "
                                        "streams", status_code=503, reason="ADAPTERS_EXHAUSTED")
            self._adapter_installing.add(slot)
        if victim is not None and victim in self._adapter_reg_pinned:
            # the evicted adapter's host copy becomes reclaimable registry capacity
            self._adapter_reg_pinned.discard(victim)
            self._registry.release(victim)
        # no lane reads this slot (it was free or unpinned), so the install
        # runs outside _lock and never stalls the decode loop
        try:
            self._lora.install(slot, params)
        except ValueError as exc:
            with self._lock:
                self._adapter_installing.discard(slot)
                self._adapter_free.append(slot)
            raise MicroserviceError(f"adapter {name!r} does not fit this engine's factor pool: {exc}",
                                    status_code=400, reason="ADAPTER_INCOMPATIBLE") from exc
        except BaseException:
            with self._lock:
                self._adapter_installing.discard(slot)
                self._adapter_free.append(slot)
            raise
        with self._lock:
            self._adapter_installing.discard(slot)
            self._adapter_table[name] = slot
            self._adapter_names[slot] = name
            self._adapter_ref[slot] = 1
            self._adapter_temp_pins[slot] = self._adapter_temp_pins.get(slot, 0) + 1
            self._counters["adapter_loads"] += 1
        return slot

    def _acquire_adapter_slot(self, name: str) -> int:
        """Resolve ``name`` to a pinned pool slot: a resident adapter is a
        hit (its pin count grows), a cold one loads through the weight
        registry and installs.  The pin is a temporary one until
        :meth:`submit` hands it to the stream."""
        if self._lora is None:
            raise MicroserviceError("this engine serves no adapters (max_adapters=0 / SELDON_TPU_MAX_ADAPTERS "
                                    "unset)", status_code=400, reason="ADAPTERS_DISABLED")
        # the resident path never takes the io lock: check-and-pin is
        # atomic under _lock, so warm submits never wait for a cold load
        with self._lock:
            slot = self._pin_resident_adapter_locked(name)
            if slot is not None:
                return slot
        with self._adapter_io_lock:
            with self._lock:
                # a concurrent cold load may have installed it meanwhile
                slot = self._pin_resident_adapter_locked(name)
                if slot is not None:
                    return slot
                self._counters["adapter_misses"] += 1
            if self._registry is None or not self._registry.known(name):
                raise MicroserviceError(f"unknown adapter {name!r}: not resident and not registered in the "
                                        "weight registry", status_code=404, reason="ADAPTER_UNKNOWN")
            params = self._registry.acquire(name)
            try:
                slot = self._install_adapter(name, params)
            except BaseException:
                self._registry.release(name)
                raise
            # the registry pin is held while the adapter stays resident here
            self._adapter_reg_pinned.add(name)
            return slot

    def _pin_resident_adapter_locked(self, name: str) -> Optional[int]:
        """The hit path: pin ``name``'s slot (a temporary pin) if it is
        resident, else None."""
        slot = self._adapter_table.get(name)
        if slot is None:
            return None
        self._counters["adapter_hits"] += 1
        self._adapter_ref[slot] += 1
        self._adapter_temp_pins[slot] = self._adapter_temp_pins.get(slot, 0) + 1
        self._adapter_lru.pop(slot, None)
        return slot

    def load_adapter(self, name: str, params: Optional[Dict[str, Any]] = None) -> int:
        """Hot-load ``name`` into the pool without serving from it: install
        ``params`` directly, or pull it from the registry when omitted.
        Returns the slot; the adapter parks unpinned on the LRU."""
        if params is None:
            slot = self._acquire_adapter_slot(name)
        else:
            if self._lora is None:
                raise MicroserviceError("this engine serves no adapters (max_adapters=0)", status_code=400,
                                        reason="ADAPTERS_DISABLED")
            with self._adapter_io_lock:
                with self._lock:
                    slot = self._adapter_table.get(name)
                    if slot is not None:
                        return slot
                slot = self._install_adapter(name, params)
        with self._lock:
            self._drop_temp_pin_locked(slot)
            self._unpin_adapter_slot_locked(slot)
        return slot

    def unload_adapter(self, name: str) -> None:
        """Evict a resident adapter (rolling re-deploys).  A pinned one
        refuses with 409: live streams never have their factors swapped
        mid-decode."""
        with self._adapter_io_lock:
            with self._lock:
                slot = self._adapter_table.get(name)
                if slot is None:
                    return
                if int(self._adapter_ref[slot]) > 0:
                    raise MicroserviceError(f"adapter {name!r} is pinned by live streams", status_code=409,
                                            reason="ADAPTER_IN_USE")
                del self._adapter_table[name]
                self._adapter_names.pop(slot, None)
                self._adapter_lru.pop(slot, None)
                self._adapter_free.append(slot)
            if name in self._adapter_reg_pinned:
                self._adapter_reg_pinned.discard(name)
                self._registry.release(name)

    def adapter_stats(self) -> Dict[str, Any]:
        """Residency, per-slot pins and the factor pool's device bytes."""
        with self._lock:
            resident = [{"name": name, "slot": slot, "refcount": int(self._adapter_ref[slot]),
                         "cached": slot in self._adapter_lru}
                        for name, slot in sorted(self._adapter_table.items())]
            return {
                "enabled": self._lora is not None,
                "max_adapters": self.max_adapters,
                "rank": self._lora.rank if self._lora is not None else 0,
                "pool_bytes": self._lora.hbm_bytes() if self._lora is not None else 0,
                "resident": resident,
                "requests": dict(self._adapter_requests),
            }

    def _model_kwargs(self, adapter_ids: np.ndarray) -> Dict[str, Any]:
        """The pool's scale tables and the adapter pool with its lanes' slot
        ids, as the model takes them."""
        kw: Dict[str, Any] = {}
        if self._kv_int8:
            kw["kv_scales"] = (self.scales_k, self.scales_v)
        if self._lora is not None:
            kw["lora"] = self._lora.device_args()
            kw["adapter_idx"] = torch.from_numpy(np.ascontiguousarray(adapter_ids, np.int32)).to(self.device)
        return kw

    # ---- refcounted page allocator + prefix cache (caller holds _lock) -------

    def _allocatable_locked(self) -> int:
        """Pages available now: the free list plus the cached set
        (refcount-0 prefix pages reclaim on demand)."""
        return len(self._free_pages) + len(self._lru)

    def _evict_cached_locked(self) -> None:
        """Reclaim the least recently used cached page: unregister it from
        the prefix index and return it to the free list (staged for the
        KV tier first when it is on)."""
        page, entry = self._lru.popitem(last=False)
        self._prefix_index.pop(entry.key, None)
        self._page_entry.pop(page, None)
        if self._kv_tier is not None:
            # demoted, not discarded: its K/V stays valid until the next
            # pool write, and _tier_flush runs before every one
            self._tier_pending.append((entry.key, entry.parent, entry.tokens, page))
        self._free_pages.append(page)
        self._counters["prefix_evictions"] += 1

    def _alloc_locked(self, n: int) -> Optional[List[int]]:
        """Take ``n`` fresh pages (refcount 1 each), reclaiming cached
        pages under pressure; None when even that does not cover ``n``,
        or when the ``paged.alloc`` fault point fires (it reports
        exhaustion as a full pool would)."""
        if _faults.fire("paged.alloc"):
            return None
        if self._allocatable_locked() < n:
            return None
        while len(self._free_pages) < n:
            self._evict_cached_locked()
        out = [self._free_pages.popleft() for _ in range(n)]
        for p in out:
            self._page_ref[p] = 1
        return out

    def _free_locked(self, pages: List[int]) -> None:
        """Release one stream's mapping of ``pages``.  A page whose
        refcount drops to 0 parks on the LRU when it is a registered
        prefix page (its K/V stays valid for a later match), else returns
        to the free list.  Reversed, so a stream's deepest prefix pages
        enter the LRU first and are reclaimed before the parents a chain
        walk passes through."""
        for p in reversed(pages):
            r = int(self._page_ref[p]) - 1
            self._page_ref[p] = max(r, 0)
            if r > 0:
                continue
            entry = self._page_entry.get(p)
            if entry is not None and self._prefix_cache_enabled:
                self._lru[p] = entry
            else:
                if entry is not None:
                    self._prefix_index.pop(entry.key, None)
                    self._page_entry.pop(p, None)
                self._free_pages.append(p)

    # ---- the cost ledger ------------------------------------------------------

    def _cost_touch_locked(self, stream: _Stream) -> None:
        """Accrue the stream's KV occupancy integral up to now: called
        just before every change to ``len(stream.pages)`` (growth, free,
        eviction), so ``cost_page_s`` is exact at page-count granularity.
        No clock read with the telemetry plane off."""
        if not self._telemetry_enabled:
            return
        now = self._cost_clock()
        if stream.cost_t:
            stream.cost_page_s += (now - stream.cost_t) * len(stream.pages)
        stream.cost_t = now

    def _cost_close_locked(self, stream: _Stream) -> None:
        """Fold one terminating stream's ledger into the engine totals and
        the per-adapter split, once a stream (``cost_closed``): both from
        the same event, so the split sums to the totals exactly."""
        if not self._telemetry_enabled or stream.cost_closed:
            return
        self._cost_touch_locked(stream)
        stream.cost_t = 0.0
        stream.cost_closed = True
        self._counters["cost_page_seconds"] += stream.cost_page_s
        self._counters["cost_prefill_tokens"] += stream.cost_prefill_tokens
        self._counters["cost_decode_tokens"] += stream.cost_decode_tokens
        entry = self._cost_by_adapter.setdefault(
            stream.adapter or "base", {"page_seconds": 0.0, "prefill_tokens": 0, "decode_tokens": 0, "streams": 0})
        entry["page_seconds"] += stream.cost_page_s
        entry["prefill_tokens"] += stream.cost_prefill_tokens
        entry["decode_tokens"] += stream.cost_decode_tokens
        entry["streams"] += 1

    def _prefix_root_for(self, adapter: Optional[str]) -> int:
        """The chain root of a weight set: an adapter's prefill writes
        other K/V than the base model's for the same tokens, so each
        adapter chains off its own root."""
        if not adapter:
            return _PREFIX_ROOT
        return prefix_chain_key(_PREFIX_ROOT, (adapter,))

    def _match_prefix_locked(self, prompt: np.ndarray, root: int) -> List[_CachedPrefix]:
        """The longest cached chain of full prompt pages, root to leaf.
        The last prompt page always stays private (the suffix prefill
        needs one token to give the next-token logits), and a key that
        collides compares parent and tokens before it is shared."""
        if not self._prefix_cache_enabled:
            return []
        ps = self.page_size
        matched: List[_CachedPrefix] = []
        parent = root
        for i in range((len(prompt) - 1) // ps):
            toks = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            key = prefix_chain_key(parent, toks)
            entry = self._prefix_index.get(key)
            if entry is None or entry.parent != parent or entry.tokens != toks:
                break
            matched.append(entry)
            parent = key
        return matched

    def _register_prefix_locked(self, stream: _Stream) -> None:
        """Publish a prefilled stream's full prompt pages in the prefix
        index.  A key already registered keeps its page (the stream's own
        stays private), and a key that collides with other tokens stops
        the walk: nothing unverified is shared."""
        if not self._prefix_cache_enabled or stream.slot is None:
            return
        if self._slots[stream.slot] is not stream:
            # the stream lost its slot since admission (fail_all, cancel):
            # its pages are already released
            return
        ps = self.page_size
        prompt = stream.prompt
        parent = self._prefix_root_for(stream.adapter)
        for i in range((len(prompt) - 1) // ps):
            toks = tuple(int(t) for t in prompt[i * ps:(i + 1) * ps])
            key = prefix_chain_key(parent, toks)
            entry = self._prefix_index.get(key)
            if entry is None:
                page = stream.pages[i]
                if page not in self._page_entry:
                    e = _CachedPrefix(key, page, toks, parent)
                    self._prefix_index[key] = e
                    self._page_entry[page] = e
                    if self._kv_tier is not None:
                        # one residency a key: the pool's copy supersedes
                        # a demoted one
                        self._kv_tier.discard(key)
            elif entry.parent != parent or entry.tokens != toks:
                break
            parent = key

    def _check_invariants_locked(self) -> None:
        """The ``SELDON_TPU_PAGED_DEBUG=1`` audit: the non-trash pages
        partition into free, cached and mapped; refcounts equal the live
        block tables holding each page; every LRU entry agrees with the
        prefix index; the adapter slots balance; the KV tier is sound and
        shares no key with the prefix index."""
        problems: List[str] = []
        free = list(self._free_pages)
        free_set = set(free)
        if len(free_set) != len(free):
            problems.append("duplicate pages on the free list")
        cached = set(self._lru)
        mapped: Dict[int, int] = {}
        for s in self._slots:
            if s is None:
                continue
            for i, p in enumerate(s.pages):
                mapped[p] = mapped.get(p, 0) + 1
                if int(self._block_tables[s.slot, i]) != p:
                    problems.append(f"slot {s.slot} block table col {i} != stream page {p}")
        for a, b, name in ((free_set, cached, "free∩cached"), (free_set, set(mapped), "free∩mapped"),
                           (cached, set(mapped), "cached∩mapped")):
            if a & b:
                problems.append(f"pages simultaneously {name}: {sorted(a & b)}")
        every = free_set | cached | set(mapped)
        want = set(range(1, self.num_pages))
        if every != want:
            problems.append(f"leaked pages {sorted(want - every)} / phantom {sorted(every - want)}")
        for p in want:
            if int(self._page_ref[p]) != mapped.get(p, 0):
                problems.append(f"page {p} refcount {int(self._page_ref[p])} != {mapped.get(p, 0)} live mappings")
        for p, entry in self._lru.items():
            if entry.page != p or self._prefix_index.get(entry.key) is not entry \
                    or self._page_entry.get(p) is not entry:
                problems.append(f"LRU entry for page {p} inconsistent with index")
        problems.extend(self._adapter_problems_locked())
        if self._kv_tier is not None:
            # the tier's own levels and bytes, and no key both in the pool
            # and in the tier (registration discards, promotion pops)
            problems.extend(self._kv_tier.audit())
            dual = self._kv_tier.keys() & set(self._prefix_index)
            if dual:
                problems.append(f"prefix keys resident in HBM AND the KV tier: {sorted(dual)}")
        if problems:
            raise RuntimeError("paged allocator invariant violation: " + "; ".join(problems))

    def _adapter_problems_locked(self) -> List[str]:
        """The audit over the adapter slots: the non-zero slots partition
        into free, resident and installing; each slot's refcount equals
        its streams' pins plus in-submit temporary pins; the adapter LRU
        holds exactly the unpinned residents."""
        if self._lora is None:
            return []
        problems: List[str] = []
        free = set(self._adapter_free)
        named = set(self._adapter_names)
        installing = set(self._adapter_installing)
        if free & named:
            problems.append(f"adapter slots simultaneously free and named: {sorted(free & named)}")
        if (free | named) & installing:
            problems.append(f"adapter slots simultaneously installing and free/named: "
                            f"{sorted((free | named) & installing)}")
        if free | named | installing != set(range(1, self.max_adapters + 1)):
            problems.append("adapter slots leaked or phantom")
        pins: Dict[int, int] = dict(self._adapter_temp_pins)
        for s in list(self._queue) + [s for s in self._slots if s is not None]:
            if s.adapter_pinned:
                pins[s.adapter_slot] = pins.get(s.adapter_slot, 0) + 1
        for slot in range(1, self.max_adapters + 1):
            want = pins.get(slot, 0)
            if int(self._adapter_ref[slot]) != want:
                problems.append(f"adapter slot {slot} refcount {int(self._adapter_ref[slot])} != {want} pins")
            lru = slot in self._adapter_lru
            if lru and int(self._adapter_ref[slot]) > 0:
                problems.append(f"adapter slot {slot} cached while pinned")
            if slot in named and not lru and int(self._adapter_ref[slot]) == 0:
                problems.append(f"adapter slot {slot} resident, unpinned, but not on the LRU")
        for slot, name in self._adapter_lru.items():
            if self._adapter_table.get(name) != slot:
                problems.append(f"adapter LRU entry {name!r}@{slot} inconsistent with table")
        return problems

    # ---- SLO lifecycle: shed / expire / preempt ------------------------------

    def _remove_queued_locked(self, stream: _Stream) -> None:
        if stream in self._queued:
            self._queue.remove(stream)
            self._queued.discard(stream)

    def _release_slot_locked(self, stream: _Stream) -> None:
        """Give back the stream's slot, its pages and its lane's table."""
        slot = stream.slot
        if slot is not None and self._slots[slot] is stream:
            self._slots[slot] = None
            self._lengths[slot] = 0
            self._block_tables[slot] = 0
        if stream.pages:
            self._free_locked(stream.pages)
            stream.pages = []

    def _fail_stream_locked(self, stream: _Stream, exc: Exception) -> None:
        """Error-terminate one stream, queued or in a slot (shed, expiry):
        slot and pages released, the waiter woken with ``exc``."""
        stream.error = exc
        stream.t_finish = time.time()
        if stream.trace_id:
            self._gen_span_deferred(stream, "gen.finish", stream.t_finish, 0.0, slot=stream.slot,
                                    tokens=len(stream.tokens), error=True,
                                    reason=getattr(exc, "reason", type(exc).__name__))
        self._cost_close_locked(stream)
        self._tier_putback_locked(stream)
        self._release_slot_locked(stream)
        stream.slot = None
        self._release_adapter_locked(stream)
        self._end_stream_locked(stream)
        stream.event.set()

    def _shed_expired_queued_locked(self) -> int:
        """Drop queued streams whose budget is spent: they never reach
        the device.  Returns the number dropped."""
        if not self._queue:
            return 0
        now = time.monotonic()
        victims = [s for s in self._queue if s.deadline is not None and now >= s.deadline]
        for s in victims:
            self._remove_queued_locked(s)
            self._counters["expired"] += 1
            self._fail_stream_locked(s, deadline_exceeded(f"paged-engine queue (req {s.req_id})"))
        return len(victims)

    def _shed_for_admission_locked(self, priority: int) -> None:
        """Make room in a full bounded queue for an arriving submit:
        expired streams go first; then the lowest-priority queued stream
        (the newest within its class) sheds, but only when it ranks
        strictly below the newcomer, else the newcomer is refused.  Both
        are 503 ``SHED``."""
        self._shed_expired_queued_locked()
        if len(self._queue) < self.max_queue:
            return
        victim = min(self._queue, key=lambda s: (s.priority, -s.req_id))
        self._counters["shed"] += 1
        if victim.priority >= priority:
            raise MicroserviceError(
                f"queue full ({self.max_queue}) and every queued stream has "
                f"priority >= {priority}: request shed under overload",
                status_code=503, reason="SHED",
            )
        self._remove_queued_locked(victim)
        self._fail_stream_locked(
            victim,
            MicroserviceError(
                f"shed under overload: queue full ({self.max_queue}) and a "
                f"priority-{priority} request arrived "
                f"(this stream: priority {victim.priority})",
                status_code=503, reason="SHED",
            ),
        )

    def _preempt_victim_locked(self, stream: _Stream) -> Optional[_Stream]:
        """The in-flight stream ``stream`` may evict: strictly lower
        priority (least priority, then least progress, ties to the
        youngest).  Equal classes never preempt each other."""
        candidates = [s for s in self._slots if s is not None and s.priority < stream.priority]
        if not candidates:
            return None
        return min(candidates, key=lambda s: (s.priority, len(s.tokens), -s.req_id))

    def _preempt_locked(self, stream: _Stream) -> Optional[int]:
        """Evict the best victim for ``stream``; returns its freed slot, or
        None when nothing is preemptible.  The victim re-queues at the
        head and re-derives on restore."""
        victim = self._preempt_victim_locked(stream)
        if victim is None:
            return None
        slot = victim.slot
        self._counters["preempted"] += 1
        victim.preempted = True
        victim.cost_preempts += 1
        self._evict_locked(victim)
        return slot

    def _try_admit_locked(self, slot: int, stream: _Stream) -> bool:
        """One admission of ``stream`` into ``slot``: the prefix match
        mapped (refcount + 1), the chain walked on into the KV tier when
        it is on (each popped page is promoted in place of its prefill),
        fresh pages for the rest of the prompt and, for a migration, its
        decoded tokens; False rolls the match back (deepest page re-parked
        first) and puts the tier entries back.  A KV import maps no shared
        page: its write would land in pages other streams read."""
        plen = len(stream.prompt)
        matched = ([] if stream.kv_import is not None
                   else self._match_prefix_locked(stream.prompt, self._prefix_root_for(stream.adapter)))
        for e in matched:
            if int(self._page_ref[e.page]) == 0:
                self._lru.pop(e.page, None)
            self._page_ref[e.page] += 1
        tier_hits = self._tier_walk_locked(stream, matched)
        extra = 0
        if stream.kv_import is not None and stream.kv_import.get("tokens") is not None:
            extra = len(stream.kv_import["tokens"])
        fresh = self._alloc_locked(-(-(plen + extra) // self.page_size) - len(matched))
        if fresh is None:
            for key, parent, toks, _payload, blob, _level in reversed(tier_hits):
                self._kv_tier.put(key, parent, toks, blob)
            for e in reversed(matched):
                self._page_ref[e.page] -= 1
                if int(self._page_ref[e.page]) == 0:
                    self._lru[e.page] = e
            return False
        self._remove_queued_locked(stream)
        stream.slot = slot
        stream.pages = [e.page for e in matched] + fresh
        if self._telemetry_enabled:
            # the occupancy integral starts (or restarts) here
            stream.cost_t = self._cost_clock()
        stream.cached_len = len(matched) * self.page_size
        stream.prefilled = stream.cached_len
        if self._prefix_cache_enabled:
            if matched:
                self._counters["prefix_hits"] += 1
                self._counters["prefix_tokens_saved"] += stream.cached_len
            else:
                self._counters["prefix_misses"] += 1
        if tier_hits:
            # the tier's pages land in the first fresh pages (they continue
            # the matched chain in table order) and the prefill cursor jumps
            # past them; the prefix counters above keep counting the pool
            n_t = len(tier_hits)
            stream.tier_promote = {"pages": fresh[:n_t], "entries": tier_hits}
            stream.cached_len = (len(matched) + n_t) * self.page_size
            stream.prefilled = stream.cached_len
            self._counters["kv_tier_promotions"] += 1
            for _key, _par, _toks, _payload, blob, level in tier_hits:
                self._counters["kv_tier_host_hits" if level == "host" else "kv_tier_disk_hits"] += 1
                self._counters["kv_tier_bytes_promoted"] += len(blob)
        if stream.preempted:
            stream.preempted = False
            stream.cost_restores += 1
            self._counters["restored"] += 1
        self._slots[slot] = stream
        self._block_tables[slot] = 0
        self._block_tables[slot, : len(stream.pages)] = stream.pages
        self._lengths[slot] = plen
        # the lane's adapter slot id: every call gathers its factors by it
        self._adapter_slots[slot] = stream.adapter_slot
        return True

    def _tier_walk_locked(self, stream: _Stream, matched: List[_CachedPrefix]) -> list:
        """The chain walk past the pool's match into the KV tier: each
        full prompt page the tier holds is popped (the admission owns
        it), up to the first miss; the uncached full pages from there
        count as ``kv_tier_misses``.  A container whose CRC fails is a
        miss (the tier has dropped it)."""
        tier = self._kv_tier
        if tier is None or stream.kv_import is not None or not self._prefix_cache_enabled:
            return []
        from seldon_core_tpu_torch.codec.tensor import PayloadError

        ps = self.page_size
        n_full = (len(stream.prompt) - 1) // ps
        parent = matched[-1].key if matched else self._prefix_root_for(stream.adapter)
        hits = []
        for i in range(len(matched), n_full):
            toks = tuple(int(t) for t in stream.prompt[i * ps:(i + 1) * ps])
            key = prefix_chain_key(parent, toks)
            try:
                got = tier.pop(key, parent, toks)
            except PayloadError as exc:
                logger.warning("KV tier container for chain key %d rejected: %s", key, exc)
                got = None
            if got is None:
                self._counters["kv_tier_misses"] += n_full - i
                break
            payload, blob, level = got
            hits.append((key, parent, toks, payload, blob, level))
            parent = key
        return hits

    def _admit_locked(self) -> List[Tuple[_Stream, int]]:
        """Move queued streams into slots; returns ``(stream, prompt
        length)`` per admission.  Expired queued streams drop first; then
        the highest-priority queued stream takes the next slot, FIFO
        within a class (with every priority 0, the FIFO).  A stream that
        finds no slot, or no pages with a slot in hand, may preempt a
        strictly lower-priority in-flight stream; otherwise the wave
        stops (no shorter request overtakes the head)."""
        admitted: List[Tuple[_Stream, int]] = []
        self._shed_expired_queued_locked()
        free_slots: Deque[int] = deque(i for i in range(self.max_slots) if self._slots[i] is None)
        while self._queue:
            stream = max(self._queue, key=lambda s: s.priority)
            if not free_slots:
                slot = self._preempt_locked(stream)
                if slot is None:
                    break
                free_slots.append(slot)
                continue
            if self._try_admit_locked(free_slots[0], stream):
                admitted.append((stream, len(stream.prompt)))
                free_slots.popleft()
                continue
            slot = self._preempt_locked(stream)
            if slot is None:
                break
            free_slots.append(slot)
        return admitted

    # ---- prefill -------------------------------------------------------------

    def _pages_pow2(self, need_pages: int) -> int:
        """A page count rounded up to a power of two, capped at the
        per-stream table width (the JAX engine's shape ladder)."""
        p = 1
        while p < need_pages:
            p *= 2
        return min(p, self.pages_per_stream)

    def _prefill_streams(self, streams: List[_Stream]) -> Tuple[List[_Stream], int, float]:
        """Monolithic prefill (no token budget): every admitted stream's
        uncached suffix in this wave.  Returns what
        :meth:`_run_prefill_slices` does."""
        return self._run_prefill_slices([(s, s.prefilled, len(s.prompt) - s.prefilled) for s in streams])

    def _plan_prefill_slices_locked(self, prefilling: List[_Stream], budget: int) -> List[Tuple[_Stream, int, int]]:
        """The wave's prefill slices under ``budget`` tokens: pending
        prompts priority-first then FIFO, each taking what is left,
        floored to a page boundary unless the slice ends the prompt (the
        next slice's start must stay page-aligned)."""
        slices: List[Tuple[_Stream, int, int]] = []
        left = int(budget)
        ps = self.page_size
        for s in sorted(prefilling, key=lambda s: (-s.priority, s.req_id)):
            need = len(s.prompt) - s.prefilled
            if left < ps:
                continue
            n = min(left, need)
            if n < need:
                n = (n // ps) * ps
            if n <= 0:
                continue
            slices.append((s, s.prefilled, n))
            left -= n
        return slices

    def _run_prefill_slices(self, slices: List[Tuple[_Stream, int, int]]) -> Tuple[List[_Stream], int, float]:
        """One wave's prefill work, ``(stream, start, n)`` slices with
        ``start`` page-aligned: whole uncached prompts through the
        from-zero call, everything else (a cached prefix, a later slice)
        through the cached-suffix call, one call per bucket; a KV import's
        pages are written first, in place of its prefill.  Returns the
        streams whose prompt is now whole (their full prompt pages enter
        the prefix index, and a ``kv_export`` stream resolves with its
        payload instead of decoding), the prompt tokens computed and the
        wave's prefill wall seconds."""
        if not slices:
            return [], 0, 0.0
        # staged demotions are gathered before this wave can overwrite them
        self._tier_flush()
        t0 = time.perf_counter()
        t_admit = time.time()
        plain: Dict[int, List[Tuple[_Stream, int, int]]] = {}
        cached: Dict[int, List[Tuple[_Stream, int, int]]] = {}
        tokens = 0
        completed: List[_Stream] = []
        for stream, start, _n in slices:
            if not stream.t_prefill_start:
                stream.t_prefill_start = t_admit
            # the queue wait: one span a stream, on its first slice
            if stream.trace_id and start == stream.cached_len:
                self._gen_span(stream, "gen.queued", stream.t_submit or t_admit,
                               max(0.0, t_admit - stream.t_submit) if stream.t_submit else 0.0,
                               slot=stream.slot, queue_depth=stream.queue_depth_at_submit)
        for stream, start, n in slices:
            if stream.kv_import is not None:
                self._import_kv_stream(stream)
                completed.append(stream)
                continue
            bucket = next(b for b in self.prompt_buckets if b >= n)
            target = plain if start == 0 and n == len(stream.prompt) else cached
            target.setdefault(bucket, []).append((stream, start, n))
            tokens += n
        with torch.inference_mode(), self._materialized():
            for bucket, group in plain.items():
                completed.extend(self._prefill_group(bucket, group, use_cache=False))
            for bucket, group in cached.items():
                completed.extend(self._prefill_group(bucket, group, use_cache=True))
        calls = len(plain) + len(cached)
        wall = time.perf_counter() - t0
        with self._lock:
            if calls:
                self._counters["prefill_wall_s"] += wall
                self._counters["prefill_tokens"] += tokens
                self._counters["prefill_chunks"] += calls
            for stream in completed:
                self._register_prefix_locked(stream)
        exports = [s for s in completed if s.kv_export]
        if exports:
            self._export_streams(exports)
            completed = [s for s in completed if not s.kv_export]
        return completed, tokens, wall

    def _prefill_group(self, bucket: int, group: List[Tuple[_Stream, int, int]], use_cache: bool) -> List[_Stream]:
        """One batched prefill call for same-bucket slices: ``k`` rows, a
        power of two; pad rows (one token, table row 0, adapter slot 0)
        write only the trash page.

        ``use_cache``: the suffix call, each row attending over its
        ``start`` resident tokens (shared prefix pages, earlier slices)
        through a read table, the gather lane's cached attention, and
        writing through a table shifted to the page after them (``start``
        is page-aligned, so every write starts at offset 0).  Otherwise
        the from-zero call.  Installs the last-token logits of the
        streams whose prompt is now whole, and returns them."""
        t_group = time.time()
        k = 1
        while k < len(group):
            k *= 2
        ps = self.page_size
        padded = np.zeros((k, bucket), np.int64)
        true_lens = np.ones((k,), np.int64)  # pad rows: 1 token -> trash
        cached_lens = np.zeros((k,), np.int64)
        adapter_rows = np.zeros((k,), np.int32)
        if use_cache:
            rp = self._pages_pow2(max(1, max(start // ps for _s, start, _n in group)))
            wp = -(-bucket // ps)
            read_rows = np.zeros((k, rp), np.int32)
            write_rows = np.zeros((k, wp), np.int32)
        else:
            pages_h = self._pages_pow2(-(-bucket // ps))
            read_rows = write_rows = np.zeros((k, pages_h), np.int32)
        for i, (stream, start, n) in enumerate(group):
            padded[i, :n] = stream.prompt[start:start + n]
            true_lens[i] = n
            cached_lens[i] = start
            adapter_rows[i] = stream.adapter_slot
            if use_cache:
                read_rows[i] = self._block_tables[stream.slot, :rp]
                row = self._block_tables[stream.slot, start // ps: start // ps + wp]
                write_rows[i, : len(row)] = row
            else:
                read_rows[i] = self._block_tables[stream.slot, :pages_h]
        dev = self.device
        tokens = torch.from_numpy(padded).to(dev)
        cached_t = torch.from_numpy(cached_lens).to(dev)
        positions = torch.clamp(cached_t[:, None] + torch.arange(bucket, device=dev)[None, :], max=self.max_len - 1)
        last_pos = torch.from_numpy(true_lens - 1).to(dev)
        reads = torch.from_numpy(read_rows).to(dev)
        writes = reads if not use_cache else torch.from_numpy(write_rows).to(dev)
        static = f"cached,bucket={bucket},k={k},rp={rp}" if use_cache else f"bucket={bucket},k={k}"
        last, nk, nv = self._sentinels["paged_prefill"].wrap(self.module, static=static)(
            tokens, positions, self.pages_k, self.pages_v, reads, cached_t.int(), use_kernel=self._kernel_active,
            select=last_pos, **self._model_kwargs(adapter_rows))
        zeros = torch.zeros((k,), dtype=torch.int32, device=dev)
        write_kv(kv_join(self.pages_k, self.scales_k), kv_join(self.pages_v, self.scales_v), nk, nv, writes, zeros,
                 None, page_size=ps, max_len=self.max_len, from_zero=True)
        finals = []
        for i, (stream, start, n) in enumerate(group):
            stream.prefilled = start + n
            stream.cost_prefill_tokens += n
            if stream.prefilled >= len(stream.prompt):
                finals.append((i, stream))
        if not finals:
            return []
        rows = torch.tensor([i for i, _s in finals], device=dev)
        slots = torch.tensor([s.slot for _i, s in finals], device=dev)
        final_logits = last[rows, 0]
        self._logits[slots] = final_logits
        if self.speculative is not None:
            # the verify rounds start from each prompt's greedy token: one
            # readback for the group
            for (_i, stream), tok in zip(finals, torch.argmax(final_logits, dim=-1).tolist()):
                stream.pending = int(tok)
        exports = [(j, stream) for j, (_i, stream) in enumerate(finals) if stream.kv_export]
        if exports:
            # the handoff carries the last-token logits: the decode engine
            # samples without a forward of its own
            last_np = final_logits.float().cpu().numpy()
            for j, stream in exports:
                stream.kv_payload = {"last_logits": last_np[j]}
        t_done = time.time()
        for _i, stream in finals:
            # seeded when the prompt is whole, so an evicted stream's
            # re-derived run draws the same tokens again
            stream.generator = (torch.Generator(device=dev).manual_seed(stream.seed % (1 << 63))
                                if stream.temperature > 0 else None)
            stream.t_decode_start = t_done
            # the group prefills in one call: each member's span carries
            # the group's wall, tagged with the group's size
            self._gen_span(stream, "gen.prefill", t_group, t_done - t_group, slot=stream.slot, bucket=bucket,
                           prompt_len=len(stream.prompt), cached_tokens=stream.cached_len,
                           pages_held=len(stream.pages), group_size=len(group))
        return [s for _i, s in finals]

    # ---- KV handoff, live migration and the KV tier ------------------------

    def _import_kv_stream(self, stream: _Stream) -> None:
        """Write an imported payload's pages into this pool (plain tensor
        indexing, the JAX engine's ``.at[:, pages].set``) and install the
        stream's decode state: its last logits, its sampler, and for a
        migration its decoded tokens and streaming cursor.  Afterwards it
        decodes as a stream that prefilled here."""
        self._tier_flush()
        t0 = time.time()
        payload = stream.kv_import
        plen = len(stream.prompt)
        mig_tokens = payload.get("tokens")
        extra = 0 if mig_tokens is None else len(mig_tokens)
        total = plen + extra
        slot = stream.slot
        dev = self.device
        last = np.asarray(payload["last_logits"], np.float32).reshape(-1)
        with torch.inference_mode():
            pages = torch.tensor(stream.pages[: -(-total // self.page_size)], dtype=torch.long, device=dev)
            for pool, name in ((self.pages_k, "k"), (self.pages_v, "v"), (self.scales_k, "k_scales"),
                               (self.scales_v, "v_scales")):
                if pool is not None:
                    pool[:, pages] = _host_tensor(payload[name]).to(dev)
            self._logits[slot] = torch.tensor(last, device=dev)
        stream.generator = self._import_sampler(stream, payload.get("key_data"))
        if self.speculative is not None:
            pending = payload.get("pending")
            stream.pending = int(pending) if pending is not None else int(np.argmax(last))
        stream.prefilled = plen
        migration = bool(payload.get("migration"))
        if extra:
            stream.tokens = [int(t) for t in np.asarray(mig_tokens).reshape(-1)]
        if migration:
            stream.streamed = int(payload.get("streamed") or 0)
        stream.t_decode_start = time.time()
        with self._lock:
            if extra:
                # decode resumes mid-sequence, over the decoded tokens' K/V too
                self._lengths[slot] = total
            stream.kv_import = None  # consumed: the host copy goes
            stream.kv_imported = True
            self._counters["migrated_in" if migration else "kv_imports"] += 1
        self._gen_span(stream, "gen.prefill", t0, stream.t_decode_start - t0, slot=slot, bucket=0, prompt_len=plen,
                       cached_tokens=0, pages_held=len(stream.pages), group_size=1, imported=True,
                       migrated=migration)

    def _import_sampler(self, stream: _Stream, key_data) -> Optional[torch.Generator]:
        """A sampled stream's generator on this engine's device: the
        source's state when the payload carries one (the same sample path
        goes on), else seeded from the stream's seed as a prefill does."""
        if stream.temperature <= 0:
            return None
        gen = torch.Generator(device=self.device)
        words = np.asarray(key_data if key_data is not None else [], np.uint32).reshape(-1)
        if words.size:
            gen.set_state(torch.from_numpy(words.view(np.uint8).copy()))
        else:
            gen.manual_seed(stream.seed % (1 << 63))
        return gen

    def _check_sampler_state(self, temperature: float, key_data, kind: str) -> None:
        """A sampled stream resumes only from a state of this engine's
        generator kind: a JAX key or another device's state is a 400."""
        words = np.asarray(key_data if key_data is not None else [], np.uint32).reshape(-1)
        if temperature <= 0 or not words.size:
            return
        want = torch.Generator(device=self.device).get_state().numel()
        if words.size * 4 != want:
            raise MicroserviceError(
                f"{kind} key_data carries {words.size * 4} bytes of sampler state, but this engine's "
                f"{self.device.type} torch.Generator state is {want} bytes: a sampled stream resumes only from a "
                "state of its engine's generator kind", status_code=400, reason="RNG_STATE_MISMATCH")

    def _tier_flush(self) -> None:
        """Gather every staged demotion to the host as one-page handoff
        containers and hand them to the KV tier.  It runs before every
        pool write (a prefill wave, an import, a promotion, a decode
        chunk): a staged page sits on the free list with its K/V valid
        only until the next write, and the gather is ordered before that
        write on the device and finished (read back) before it is
        enqueued.  A chain demoted in this wave promotes from the next."""
        tier = self._kv_tier
        if tier is None:
            return
        with self._lock:
            if not self._tier_pending:
                return
            pending, self._tier_pending = self._tier_pending, []
            # a key registered again since it was staged is in the pool
            pending = [e for e in pending if e[0] not in self._prefix_index]
        if not pending:
            return
        from seldon_core_tpu_torch.codec.bufview import pack_kv_handoff

        host = self._gather_pages([e[3] for e in pending])
        demoted = bytes_demoted = evicted = 0
        for i, (key, parent, toks, _page) in enumerate(pending):
            payload = {
                "prompt": np.asarray(toks, np.int32),
                # a demoted page has no next-token logits; promotion never reads the frame
                "last_logits": np.zeros((1,), np.float32),
                **{name: t[:, i:i + 1] for name, t in host.items()},
                "page_size": self.page_size,
                "layout": "split",
            }
            blob = pack_kv_handoff(payload)
            evicted += tier.put(key, parent, toks, blob)
            demoted += 1
            bytes_demoted += len(blob)
        with self._lock:
            self._counters["kv_tier_demotions"] += demoted
            self._counters["kv_tier_bytes_demoted"] += bytes_demoted
            self._counters["kv_tier_evictions"] += evicted

    def _tier_promote_ready(self) -> None:
        """Write every newly admitted stream's promoted tier chain into its
        fresh pages, right after the admission wave and before any prefill
        or decode touches the streams (staged demotions gathered first)."""
        if self._kv_tier is None:
            return
        self._tier_flush()
        with self._lock:
            todo = []
            for s in self._slots:
                if s is not None and s.tier_promote is not None:
                    todo.append(s.tier_promote)
                    s.tier_promote = None
        if not todo:
            return
        with torch.inference_mode():
            for tp in todo:
                pages = torch.tensor(tp["pages"], dtype=torch.long, device=self.device)
                for pool, name in ((self.pages_k, "k"), (self.pages_v, "v"), (self.scales_k, "k_scales"),
                                   (self.scales_v, "v_scales")):
                    if pool is not None:
                        pool[:, pages] = torch.cat([_host_tensor(e[3][name]) for e in tp["entries"]],
                                                   dim=1).to(self.device)

    def _tier_putback_locked(self, stream: _Stream) -> None:
        """Return a promotion the stream never consumed to the tier (it
        died between admission and its promotion): its pages landed
        nowhere, and dropping them would lose them."""
        tp = stream.tier_promote
        if tp is None:
            return
        stream.tier_promote = None
        if self._kv_tier is None:
            return
        for key, parent, toks, _payload, blob, _level in reversed(tp["entries"]):
            self._kv_tier.put(key, parent, toks, blob)

    def _gather_pages(self, pages: List[int]) -> Dict[str, Any]:
        """The K/V of ``pages`` on the host: CPU tensors of the pool's
        dtype, and an int8 pool's float32 scale tables."""
        with torch.inference_mode():
            idx = torch.tensor(pages, dtype=torch.long, device=self.device)
            out: Dict[str, Any] = {"k": self.pages_k[:, idx].cpu(), "v": self.pages_v[:, idx].cpu()}
            if self._kv_int8:
                out["k_scales"] = self.scales_k[:, idx].cpu().numpy()
                out["v_scales"] = self.scales_v[:, idx].cpu().numpy()
        return out

    def _export_streams(self, streams: List[_Stream]) -> None:
        """Resolve ``kv_export`` streams with their handoff payload
        (prompt, the prompt's pages, last-token logits), then free their
        pages the usual way (the full prompt pages stay in the prefix
        index)."""
        for stream in streams:
            P = -(-len(stream.prompt) // self.page_size)
            payload = {
                "prompt": np.asarray(stream.prompt, np.int32),
                **self._gather_pages(stream.pages[:P]),
                "last_logits": np.asarray((stream.kv_payload or {}).get("last_logits"), np.float32).reshape(-1),
                "page_size": self.page_size,
                "layout": "split",
            }
            with self._lock:
                stream.kv_payload = payload
                slot = stream.slot
                self._cost_close_locked(stream)
                self._release_slot_locked(stream)
                stream.slot = None
                self._release_adapter_locked(stream)
                self._counters["kv_exports"] += 1
                self._counters["completed"] += 1
                if stream.trace_id:
                    self._gen_span_deferred(stream, "gen.finish", time.time(), 0.0, slot=slot, tokens=0,
                                            kv_export=True)
                stream.event.set()

    def prefill_export(self, prompt, *, seed: int = 0, priority: int = 0, deadline: Optional[float] = None,
                       drive: bool = True, adapter: Optional[str] = None) -> Dict[str, Any]:
        """Prefill ``prompt`` and return its KV-page handoff payload for
        :meth:`submit_prefilled` on a decode engine.  ``drive=False`` when
        another thread steps this engine."""
        stream = self.submit(np.asarray(prompt), max_new_tokens=1, seed=seed, priority=priority, deadline=deadline,
                             kv_export=True, adapter=adapter)
        if drive:
            while not stream.event.is_set() and self.has_work():
                self.step()
        stream.event.wait()
        if stream.error is not None:
            raise stream.error
        return stream.kv_payload

    def _check_pages(self, k: torch.Tensor, v: torch.Tensor, P: int, kind: str, what: str) -> None:
        """Payload pages must fit this pool: ``(layers, P, page_size,
        heads, head_dim)`` in the pool's dtype (a flat, rank-4 stack of a
        JAX flat pool fails here), or their write would serve garbage."""
        want = (self.num_layers, P) + tuple(self.pages_k.shape[2:])
        for name, arr in (("k", k), ("v", v)):
            if tuple(arr.shape) != want:
                raise MicroserviceError(
                    f"{kind} {name} shape {tuple(arr.shape)} does not fit this engine's pool geometry {want} "
                    f"({what}, page tail)", status_code=400, reason="KV_LAYOUT_MISMATCH")
            if arr.dtype != self.pages_k.dtype:
                raise MicroserviceError(f"{kind} {name} dtype {_dtype_name(arr)} != pool dtype "
                                        f"{_dtype_name(self.pages_k)}", status_code=400, reason="KV_LAYOUT_MISMATCH")

    def _check_page_size(self, payload: Dict[str, Any], kind: str, who: str) -> None:
        ps = int(payload.get("page_size", self.page_size))
        if ps != self.page_size:
            raise MicroserviceError(f"{kind} page_size {ps} != engine page_size {self.page_size}: {who} must share "
                                    "one pool configuration", status_code=400, reason="KV_LAYOUT_MISMATCH")

    def _check_last_logits(self, last: np.ndarray, kind: str) -> None:
        if last.shape[0] != self.vocab_size:
            raise MicroserviceError(f"{kind} last_logits carries {last.shape[0]} entries, engine vocab is "
                                    f"{self.vocab_size}", status_code=400, reason="KV_LAYOUT_MISMATCH")

    def submit_prefilled(self, payload: Dict[str, Any], **kw) -> _Stream:
        """Admit a prefill worker's KV-page payload for decode; ``kw``
        goes to :meth:`submit`.  The payload is checked against this
        pool's geometry first: a write of mismatched pages would serve
        garbage rather than raise."""
        prompt = np.asarray(payload["prompt"], np.int32).reshape(-1)
        k, v = _host_tensor(payload["k"]), _host_tensor(payload["v"])
        last = np.asarray(payload["last_logits"], np.float32).reshape(-1)
        self._check_page_size(payload, "KV payload", "prefill and decode workers")
        P = -(-len(prompt) // self.page_size)
        self._check_pages(k, v, P, "KV payload", "layers, prompt pages")
        self._check_last_logits(last, "KV payload")
        kv = {"k": k, "v": v, "last_logits": last}
        if self._kv_int8:
            kv["k_scales"], kv["v_scales"] = self._validate_kv_scales(payload, P, "KV payload")
        return self.submit(prompt, kv_import=kv, **kw)

    def _validate_kv_scales(self, payload: Dict[str, Any], P: int, kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """An int8 payload's per-page scale tables against this pool: an
        int8 page without its scale would serve garbage rather than raise."""
        out = []
        for name in ("k_scales", "v_scales"):
            arr = payload.get(name)
            if arr is None:
                raise MicroserviceError(
                    f"{kind} carries int8 pages but no {name} frame — int8 KV containers must carry one f32 "
                    "scale per page per k/v", status_code=400, reason="KV_LAYOUT_MISMATCH")
            arr = _host_tensor(arr)
            want = (self.num_layers, P)
            if tuple(arr.shape) != want:
                raise MicroserviceError(f"{kind} {name} shape {tuple(arr.shape)} does not fit the scale-table "
                                        f"geometry {want} (layers, pages)", status_code=400,
                                        reason="KV_LAYOUT_MISMATCH")
            if arr.dtype != torch.float32:
                raise MicroserviceError(f"{kind} {name} dtype {_dtype_name(arr)} != float32", status_code=400,
                                        reason="KV_LAYOUT_MISMATCH")
            out.append(arr)
        return out[0], out[1]

    def migrate_export(self, streams=None) -> List[Tuple[Dict[str, Any], _Stream]]:
        """Snapshot mid-decode streams for live migration to a peer: the
        K/V pages of the prompt and the decoded tokens, the decode cursor
        (the tokens so far), the last logits, the sampler's state, the
        sampling terms, the deadline left, the priority, the adapter and
        the streaming cursor: what :meth:`migrate_import` needs to resume
        at the exact next token.  Call with the step loop quiesced.

        Exports those of ``streams`` (default: every stream in a slot)
        that are whole (prefill done, not an export or an import), not on
        a speculative engine (their draft state stays here: they fall
        back to the drain journal), and whose cache length is their
        prompt plus their tokens.  An exported stream leaves this engine
        (slot and pages released, ``migrated_out`` counted) with its
        waiter unresolved: the caller adopts it on a peer
        (``migrate_import(payload, stream=s)``) or fails it and journals
        its recipe."""
        now = time.monotonic()
        with self._lock:
            candidates = list(streams) if streams is not None else [s for s in self._slots if s is not None]
            exportable = [s for s in candidates
                          if s.slot is not None and self._slots[s.slot] is s and not s.cancelled
                          and not s.kv_export and s.kv_import is None and s.prefilled >= len(s.prompt)
                          and self.speculative is None]
        out: List[Tuple[Dict[str, Any], _Stream]] = []
        for s in exportable:
            slot = s.slot
            total = len(s.prompt) + len(s.tokens)
            if int(self._lengths[slot]) != total:
                # cursor and cache disagree: no inconsistent snapshot
                logger.warning("migrate_export skipping req %d: cache length %d != prompt+decoded %d", s.req_id,
                               int(self._lengths[slot]), total)
                continue
            state = (np.frombuffer(s.generator.get_state().numpy().tobytes(), np.uint32).copy()
                     if s.generator is not None else np.zeros((0,), np.uint32))
            payload = {
                "req_id": s.req_id,
                "prompt": np.asarray(s.prompt, np.int32),
                "tokens": np.asarray(s.tokens, np.int32),
                **self._gather_pages(s.pages[: -(-total // self.page_size)]),
                "last_logits": self._logits[slot].float().cpu().numpy(),
                "key_data": state,
                "max_new_tokens": int(s.max_new),
                "temperature": float(s.temperature),
                "top_k": int(s.top_k),
                "eos_id": int(s.eos_id),
                "seed": int(s.seed),
                "priority": int(s.priority),
                "deadline_remaining_ms": max(0.0, (s.deadline - now) * 1000.0) if s.deadline is not None else None,
                "streamed": int(s.streamed),
                "stream_tokens": s.token_queue is not None,
                "adapter": s.adapter,
                "pending": s.pending,
                "page_size": self.page_size,
                "layout": "split",
            }
            with self._lock:
                if self._slots[slot] is not s:
                    continue  # retired meanwhile
                # the work this engine spent stays attributed here
                self._cost_close_locked(s)
                self._release_slot_locked(s)
                s.slot = None
                self._release_adapter_locked(s)
                self._counters["migrated_out"] += 1
            out.append((payload, s))
        self._flush_spans()
        return out

    def migrate_import(self, payload: Dict[str, Any], *, stream: Optional[_Stream] = None,
                       stream_tokens: Optional[bool] = None) -> _Stream:
        """Admit a :meth:`migrate_export` payload: its pages are written
        at admission, its cursor, sampler and logits installed as the
        source held them, and decode resumes at the exact next token.

        ``stream`` (in-process evacuation) adopts the source engine's
        stream object, so its waiter and token queue carry on; without
        it (a container from another process) a fresh stream is built
        from the payload's recipe, streaming as ``stream_tokens`` says
        (default: as the payload says)."""
        prompt = np.asarray(payload["prompt"], np.int32).reshape(-1)
        tokens = np.asarray(payload.get("tokens", []), np.int32).reshape(-1)
        k, v = _host_tensor(payload["k"]), _host_tensor(payload["v"])
        last = np.asarray(payload["last_logits"], np.float32).reshape(-1)
        self._check_page_size(payload, "migration payload", "source and target engines")
        P = -(-(len(prompt) + len(tokens)) // self.page_size)
        self._check_pages(k, v, P, "migration payload", "layers, prompt+decoded pages")
        self._check_last_logits(last, "migration payload")
        key_data = np.asarray(payload.get("key_data", []), np.uint32).reshape(-1)
        kv = {"k": k, "v": v, "last_logits": last, "tokens": tokens, "key_data": key_data,
              "streamed": int(payload.get("streamed") or 0), "pending": payload.get("pending"), "migration": True}
        if self._kv_int8:
            kv["k_scales"], kv["v_scales"] = self._validate_kv_scales(payload, P, "migration payload")
        self._check_sampler_state(float(payload.get("temperature", 0.0)), key_data, "migration payload")
        rem = payload.get("deadline_remaining_ms")
        deadline = time.monotonic() + max(0.0, float(rem)) / 1000.0 if rem is not None else None
        if stream is None:
            want_stream = bool(payload.get("stream_tokens")) if stream_tokens is None else bool(stream_tokens)
            return self.submit(prompt, max_new_tokens=int(payload.get("max_new_tokens", 32)),
                               temperature=float(payload.get("temperature", 0.0)), top_k=int(payload.get("top_k", 0)),
                               eos_id=int(payload.get("eos_id", -1)), seed=int(payload.get("seed", 0)),
                               priority=int(payload.get("priority", 0)), deadline=deadline, stream_tokens=want_stream,
                               adapter=payload.get("adapter") or None, kv_import=kv)
        # in-process adoption: the source's stream object joins this
        # engine's queue with its waiter, token queue and cursor
        plen, max_new = len(prompt), int(stream.max_new)
        bucket = next((b for b in self.prompt_buckets if b >= plen), None)
        if bucket is None or plen + max_new > self.max_len:
            raise MicroserviceError(f"prompt {plen} + max_new {max_new} exceeds max_len {self.max_len}",
                                    status_code=400, reason="SEQUENCE_TOO_LONG")
        need = -(-(plen + max_new) // self.page_size)
        if need > self.num_pages - 1:
            raise MicroserviceError(f"request needs {need} pages but the pool holds {self.num_pages - 1}",
                                    status_code=400, reason="SEQUENCE_TOO_LONG")
        adapter = stream.adapter or None
        if adapter is not None:
            with self._lock:
                self._check_open_locked()
                if self.max_queue and len(self._queue) >= self.max_queue:
                    self._shed_for_admission_locked(int(stream.priority))
        adapter_slot = self._acquire_adapter_slot(adapter) if adapter is not None else 0
        try:
            with self._lock:
                self._check_open_locked()
                if self.max_queue and len(self._queue) >= self.max_queue:
                    self._shed_for_admission_locked(int(stream.priority))
                stream.slot = None
                stream.pages = []
                stream.cached_len = 0
                stream.prefilled = 0
                stream.tokens = []
                stream.generator = None
                stream.kv_import = kv
                stream.kv_imported = False
                stream.kv_export = False
                stream.kv_payload = None
                stream.tier_promote = None
                stream.cancelled = False
                stream.preempted = False
                stream.error = None
                stream.result = None
                stream.deadline = deadline
                stream.adapter_slot = int(adapter_slot)
                if adapter_slot:
                    stream.adapter_pinned = True
                    self._drop_temp_pin_locked(adapter_slot)
                    self._adapter_requests[adapter] = self._adapter_requests.get(adapter, 0) + 1
                stream.queue_depth_at_submit = len(self._queue)
                self._queue.append(stream)
                self._queued.add(stream)
            return stream
        except BaseException:
            if adapter_slot:
                with self._lock:
                    self._drop_temp_pin_locked(adapter_slot)
                    self._unpin_adapter_slot_locked(adapter_slot)
            raise

    def fail_stream(self, stream: _Stream, exc: Exception) -> None:
        """Error-terminate one detached stream (a migration no peer took:
        its waiter resolves, the journal covers the re-derivation)."""
        with self._lock:
            if stream.result is not None or stream.error is not None:
                return
            self._fail_stream_locked(stream, exc)

    def predict_cost_s(self, prompt_len: int, max_new: int) -> Optional[float]:
        """Predicted service seconds of one request from this engine's
        measured rates (wall over tokens, prefill and decode); None while
        nothing is measured."""
        with self._lock:
            ptok, pwall = self._counters["prefill_tokens"], self._counters["prefill_wall_s"]
            dtok, dwall = self._counters["tokens"], self._counters["chunk_wall_s"]
        if ptok <= 0 or pwall <= 0 or dtok <= 0 or dwall <= 0:
            return None
        return float(prompt_len) * (pwall / ptok) + float(max_new) * (dwall / dtok)

    # ---- decode chunk ------------------------------------------------------

    def _pages_horizon(self, runnable: List[_Stream], per_chunk: int) -> int:
        """Block-table columns the next chunk needs: the longest runnable
        stream plus this chunk, in pages, rounded up to a power of two."""
        if not runnable:
            return 1
        need = max(int(self._lengths[s.slot]) for s in runnable) + per_chunk
        return self._pages_pow2(-(-need // self.page_size))

    def _ensure_pages_locked(self, stream: _Stream, per_chunk: int) -> bool:
        """Grow the stream's block table to cover its next ``per_chunk``
        tokens (never past its prompt plus ``max_new``, plus a speculative
        engine's ``draft_k + 1``: the verify segment writes past the
        accepted length); False when the pool cannot back it (the stream
        stalls this wave)."""
        slot = stream.slot
        cap = len(stream.prompt) + stream.max_new + (self.draft_k + 1 if self.speculative is not None else 0)
        horizon = min(int(self._lengths[slot]) + per_chunk, cap, self.max_len)
        need = -(-horizon // self.page_size)
        if len(stream.pages) < need:
            self._cost_touch_locked(stream)
        while len(stream.pages) < need:
            got = self._alloc_locked(1)
            if got is None:
                return False
            self._block_tables[slot, len(stream.pages)] = got[0]
            stream.pages.extend(got)
        return True

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

    def _plan_buckets(self, runnable: List[_Stream], steps: int,
                      pages_h: int) -> Tuple[Tuple[Tuple[int, int], ...], np.ndarray]:
        """The next chunk's length buckets, ``((lanes, pages), ...)``
        summing to ``max_slots`` lanes, and the slot permutation that
        sorts the lanes into them (the JAX engine's ``_plan_buckets``).

        Two halves of ``max_slots // 2`` lanes: the shorter half of the
        runnable lanes anchors bucket 0, the longer half bucket 1, and
        idle or stalled lanes (whose compute is discarded) fill what is
        left of each.  A bucket's width is the power-of-two page count of
        its longest runnable lane: the pages at the chunk's start for the
        ring chunk, plus this chunk's growth for the pool chunk (its
        in-chunk tokens are read back from the pool).  One bucket of
        ``pages_h`` whenever the two widths agree, fewer than 2 lanes run
        or ``SELDON_TPU_CTX_BUCKETS=1``."""
        B = self.max_slots
        ident = np.arange(B, dtype=np.int32)
        grow = steps if self._chunk_impl == "pool" else 0

        def h_of(ctx_tokens: int) -> int:
            return min(self._pages_pow2(max(1, -(-(ctx_tokens + grow) // self.page_size))), pages_h)

        if not runnable:
            return ((B, 1),), ident
        h_all = h_of(max(int(self._lengths[s.slot]) for s in runnable))
        if self._ctx_buckets < 2 or B < 2 or len(runnable) < 2:
            return ((B, h_all),), ident
        B0 = B // 2
        run_lanes = sorted((int(self._lengths[s.slot]), s.slot) for s in runnable)
        k0 = min(len(run_lanes) // 2, B0)
        h0 = h_of(run_lanes[k0 - 1][0]) if k0 else 1
        h1 = h_of(run_lanes[-1][0])
        if h0 == h1:
            return ((B, h_all),), ident
        live = {g for _, g in run_lanes}
        idle = [g for g in range(B) if g not in live]
        fill0 = B0 - k0
        order = np.asarray([g for _, g in run_lanes[:k0]] + idle[:fill0]
                           + [g for _, g in run_lanes[k0:]] + idle[fill0:], np.int32)
        return ((B0, h0), (B - B0, h1)), order

    def _chunk(self, steps: int, buckets, perm: np.ndarray, tables: np.ndarray, lengths: np.ndarray,
               done: np.ndarray, max_new: np.ndarray, eos_ids: np.ndarray, samplers,
               adapter_ids: np.ndarray, nan_victim: Optional[int] = None) -> np.ndarray:
        """``steps`` decode steps of every slot as device work; one
        device-to-host copy at the end returns ``(B, steps + 2)``: the
        tokens, then each slot's emitted count and new length, and with
        the NaN guard on one more column, whether each slot's logits are
        all finite (the screen rides the same copy: no second sync).

        With two buckets every per-slot input is permuted bucket-sorted
        here and every output back, so the engine's state stays
        slot-major.  The pool chunk or the ring chunk runs the steps, as
        the engine's ``chunk_impl`` says.  ``nan_victim``: the slot the
        ``paged.nan`` fault point poisons when it fires after the steps."""
        multi = len(buckets) > 1
        if multi:
            inv = np.argsort(perm)
            tables, lengths, done, max_new, eos_ids, adapter_ids = (
                a[perm] for a in (tables, lengths, done, max_new, eos_ids, adapter_ids))
            samplers = [(int(inv[slot]), g, temp, k) for slot, g, temp, k in samplers]
        dev = self.device
        perm_t = torch.from_numpy(perm.astype(np.int64)).to(dev) if multi else None
        tables_t = torch.from_numpy(tables).to(dev)
        # per-bucket tables, each contiguous at its own width (the pool
        # chunk's one bucket is the whole table, no copy)
        split, off = [], 0
        for nb, hb in buckets:
            split.append(tables_t[off:off + nb, :hb].contiguous())
            off += nb
        lengths_t = torch.from_numpy(lengths).to(dev)
        st = _ChunkState(
            tables=tables_t, split=tuple(split), lengths=lengths_t, done=torch.from_numpy(done).to(dev),
            emitted=torch.zeros_like(lengths_t), max_new=torch.from_numpy(max_new).to(dev),
            eos=torch.from_numpy(eos_ids.astype(np.int64)).to(dev), model_kw=self._model_kwargs(adapter_ids),
            logits=self._logits[perm_t] if multi else self._logits, samplers=samplers)
        toks = (self._chunk_pool if self._chunk_impl == "pool" else self._chunk_ring)(steps, st)
        if nan_victim is not None and _faults.enabled() and _faults.fire("paged.nan"):
            st.logits[int(inv[nan_victim]) if multi else nan_victim] = float("nan")
            logger.warning("injected paged.nan into slot %d", nan_victim)
        self._logits = st.logits[torch.from_numpy(inv).to(dev)] if multi else st.logits
        cols = [torch.stack(toks, dim=1), st.emitted[:, None].long(), st.lengths[:, None].long()]
        if self._nan_guard:
            cols.append(torch.isfinite(st.logits).all(-1)[:, None].long())
        out = torch.cat(cols, dim=1).cpu().numpy()
        return out[inv] if multi else out

    def _decode_step(self, st: _ChunkState) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step's sampling and bookkeeping, shared by both chunks:
        each lane's token (eos for an inactive lane), and the lanes that
        were active for it.  Every sampler draws its generator once a
        step on either chunk."""
        token = self._sample_batch(st.logits, st.samplers)
        active = ~st.done
        token = torch.where(active, token, st.eos)
        st.emitted = st.emitted + active.int()
        st.done = st.done | (token == st.eos) | (st.emitted >= st.max_new)
        return token, active

    def _chunk_pool(self, steps: int, st: _ChunkState) -> List[torch.Tensor]:
        """The pool chunk (JAX ``_chunk_fn_pool``): every step attends
        over the pool, one kernel call per bucket per layer on the kernel
        lane, and writes its token's K/V back through the full tables."""
        attn_tables = st.split if len(st.split) > 1 else st.tables
        toks = []
        for _ in range(steps):
            token, active = self._decode_step(st)
            positions = torch.clamp(st.lengths, max=self.max_len - 1)[:, None]
            new_logits, nk, nv = self.module(token[:, None], positions, self.pages_k, self.pages_v, attn_tables,
                                             st.lengths, use_kernel=self._kernel_active, **st.model_kw)
            write_kv(kv_join(self.pages_k, self.scales_k), kv_join(self.pages_v, self.scales_v), nk, nv, st.tables,
                     st.lengths, active[:, None], page_size=self.page_size, max_len=self.max_len)
            st.logits = torch.where(active[:, None], new_logits[:, 0], st.logits)
            st.lengths = st.lengths + active.int()
            toks.append(token)
        return toks

    def _chunk_ring(self, steps: int, st: _ChunkState) -> List[torch.Tensor]:
        """The ring chunk (JAX ``_chunk_fn``): each bucket's context is
        gathered from the pool once, through its table's first columns;
        the chunk's own K/V accumulate in a ``(layers, B, steps, h, hd)``
        ring, column ``t`` at step ``t``; each step attends with dense
        products only.  At the end each lane's accepted columns
        ``0..emitted-1`` are written to its positions ``len0..`` in one
        write: the columns an inactive lane wrote never reach the pool,
        and a lane that emitted nothing writes nothing (its pages are
        never a shared prefix page: a lane writes at or past its prompt's
        length, and the last prompt page is always private)."""
        if self._mesh is not None:
            return self._chunk_ring_mesh(steps, st)
        L, B, ps = self.num_layers, self.max_slots, self.page_size
        h, hd = self.num_heads, self.head_dim
        ctx_k, ctx_v = [], []
        for tb in st.split:
            nb, cb = tb.shape[0], tb.shape[1] * ps
            ctx_k.append(self.pages_k[:, tb].reshape(L, nb, cb, h, hd))
            ctx_v.append(self.pages_v[:, tb].reshape(L, nb, cb, h, hd))
        if len(ctx_k) == 1:
            ctx_k, ctx_v = ctx_k[0], ctx_v[0]
        else:
            ctx_k, ctx_v = tuple(ctx_k), tuple(ctx_v)
        ring_k = torch.zeros((L, B, steps, h, hd), dtype=self.pages_k.dtype, device=self.device)
        ring_v = torch.zeros_like(ring_k)
        len0 = st.lengths
        toks = []
        for t in range(steps):
            token, active = self._decode_step(st)
            positions = torch.clamp(st.lengths, max=self.max_len - 1)[:, None]
            new_logits, nk, nv = self.module.forward_ring(token[:, None], positions, ctx_k, ctx_v, ring_k, ring_v,
                                                          t, len0, **st.model_kw)
            ring_k[:, :, t] = nk[:, :, 0]
            ring_v[:, :, t] = nv[:, :, 0]
            st.logits = torch.where(active[:, None], new_logits[:, 0], st.logits)
            st.lengths = st.lengths + active.int()
            toks.append(token)
        accepted = torch.arange(steps, device=self.device)[None, :] < st.emitted[:, None]
        write_kv(self.pages_k, self.pages_v, ring_k, ring_v, st.tables, len0, accepted, page_size=ps,
                 max_len=self.max_len)
        return toks

    def _chunk_ring_mesh(self, steps: int, st: _ChunkState) -> List[torch.Tensor]:
        """:meth:`_chunk_ring` over the mesh: each position gathers its
        lanes' context at its heads once, keeps its part of the ring, and
        the accepted columns are written to the positions holding their
        pages at the end."""
        rows, ctx = self.module.ring_context(self.pages_k, self.pages_v, st.split, self.max_slots)
        ring_k, ring_v = self.module.ring_buffers(rows, steps)
        len0 = st.lengths
        toks = []
        for t in range(steps):
            token, active = self._decode_step(st)
            positions = torch.clamp(st.lengths, max=self.max_len - 1)[:, None]
            new_logits, nk, nv = self.module.forward_ring(token[:, None], positions, rows, ctx, ring_k, ring_v, t,
                                                          len0, **st.model_kw)
            ring_k.set_column(t, nk)
            ring_v.set_column(t, nv)
            st.logits = torch.where(active[:, None], new_logits[:, 0], st.logits)
            st.lengths = st.lengths + active.int()
            toks.append(token)
        accepted = torch.arange(steps, device=self.device)[None, :] < st.emitted[:, None]
        write_kv(self.pages_k, self.pages_v, ring_k, ring_v, st.tables, len0, accepted, page_size=self.page_size,
                 max_len=self.max_len)
        return toks

    def step(self) -> bool:
        """Admit + prefill joiners, run one decode chunk, retire finished.
        Returns True while there is (or may be) more work.  Safe from any
        thread: steps never interleave.  The gen.* spans queued under the
        engine lock are emitted here, after it drops, on every way out."""
        with self._step_lock:
            try:
                if self.speculative is not None:
                    return self._step_speculative()
                return self._step_decode()
            finally:
                self._flush_spans()

    def _wave_start_locked(self) -> Dict[str, Any]:
        """The counters a wave's flight-recorder record carries deltas of."""
        pre = {k: self._counters[k] for k in ("prefix_hits", "prefix_tokens_saved") + _SLO_COUNTER_KEYS}
        if self._kv_tier is not None:
            pre.update({k: self._counters[k] for k in _TIER_DELTA_KEYS})
        return pre

    def _wave_record_locked(self, pre: Dict[str, Any]) -> Dict[str, Any]:
        """The part of a wave's record read under the engine lock: queue
        depth and the counter deltas since :meth:`_wave_start_locked`
        (the KV tier's only with the tier on, so the off lane's records
        keep their keys)."""
        keys = _SLO_COUNTER_KEYS + (_TIER_DELTA_KEYS if self._kv_tier is not None else ())
        return {
            "queue_depth": len(self._queue),
            "prefix_hits": self._counters["prefix_hits"] - pre["prefix_hits"],
            "prefix_tokens_saved": self._counters["prefix_tokens_saved"] - pre["prefix_tokens_saved"],
            "prefix_pages_cached": len(self._lru),
            "deltas": {k: self._counters[k] - pre[k] for k in keys},
        }

    def _wave_record(self, phase: str, *, wall_s: float, prefill_wall_s: float, steps: int, buckets,
                     occupancy: int, admissions: int, stalls: int, decode_tokens: int, prefill_tokens: int,
                     puids, trace_id: str, locked: Dict[str, Any]) -> None:
        """Write one wave's record (the JAX engine's record keys); with
        neither the recorder nor the watchdog on, nothing."""
        if self.recorder is None and self._watchdog is None:
            return
        rec = {"phase": phase, "puids": list(puids)}
        if phase != "prefill":
            rec["trace_id"] = trace_id
        rec.update({
            "wall_ms": round(wall_s * 1000.0, 3),
            "prefill_wall_ms": round(prefill_wall_s * 1000.0, 3),
            "tp_degree": self.tp_degree,
            "dp_degree": self.dp_degree,
            "steps": steps,
            "buckets": [list(b) for b in buckets],
            "occupancy": occupancy,
            "admissions": admissions,
            "stalls": stalls,
            "queue_depth": locked["queue_depth"],
            "tokens": decode_tokens + prefill_tokens,
            "prefill_tokens": prefill_tokens,
            "decode_tokens": decode_tokens,
            "prefix_hits": locked["prefix_hits"],
            "prefix_tokens_saved": locked["prefix_tokens_saved"],
            "prefix_pages_cached": locked["prefix_pages_cached"],
            **locked["deltas"],
        })
        self._record_chunk(rec)

    def _record_prefill_wave(self, pre: Dict[str, Any], *, wall_s: float, tokens: int, occupancy: int,
                             admissions: int, stalls: int, puids) -> bool:
        """Record a wave that carried prefill work only (a budgeted
        prefill-only wave, or one whose streams all ended at prefill), so
        the recorder's token mix does not undercount against
        ``prefill_tokens``.  Returns step()'s value."""
        with self._lock:
            more = self._wave_end_locked()
            locked = self._wave_record_locked(pre)
        self._wave_record("prefill", wall_s=wall_s, prefill_wall_s=wall_s, steps=0, buckets=[],
                          occupancy=occupancy, admissions=admissions, stalls=stalls, decode_tokens=0,
                          prefill_tokens=tokens, puids=puids, trace_id="", locked=locked)
        return more

    def _kv_dtype_name(self) -> str:
        return "int8" if self._kv_int8 else _dtype_name(self.pages_k)

    def _steps_for_locked(self, decoding: List[_Stream]) -> int:
        """The chunk length: ``steps_per_call``, doubled toward
        ``max_steps`` while nothing waits and only as far as the pool can
        back the doubling for every decoding stream (a shrunk pool would
        otherwise stall and evict progress the short chunk keeps)."""
        steps = self.steps_per_call
        if not decoding or self._queue:
            return steps
        most = max(s.max_new - len(s.tokens) for s in decoding)
        free = self._allocatable_locked()
        while steps * 2 <= self.max_steps and steps < most:
            nxt = steps * 2
            need = 0
            for s in decoding:
                horizon = min(int(self._lengths[s.slot]) + nxt, len(s.prompt) + s.max_new, self.max_len)
                need += max(0, -(-horizon // self.page_size) - len(s.pages))
            if need > free:
                break
            steps = nxt
        return steps

    def _step_decode(self) -> bool:
        with self._lock:
            pre = self._wave_start_locked()
            admitted = self._admit_locked()
        # promoted tier chains land before any prefill or decode of the wave
        self._tier_promote_ready()
        budget = self.chunk_token_budget
        wave_ptok, wave_pwall = 0, 0.0
        if admitted and not budget:
            # monolithic prefill: admitted prompts prefill whole and decode
            # in this same wave
            _done, wave_ptok, wave_pwall = self._prefill_streams([s for s, _ in admitted])
        with self._lock:
            self._counters["prefills"] += len(admitted)
            active = self._retire_cancelled_locked([s for s in self._slots if s is not None])
        if not active:
            # every admitted stream ended at its prefill (a KV export, a
            # cancellation): the wave still carried prefill work
            if wave_ptok:
                return self._record_prefill_wave(pre, wall_s=wave_pwall, tokens=wave_ptok, occupancy=0,
                                                 admissions=len(admitted), stalls=0,
                                                 puids=[s.puid for s, _ in admitted if s.puid])
            with self._lock:
                return self._wave_end_locked()
        with self._lock:
            if budget:
                # only whole prompts decode: a stream whose last slice runs
                # this wave decodes from the next one
                decoding = [s for s in active if s.prefilled >= len(s.prompt)]
                prefilling = [s for s in active if s.prefilled < len(s.prompt)]
            else:
                decoding, prefilling = list(active), []
            steps = self._steps_for_locked(decoding) if not prefilling else self.steps_per_call
            stalled = np.zeros((self.max_slots,), bool)
            for stream in decoding:
                if not self._ensure_pages_locked(stream, steps):
                    stalled[stream.slot] = True
            self._counters["stalls"] += int(stalled.sum())
            # every decoding stream stalled on the pool: evict the one with
            # the least progress (ties to the youngest) to the head of the
            # queue until one can run.  A re-run re-derives its tokens (a
            # sampled one re-seeds).  A lone stream always fits (submit
            # refuses more than the pool); a prefill backlog is progress,
            # so the loop stands down for it.
            while decoding and not prefilling and all(stalled[s.slot] for s in decoding):
                victim = min(decoding, key=lambda s: (len(s.tokens), -s.req_id))
                decoding.remove(victim)
                self._evict_locked(victim)
                for stream in decoding:
                    if stalled[stream.slot] and self._ensure_pages_locked(stream, steps):
                        stalled[stream.slot] = False
            if not decoding and not prefilling:
                return self._wave_end_locked()
            runnable = [s for s in decoding if not stalled[s.slot]]
            if budget and runnable:
                # decode admitted first, never squeezed below one step
                steps = min(steps, max(1, budget // len(runnable)))
            slices = self._plan_prefill_slices_locked(prefilling, budget - steps * len(runnable)) if budget else []
            B = self.max_slots
            done = np.ones((B,), bool)
            max_new = np.zeros((B,), np.int32)
            eos_ids = np.full((B,), -1, np.int32)
            samplers = []
            for stream in runnable:
                s = stream.slot
                done[s] = False
                max_new[s] = stream.max_new - len(stream.tokens)
                eos_ids[s] = stream.eos_id
                if stream.temperature > 0:
                    samplers.append((s, stream.generator, stream.temperature, stream.top_k))
            pages_h = self._pages_horizon(runnable, steps)
            # the lanes' length buckets: the pool chunk's per-step table
            # widths, or the ring chunk's gathered context widths
            buckets, perm = self._plan_buckets(runnable, steps, pages_h)
            tables = np.ascontiguousarray(self._block_tables[:, :pages_h])
            lengths = self._lengths.copy()
            adapter_ids = self._adapter_slots.copy()
        if slices:
            # the budget's prefill slices run before the chunk; a stream they
            # complete stays masked in it
            _done, ptok, pwall = self._run_prefill_slices(slices)
            wave_ptok += ptok
            wave_pwall += pwall
        if not runnable:
            if wave_ptok:
                return self._record_prefill_wave(pre, wall_s=wave_pwall, tokens=wave_ptok, occupancy=len(active),
                                                 admissions=len(admitted), stalls=int(stalled.sum()),
                                                 puids=[s.puid for s in active if s.puid])
            with self._lock:
                return self._wave_end_locked()
        try:
            # the paged.chunk fault point fires before any device work, so
            # only this chunk's streams fail; a real device error later
            # still escalates through the decode loop's fail_all
            _faults.raise_if("paged.chunk")
        except _faults.InjectedFault as exc:
            return self._contain_chunk_fault(runnable, exc)
        # page growth above may have staged demotions: gathered before the chunk writes
        self._tier_flush()
        self._profile_before_chunk()
        t_chunk = time.perf_counter()
        with torch.inference_mode(), self._materialized():
            # the sampled lanes' host generators are no part of the program's
            # signature (the JAX chunk takes (B,) temperature and top-k arrays)
            chunk = self._sentinels["paged_chunk"].wrap(functools.partial(self._chunk, samplers=samplers),
                                                        static=f"steps={steps},buckets={tuple(buckets)}")
            out = chunk(steps, buckets, perm, tables, lengths, done, max_new, eos_ids, adapter_ids=adapter_ids,
                        nan_victim=min(s.slot for s in runnable))
        chunk_wall = time.perf_counter() - t_chunk
        self._profile_after_chunk()
        toks, emitted, lengths_out = out[:, :steps], out[:, steps], out[:, steps + 1]
        # the NaN screen before the harvest: a poisoned lane's tokens of
        # this chunk are never delivered
        self._quarantine_poisoned(runnable, out[:, steps + 2] if self._nan_guard else None)
        t_now = time.time()
        with self._lock:
            self._counters["chunks"] += 1
            self._counters["chunk_wall_s"] += chunk_wall
            self._chunk_steps[steps] = self._chunk_steps.get(steps, 0) + 1
            if len(buckets) > 1:
                self._counters["bucketed_chunks"] += 1
                self._counters["bucketed_steps"] += steps
            chunk_tokens = 0
            for stream in runnable:
                s = stream.slot
                if s is None or self._slots[s] is not stream:
                    continue  # quarantined, or failed or retired from another thread meanwhile
                self._lengths[s] = lengths_out[s]
                n = int(emitted[s])
                self._counters["tokens"] += n
                chunk_tokens += n
                stream.cost_decode_tokens += n
                got = toks[s, :n].tolist()
                if got and not stream.tokens and not stream.t_first_token:
                    stream.t_first_token = t_now
                stream.tokens.extend(got)
                if stream.eos_id in got or len(stream.tokens) >= stream.max_new:
                    self._finish_locked(stream)
                else:
                    self._stream_push(stream)
            more = self._wave_end_locked()
            locked = self._wave_record_locked(pre)
            # an exemplar's trace: any traced stream of the wave links the
            # chunk's duration to one real request
            trace = next((s.trace_id for s in decoding if s.trace_id), "") if self._telemetry_enabled else ""
            puids = sorted({s.puid for s in active if s.puid})
        self._wave_record("decode", wall_s=chunk_wall, prefill_wall_s=wave_pwall, steps=steps, buckets=buckets,
                          occupancy=len(active), admissions=len(admitted), stalls=int(stalled.sum()),
                          decode_tokens=chunk_tokens, prefill_tokens=wave_ptok, puids=puids, trace_id=trace,
                          locked=locked)
        return more

    def _step_speculative(self) -> bool:
        """One draft/verify round for every decoding stream (JAX
        ``_step_speculative``): admission and prefill as the plain step
        does them (under a token budget, verify first: each verifying
        stream is priced at ``draft_k + 1`` tokens and prompt slices take
        the rest); a prompt made whole emits its greedy token at once;
        page growth of ``draft_k + 1`` a stream, with stall and evict;
        drafts by mode, never past a stream's budget; one verify forward
        of every lane."""
        from seldon_core_tpu_torch.models.speculative import ngram_draft

        with self._lock:
            pre = self._wave_start_locked()
            admitted = self._admit_locked()
        self._tier_promote_ready()
        budget = self.chunk_token_budget
        fresh: List[_Stream] = []
        slices: List[Tuple[_Stream, int, int]] = []
        L = self.draft_k + 1
        wave_ptok, wave_pwall = 0, 0.0
        if not budget:
            fresh, wave_ptok, wave_pwall = self._prefill_streams([s for s, _ in admitted])
        else:
            with self._lock:
                live = [s for s in self._slots if s is not None]
                verify_lanes = sum(1 for s in live if s.prefilled >= len(s.prompt))
                slices = self._plan_prefill_slices_locked([s for s in live if s.prefilled < len(s.prompt)],
                                                          budget - verify_lanes * L)
            if slices:
                fresh, wave_ptok, wave_pwall = self._run_prefill_slices(slices)
        with self._lock:
            self._counters["prefills"] += len(admitted)
            t_now = time.time()
            for stream in fresh:
                # the prefill's argmax is the first generated token: emitted
                # now, so every round verifies continuations of tokens[-1]
                if stream.result is not None or stream.error is not None:
                    continue
                if not stream.t_first_token:
                    stream.t_first_token = t_now
                stream.tokens.append(int(stream.pending))
                self._counters["tokens"] += 1
                if stream.pending == stream.eos_id or len(stream.tokens) >= stream.max_new:
                    self._finish_locked(stream)
                else:
                    self._stream_push(stream)
            active = self._retire_cancelled_locked([s for s in self._slots if s is not None])
        if not active:
            # every stream ended at its prefill or its first token: the
            # wave still carried prefill work
            if wave_ptok:
                return self._record_prefill_wave(pre, wall_s=wave_pwall, tokens=wave_ptok, occupancy=0,
                                                 admissions=len(admitted), stalls=0,
                                                 puids=[s.puid for s, _ in admitted if s.puid])
            with self._lock:
                return self._wave_end_locked()
        with self._lock:
            # under a budget a stream whose last slice ran this wave
            # verifies from the next one (the wave keeps its planned size)
            fresh_ids = {id(s) for s in fresh} if budget else set()
            verify_set = [s for s in active if s.prefilled >= len(s.prompt) and id(s) not in fresh_ids]
            stalled = np.zeros((self.max_slots,), bool)
            for stream in verify_set:
                if not self._ensure_pages_locked(stream, L):
                    stalled[stream.slot] = True
            self._counters["stalls"] += int(stalled.sum())
            # eviction stands down only when this wave's prefill slices
            # made progress: a backlog alone would livelock when every
            # verifying lane is page-starved and the verify-first pricing
            # left the planner under one page
            while verify_set and not slices and all(stalled[s.slot] for s in verify_set):
                victim = min(verify_set, key=lambda s: (len(s.tokens), -s.req_id))
                verify_set.remove(victim)
                active.remove(victim)
                self._evict_locked(victim)
                for stream in verify_set:
                    if stalled[stream.slot] and self._ensure_pages_locked(stream, L):
                        stalled[stream.slot] = False
            if not active:
                return self._wave_end_locked()
            runnable = [s for s in verify_set if not stalled[s.slot]]
            # each stream's context, draft count and start token, read
            # while its tokens cannot move
            work = []
            for stream in runnable:
                # only remaining - 1 drafts can ever be emitted: more would
                # burn verify width and count acceptances finish discards
                k_eff = max(0, min(self.draft_k, stream.max_new - len(stream.tokens) - 1))
                context = np.concatenate([stream.prompt, np.asarray(stream.tokens, np.int32)])
                work.append((stream, k_eff, context, int(stream.pending), len(stream.tokens)))
            pages_h = self._pages_horizon(runnable, L)
            tables = np.ascontiguousarray(self._block_tables[:, :pages_h])
            lengths = self._lengths.copy()
            adapter_ids = self._adapter_slots.copy()
        if not runnable:
            # prefill slices, or streams made whole this wave, were the progress
            if wave_ptok:
                return self._record_prefill_wave(pre, wall_s=wave_pwall, tokens=wave_ptok, occupancy=len(active),
                                                 admissions=len(admitted), stalls=int(stalled.sum()),
                                                 puids=[s.puid for s in active if s.puid])
            with self._lock:
                return self._wave_end_locked()
        try:  # the decode chunk's containment, before any device work
            _faults.raise_if("paged.chunk")
        except _faults.InjectedFault as exc:
            return self._contain_chunk_fault(runnable, exc)
        mode = self.speculative["draft"]
        with torch.inference_mode():
            model_drafts = None
            if mode == "model":
                # windows end at each stream's pending token, so the drafts
                # continue the sequence the verify checks
                W = self.draft_window
                windows = np.zeros((self.max_slots, W), np.int32)
                lens = np.zeros((self.max_slots,), np.int32)
                for stream, _k, context, _p, _n in work:
                    tail = context[-W:]
                    windows[stream.slot, : len(tail)] = tail
                    lens[stream.slot] = len(tail)
                model_drafts = self._sentinels["paged_draft_rollout"].wrap(self._draft_rollout)(windows, lens)
            segs = np.zeros((self.max_slots, L), np.int32)
            n_drafts = np.zeros((self.max_slots,), np.int32)
            active_mask = np.zeros((self.max_slots,), bool)
            for stream, k_eff, context, pending, done in work:
                slot = stream.slot
                if k_eff == 0:
                    drafted = np.zeros((0,), np.int32)
                elif mode == "oracle" and stream.draft_hint is not None:
                    drafted = stream.draft_hint[done: done + k_eff]
                elif mode == "model":
                    drafted = model_drafts[slot, :k_eff]
                else:
                    drafted = ngram_draft(context, k_eff, ngram=int(self.speculative["ngram"]))[:k_eff]
                segs[slot, 0] = pending
                segs[slot, 1: 1 + len(drafted)] = drafted
                n_drafts[slot] = len(drafted)
                active_mask[slot] = True
            # verify-lane page growth may have staged demotions
            self._tier_flush()
            self._profile_before_chunk()
            t_chunk = time.perf_counter()
            with self._materialized():
                out = self._sentinels["paged_spec_chunk"].wrap(self._spec_chunk)(segs, n_drafts, active_mask,
                                                                                 tables, lengths, adapter_ids)
            chunk_wall = time.perf_counter() - t_chunk
            self._profile_after_chunk()
        toks, counts, lengths_out = out[:, :L], out[:, L], out[:, L + 1]
        with self._lock:
            self._counters["chunks"] += 1
            self._counters["chunk_wall_s"] += chunk_wall
            self._counters["spec_drafted"] += int(n_drafts.sum())
            chunk_tokens = 0
            for stream in runnable:
                s = stream.slot
                if s is None or self._slots[s] is not stream:
                    continue  # failed or retired from another thread meanwhile
                self._lengths[s] = lengths_out[s]
                n = int(counts[s])
                got = toks[s, :n].tolist()
                self._counters["tokens"] += n
                chunk_tokens += n
                stream.cost_decode_tokens += n
                self._counters["spec_accepted"] += max(0, n - 1)
                stream.tokens.extend(got)
                if got:
                    stream.pending = int(got[-1])
                if stream.eos_id in got or len(stream.tokens) >= stream.max_new:
                    self._finish_locked(stream)
                else:
                    self._stream_push(stream)
            more = self._wave_end_locked()
            locked = self._wave_record_locked(pre)
            trace = next((s.trace_id for s in runnable if s.trace_id), "") if self._telemetry_enabled else ""
            puids = sorted({s.puid for s in active if s.puid})
        self._wave_record("spec_verify", wall_s=chunk_wall, prefill_wall_s=wave_pwall, steps=L, buckets=[],
                          occupancy=len(active), admissions=len(admitted), stalls=int(stalled.sum()),
                          decode_tokens=chunk_tokens, prefill_tokens=wave_ptok, puids=puids, trace_id=trace,
                          locked=locked)
        return more

    def _wave_end_locked(self) -> bool:
        """The chunk boundary: the allocator audit when asked for, and
        whether there is more work."""
        if self._debug_invariants:
            self._check_invariants_locked()
        return bool(self._queue) or any(s is not None for s in self._slots)

    # ---- retirement ----------------------------------------------------------

    @staticmethod
    def _delivered(stream: _Stream) -> List[int]:
        """The stream's tokens as it delivers them: clamped to its budget
        and cut after the first eos."""
        toks = stream.tokens[: stream.max_new]
        if stream.eos_id in toks:
            toks = toks[: toks.index(stream.eos_id) + 1]
        return toks

    def _stream_push(self, stream: _Stream) -> None:
        """Push the delivered tokens the consumer has not seen yet."""
        if stream.token_queue is None:
            return
        new = self._delivered(stream)[stream.streamed:]
        if new:
            stream.streamed += len(new)
            stream.token_queue.put([int(t) for t in new])

    @staticmethod
    def _end_stream_locked(stream: _Stream) -> None:
        """The end marker of a streamed request, on every way out."""
        if stream.token_queue is not None:
            stream.token_queue.put(None)

    def _finish_locked(self, stream: _Stream) -> None:
        """Deliver ``(max_new,)`` ids, cut after the first eos and padded
        with eos, push a stream's last tokens and its end, and free the
        slot and its pages."""
        toks = self._delivered(stream)
        stream.result = np.asarray(toks + [stream.eos_id] * (stream.max_new - len(toks)), np.int32)
        stream.t_finish = now = time.time()
        if stream.trace_id:
            emitted = len(stream.tokens[: stream.max_new])
            if stream.t_decode_start:
                self._gen_span_deferred(stream, "gen.decode", stream.t_decode_start,
                                        max(0.0, now - stream.t_decode_start), slot=stream.slot, tokens=emitted)
            finish_tags: Dict[str, Any] = dict(slot=stream.slot, tokens=emitted, pages_held=len(stream.pages),
                                               cancelled=stream.cancelled)
            if self._telemetry_enabled:
                # the cost ledger as span tags: the trace's view of the
                # numbers the response's meta.tags.cost carries
                self._cost_close_locked(stream)
                finish_tags["cost_page_s"] = round(stream.cost_page_s, 6)
                finish_tags["cost_prefill_tokens"] = stream.cost_prefill_tokens
                finish_tags["cost_decode_tokens"] = stream.cost_decode_tokens
                if stream.adapter:
                    finish_tags["cost_adapter"] = stream.adapter
            if self.speculative is not None:
                drafted = self._counters["spec_drafted"]
                finish_tags["spec_accept_rate"] = (round(self._counters["spec_accepted"] / drafted, 3)
                                                   if drafted else 0.0)
            self._gen_span_deferred(stream, "gen.finish", now, 0.0, **finish_tags)
        self._cost_close_locked(stream)  # once: a traced close above makes this a no-op
        self._tier_putback_locked(stream)
        self._release_slot_locked(stream)
        self._release_adapter_locked(stream)
        self._counters["completed"] += 1
        self._stream_push(stream)
        self._end_stream_locked(stream)
        stream.event.set()

    def _evict_locked(self, stream: _Stream) -> None:
        """Put a stream out of its slot, back at the head of the queue; it
        re-prefills (re-matching the prefix index) and re-derives its
        tokens when admitted again.  Its lifecycle clock restarts (the
        re-queue wait is a new queue term), and its page-seconds accrue
        up to the free, then pause while it is queued."""
        now = time.time()
        if stream.trace_id:
            self._gen_span_deferred(stream, "gen.evict", now, 0.0, slot=stream.slot,
                                    tokens_discarded=len(stream.tokens), pages_freed=len(stream.pages))
        self._cost_touch_locked(stream)
        stream.cost_t = 0.0
        self._tier_putback_locked(stream)
        self._release_slot_locked(stream)
        stream.slot = None
        stream.tokens = []
        stream.generator = None
        stream.cached_len = 0
        stream.prefilled = 0
        stream.t_submit = now
        stream.t_prefill_start = 0.0
        stream.t_decode_start = 0.0
        stream.t_first_token = 0.0
        stream.queue_depth_at_submit = len(self._queue)
        self._counters["evictions"] += 1
        self._queue.appendleft(stream)
        self._queued.add(stream)

    def _retire_cancelled_locked(self, active: List[_Stream]) -> List[_Stream]:
        """Finish flagged streams and fail expired ones before the next
        chunk (never mid-chunk); returns the live rest."""
        live = []
        now = None
        for stream in active:
            if stream.cancelled:
                self._finish_locked(stream)
                continue
            if stream.deadline is not None:
                now = time.monotonic() if now is None else now
                if now >= stream.deadline:
                    self._counters["expired"] += 1
                    self._fail_stream_locked(stream, deadline_exceeded(
                        f"paged-engine decode (req {stream.req_id}, {len(stream.tokens)} tokens in)"))
                    continue
            live.append(stream)
        return live

    def cancel(self, stream: _Stream) -> None:
        """Abandon a stream: a queued one resolves at once (eos-padded); an
        in-slot one is flagged and retired before the next chunk, never
        mid-chunk."""
        with self._lock:
            if stream.result is not None or stream.error is not None:
                return
            if stream in self._queued:
                self._remove_queued_locked(stream)
                toks = stream.tokens[: stream.max_new]
                stream.result = np.asarray(toks + [stream.eos_id] * (stream.max_new - len(toks)), np.int32)
                self._release_adapter_locked(stream)
                self._end_stream_locked(stream)
                stream.event.set()
                return
            stream.cancelled = True

    def has_work(self) -> bool:
        with self._lock:
            return bool(self._queue) or any(s is not None for s in self._slots)

    def engine_stats(self, detail: bool = False) -> Dict[str, Any]:
        """Counters and live occupancy.  Keys that belong to an optional
        plane are there only with it on, as in the JAX engine: the
        ``kv_tier_*`` keys with the KV tier, ``captures`` and
        ``capture_store_bytes`` with the capture plane, the ``cost_*``
        keys with ``SELDON_TPU_TELEMETRY``.  ``health`` is the watchdog's
        state (``health_state`` its code: 0 healthy, 1 degraded, 2
        evacuating; always "healthy" with the watchdog off), which
        ``models/disagg.evacuate_streams`` reads.  Every key is exported
        by ``utils/metrics.GenerationPrometheusBridge`` or excluded there
        by name.  ``detail=True`` adds the watchdog's window and the
        flight recorder's ring and aggregates (``/debug/engine?detail=1``)."""
        if self._watchdog is not None:
            from seldon_core_tpu_torch.utils.watchdog import STATE_CODES

            health = self._watchdog.state
            health_code, trips = STATE_CODES[health], self._watchdog.trips
        else:
            health, health_code, trips = "healthy", 0, 0
        with self._lock:
            out = {
                "kernel_active": int(self._kernel_active),
                "chunk_impl": self._chunk_impl,
                "ctx_buckets": self._ctx_buckets,
                **self._counters,
                "active": sum(s is not None for s in self._slots),
                "queued": len(self._queue),
                "free_pages": len(self._free_pages),
                # mapped pages only: cached prefix pages are reclaimable
                "pool_pages_used": self.num_pages - 1 - len(self._free_pages) - len(self._lru),
                "pool_pages_total": self.num_pages - 1,
                "prefix_pages_cached": len(self._lru),
                "chunk_steps": dict(self._chunk_steps),
                "kv_dtype_int8": int(self._kv_int8),
                # the mesh degrees this engine runs at (1 = one device) and
                # the K+V pool bytes one position holds
                "tp_degree": self.tp_degree,
                "dp_degree": self.dp_degree,
                "pool_shard_bytes": self._pool_shard_bytes,
                "adapters_resident": len(self._adapter_table),
                "adapter_slots": self.max_adapters,
                # first calls under a new signature at the four programs (the
                # per-program split is jitwatch's own series, so the bridge skips it)
                "jit_compiles": sum(st.compiles for st in self._sentinels.values()),
                "health": health,
                "health_state": health_code,
                "watchdog_trips": trips,
                "cost_by_adapter": {k: dict(v) for k, v in self._cost_by_adapter.items()},
            }
        if self._capture_enabled:
            try:
                from seldon_core_tpu_torch.utils import capture as _capture

                out["capture_store_bytes"] = _capture.default_store().total_bytes()
            except Exception:  # noqa: BLE001 — stats never break serving
                out["capture_store_bytes"] = 0
        else:
            out.pop("captures")
        if self._kv_tier is not None:
            tier = self._kv_tier.stats()
            out["kv_tier_host_bytes"] = tier["host_bytes"]
            out["kv_tier_disk_bytes"] = tier["disk_bytes"]
        else:
            for k in _TIER_COUNTER_KEYS:
                out.pop(k)
        if not self._telemetry_enabled:
            for k in ("cost_page_seconds", "cost_prefill_tokens", "cost_decode_tokens", "cost_by_adapter"):
                out.pop(k)
        if detail:
            if self._watchdog is not None:
                out["watchdog"] = self._watchdog.stats()
            if self.recorder is not None:
                out["recorder"] = self.recorder.snapshot()
                out["recorder_stats"] = self.recorder.stats()
            else:
                out["recorder"] = []
                out["recorder_stats"] = {"records": 0, "seq": 0}
        return out

    # ---- drain and replay ----------------------------------------------------

    @staticmethod
    def _journal_entry(s: _Stream, now: float) -> Dict[str, Any]:
        """One live stream's re-derivation recipe as a journal entry.  An
        absolute monotonic deadline does not survive a process: the budget
        left is written and re-minted on replay."""
        return journal_entry(
            req_id=s.req_id,
            prompt=[int(t) for t in s.prompt],
            max_new_tokens=int(s.max_new),
            temperature=float(s.temperature),
            top_k=int(s.top_k),
            eos_id=int(s.eos_id),
            seed=int(s.seed),
            priority=int(s.priority),
            deadline_remaining_ms=max(0.0, (s.deadline - now) * 1000.0) if s.deadline is not None else None,
            # the tokens the consumer has seen: a replay pushes only past them
            streamed=int(s.streamed),
            stream_tokens=s.token_queue is not None,
            tokens_decoded=len(s.tokens),
            adapter=s.adapter,
        )

    def drain(self) -> List[Dict[str, Any]]:
        """Drain for handoff: stop admission, then journal every live
        stream's recipe (prompt, sampling terms, seed, priority, deadline
        left, streaming cursor) for a respawned engine's :meth:`replay`.
        Decoded tokens are not journaled: a stream's seed makes its
        re-derivation draw the same tokens, as after an eviction.  Each
        journaled stream's waiter fails with 503 ``DRAINING``; handoff
        and migration imports are not journaled (their coordinator
        retries them).  Call with the step loop quiesced; the engine
        stays closed."""
        with self._lock:
            self._closed = True
            victims = [s for s in self._slots if s is not None] + list(self._queue)
            now = time.monotonic()
            entries = [self._journal_entry(s, now) for s in victims
                       if not (s.kv_export or s.kv_import is not None or s.kv_imported)]
            self._queue.clear()
            self._queued.clear()
            err = MicroserviceError("engine draining: stream journaled for handoff to the respawned engine",
                                    status_code=503, reason="DRAINING")
            for s in victims:
                self._fail_stream_locked(s, err)
            self._counters["drained"] += len(victims)
        self._flush_spans()
        return entries

    def replay(self, entries, stream_tokens: Optional[bool] = None) -> List[_Stream]:
        """Re-submit journaled streams (the restore half of drain).
        ``stream_tokens=None`` keeps each entry's streaming mode and
        resumes its cursor; ``False`` replays unary (a respawned process:
        the original consumers are gone).  An entry whose deadline was
        spent before the replay is skipped and counted ``expired``; one
        this engine refuses is skipped with a warning.  Call before the
        step loop consumes (the cursor must be in place first)."""
        out: List[_Stream] = []
        for e in entries:
            deadline = None
            rem = e.get("deadline_remaining_ms")
            if rem is not None:
                if float(rem) <= 0.0:
                    with self._lock:
                        self._counters["expired"] += 1
                    logger.warning("journal replay skipped req %s: deadline expired between journal write and "
                                   "replay", e.get("req_id"))
                    continue
                deadline = time.monotonic() + float(rem) / 1000.0
            want_stream = bool(e.get("stream_tokens")) if stream_tokens is None else bool(stream_tokens)
            try:
                s = self.submit(np.asarray(e["prompt"], np.int32), max_new_tokens=int(e.get("max_new_tokens", 32)),
                                temperature=float(e.get("temperature", 0.0)), top_k=int(e.get("top_k", 0)),
                                eos_id=int(e.get("eos_id", -1)), seed=int(e.get("seed", 0)),
                                priority=int(e.get("priority", 0)), deadline=deadline, stream_tokens=want_stream,
                                adapter=e.get("adapter") or None)
            except MicroserviceError as exc:
                logger.warning("journal replay skipped req %s: %s", e.get("req_id"), exc)
                continue
            if want_stream and e.get("streamed"):
                s.streamed = int(e["streamed"])
            with self._lock:
                self._counters["replayed"] += 1
            out.append(s)
        return out

    def close(self, exc: Optional[Exception] = None) -> None:
        """Shut the engine: later submits get 503, pending streams fail."""
        with self._lock:
            self._closed = True
        self.fail_all(exc or MicroserviceError("engine closed", status_code=503, reason="SHUTTING_DOWN"))
        # a closed engine's registry pins drop: its adapters' host copies
        # become reclaimable registry capacity
        with self._adapter_io_lock:
            pinned, self._adapter_reg_pinned = self._adapter_reg_pinned, set()
        for name in pinned:
            self._registry.release(name)

    def fail_all(self, exc: Exception) -> None:
        """Error out every queued and in-flight stream; the engine stays usable."""
        with self._lock:
            victims = [s for s in self._slots if s is not None] + list(self._queue)
            self._queue.clear()
            self._queued.clear()
            self._slots = [None] * self.max_slots
            self._lengths[:] = 0
            self._block_tables[:] = 0
            for stream in victims:
                self._cost_close_locked(stream)
                self._tier_putback_locked(stream)
                if stream.pages:
                    self._free_locked(stream.pages)
                    stream.pages = []
                stream.error = exc
                self._release_adapter_locked(stream)
                self._end_stream_locked(stream)
                stream.event.set()

    def run(self) -> None:
        """Drain everything synchronously (tests, batch jobs)."""
        while self.has_work():
            self.step()

    def generate(self, prompt, **kw) -> np.ndarray:
        """One prompt's tokens, stepping the engine from this thread until
        its stream is done (a serving loop may step it meanwhile)."""
        stream = self.submit(np.asarray(prompt), **kw)
        while not stream.event.is_set():
            self.step()
        if stream.error:
            raise stream.error
        return stream.result


# ---------------------------------------------------------------------------
# the served component
# ---------------------------------------------------------------------------

def component_mesh(mesh_axes: Optional[Dict[str, int]], device: torch.device):
    """A component's ``mesh_axes`` as a mesh (JAX ``mesh_from_axes``): over
    the host's CUDA devices, or, for a component asked to run on the
    CPU, over that many CPU positions; None without ``mesh_axes``."""
    if not mesh_axes:
        return None
    if device.type == "cpu":
        size = int(np.prod([int(v) for v in mesh_axes.values()]))
        return mesh_from_axes(mesh_axes, devices=[device] * size)
    return mesh_from_axes(mesh_axes)


class StreamingLM(TPUComponent):
    """Deployable continuous-batching generation component.

    Concurrent ``predict`` calls share one :class:`PagedEngine`: each
    request's rows become streams, one decode-loop thread steps the
    engine, and every caller waits only for its own streams.  Another
    thread may step the same engine (``engine.generate``): the engine's
    step lock keeps the two from interleaving.  Per-request overrides via
    ``meta.tags``: ``max_new_tokens``, ``temperature``, ``top_k``,
    ``seed``, ``adapter`` (the ``X-Seldon-Adapter`` header lands there
    too), ``priority`` (``X-Seldon-Priority``), ``deadline_ms`` and
    ``deadline_at_monotonic`` (the ``X-Seldon-Deadline-Ms`` budget rides
    the ambient deadline).  Runs on ``cuda`` unless ``device="cpu"``;
    ``dtype`` is bfloat16 unless ``float32``.

    The engine options pass through as the JAX component's do:
    ``quantize``, ``precision``, ``prefix_cache``, ``max_steps_per_call``,
    ``max_queue``, ``chunk_token_budget`` and ``speculative`` (per-slot
    draft/verify inside the engine, greedy only; ``metrics()`` then adds
    ``speculative_acceptance_rate`` and ``speculative_rounds``).

    ``adapters`` (a dict, or its JSON) is the deployment's adapter
    catalogue, ``name -> {"seed": n, "alpha": a}`` (deterministic
    synthetic factors) or ``name -> {target: (A, B)}`` (raw factors);
    each registers in the process weight registry at load and
    materialises when a request first selects it, into one of
    ``max_adapters`` pool slots of rank ``lora_rank``.

    The telemetry plane, wired at load: a ``GenerationPrometheusBridge``
    (``SELDON_TPU_PROM_BRIDGE``) and a telemetry ring
    (``SELDON_TPU_TELEMETRY``, served at ``GET /debug/telemetry``)
    collected from the decode loop, each request's cost totals in
    ``meta.tags.cost``, and with ``SELDON_TPU_CAPTURE=1`` a capture of
    the requests its triggers pick (``tools/replay.py`` replays one).
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
        lora_rank: int = 8,
        adapters: Any = None,
        device: str = "cuda",
        dtype: str = "bfloat16",
        **kwargs: Any,
    ):
        super().__init__(**kwargs)
        check_ported_options()
        precision, quantize = _precision_modes(quantize, precision)  # fail at construction
        if isinstance(adapters, str):
            adapters = json.loads(adapters) if adapters else None
        self.adapters: Dict[str, Any] = dict(adapters) if adapters else {}
        self.max_adapters = int(max_adapters)
        self.lora_rank = int(lora_rank)
        self.device = resolve_device(device)
        self.dtype_name = dtype
        self.dtype = _resolve_dtype(dtype)
        self.config = dict(vocab_size=int(vocab_size), d_model=int(d_model), num_layers=int(num_layers),
                           num_heads=int(num_heads), max_len=int(max_len))
        if isinstance(mesh_axes, str):
            mesh_axes = json.loads(mesh_axes) if mesh_axes else None
        self.mesh_axes = dict(mesh_axes) if mesh_axes else None
        self.engine_config = dict(page_size=int(page_size), num_pages=int(num_pages) or None,
                                  max_slots=int(max_slots), steps_per_call=int(steps_per_call),
                                  tp=int(tp or 0), dp=int(dp or 0),
                                  max_steps_per_call=int(max_steps_per_call), quantize=quantize,
                                  precision=precision, prefix_cache=prefix_cache, max_queue=int(max_queue),
                                  chunk_token_budget=int(chunk_token_budget),
                                  speculative=dict(speculative) if speculative else None)
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
        # set by drain / evacuate: the stopped loop leaves the engine's
        # streams to them instead of closing it
        self._draining = False
        self._load_lock = threading.Lock()
        self._request_seed = RequestSeeds()
        self._load_time_s: Optional[float] = None
        # the telemetry plane, wired at load: the Prometheus bridge
        # (SELDON_TPU_PROM_BRIDGE), the telemetry ring (SELDON_TPU_TELEMETRY)
        # and the last predict's cost totals on its dispatch thread
        self._prom_bridge = None
        self._telemetry_ring = None
        self._request_cost = threading.local()

    def load(self) -> None:
        """Build the engine (seeded weights), warm it with one short
        generation, and start the decode loop.  Idempotent: a second
        call must not start a second loop over the same engine."""
        with self._load_lock:
            if self.engine is not None:
                return
            t0 = time.perf_counter()
            params = load_lm_params(self.model_uri, self.config, self.seed, self.device)
            engine = PagedEngine(params, dtype=self.dtype, device=self.device, max_adapters=self.max_adapters,
                                 lora_rank=self.lora_rank, weight_registry=self._register_adapters(),
                                 mesh=component_mesh(self.mesh_axes, self.device), **self.config,
                                 **self.engine_config)
            # first CUDA calls (library handles, the kernel build) pay here, not in a request
            engine.generate(np.zeros((1,), np.int32), max_new_tokens=2)
            self._wire_telemetry(engine)
            self._replay_journal(engine)
            self._loop_thread = threading.Thread(target=self._loop, name="streaminglm-decode", daemon=True)
            self.engine = engine  # published after construction; the loop reads it
            self._loop_thread.start()
            self._load_time_s = time.perf_counter() - t0
            logger.info("streaminglm loaded on %s in %.2fs (kernel lane %s, kv pool %s, precision %s, prefix cache "
                        "%s, %d adapter slots)", self.device, self._load_time_s,
                        "on" if engine._kernel_active else "off", "int8" if engine._kv_int8 else self.dtype_name,
                        engine.precision, "on" if engine._prefix_cache_enabled else "off", engine.max_adapters)

    def _wire_telemetry(self, engine: PagedEngine) -> None:
        """The engine's canonical ``seldon_tpu_engine_*`` series on the
        process registry (``SELDON_TPU_PROM_BRIDGE``; one ``model_name``
        an engine, so two StreamingLMs of one process never share a
        series) and the telemetry ring (``SELDON_TPU_TELEMETRY``), both
        collected from the decode loop.  A failure here is logged: the
        metrics never block serving."""
        if _knobs.flag("SELDON_TPU_PROM_BRIDGE"):
            try:
                from seldon_core_tpu_torch.utils.metrics import GenerationPrometheusBridge

                global _BRIDGE_SEQ
                with _BRIDGE_SEQ_LOCK:
                    seq = _BRIDGE_SEQ
                    _BRIDGE_SEQ += 1
                self._prom_bridge = GenerationPrometheusBridge(engine, model_name=f"streaminglm-{seq}")
            except Exception:  # noqa: BLE001 — metrics never block serving
                logger.exception("prometheus bridge unavailable")
        if _telemetry.telemetry_enabled():
            self._telemetry_ring = _telemetry.TelemetryRing(
                capacity=int(_knobs.raw("SELDON_TPU_TELEMETRY_RING", "256") or 256))

    def _collect(self) -> None:
        """One collect of the bridge and one telemetry sample; both
        contain their own failures."""
        if self._prom_bridge is not None:
            self._prom_bridge.collect()
        if self._telemetry_ring is not None:
            try:
                self._telemetry_ring.sample_engine(self.engine)
            except Exception:  # noqa: BLE001 — telemetry never blocks serving
                logger.exception("telemetry sample failed")

    @staticmethod
    def _replay_journal(engine: PagedEngine) -> None:
        """Re-submit the streams a drained predecessor journaled at
        ``SELDON_TPU_DRAIN_JOURNAL`` before the decode loop starts, unary
        (their consumers died with the old process), and unlink the
        journal so it never replays twice.  A corrupt journal is logged
        and never blocks serving."""
        path = _knobs.raw("SELDON_TPU_DRAIN_JOURNAL", "")
        if not path or not os.path.exists(path):
            return
        try:
            with open(path) as f:
                entries = [json.loads(line) for line in f if line.strip()]
            os.unlink(path)
            if entries:
                replayed = engine.replay(entries, stream_tokens=False)
                logger.info("drain journal %s: replayed %d/%d streams", path, len(replayed), len(entries))
        except Exception:  # noqa: BLE001 — callers' retries re-derive what it described
            logger.exception("drain-journal replay failed (%s)", path)

    def _register_adapters(self):
        """Register the deployment's adapter catalogue in the process
        weight registry (from :meth:`load`, before the engine exists).
        Returns the registry the engine resolves names through, or None
        when multi-LoRA is off entirely."""
        if not (self.adapters or self.max_adapters):
            return None
        from seldon_core_tpu_torch.models.registry import get_registry

        registry = get_registry()
        hint = 4 * self.config["num_layers"] * sum(
            (d_in + d_out) * self.lora_rank for d_in, d_out in target_dims(self.config["d_model"]).values())
        for name, spec in self.adapters.items():
            registry.register(name, self._adapter_loader(spec), bytes_hint=hint)
        return registry

    def _adapter_loader(self, spec: Any):
        """One adapter's loader: a raw ``{target: (A, B)}`` dict passes
        through; ``{"uri": ...}`` restores a flax msgpack checkpoint onto
        the factor template (``make_lora_params``' structure), as the JAX
        engine does; ``{"seed": n, "alpha": a}`` (or a bare seed) builds
        deterministic synthetic factors (``alpha`` defaults to the rank),
        the JAX package's for the same seed."""
        cfg = dict(self.config)
        rank = self.lora_rank

        def loader():
            if isinstance(spec, dict) and any(t in spec for t in LORA_TARGETS):
                return spec
            if isinstance(spec, dict) and "uri" in spec:
                from seldon_core_tpu_torch.utils import serialization, storage

                template = make_lora_params(0, num_layers=cfg["num_layers"], d_model=cfg["d_model"], rank=rank)
                with open(storage.download(spec["uri"]), "rb") as f:
                    return serialization.to_numpy_tree(serialization.from_bytes(template, f.read()))
            seed = int(spec.get("seed", 0)) if isinstance(spec, dict) else int(spec)
            alpha = float(spec.get("alpha", rank)) if isinstance(spec, dict) else float(rank)
            return make_lora_params(seed, num_layers=cfg["num_layers"], d_model=cfg["d_model"], rank=rank,
                                    alpha=alpha)

        return loader

    @staticmethod
    def _request_adapter(tags) -> Optional[str]:
        """The request's adapter: ``meta.tags.adapter`` (where the
        ``X-Seldon-Adapter`` header lands; an explicit body tag wins);
        empty or absent is the base model."""
        return normalize_adapter(tags.get("adapter"))

    @staticmethod
    def _slo_terms(tags) -> Tuple[int, Optional[float]]:
        """Per-request SLO terms: the ``priority`` tag (clamped like the
        ingress header) and the tightest of the ``deadline_at_monotonic``
        tag (an absolute expiry), the ``deadline_ms`` tag (relative,
        minted here) and the ambient request budget, as an absolute
        ``time.monotonic()`` expiry."""
        try:
            priority = clamp_priority(int(float(tags.get("priority", 0))))
        except (TypeError, ValueError):
            priority = 0
        deadline = None
        raw_abs = tags.get("deadline_at_monotonic")
        if raw_abs is not None:
            try:
                deadline = float(raw_abs)
            except (TypeError, ValueError):
                deadline = None
        raw = tags.get("deadline_ms")
        if raw is not None:
            try:
                rel = time.monotonic() + max(0.0, float(raw)) / 1000.0
                deadline = rel if deadline is None else min(deadline, rel)
            except (TypeError, ValueError):
                pass
        ambient = current_deadline()
        if ambient is not None:
            deadline = ambient.expires_at if deadline is None else min(deadline, ambient.expires_at)
        return priority, deadline

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        last_collect = 0.0

        def collect(min_interval_s: float) -> None:
            # throttled inside the busy loop too: under sustained load the
            # series must not freeze during the backlog they watch
            nonlocal last_collect
            if self._prom_bridge is None and self._telemetry_ring is None:
                return
            now = time.monotonic()
            if now - last_collect >= min_interval_s:
                last_collect = now
                self._collect()

        while not self._stop:
            self._wake.wait(timeout=0.5)
            self._wake.clear()
            try:
                while self.engine.has_work():
                    if self._stop:
                        break
                    self.engine.step()
                    collect(2.0)
            except Exception as exc:  # noqa: BLE001 — surfaced to every waiter
                logger.exception("decode loop failed")
                self.engine.fail_all(exc)
            collect(0.5)
        # nothing steps the streams again: close the engine, unless a drain
        # or an evacuation owns them (it journals or migrates them first)
        if not self._draining:
            self.engine.close(MicroserviceError("component shut down", status_code=503, reason="SHUTTING_DOWN"))

    def shutdown(self) -> None:
        self._stop = True
        self._wake.set()

    def unload(self) -> None:
        self.shutdown()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=30)

    def predict(self, X, names, meta=None):
        if self.engine is None:
            self.load()
        meta = meta or {}
        tags = meta.get("tags", {})
        if tags.get("kv_migration"):
            return self._accept_migration(X)
        max_new = int(tags.get("max_new_tokens", self.max_new_tokens))
        temperature = float(tags.get("temperature", self.temperature))
        top_k = int(tags.get("top_k", self.top_k))
        request_seed = self._request_seed(tags, meta)
        priority, deadline = self._slo_terms(tags)
        adapter = self._request_adapter(tags)
        X = np.atleast_2d(np.asarray(X, np.int32))
        streams = []
        try:
            for i, row in enumerate(X):
                streams.append(self.engine.submit(
                    row, max_new_tokens=max_new, temperature=temperature, top_k=top_k, eos_id=self.eos_id,
                    seed=self.seed ^ (request_seed * 1000003 + i), adapter=adapter, priority=priority,
                    deadline=deadline, puid=str(meta.get("puid", "")),
                ))
            self._wake.set()
            for stream in streams:
                stream.event.wait()
                if stream.error:
                    raise stream.error
            if self.engine._telemetry_enabled:
                # the request's cost rides meta.tags.cost: the dispatcher
                # reads tags() on this thread right after predict
                self._request_cost.value = {
                    "page_seconds": round(sum(s.cost_page_s for s in streams), 6),
                    "prefill_tokens": sum(s.cost_prefill_tokens for s in streams),
                    "decode_tokens": sum(s.cost_decode_tokens for s in streams),
                    "preemptions": sum(s.cost_preempts for s in streams),
                    "restores": sum(s.cost_restores for s in streams),
                    "adapter": adapter or "base",
                }
            result = np.stack([s.result for s in streams])
            self._maybe_capture(streams, tags=tags, meta=meta, request_seed=request_seed, status="ok",
                                tokens=streams[0].result)
            return result
        except BaseException as exc:
            # one row failed (shed, expired): its siblings must not keep
            # decoding unread
            for s in streams:
                if s.result is None and s.error is None:
                    self.engine.cancel(s)
            self._maybe_capture(streams, tags=tags, meta=meta, request_seed=request_seed, status="error",
                                reason=repr(exc))
            raise

    def predict_stream(self, X, names=None, meta=None):
        """Token streaming for ONE prompt: a generator of int32 arrays of
        newly decoded tokens as the engine's chunks land (JAX
        ``paged.py:7355-7415``).  The tag overrides, the seed rule, the
        SLO terms and the adapter are ``predict``'s, so a streamed request
        samples the tokens the unary ``predict`` of the same request
        does, and the chunks joined are its row cut at eos.  An eviction
        re-derives the stream's tokens and pushes on from the last one
        sent.  The stream's error is raised after its end marker; closing
        the generator (a consumer gone) cancels the stream, which frees
        its slot and pages.  A stream that ends (or fails) is captured as
        ``predict``'s requests are; a consumer leaving mid-stream is not
        a serving incident and is not captured."""
        if self.engine is None:
            self.load()
        meta = meta or {}
        tags = meta.get("tags", {})
        max_new = int(tags.get("max_new_tokens", self.max_new_tokens))
        temperature = float(tags.get("temperature", self.temperature))
        top_k = int(tags.get("top_k", self.top_k))
        request_seed = self._request_seed(tags, meta)
        X = np.atleast_2d(np.asarray(X, np.int32))
        if X.shape[0] != 1:
            raise MicroserviceError("token streaming serves one prompt per stream; send rows separately "
                                    "(predict() batches them)", status_code=400, reason="BAD_REQUEST")
        priority, deadline = self._slo_terms(tags)
        stream = self.engine.submit(X[0], max_new_tokens=max_new, temperature=temperature, top_k=top_k,
                                    eos_id=self.eos_id, seed=self.seed ^ (request_seed * 1000003),
                                    stream_tokens=True, priority=priority, deadline=deadline,
                                    adapter=self._request_adapter(tags), puid=str(meta.get("puid", "")))
        self._wake.set()
        try:
            while True:
                got = stream.token_queue.get()
                if got is None:
                    break
                yield np.asarray(got, np.int32)
            if stream.error:
                err = stream.error
                self._maybe_capture([stream], tags=tags, meta=meta, request_seed=request_seed, status="error",
                                    reason=repr(err))
                raise err
            self._maybe_capture([stream], tags=tags, meta=meta, request_seed=request_seed, status="ok")
        finally:
            self.engine.cancel(stream)

    def drain(self, journal_path: Optional[str] = None, timeout_s: float = 30.0) -> List[Dict[str, Any]]:
        """Drain, then exit: stop the decode loop at the next chunk
        boundary, live-migrate the mid-decode streams to
        ``SELDON_TPU_EVACUATE_TO`` when it names a peer (a stream that
        cannot ship is journaled instead), journal every other live
        stream, and fail their waiters with 503 (``MIGRATING`` /
        ``DRAINING``).  The journal is JSONL written to ``journal_path``
        or ``SELDON_TPU_DRAIN_JOURNAL`` by tmp + rename, so a respawned
        process never reads half of it; :meth:`load` replays it.  The
        microservice calls this on SIGTERM; a never-loaded component
        returns []."""
        path = journal_path if journal_path is not None else _knobs.raw("SELDON_TPU_DRAIN_JOURNAL", "")
        if self.engine is None:
            return []
        self._quiesce_loop(timeout_s)
        entries: List[Dict[str, Any]] = []
        peer = _knobs.raw("SELDON_TPU_EVACUATE_TO", "") or ""
        if peer:
            entries.extend(self._evacuate_remote(peer))
        entries.extend(self.engine.drain())
        if path and entries:
            self._write_journal(path, entries)
            logger.info("drained %d live streams to %s", len(entries), path)
        return entries

    @staticmethod
    def _write_journal(path: str, entries: List[Dict[str, Any]]) -> None:
        try:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                for e in entries:
                    f.write(json.dumps(e) + "\n")
            os.replace(tmp, path)
        except OSError:
            logger.exception("drain journal write failed (%s)", path)

    def _quiesce_loop(self, timeout_s: float = 30.0) -> None:
        """Stop the decode loop at the next chunk boundary: neither a
        drain nor an evacuation may snapshot state a chunk still writes."""
        self._draining = True
        self._stop = True
        self._wake.set()
        if self._loop_thread is not None and self._loop_thread.is_alive():
            self._loop_thread.join(timeout=timeout_s)
            if self._loop_thread.is_alive():
                logger.error("decode loop still running after %.0fs drain wait — journaling anyway (the wave's "
                             "chunk results may be lost; re-derivation covers them)", timeout_s)

    def evacuate(self, peers, journal_path: Optional[str] = None, timeout_s: float = 30.0) -> Dict[str, Any]:
        """In-process live evacuation: quiesce the decode loop, migrate
        every exportable stream to a healthy peer
        (``models/disagg.evacuate_streams``: highest priority first, to
        the cheapest peer), journal the rest, close this engine.
        ``peers`` are :class:`PagedEngine` s or components with an
        ``.engine``.  Streaming consumers keep their token queues: no
        token is lost."""
        if self.engine is None:
            return {"migrated": 0, "journaled": 0, "failed": 0}
        from seldon_core_tpu_torch.models.disagg import evacuate_streams

        self._quiesce_loop(timeout_s)
        engines = [getattr(p, "engine", None) or p for p in peers]
        summary = evacuate_streams(self.engine, engines)
        for p in peers:
            wake = getattr(p, "_wake", None)
            if wake is not None:
                wake.set()  # adopted streams resume without the loop's poll
        entries = list(summary.pop("journal", []))
        entries.extend(self.engine.drain())
        path = journal_path if journal_path is not None else _knobs.raw("SELDON_TPU_DRAIN_JOURNAL", "")
        if path and entries:
            self._write_journal(path, entries)
        summary["journaled"] = len(entries)
        logger.info("evacuation: %d stream(s) live-migrated, %d journaled, %d failed", summary.get("migrated", 0),
                    len(entries), summary.get("failed", 0))
        return summary

    def _evacuate_remote(self, endpoint: str) -> List[Dict[str, Any]]:
        """Ship this engine's exportable streams to ``endpoint``
        (``grpc://host:port`` or ``rest://host:port``) as migration
        containers, one predict call each on the port's transport clients
        (tag ``kv_migration``, the container as a uint8 ``rawTensor``),
        metered as ``method="migrate"`` hops.  A shipped stream's waiter
        fails 503 ``MIGRATING`` (its state lives on the peer; a retry
        lands there); a stream that cannot ship comes back as a journal
        entry.  Across processes the consumer's connection dies with this
        one: shipping the K/V lets the stream finish on the peer and
        registers its prompt pages in the peer's prefix cache."""
        import asyncio

        from seldon_core_tpu_torch.codec.bufview import pack_kv_migration
        from seldon_core_tpu_torch.engine.graph import Endpoint, UnitSpec
        from seldon_core_tpu_torch.engine.transport import GrpcClient, RestClient, migration_hop
        from seldon_core_tpu_torch.models.disagg import migration_journal_entry
        from seldon_core_tpu_torch.runtime.message import InternalMessage

        exported = self.engine.migrate_export()
        if not exported:
            return []
        scheme, sep, rest = endpoint.partition("://")
        if not sep:
            scheme, rest = "grpc", endpoint
        host, _, port = rest.partition(":")
        spec = UnitSpec(name=f"evacuate@{rest}", endpoint=Endpoint(
            host=host or "localhost", port=int(port or 9000), transport="REST" if scheme == "rest" else "GRPC"))
        client = RestClient(spec) if scheme == "rest" else GrpcClient(spec)
        loop = asyncio.new_event_loop()
        fallback: List[Dict[str, Any]] = []
        migrated = 0
        err = MicroserviceError("stream live-migrated to a peer engine during evacuation", status_code=503,
                                reason="MIGRATING")
        try:
            for payload, stream in sorted(exported, key=lambda ps: -ps[0]["priority"]):
                try:
                    buf = pack_kv_migration(payload)
                    with migration_hop("streaminglm-evacuate", "dcn") as hop:
                        if hop is not None:
                            hop.request_bytes = len(buf)
                        msg = InternalMessage(payload=np.frombuffer(buf, np.uint8)[None, :], kind="rawTensor")
                        msg.meta.tags["kv_migration"] = 1
                        loop.run_until_complete(client.transform_input(msg))
                    migrated += 1
                except Exception:  # noqa: BLE001 — the recipe is journaled instead
                    logger.exception("migration ship failed for req %s — journaling", payload.get("req_id"))
                    fallback.append(migration_journal_entry(payload))
                self.engine.fail_stream(stream, err)
        finally:
            try:
                loop.run_until_complete(client.close())
            except Exception:  # noqa: BLE001 — client teardown is best-effort at exit
                pass
            loop.close()
        logger.info("remote evacuation to %s: %d migrated, %d journaled", endpoint, migrated, len(fallback))
        return fallback

    def _accept_migration(self, X) -> np.ndarray:
        """The migration ingress: a peer evacuating its streams sends each
        as a uint8 migration container (CRC-checked); the stream resumes
        here at the exact next token.  Returns a 1x1 acknowledgement with
        the resumed stream's request id."""
        from seldon_core_tpu_torch.codec.bufview import unpack_kv_migration
        from seldon_core_tpu_torch.engine.transport import migration_hop

        buf = np.ascontiguousarray(np.asarray(X, np.uint8).reshape(-1)).tobytes()
        # the transport.corrupt chaos point: the CRC32C trailer must turn a
        # flipped byte into the named rejection below, never into K/V
        buf = _faults.corrupt_bytes("transport.corrupt", buf)
        with migration_hop("streaminglm-ingress", "dcn") as hop:
            if hop is not None:
                hop.request_bytes = len(buf)
            try:
                payload = unpack_kv_migration(buf)
            except Exception as exc:
                raise MicroserviceError(f"malformed migration container: {exc}", status_code=400,
                                        reason="BAD_MIGRATION_PAYLOAD") from exc
            stream = self.engine.migrate_import(payload, stream_tokens=False)
        self._wake.set()
        return np.asarray([[stream.req_id]], np.int32)

    def _capture_model_config(self) -> Dict[str, Any]:
        """The constructor arguments a replay rebuilds this model from
        (``tools/replay.py``): architecture, engine shape, numeric regime,
        device and dtype.  Runtime knobs travel in the capture's knob
        snapshot.  Values that JSON cannot hold are left out."""
        eng = self.engine_config
        cfg = {
            **self.config,
            "max_new_tokens": self.max_new_tokens, "temperature": self.temperature, "top_k": self.top_k,
            "eos_id": self.eos_id, "model_uri": self.model_uri, "seed": self.seed,
            "page_size": eng["page_size"], "num_pages": int(eng["num_pages"] or 0), "max_slots": eng["max_slots"],
            "steps_per_call": eng["steps_per_call"], "max_steps_per_call": eng["max_steps_per_call"],
            "quantize": eng["quantize"] or "", "precision": eng["precision"] or "", "speculative": eng["speculative"],
            "prefix_cache": eng["prefix_cache"], "max_queue": eng["max_queue"],
            "chunk_token_budget": eng["chunk_token_budget"], "max_adapters": self.max_adapters,
            "lora_rank": self.lora_rank, "adapters": self.adapters, "device": str(self.device),
            "dtype": self.dtype_name,
        }
        out = {}
        for k, v in cfg.items():
            try:
                json.dumps(v)
            except (TypeError, ValueError):
                continue
            out[k] = v
        return out

    def _maybe_capture(self, streams, *, tags, meta, request_seed, status="ok", reason="", tokens=None) -> None:
        """Evaluate the capture triggers for a finished request (its first
        row: a replay re-submits the whole request) and store the capture
        when one fires.  Contained: forensics never breaks serving."""
        engine = self.engine
        if engine is None or not engine._capture_enabled or not streams:
            return
        try:
            stream = streams[0]
            puid = str(meta.get("puid", "") or stream.puid or stream.trace_id or f"req-{stream.req_id}")
            trigger = engine.capture_trigger(puid, stream.error if status != "ok" else None)
            if trigger is None and status != "ok":
                trigger = "error"  # raised before or around the submit
            if trigger is None:
                return
            remaining = None
            if stream.deadline is not None:
                remaining = max(0.0, (stream.deadline - time.monotonic()) * 1000.0)
            engine.capture_request(stream, puid=puid, trigger=trigger, status=status, reason=reason, tokens=tokens,
                                   extra={"request_seed": int(request_seed), "model": self._capture_model_config(),
                                          "tags": {k: v for k, v in tags.items()
                                                   if isinstance(v, (str, int, float, bool))},
                                          "rows": len(streams), "deadline_remaining_ms": remaining})
        except Exception:  # noqa: BLE001 — forensics never breaks serving
            logger.exception("request capture failed")

    def tags(self):
        """Response meta tags: the last predict's cost totals on this
        dispatch thread (read right after predict), popped once so a later
        request that fails before its submit inherits nothing."""
        cost = getattr(self._request_cost, "value", None)
        self._request_cost.value = None
        return {"cost": cost} if cost else {}

    def telemetry_snapshot(self, window_s: float = 0.0):
        """The versioned per-replica telemetry payload
        (``utils/telemetry.TelemetryRing.snapshot``), after one fresh
        sample, so a poll between the loop's samples still sees the
        current queue and residency.  None with the plane off."""
        if self._telemetry_ring is None:
            return None
        if self.engine is not None:
            try:
                self._telemetry_ring.sample_engine(self.engine)
            except Exception:  # noqa: BLE001 — serve what the ring has
                logger.exception("telemetry sample failed")
        return self._telemetry_ring.snapshot(window_s)

    def custom_routes(self):
        """``GET /debug/telemetry?window=<s>`` on the component's own REST
        surface.  With the telemetry plane off there is no ring and no
        route."""
        if self._telemetry_ring is None:
            return {}

        def debug_telemetry(request):
            try:
                window_s = float(request.query.get("window", "0") or 0.0)
            except (ValueError, AttributeError):
                window_s = 0.0
            return self.telemetry_snapshot(window_s)

        return {"/debug/telemetry": debug_telemetry}

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
            gauge_metric("paged_pool_utilization", s["pool_pages_used"] / max(1, s["pool_pages_total"])),
            gauge_metric("paged_evictions", s["evictions"]),
            gauge_metric("paged_stall_events", s["stalls"]),
            gauge_metric("paged_prefix_hit_rate", s["prefix_hits"] / max(1, s["prefix_hits"] + s["prefix_misses"])),
            gauge_metric("paged_prefix_pages_cached", s["prefix_pages_cached"]),
            gauge_metric("paged_prefix_tokens_saved", s["prefix_tokens_saved"]),
            gauge_metric("paged_kernel_active", s["kernel_active"]),
            gauge_metric("paged_kv_dtype_int8", s["kv_dtype_int8"]),
            gauge_metric("paged_adapters_resident", s["adapters_resident"]),
            gauge_metric("paged_bucketed_chunks", s["bucketed_chunks"]),
            gauge_metric("paged_tp_degree", s["tp_degree"]),
            gauge_metric("paged_dp_degree", s["dp_degree"]),
        ]
        for key in ("shed", "expired", "preempted", "restored", "adapter_loads", "adapter_hits", "adapter_misses",
                    "adapter_evictions", "drained", "replayed", "kv_exports", "kv_imports", "migrated_out",
                    "migrated_in", "quarantined", "chunk_faults", "health_state",
                    *(k for k in s if k.startswith("kv_tier_"))):
            out.append(gauge_metric(f"paged_{key}", s[key]))
        for name, n in self.engine.adapter_stats()["requests"].items():
            out.append(gauge_metric("paged_adapter_requests", n, tags={"adapter": name}))
        for name, n in kernels.launch_counts().items():
            out.append(gauge_metric("streaminglm_kernel_launches", float(n), tags={"kernel": name}))
        if self.engine.speculative is not None:
            out.append(gauge_metric("speculative_acceptance_rate", s["spec_accepted"] / max(1, s["spec_drafted"])))
            out.append(gauge_metric("speculative_rounds", s["chunks"]))
        return out

    def health_status(self):
        engine = self.engine
        cfg = self.engine_config
        return {
            "model": "streaminglm",
            "loaded": engine is not None,
            "device": str(self.device),
            "device_name": torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu",
            "dtype": self.dtype_name,
            "load_time_s": self._load_time_s,
            "quantize": cfg["quantize"],
            "precision": cfg["precision"],
            "prefix_cache": bool(engine._prefix_cache_enabled) if engine is not None else cfg["prefix_cache"],
            "chunk_token_budget": engine.chunk_token_budget if engine is not None else cfg["chunk_token_budget"],
            "max_queue": engine.max_queue if engine is not None else cfg["max_queue"],
            "speculative": _reported_speculative(engine.speculative if engine is not None else cfg["speculative"]),
            "weight_bytes": engine.weight_bytes() if engine is not None else None,
            "kernel_active": bool(engine is not None and engine._kernel_active),
            "chunk_impl": engine._chunk_impl if engine is not None else None,
            "kv_dtype": ("int8" if engine._kv_int8 else self.dtype_name) if engine is not None else None,
            "kernel_launches": kernels.launch_counts(),
            "engine": engine.engine_stats() if engine is not None else {},
            "adapters": engine.adapter_stats() if engine is not None else {},
        }
