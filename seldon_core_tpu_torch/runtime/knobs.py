"""Environment knobs the port reads, in one place.

Each knob is read straight from ``os.environ`` when it is needed.  Where
a knob means what it means in the JAX package, it keeps that package's
``SELDON_TPU_*`` name, so one deployment spec configures either server.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

KNOBS: Dict[str, str] = {
    "SELDON_TPU_DISPATCH_THREADS": "size of the shared dispatch thread pool (default 128)",
    "SELDON_TPU_PAGED_KERNEL": (
        "paged decode lane: 'auto' (default: the CUDA kernel on a CUDA engine, the gather lane "
        "on the CPU), '1'/'force' (the kernel lane everywhere; its plain version on the CPU), "
        "'0' (the gather lane)"
    ),
    "SELDON_TPU_PAGED_KERNEL_IMPL": "paged decode kernel: 'stream' (K4, default) or 'grid' (K5)",
    "SELDON_TPU_CHUNK_IMPL": (
        "decode chunk: unset = 'pool' where the kernel lane can run, else 'ring'; 'pool' (per-step attention "
        "over the pool, the kernel lane's home) or 'ring' (the context gathered once a chunk plus an in-chunk "
        "ring, dense products only); anything else raises"
    ),
    "SELDON_TPU_CTX_BUCKETS": (
        "length buckets of a decode chunk: '2' (the shorter half of the running lanes attends at its own table "
        "width) or '1' (one width for every lane); unset, 1 on a CUDA device and 2 elsewhere"
    ),
    "SELDON_TPU_KV_DTYPE": (
        "KV pool dtype: 'bf16' (default: the engine dtype, natively) or 'int8' (int8 pages with one float32 "
        "scale per page for K and for V: half the pool bytes; the pool chunk only)"
    ),
    "SELDON_TPU_MAX_ADAPTERS": "LoRA adapter pool slots of a PagedEngine when max_adapters is 0 (unset/0: adapters off)",
    "SELDON_TPU_WEIGHT_BUDGET_GIB": "weight registry budget in GiB for named weight sets (unset/0: no budget)",
    "SELDON_TPU_PREFIX_CACHE": "page-granular automatic prefix caching ('0' = off; a constructor's prefix_cache wins)",
    "SELDON_TPU_PAGED_DEBUG": "the paged engine's allocator audit at every chunk boundary ('1' = on)",
    "SELDON_TPU_MAX_QUEUE": "bounded run-queue depth for priority shedding when max_queue is 0 (0 = unbounded)",
    "SELDON_TPU_CHUNK_TOKEN_BUDGET": (
        "chunked-prefill co-scheduling when chunk_token_budget is 0: the most tokens one engine wave may carry, "
        "filled decode-first then with page-aligned prompt slices (0 = off: monolithic prefill)"
    ),
    "SELDON_TPU_ZERO_COPY": (
        "buffer-view lane: SRT1 frames decode to zero-copy views from the native ingress to the device "
        "staging buffer ('0' = proto/JSON paths only; frames are refused naming the knob)"
    ),
    "SELDON_TPU_NATIVE_SO": "path of a prebuilt native front-server library to load instead of the port's own build",
    "SELDON_TPU_TRACE_EXPORT": "per-process JSONL span sink of the microservice CLI's --tracing (unset: the ring only)",
    "SELDON_TPU_TRANSPORT_TELEMETRY": "per-hop transport metrics seldon_tpu_transport_* ('0' = off)",
    "SELDON_TPU_BREAKER": "per-endpoint circuit breakers of the graph's node clients ('0' = off)",
    "SELDON_TPU_MODEL_CACHE": (
        "directory remote model_uri downloads land in (unset: seldon-tpu-models under the temp directory)"
    ),
    "SELDON_TPU_DRAIN_JOURNAL": "drain/handoff journal path (pinned per worker by the supervisor)",
    "SELDON_TPU_KV_CHECKSUM": (
        "CRC32C integrity trailer on KV handoff/migration containers (0 = off; default on: a flipped byte "
        "rejects as a named PayloadError instead of decoding as garbage KV)"
    ),
    "SELDON_TPU_KV_OFFLOAD": (
        "hierarchical KV tier: demote LRU-reclaimed prefix/session pages into a budgeted host-RAM store "
        "(optionally spilling to disk) and promote them back through the page import on the next chain hit "
        "(0 = off, discard-on-reclaim as before)"
    ),
    "SELDON_TPU_KV_HOST_BUDGET_GIB": (
        "host-RAM byte budget for the KV tier's container store (oldest entries spill to disk or drop when "
        "exceeded; default 4)"
    ),
    "SELDON_TPU_KV_SPILL_DIR": (
        "disk level below the host KV tier: CRC-trailered containers written atomic tmp+rename, LRU-evicted "
        "to the spill budget (empty = no disk level, host-budget overflow drops)"
    ),
    "SELDON_TPU_KV_SPILL_GIB": "disk byte budget for the KV tier's spill directory (default 16)",
    "SELDON_TPU_EVACUATE_TO": (
        "peer endpoint ('grpc://host:port' | 'rest://host:port') that drain() live-migrates streams to before "
        "exiting; failures fall back to the drain journal (empty = journal only)"
    ),
}

# flag knobs and their defaults: "1" = on unless set to "0", "0" = off
# unless set to "1" (the JAX package's defaults)
_FLAG_DEFAULTS: Dict[str, str] = {
    "SELDON_TPU_PREFIX_CACHE": "1",
    "SELDON_TPU_PAGED_DEBUG": "0",
    "SELDON_TPU_ZERO_COPY": "1",
    "SELDON_TPU_TRANSPORT_TELEMETRY": "1",
    "SELDON_TPU_BREAKER": "1",
    "SELDON_TPU_KV_CHECKSUM": "1",
    "SELDON_TPU_KV_OFFLOAD": "0",
}


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The knob's value, or ``default`` when unset; the name must be listed."""
    if name not in KNOBS:
        raise KeyError(f"unregistered knob {name!r}; known: {sorted(KNOBS)}")
    return os.environ.get(name, default)


def flag(name: str) -> bool:
    """An on/off knob: a default-on flag is off only at ``0``, a
    default-off flag is on only at ``1`` (the JAX package's rule)."""
    if name not in _FLAG_DEFAULTS:
        raise KeyError(f"{name!r} is not a flag knob; read it with raw()")
    default = _FLAG_DEFAULTS[name]
    val = raw(name, default)
    return val != "0" if default == "1" else val == "1"
