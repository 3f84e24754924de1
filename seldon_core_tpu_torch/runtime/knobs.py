"""The declared registry of every runtime knob the port reads.

Every ``SELDON_TPU_*`` environment variable, ``seldon.io/*`` deployment
annotation and ``X-Seldon-*`` request header the port reads is declared
here, with its kind, default, whether ``=0`` spells off, one line of
doc and where it is documented.  Where a knob means what it means in the
JAX package it keeps that package's name and default, so one deployment
spec configures either server.

* **Reads go through it.**  :func:`raw` and :func:`flag` raise
  :class:`UndeclaredKnobError` for a name that is not declared, so a
  knob cannot exist without an entry (``tests/test_torch_port_debug.py``
  checks by an AST scan that every name the port spells is declared).
* **``=0`` spells off** on every knob whose ``zero_off`` is set.
* **It is an operational surface.**  :func:`snapshot` renders the whole
  registry with the current values in the JAX package's shape (the same
  keys per entry); the gateway serves it at ``GET /debug/knobs`` and a
  request capture keeps the set ones (``utils/capture.knob_snapshot``).

Parsing stays at the read site; ``kind`` and ``default`` document what
the reader accepts and does when the knob is unset.  The module imports
the standard library only.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

__all__ = [
    "Knob",
    "Annotation",
    "Header",
    "ENV_KNOBS",
    "ANNOTATIONS",
    "HEADERS",
    "UndeclaredKnobError",
    "raw",
    "flag",
    "declared",
    "snapshot",
]


class UndeclaredKnobError(KeyError):
    """A ``SELDON_TPU_*`` read of a name missing from the registry: a
    programming error (declare the knob), never a runtime condition."""


@dataclass(frozen=True)
class Knob:
    """One declared environment knob: ``kind`` is the value's shape
    (``flag`` | ``int`` | ``float`` | ``str`` | ``path`` | ``spec``),
    ``default`` the effective value when unset, ``zero_off`` the ``=0``
    means off contract, ``anchor`` where the knob is documented."""

    name: str
    kind: str
    default: str
    zero_off: bool
    doc: str
    anchor: str


@dataclass(frozen=True)
class Annotation:
    """One declared ``seldon.io/*`` deployment annotation."""

    name: str
    kind: str
    doc: str


@dataclass(frozen=True)
class Header:
    """One declared ``X-Seldon-*`` request header (case-insensitive on
    the wire; gRPC metadata uses the lowercase spelling)."""

    name: str
    kind: str
    doc: str


def _knobs(*knobs: Knob) -> Dict[str, Knob]:
    out: Dict[str, Knob] = {}
    for k in knobs:
        if k.name in out:
            raise ValueError(f"duplicate knob declaration {k.name!r}")
        out[k.name] = k
    return out


_PORT = "README.md, PyTorch / H100 port"

ENV_KNOBS: Dict[str, Knob] = _knobs(
    # ---- runtime / process ------------------------------------------------
    Knob("SELDON_TPU_DISPATCH_THREADS", "int", "128", False,
         "dispatch thread-pool size for component calls",
         "architecture.md §2"),
    Knob("SELDON_TPU_TRACE_EXPORT", "path", "", False,
         "per-process JSONL span sink of the microservice CLI's --tracing",
         "architecture.md §5c-bis"),
    Knob("SELDON_TPU_DRAIN_JOURNAL", "path", "", False,
         "drain/handoff journal path (pinned per worker by the supervisor)",
         "operations.md failure-containment"),
    Knob("SELDON_TPU_MODEL_CACHE", "path", "", False,
         "directory remote model_uri downloads land in (unset: "
         "seldon-tpu-models under the temp directory)",
         "architecture.md §3"),
    Knob("SELDON_TPU_NATIVE_SO", "path", "", False,
         "path of a prebuilt native front-server library to load instead "
         "of the port's own build",
         "architecture.md §9"),
    # ---- transport / telemetry -------------------------------------------
    Knob("SELDON_TPU_ZERO_COPY", "flag", "1", True,
         "buffer-view lane: SRT1 frames decode to zero-copy views from the "
         "native ingress to the device staging buffer (0 = proto/JSON "
         "paths only; frames are refused naming the knob)",
         "architecture.md §9a"),
    Knob("SELDON_TPU_BREAKER", "flag", "1", True,
         "per-endpoint circuit breakers of the graph's node clients (0 = off)",
         "operations.md failure-containment"),
    Knob("SELDON_TPU_TRANSPORT_TELEMETRY", "flag", "1", True,
         "per-hop transport metrics seldon_tpu_transport_* (0 = off)",
         "architecture.md §5c-bis"),
    Knob("SELDON_TPU_FAULT", "spec", "", True,
         "fault-injection spec 'point[:k=v,..];..' (empty/0 = disarmed; "
         "points: utils/faults.KNOWN_POINTS)",
         "operations.md fault-injection"),
    # ---- generation engine ------------------------------------------------
    Knob("SELDON_TPU_PAGED_KERNEL", "str", "auto", True,
         "paged decode lane: 'auto' (the CUDA kernel on a CUDA engine, the "
         "gather lane on the CPU), '1'/'force' (the kernel lane everywhere; "
         "its plain version on the CPU), '0' (the gather lane)",
         _PORT),
    Knob("SELDON_TPU_PAGED_KERNEL_IMPL", "str", "stream", False,
         "paged decode kernel: 'stream' (K4) or 'grid' (K5)",
         "architecture.md §5b"),
    Knob("SELDON_TPU_KV_DTYPE", "str", "bf16", False,
         "KV pool dtype: 'bf16' (the engine dtype) or 'int8' (int8 pages "
         "with one float32 scale per page for K and for V; the pool chunk "
         "only)",
         "architecture.md §5b-septies"),
    Knob("SELDON_TPU_CHUNK_IMPL", "str", "", False,
         "decode chunk: unset = 'pool' where the kernel lane can run, else "
         "'ring'; 'pool' or 'ring'; anything else raises",
         "architecture.md §5b"),
    Knob("SELDON_TPU_CTX_BUCKETS", "int", "", False,
         "length buckets of a decode chunk: '2' or '1'; unset, 1 on a CUDA "
         "device and 2 elsewhere",
         _PORT),
    Knob("SELDON_TPU_PREFIX_CACHE", "flag", "1", True,
         "page-granular automatic prefix caching (0 = off; a constructor's "
         "prefix_cache wins)",
         "architecture.md §5b-bis"),
    Knob("SELDON_TPU_PAGED_DEBUG", "flag", "0", False,
         "the paged engine's allocator audit at every chunk boundary (1 = on)",
         "architecture.md §5b-bis"),
    Knob("SELDON_TPU_MAX_QUEUE", "int", "0", True,
         "bounded run-queue depth for priority shedding when max_queue is 0 "
         "(0 = unbounded)",
         "operations.md overload-runbook"),
    Knob("SELDON_TPU_CHUNK_TOKEN_BUDGET", "int", "0", True,
         "chunked-prefill co-scheduling when chunk_token_budget is 0: the "
         "most tokens one engine wave may carry, filled decode-first then "
         "with page-aligned prompt slices (0 = off: monolithic prefill)",
         "architecture.md §5b-quater"),
    Knob("SELDON_TPU_PREFILL_WORKERS", "int", "0", True,
         "disaggregated serving when prefill_workers is 0: in-process prefill "
         "engines handing finished KV pages to the decode engine's pool "
         "(0 = off: one engine prefills and decodes)",
         "architecture.md §5b-quater"),
    Knob("SELDON_TPU_DISAGG_ROLE", "str", "", False,
         "role pin of a disaggregated worker, logged at load ('prefill' | "
         "'decode'; empty = unified engine)",
         "architecture.md §5b-quater"),
    Knob("SELDON_TPU_ADMISSION_PRICING", "flag", "1", True,
         "disaggregated admission prices a request by its predicted "
         "prefill+decode cost and refuses deadlines it cannot meet (0 = "
         "admit everything unpriced)",
         "architecture.md §5b-quater"),
    Knob("SELDON_TPU_MAX_ADAPTERS", "int", "0", True,
         "LoRA adapter pool slots of a PagedEngine when max_adapters is 0 "
         "(0 = adapters off)",
         "architecture.md §5b-quinquies"),
    Knob("SELDON_TPU_WEIGHT_BUDGET_GIB", "float", "0", True,
         "weight registry budget in GiB for named weight sets (0 = no budget)",
         "architecture.md §5b-quinquies"),
    Knob("SELDON_TPU_KV_CHECKSUM", "flag", "1", True,
         "CRC32C integrity trailer on KV handoff/migration/capture "
         "containers (0 = off; default on: a flipped byte rejects as a "
         "named PayloadError instead of decoding as garbage)",
         "architecture.md §5b-sexies"),
    Knob("SELDON_TPU_KV_OFFLOAD", "flag", "0", True,
         "hierarchical KV tier: demote LRU-reclaimed prefix pages into a "
         "budgeted host-RAM store (optionally spilling to disk) and promote "
         "them back on the next chain hit (0 = off)",
         "architecture.md §5b-nonies"),
    Knob("SELDON_TPU_KV_HOST_BUDGET_GIB", "float", "4", False,
         "host-RAM byte budget for the KV tier's container store",
         "architecture.md §5b-nonies"),
    Knob("SELDON_TPU_KV_SPILL_DIR", "path", "", False,
         "disk level below the host KV tier (empty = no disk level, "
         "host-budget overflow drops)",
         "architecture.md §5b-nonies"),
    Knob("SELDON_TPU_KV_SPILL_GIB", "float", "16", False,
         "disk byte budget for the KV tier's spill directory",
         "architecture.md §5b-nonies"),
    Knob("SELDON_TPU_NAN_GUARD", "flag", "1", True,
         "post-chunk NaN/Inf screen on served logits: a non-finite lane "
         "retires only its stream with 500 NUMERIC_POISON (0 = off; decode "
         "lane only, the speculative verify lane is not screened)",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_WATCHDOG", "flag", "1", True,
         "device-health watchdog driving the engine health state machine "
         "healthy -> degraded -> evacuating (0 = off)",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_WATCHDOG_CHUNK_MS", "float", "0", True,
         "chunk-wall-time ceiling (ms) the watchdog counts breaches against; "
         "waves that ran a first-seen chunk signature or built/loaded a "
         "kernel library are exempt (0 = ceiling off)",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_WATCHDOG_FAULT_RATE", "float", "0.5", False,
         "chunk-fault fraction of the watchdog window that degrades the engine",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_WATCHDOG_COMPILES", "int", "0", True,
         "first-seen chunk signatures (and kernel builds/loads) per watchdog "
         "window counted as a compile storm (0 = off)",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_WATCHDOG_HBM_PCT", "float", "0", True,
         "pool-page occupancy percentage counted as allocator pressure by "
         "the watchdog (0 = off)",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_WATCHDOG_WINDOW", "int", "32", False,
         "watchdog sliding-window length in engine waves",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_WATCHDOG_BREACHES", "int", "8", False,
         "window breaches that drive healthy -> degraded (a clean window "
         "recovers degraded -> healthy)",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_FORCE_EVACUATE", "flag", "0", False,
         "force the engine health state to 'evacuating' (operator "
         "forced-migration switch; 1 = on)",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_EVACUATE_TO", "str", "", False,
         "peer endpoint ('grpc://host:port' | 'rest://host:port') that "
         "drain() live-migrates streams to before exiting; failures fall "
         "back to the drain journal (empty = journal only)",
         "operations.md evacuation-runbook"),
    Knob("SELDON_TPU_PROM_BRIDGE", "flag", "1", True,
         "GenerationPrometheusBridge wired in StreamingLM.load (0 = off)",
         "architecture.md §5c"),
    # ---- observability / forensics ---------------------------------------
    Knob("SELDON_TPU_FLIGHT_RECORDER", "str", "512", True,
         "per-chunk flight-recorder ring capacity (0 = off, digits = size)",
         "architecture.md §5c"),
    Knob("SELDON_TPU_DUMP_P99_MS", "float", "0", True,
         "chunk-wall p99 breach threshold that auto-dumps the ring (0 = off)",
         "architecture.md §5c"),
    Knob("SELDON_TPU_DUMP_DIR", "path", "", False,
         "directory for p99-breach flight-recorder JSONL dumps",
         "architecture.md §5c"),
    Knob("SELDON_TPU_PROFILE_DIR", "path", "", False,
         "torch.profiler Chrome-trace output directory for the first N "
         "decode chunks",
         _PORT),
    Knob("SELDON_TPU_PROFILE_CHUNKS", "int", "4", False,
         "how many decode chunks run under the profiler hook",
         "architecture.md §5c"),
    Knob("SELDON_TPU_TELEMETRY", "flag", "1", True,
         "telemetry plane: per-replica telemetry ring, per-request cost "
         "ledger and histogram trace exemplars (0 = off: no new metric "
         "series, no new stats keys, no /debug/telemetry route)",
         "architecture.md §5c-ter"),
    Knob("SELDON_TPU_TELEMETRY_RING", "int", "256", False,
         "telemetry time-series ring capacity (samples per replica)",
         "architecture.md §5c-ter"),
    Knob("SELDON_TPU_CAPTURE", "flag", "0", True,
         "per-request capture plane: head-sampled / on-error / p99-breach "
         "requests stored as SRT1 capture containers for GET "
         "/debug/request/<puid> and tools/replay.py (0 = off)",
         "architecture.md §5c-quater"),
    Knob("SELDON_TPU_CAPTURE_SAMPLE", "int", "0", True,
         "head-sampling rate: capture every Nth completed request (0 = no "
         "head sampling; error/breach triggers still fire)",
         "architecture.md §5c-quater"),
    Knob("SELDON_TPU_CAPTURE_DIR", "path", "", False,
         "bounded on-disk capture store directory (LRU-by-bytes eviction); "
         "empty = a per-process temp directory",
         "architecture.md §5c-quater"),
    Knob("SELDON_TPU_CAPTURE_PAYLOADS", "flag", "1", True,
         "keep prompt/output token frames in capture containers; 0 = "
         "redact them (lengths and metadata survive, replay becomes "
         "impossible)",
         "architecture.md §5c-quater"),
)


ANNOTATIONS: Dict[str, Annotation] = {
    a.name: a for a in (
        Annotation("seldon.io/breaker", "flag",
                   "per-deployment circuit-breaker enable/disable"),
        Annotation("seldon.io/breaker-failures", "int",
                   "consecutive transient failures that open the breaker"),
        Annotation("seldon.io/breaker-reset-ms", "int",
                   "open -> half-open probe delay"),
        Annotation("seldon.io/breaker-probes", "int",
                   "half-open probe budget"),
        Annotation("seldon.io/hedge-ms", "int",
                   "first-wins duplicate delay for idempotent unary calls"),
        Annotation("seldon.io/grpc-retries", "int",
                   "bounded gRPC retry budget on transient statuses"),
        Annotation("seldon.io/grpc-read-timeout", "int",
                   "gRPC per-call timeout (ms)"),
        Annotation("seldon.io/rest-retries", "int",
                   "bounded REST retry budget on 502/503/504 + connection faults"),
        Annotation("seldon.io/rest-read-timeout", "int",
                   "REST read timeout (ms)"),
        Annotation("seldon.io/rest-connection-timeout", "int",
                   "REST connect timeout (ms)"),
    )
}


HEADERS: Dict[str, Header] = {
    h.name: h for h in (
        Header("X-Seldon-Deadline-Ms", "int",
               "end-to-end budget minted at ingress; re-injected with the "
               "remaining budget on every downstream hop"),
        Header("X-Seldon-Priority", "int",
               "admission priority class for the generation engine's "
               "shedding/preemption policy"),
        Header("X-Seldon-Adapter", "str",
               "named LoRA adapter (weight set) this request decodes with; "
               "lands in meta.tags.adapter, an explicit tag in the body wins"),
    )
}

_HEADER_NAMES_LOWER = {h.lower() for h in HEADERS}


def declared(name: str) -> bool:
    """True when ``name`` is a declared env knob, annotation, or header
    (headers match case-insensitively)."""
    return name in ENV_KNOBS or name in ANNOTATIONS or name.lower() in _HEADER_NAMES_LOWER


def _require(name: str) -> Knob:
    knob = ENV_KNOBS.get(name)
    if knob is None:
        raise UndeclaredKnobError(
            f"{name!r} is not declared in runtime/knobs.py: every SELDON_TPU_* read goes through the registry")
    return knob


def raw(name: str, default: Optional[str] = None) -> Optional[str]:
    """The knob's value, or ``default`` when unset; an undeclared name
    raises :class:`UndeclaredKnobError`."""
    _require(name)
    return os.environ.get(name, default)


def flag(name: str) -> bool:
    """An on/off knob: a default-on flag is off only at ``0``, a
    default-off flag is on only at ``1``.  Only for ``kind="flag"``."""
    knob = _require(name)
    if knob.kind != "flag":
        raise UndeclaredKnobError(f"{name!r} is kind={knob.kind!r}, not a flag: read it with raw()")
    val = os.environ.get(name)
    if val is None:
        val = knob.default
    return val != "0" if knob.default == "1" else val == "1"


def snapshot(environ: Optional[Dict[str, str]] = None) -> List[Dict[str, Any]]:
    """The whole registry with current raw values, sorted by name (the
    ``GET /debug/knobs`` payload; ``environ`` overrides the process
    environment)."""
    e = environ if environ is not None else os.environ
    out: List[Dict[str, Any]] = []
    for knob in sorted(ENV_KNOBS.values(), key=lambda k: k.name):
        val = e.get(knob.name)
        out.append({
            "name": knob.name,
            "kind": knob.kind,
            "default": knob.default,
            "zero_off": knob.zero_off,
            "set": val is not None,
            "value": val,
            "doc": knob.doc,
            "anchor": knob.anchor,
        })
    return out
