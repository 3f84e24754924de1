"""Per-request black-box capture: the forensics record one slow or
failed request leaves behind (the port's copy of
``seldon_core_tpu/utils/capture.py``; a container either package writes
the other reads).

The capture plane assembles what the engine already measures (lifecycle
phase stamps, the flight recorder's per-wave records, the cost ledger's
totals, the sampling recipe and seed) into one per-request artifact: a
CRC-trailered SRT1 capture container (``codec/bufview.pack_capture``)
in a bounded on-disk store.  Three triggers write it
(``SELDON_TPU_CAPTURE_SAMPLE`` head sampling, always-on-error, and
p99-breach via the flight recorder's dump hook), the gateway's
``GET /debug/request/<puid>`` stitches it with the live span ring into
one timeline, and ``seldon_core_tpu_torch/tools/replay.py`` re-executes
it (greedy replays are bit for bit on the same device and dtype).

Privacy posture: every store write routes through :func:`redact`: with
``SELDON_TPU_CAPTURE_PAYLOADS=0`` the prompt and output token frames
are dropped while lengths and metadata survive.

``SELDON_TPU_CAPTURE=0`` (the default) removes the plane entirely: no
store, no triggers, no new ``engine_stats()`` keys.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import tempfile
import threading
import time
import zlib
from typing import Any, Dict, List, Optional

import numpy as np

from seldon_core_tpu_torch.runtime import knobs

logger = logging.getLogger(__name__)

CAPTURE_SCHEMA_VERSION = 1

# default LRU byte budget for the on-disk store; constructor-overridable
# (deliberately not a knob: the dir + master switch are the operator
# surface, the budget is a safety backstop)
DEFAULT_STORE_BYTES = 64 << 20

_FILE_SUFFIX = ".srt1"
_UNSAFE_RE = re.compile(r"[^A-Za-z0-9._-]")


def capture_enabled() -> bool:
    """Master switch: ``SELDON_TPU_CAPTURE=1`` arms the plane (default
    off — the hot path carries zero capture work on the off lane)."""
    return knobs.flag("SELDON_TPU_CAPTURE")


def sample_every() -> int:
    """Head-sampling rate: capture every Nth completed request
    (0 = head sampling off; error/breach triggers are independent)."""
    try:
        return max(0, int(knobs.raw("SELDON_TPU_CAPTURE_SAMPLE", "0") or 0))
    except ValueError:
        return 0


def payloads_enabled() -> bool:
    """``SELDON_TPU_CAPTURE_PAYLOADS=0`` drops payload frames at the
    store boundary (see :func:`redact`)."""
    return knobs.flag("SELDON_TPU_CAPTURE_PAYLOADS")


@dataclasses.dataclass
class RequestCapture:
    """One request's black box: identity, recipe, phase decomposition,
    per-wave recorder slice, cost totals, payload frames, and the knob
    snapshot a replay rebuilds the engine from."""

    puid: str
    trace_id: str = ""
    status: str = "ok"              # ok | error
    reason: str = ""                # MicroserviceError reason on errors
    trigger: str = "manual"         # sample | error | breach | manual
    # sampling recipe + the exact per-request seed the component mixed
    # (tools/replay.py re-submits it via the tags["seed"] override)
    seed: Optional[int] = None
    max_new_tokens: int = 0
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    adapter: Optional[str] = None
    priority: int = 0
    deadline_remaining_ms: Optional[float] = None
    rows: int = 1
    # lifecycle phase decomposition (ms), derived from the stream's
    # t_submit/t_prefill_start/t_decode_start/t_first_token/t_finish
    phases: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # flight-recorder records whose wave carried this puid — each holds
    # the prefill/decode wall terms + queue depth of one engine wave
    waves: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    cost: Dict[str, Any] = dataclasses.field(default_factory=dict)
    knobs: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    model: Dict[str, Any] = dataclasses.field(default_factory=dict)
    tags: Dict[str, Any] = dataclasses.field(default_factory=dict)
    time: float = 0.0
    prompt: Any = None              # 1-D int32 token ids (or None)
    tokens: Any = None              # 1-D int32 emitted tokens (or None)

    def to_payload(self) -> Dict[str, Any]:
        """The ``{"prompt", "tokens", "meta"}`` dict
        ``codec/bufview.pack_capture`` serializes."""
        meta = {
            "schema_version": CAPTURE_SCHEMA_VERSION,
            "puid": self.puid,
            "trace_id": self.trace_id,
            "status": self.status,
            "reason": self.reason,
            "trigger": self.trigger,
            "seed": self.seed,
            "max_new_tokens": int(self.max_new_tokens),
            "temperature": float(self.temperature),
            "top_k": int(self.top_k),
            "eos_id": self.eos_id,
            "adapter": self.adapter,
            "priority": int(self.priority),
            "deadline_remaining_ms": self.deadline_remaining_ms,
            "rows": int(self.rows),
            "phases": dict(self.phases),
            "waves": list(self.waves),
            "cost": dict(self.cost),
            "knobs": list(self.knobs),
            "model": dict(self.model),
            "tags": dict(self.tags),
            "time": float(self.time),
        }
        return {
            "prompt": np.asarray(
                [] if self.prompt is None else self.prompt, np.int32
            ).reshape(-1),
            "tokens": np.asarray(
                [] if self.tokens is None else self.tokens, np.int32
            ).reshape(-1),
            "meta": meta,
        }

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> "RequestCapture":
        meta = dict(payload.get("meta") or {})
        fields = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in meta.items()
                  if k in fields and k not in ("prompt", "tokens")}
        cap = cls(puid=str(meta.get("puid", "")), **{
            k: v for k, v in kwargs.items() if k != "puid"
        })
        cap.prompt = np.asarray(payload.get("prompt", []), np.int32).reshape(-1)
        cap.tokens = np.asarray(payload.get("tokens", []), np.int32).reshape(-1)
        return cap


def redact(payload: Dict[str, Any]) -> Dict[str, Any]:
    """The store's write-side filter — EVERY capture-store write routes
    through here.  Always stamps the payload lengths
    into the meta; with ``SELDON_TPU_CAPTURE_PAYLOADS=0`` the prompt
    and output token frames are replaced by empty frames so raw ids
    never reach disk."""
    out = dict(payload)
    meta = dict(out.get("meta") or {})
    prompt = np.asarray(out.get("prompt", []), np.int32).reshape(-1)
    tokens = np.asarray(out.get("tokens", []), np.int32).reshape(-1)
    meta.setdefault("prompt_len", int(prompt.size))
    meta.setdefault("tokens_len", int(tokens.size))
    if not payloads_enabled():
        prompt = np.zeros((0,), np.int32)
        tokens = np.zeros((0,), np.int32)
        meta["payloads_redacted"] = True
    else:
        meta.setdefault("payloads_redacted", False)
    out["prompt"], out["tokens"], out["meta"] = prompt, tokens, meta
    return out


def _safe_name(puid: str) -> str:
    """Collision-safe filename stem for a puid: the sanitized tail plus
    a crc32 of the raw id (two puids differing only in stripped
    characters must not alias one file)."""
    stem = _UNSAFE_RE.sub("_", puid)[-80:] or "request"
    return f"{stem}-{zlib.crc32(puid.encode('utf-8')) & 0xFFFFFFFF:08x}"


class CaptureStore:
    """Bounded on-disk capture store: one SRT1 container per puid under
    ``root`` (``SELDON_TPU_CAPTURE_DIR``, else a lazily created temp
    dir), LRU-evicted by total bytes.  Thread-safe; write failures are
    counted, never raised into the serving path by callers."""

    def __init__(self, root: Optional[str] = None,
                 max_bytes: int = DEFAULT_STORE_BYTES):
        self.root = root or knobs.raw("SELDON_TPU_CAPTURE_DIR", "") or ""
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self.writes = 0
        self.evictions = 0
        self.errors = 0

    def _ensure_root(self) -> str:
        with self._lock:
            if not self.root:
                self.root = tempfile.mkdtemp(prefix="seldon-tpu-captures-")
            os.makedirs(self.root, exist_ok=True)
            return self.root

    def path_for(self, puid: str) -> str:
        return os.path.join(
            self._ensure_root(), f"capture-{_safe_name(puid)}{_FILE_SUFFIX}"
        )

    # -- writes -------------------------------------------------------------

    def put(self, cap: "RequestCapture") -> Optional[str]:
        """Serialize + store one capture; returns the file path, or
        None on failure (counted in ``errors``)."""
        from seldon_core_tpu_torch.codec import bufview

        try:
            blob = bufview.pack_capture(redact(cap.to_payload()))
            path = self.path_for(cap.puid)
            tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — counted, never raised to serving
            with self._lock:
                self.errors += 1
            logger.exception("capture store write failed (puid=%s)", cap.puid)
            return None
        with self._lock:
            self.writes += 1
        self._evict_over_budget(keep=path)
        return path

    def _evict_over_budget(self, keep: Optional[str] = None) -> None:
        """Drop oldest-written containers until the store fits the byte
        budget (the just-written file is evicted last)."""
        try:
            entries = []
            for name in self._listdir():
                p = os.path.join(self.root, name)
                st = os.stat(p)
                entries.append((st.st_mtime, st.st_size, p))
            total = sum(size for _, size, _ in entries)
            entries.sort()  # oldest first
            for _, size, p in entries:
                if total <= self.max_bytes:
                    break
                if p == keep and total - size <= self.max_bytes:
                    continue
                os.unlink(p)
                total -= size
                with self._lock:
                    self.evictions += 1
        except OSError:
            logger.exception("capture store eviction sweep failed")

    # -- reads --------------------------------------------------------------

    def _listdir(self) -> List[str]:
        if not self.root or not os.path.isdir(self.root):
            return []
        return [n for n in os.listdir(self.root)
                if n.startswith("capture-") and n.endswith(_FILE_SUFFIX)]

    def get(self, puid: str) -> Optional["RequestCapture"]:
        if not self.root:
            return None
        path = os.path.join(
            self.root, f"capture-{_safe_name(puid)}{_FILE_SUFFIX}"
        )
        return self.load(path)

    @staticmethod
    def load(path: str) -> Optional["RequestCapture"]:
        from seldon_core_tpu_torch.codec import bufview

        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return None
        return RequestCapture.from_payload(bufview.unpack_capture(blob))

    def puids(self) -> List[str]:
        """Stored puids, newest first (reads each container's meta —
        the store is a debug surface, not a hot path)."""
        out = []
        for name in self._listdir():
            p = os.path.join(self.root, name)
            try:
                mtime = os.stat(p).st_mtime
            except OSError:
                continue
            cap = self.load(p)
            if cap is not None:
                out.append((mtime, cap.puid))
        return [puid for _, puid in sorted(out, reverse=True)]

    def total_bytes(self) -> int:
        total = 0
        for name in self._listdir():
            try:
                total += os.stat(os.path.join(self.root, name)).st_size
            except OSError:
                continue
        return total


_default_store: Optional[CaptureStore] = None
_default_lock = threading.Lock()


def default_store() -> CaptureStore:
    """The process-wide store every writer and the gateway's
    ``/debug/request`` endpoint share (same ``SELDON_TPU_CAPTURE_DIR``
    resolution everywhere)."""
    global _default_store
    with _default_lock:
        if _default_store is None:
            _default_store = CaptureStore()
        return _default_store


def reset_default_store() -> None:
    """Drop the singleton so the next reader re-resolves
    ``SELDON_TPU_CAPTURE_DIR`` (tests + tools that flip the env)."""
    global _default_store
    with _default_lock:
        _default_store = None


def phase_terms(t_submit: Optional[float], t_prefill: Optional[float],
                t_decode: Optional[float], t_first: Optional[float],
                t_finish: Optional[float]) -> Dict[str, Any]:
    """The five-phase latency decomposition (ms) from a stream's
    lifecycle stamps; missing stamps yield None terms (error captures
    may die before decode ever started)."""

    def ms(a: Optional[float], b: Optional[float]) -> Optional[float]:
        if not a or not b:
            return None
        return round((b - a) * 1000.0, 3)

    return {
        "queued_ms": ms(t_submit, t_prefill),
        "prefill_ms": ms(t_prefill, t_decode),
        "decode_ms": ms(t_decode, t_finish),
        "ttft_ms": ms(t_submit, t_first),
        "total_ms": ms(t_submit, t_finish),
        "stamps": {
            "t_submit": t_submit, "t_prefill_start": t_prefill,
            "t_decode_start": t_decode, "t_first_token": t_first,
            "t_finish": t_finish,
        },
    }


def knob_snapshot() -> List[Dict[str, Any]]:
    """The SET knobs of this process (name -> raw value) — the recipe
    ``tools/replay.py`` re-applies before rebuilding the
    engine.  Unset knobs are omitted: the replay host's defaults apply,
    exactly as they did at capture time."""
    return [
        {"name": k["name"], "value": k["value"]}
        for k in knobs.snapshot() if k["set"]
    ]


def now() -> float:
    return time.time()
